"""The protocol's two circuit families and the list generation on them —
counterpart of :mod:`qba_tpu.qsim.protocol_circuits`.

:func:`generate_lists_dense` runs the joint circuits per list position
on a circuit executor; :func:`generate_lists_stabilizer` runs every
position of a batch on the batched GF(2) engine: the parity products of
:func:`stabilizer_gen_operands`, then the measurement sweep
(:func:`qba_tpu_torch.ops.gf2_sweep.gf2_sweep`, a kernel on CUDA) from
the static tableaux of :func:`stabilizer_gen_tables`; on CUDA the sweep
kernel evaluates each family's affine map, :func:`stabilizer_sweep_tables`.
The trial megakernel's gen entry takes the same tables and operands and
sweeps inside the launch.

Qubit layout: ``(n_parties + 1)`` groups of ``n_qubits``; group 0 is the
QSD's extra copy, group 1 the commander's particles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.decode import measure_to_ints
from qba_tpu_torch.qsim.circuit import Circuit, Gate


def not_q_correlated(n_parties: int, n_qubits: int) -> Gate:
    """H on every qubit of groups 1..n_parties, then CNOT copying group 1
    onto group 0."""
    size = (n_parties + 1) * n_qubits
    gate = Gate(size, "not Q-Correlated")
    for i in range(n_qubits, size):
        gate.add_operation("H", targets=i)
    for i in range(n_qubits):
        gate.add_operation("X", targets=i, controls=i + n_qubits)
    return gate


def q_correlated(n_parties: int, n_qubits: int) -> Gate:
    """H on group 0; X-encode a permutation value into each party group
    as ``XPOW`` ops reading the permutation's bits at run time; CNOT
    group 0 onto every other group."""
    size = (n_parties + 1) * n_qubits
    gate = Gate(size, "Q-Correlated")
    for i in range(n_qubits):
        gate.add_operation("H", targets=i)
    for i in range(1, n_parties + 1):
        for j in range(n_qubits):
            # param vector layout: bit j (big-endian) of rands[i-1]
            gate.add_operation(
                "XPOW", targets=i * n_qubits + j, param=(i - 1) * n_qubits + j
            )
    for i in range(n_qubits, size):
        gate.add_operation("X", targets=i, controls=i % n_qubits)
    return gate


def gen_q_corr_circuit(n_parties: int, n_qubits: int) -> Circuit:
    size = (n_parties + 1) * n_qubits
    return Circuit(size, "Q-Correlated Circuit").add_operation(
        q_correlated(n_parties, n_qubits)
    )


def gen_nq_corr_circuit(n_parties: int, n_qubits: int) -> Circuit:
    size = (n_parties + 1) * n_qubits
    return Circuit(size, "Not Q-Correlated Circuit").add_operation(
        not_q_correlated(n_parties, n_qubits)
    )


def _perm_bits(perm: torch.Tensor, n_qubits: int) -> torch.Tensor:
    """Big-endian bits of each permutation entry: ``[..., n] -> [..., n *
    n_qubits]`` int32."""
    shifts = torch.arange(n_qubits - 1, -1, -1, device=perm.device)
    bits = (perm[..., None] >> shifts) & 1
    return bits.reshape(perm.shape[:-1] + (-1,)).to(torch.int32)


def dense_draws(cfg: QBAConfig, keys: torch.Tensor):
    """The integer draws of the dense path for trial keys ``[T, 2]``:
    ``(qcorr bool [T, S], perms int32 [T, S, n], params int32 [T, S, n *
    n_qubits], meas_keys [T, S, 2])`` — which positions are Q-correlated,
    each position's permutation of ``1..n``, its bits as the Q-correlated
    circuit's runtime params, and its measurement key."""
    n, s = cfg.n_parties, cfg.size_l
    k = jr.split(keys, 3)
    qcorr = jr.bernoulli(k[..., 0, :], 0.5, (s,))
    perm_keys = jr.split(k[..., 1, :], s)
    meas_keys = jr.split(k[..., 2, :], s)
    perms = jr.permutation(
        perm_keys, torch.arange(1, n + 1, dtype=torch.int32,
                                device=keys.device))
    return qcorr, perms, _perm_bits(perms, cfg.n_qubits), meas_keys


def lists_from_bits(cfg: QBAConfig, bits: torch.Tensor) -> torch.Tensor:
    """Measured bits ``[T, size_l, total_qubits]`` -> order values int32
    ``[T, n_parties + 1, size_l]``: party ``i``'s bits across positions,
    big-endian per group."""
    n, nq, s = cfg.n_parties, cfg.n_qubits, cfg.size_l
    per_party = bits.reshape(-1, s, n + 1, nq).transpose(1, 2)
    return measure_to_ints(per_party.reshape(-1, n + 1, s * nq), s, nq)


def generate_lists_dense(cfg: QBAConfig, keys: torch.Tensor,
                         impl: str = "xla"):
    """Dense-path list generation for trial keys ``[T, 2]``: one sample
    of the joint circuit per list position, every trial and position in
    one batch.

    ``impl`` selects the circuit executor (:meth:`Circuit.compile`):
    ``"xla"``, ``"pallas"``, ``"stabilizer"`` (the per-shot tableau
    engine, any width) or ``"auto"``, which past the dense cap hands the
    whole batch to :func:`generate_lists_stabilizer`.  Each position runs
    only the circuit family its ``qcorr`` bit selects, on that position's
    measurement key (the JAX package runs both on the same key and
    selects: the result is the same).

    Returns ``(lists int32 [T, n_parties + 1, size_l], qcorr bool [T,
    size_l])``: row 0 is the QSD's extra copy, row 1 the commander.
    """
    n, nq = cfg.n_parties, cfg.n_qubits
    if keys.dim() != 2:
        raise ValueError(f"keys must be [T, 2]; got {tuple(keys.shape)}")
    if impl == "auto":
        impl = gen_q_corr_circuit(n, nq).resolve_auto_impl(keys.device)
        if impl == "stabilizer":
            return generate_lists_stabilizer(cfg, keys)
    noise = (cfg.p_depolarize, cfg.p_measure_flip)
    run_q = gen_q_corr_circuit(n, nq).compile(impl, *noise)
    run_nq = gen_nq_corr_circuit(n, nq).compile(impl, *noise)

    qcorr, _perms, params, meas_keys = dense_draws(cfg, keys)
    bits = torch.empty(qcorr.shape + ((n + 1) * nq,), dtype=torch.int32,
                       device=keys.device)
    bits[qcorr] = run_q(meas_keys[qcorr], params[qcorr])
    bits[~qcorr] = run_nq(meas_keys[~qcorr])
    return lists_from_bits(cfg, bits), qcorr


@functools.lru_cache(maxsize=None)
def _programs(n_parties: int, n_qubits: int):
    """Both families' symplectic programs (Q-correlated, then not)."""
    from qba_tpu_torch.gf2.symplectic import compile_symplectic

    total = (n_parties + 1) * n_qubits
    circ_q = gen_q_corr_circuit(n_parties, n_qubits)
    circ_nq = gen_nq_corr_circuit(n_parties, n_qubits)
    return (compile_symplectic(total, tuple(circ_q.ops), circ_q.n_params),
            compile_symplectic(total, tuple(circ_nq.ops), 0))


def stabilizer_gen_tables(cfg: QBAConfig, device=None):
    """Static packed tableaux of both circuit families: ``(x0w_q, z0w_q,
    x0w_nq, z0w_nq)``, each int32 ``[2 * total_qubits, W]`` holding the
    JAX package's uint32 words (:mod:`qba_tpu_torch.gf2.bitops`), on
    ``device`` (default: the CPU)."""
    from qba_tpu_torch.gf2.bitops import pack_bits

    prog_q, prog_nq = _programs(cfg.n_parties, cfg.n_qubits)
    return tuple(pack_bits(torch.from_numpy(m)).to(device)
                 for m in (prog_q.x, prog_q.z, prog_nq.x, prog_nq.z))


@functools.lru_cache(maxsize=None)
def _sweep_tables(n_parties: int, n_qubits: int, device: torch.device):
    from qba_tpu_torch.gf2.bitops import pack_bits
    from qba_tpu_torch.ops.gf2_sweep import sweep_tables

    progs = _programs(n_parties, n_qubits)[::-1]

    def packed(field):
        return torch.stack([pack_bits(torch.from_numpy(getattr(p, field)))
                            for p in progs])

    return sweep_tables((n_parties + 1) * n_qubits, packed("x"),
                        packed("z")).to(device)


def stabilizer_sweep_tables(cfg: QBAConfig, device=None) -> torch.Tensor:
    """The sweep kernel's tables of both circuit families
    (:func:`~qba_tpu_torch.ops.gf2_sweep.sweep_tables` of
    :func:`stabilizer_gen_tables`, family 0 not Q-correlated, family 1
    Q-correlated): int32 ``[2, wt, n_pad]`` on ``device`` (default: the
    CPU), built once per config and device (the host's symbolic sweeps,
    PERF.md)."""
    return _sweep_tables(cfg.n_parties, cfg.n_qubits,
                         torch.device("cpu" if device is None else device))


def stabilizer_gen_operands(cfg: QBAConfig, keys: torch.Tensor):
    """Per-trial operands of the stabilizer list generation for trial
    keys ``[T, 2]`` (each trial's ``k_lists`` subkey): everything of
    :func:`generate_lists_stabilizer` except the sweep and the decode,
    under the JAX package's key tree (``k_qcorr, k_perm, k_meas``;
    per-position permutation and measurement keys).  Returns ``(qcorr
    bool [T, S], coins, r_q, r_nq, mflip)``, the rest uint8 0/1:

    * ``coins`` ``[T, S, total]``: ``bits(meas_key, (total,)) & 1``,
      shared by both families;
    * ``r_q`` ``[T, S, 2 * total]``: Q-correlated phases, ``r0 ^ params
      @ L^T`` (the permutation's bits), with any depolarizing phase
      parity folded in;
    * ``r_nq`` ``[T, S, 2 * total]``: not-Q-correlated phases, noise
      likewise;
    * ``mflip`` ``[T, S, total]``: readout flips (zeros when noiseless).
    """
    from qba_tpu_torch.gf2.linalg import gf2_matmul
    from qba_tpu_torch.gf2.symplectic import _draw_coins

    dev = keys.device
    total, s = cfg.total_qubits, cfg.size_l
    prog_q, prog_nq = _programs(cfg.n_parties, cfg.n_qubits)

    def t(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(dev, torch.int32)

    qcorr, _perms, params, meas_keys = dense_draws(cfg, keys)
    coins = _draw_coins(meas_keys, total)                # [T, S, total]
    r_q = t(prog_q.r) ^ gf2_matmul(params & 1, t(prog_q.l.T))
    r_nq = t(prog_nq.r).expand(keys.shape[0], s, 2 * total)
    noisy = cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0
    if noisy:
        from qba_tpu_torch.qsim.noise import noise_draws

        bx, bz, mflip = noise_draws(meas_keys, total, cfg.p_depolarize,
                                    cfg.p_measure_flip)
        r_q = r_q ^ gf2_matmul(bx, t(prog_q.z.T)) ^ gf2_matmul(
            bz, t(prog_q.x.T))
        r_nq = r_nq ^ gf2_matmul(bx, t(prog_nq.z.T)) ^ gf2_matmul(
            bz, t(prog_nq.x.T))
    else:
        mflip = torch.zeros_like(coins)

    def u8(x):
        return x.to(torch.uint8).contiguous()

    return qcorr, u8(coins), u8(r_q), u8(r_nq), u8(mflip)


def stabilizer_bits(cfg: QBAConfig, tables, operands, *,
                    sweep=None) -> torch.Tensor:
    """Every position's measured bits ``[T, S, total]`` (readout flips
    included) from :func:`stabilizer_gen_tables` and
    :func:`stabilizer_gen_operands`: one sweep over all shots, each from
    its own family's tableau.  ``sweep`` defaults to
    :func:`~qba_tpu_torch.ops.gf2_sweep.gf2_sweep` with ``cfg``'s
    :func:`stabilizer_sweep_tables`, which on CUDA the kernel reads in
    place of ``tables``: they must be ``cfg``'s."""
    from qba_tpu_torch.ops.gf2_sweep import gf2_sweep

    x_q, z_q, x_nq, z_nq = tables
    qcorr, coins, r_q, r_nq, mflip = operands
    if sweep is None:
        sweep = functools.partial(
            gf2_sweep, tables=stabilizer_sweep_tables(cfg, qcorr.device))
    total = cfg.total_qubits
    b = qcorr.numel()
    r = torch.where(qcorr[..., None], r_q, r_nq)
    # Family 1 is the Q-correlated tableau: the family index is qcorr.
    bits = sweep(total, torch.stack([x_nq, x_q]), torch.stack([z_nq, z_q]),
                 r.reshape(b, 2 * total), coins.reshape(b, total),
                 qcorr.reshape(b).to(torch.uint8), mflip.reshape(b, total))
    return bits.reshape(qcorr.shape + (total,))


def generate_lists_stabilizer(cfg: QBAConfig, keys: torch.Tensor):
    """List generation on the batched GF(2) engine for trial keys ``[T,
    2]`` — the primary resource path at the reference's own scale (the
    48-qubit 11-party and 204-qubit 33-party joint circuits).  Same key
    tree, coins and layout as :func:`generate_lists_dense`, so the lists
    are bit-identical to ``generate_lists_dense(cfg, keys,
    impl="stabilizer")`` and to the JAX package's.  Returns ``(lists,
    qcorr)`` as :func:`generate_lists_dense`."""
    operands = stabilizer_gen_operands(cfg, keys)
    tables = stabilizer_gen_tables(cfg, keys.device)
    return lists_from_bits(cfg, stabilizer_bits(cfg, tables, operands)), \
        operands[0]
