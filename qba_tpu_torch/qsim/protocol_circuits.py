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
from qba_tpu_torch.qsim import statevector as sv
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
    whole batch to :func:`generate_lists_stabilizer`.  As in the JAX
    package both families serve every position and its ``qcorr`` bit
    selects, with no shape that depends on the bits: on the statevector
    executors the Q-correlated family's state is prepared for every
    position, the not-Q-correlated family's one all-zero-params state is
    shared, ``torch.where`` picks each position's state and the position
    is sampled once, on its measurement key
    (:func:`_dense_bits`); the tableau engine samples both families on
    every key and selects the bits.

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
    qcorr, _perms, params, meas_keys = dense_draws(cfg, keys)
    b, total = qcorr.numel(), cfg.total_qubits
    q = qcorr.reshape(b)
    params, meas_keys = params.reshape(b, -1), meas_keys.reshape(b, 2)
    if impl == "stabilizer":
        noise = (cfg.p_depolarize, cfg.p_measure_flip)
        run_q = gen_q_corr_circuit(n, nq).compile(impl, *noise)
        run_nq = gen_nq_corr_circuit(n, nq).compile(impl, *noise)
        bits = torch.where(q[:, None], run_q(meas_keys, params),
                           run_nq(meas_keys))
    else:
        bits = _dense_bits(cfg, impl, q, params, meas_keys)
    return lists_from_bits(cfg, bits.reshape(qcorr.shape + (total,))), qcorr


@functools.lru_cache(maxsize=None)
def _dense_states(n_parties: int, n_qubits: int, impl: str,
                  device: torch.device):
    """Both families' state functions (:meth:`Circuit.compile_state`,
    Q-correlated then not) on ``device``, with every constant they read
    already there: compiled once per config, executor and device."""
    fns = tuple(circ.compile_state(impl, device)
                for circ in (gen_q_corr_circuit(n_parties, n_qubits),
                             gen_nq_corr_circuit(n_parties, n_qubits)))
    for fn in fns:
        fn.place()
    return fns


def prepare_dense(cfg: QBAConfig, device=None) -> None:
    """Compile both families' state functions for ``cfg``'s dense path
    on ``device`` (the executor :func:`generate_lists_for` gives it
    there) and copy their constants there now (the gate matrices, the
    circuit kernel's op and pass tables); a CUDA graph that captures a
    chunk cannot copy from host memory, so the graph loop calls this
    before its capture."""
    dev = _on(device)
    impl = "xla"
    if cfg.qsim_path == "dense_pallas":
        impl = gen_q_corr_circuit(cfg.n_parties,
                                  cfg.n_qubits).resolve_auto_impl(dev)
    _dense_states(cfg.n_parties, cfg.n_qubits, impl, dev)


def _dense_bits(cfg: QBAConfig, impl: str, qcorr, params, meas_keys):
    """Every position's measured bits int32 ``[B, total]`` on a
    statevector executor, for positions ``qcorr`` bool ``[B]``, the
    Q-correlated family's runtime params ``[B, n_params]`` and the
    measurement keys ``[B, 2]``: the Q-correlated state of every position
    and the shared not-Q-correlated state, the position's family picked
    by ``torch.where`` and one Born sample per position, a chunk of
    positions at a time (:data:`~qba_tpu_torch.qsim.statevector.
    SAMPLE_CHUNK_ELEMS` amplitudes), then the noise's classical flips."""
    dev, total = meas_keys.device, cfg.total_qubits
    state_q, state_nq = _dense_states(cfg.n_parties, cfg.n_qubits, impl,
                                      _on(dev))
    shared = state_nq()
    step = max(1, sv.SAMPLE_CHUNK_ELEMS >> total)
    bits = torch.empty((qcorr.shape[0], total), dtype=torch.int32,
                       device=dev)
    for a in range(0, qcorr.shape[0], step):
        rows = slice(a, a + step)
        state = torch.where(qcorr[rows, None], state_q(params[rows]), shared)
        bits[rows] = sv.measure_all(state, meas_keys[rows])
    if cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0:
        from qba_tpu_torch.qsim.noise import classical_flips

        bits = bits ^ classical_flips(meas_keys, total, cfg.p_depolarize,
                                      cfg.p_measure_flip)
    return bits


@functools.lru_cache(maxsize=None)
def _programs(n_parties: int, n_qubits: int):
    """Both families' symplectic programs (Q-correlated, then not)."""
    from qba_tpu_torch.gf2.symplectic import compile_symplectic

    total = (n_parties + 1) * n_qubits
    circ_q = gen_q_corr_circuit(n_parties, n_qubits)
    circ_nq = gen_nq_corr_circuit(n_parties, n_qubits)
    return (compile_symplectic(total, tuple(circ_q.ops), circ_q.n_params),
            compile_symplectic(total, tuple(circ_nq.ops), 0))


def _on(device) -> torch.device:
    """``device`` as its tensors name it (``cuda`` with its index), the
    CPU for None: the key of the per-device table caches."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _gen_tables(n_parties: int, n_qubits: int, device: torch.device):
    from qba_tpu_torch.gf2.bitops import pack_bits

    prog_q, prog_nq = _programs(n_parties, n_qubits)
    return tuple(pack_bits(torch.from_numpy(m)).to(device)
                 for m in (prog_q.x, prog_q.z, prog_nq.x, prog_nq.z))


def stabilizer_gen_tables(cfg: QBAConfig, device=None):
    """Static packed tableaux of both circuit families: ``(x0w_q, z0w_q,
    x0w_nq, z0w_nq)``, each int32 ``[2 * total_qubits, W]`` holding the
    JAX package's uint32 words (:mod:`qba_tpu_torch.gf2.bitops`), on
    ``device`` (default: the CPU), built once per config and device and
    shared by every caller (read them, never write them)."""
    return _gen_tables(cfg.n_parties, cfg.n_qubits, _on(device))


@functools.lru_cache(maxsize=None)
def _operand_tables(n_parties: int, n_qubits: int, device: torch.device):
    """The int32 matrices :func:`stabilizer_gen_operands` reads, on
    ``device``: each family's initial phases ``r`` and tableau
    transposes, and the Q-correlated family's parameter map ``L^T``."""
    prog_q, prog_nq = _programs(n_parties, n_qubits)

    def t(m):
        return torch.from_numpy(np.ascontiguousarray(m)).to(device,
                                                            torch.int32)

    return dict(r_q=t(prog_q.r), l_q=t(prog_q.l.T), r_nq=t(prog_nq.r),
                z_q=t(prog_q.z.T), x_q=t(prog_q.x.T), z_nq=t(prog_nq.z.T),
                x_nq=t(prog_nq.x.T))


def prepare_tables(cfg: QBAConfig, device=None) -> None:
    """Build every per-config table of the stabilizer path on ``device``
    now: the tableaux, the operands' matrices and the sweep kernel's
    affine maps.  Each is built on the host and copied to the device
    once; a CUDA graph that captures a chunk cannot copy from host
    memory, so the graph loop calls this before its capture."""
    stabilizer_gen_tables(cfg, device)
    _operand_tables(cfg.n_parties, cfg.n_qubits, _on(device))
    stabilizer_sweep_tables(cfg, device)


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
    return _sweep_tables(cfg.n_parties, cfg.n_qubits, _on(device))


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

    total, s = cfg.total_qubits, cfg.size_l
    m = _operand_tables(cfg.n_parties, cfg.n_qubits, keys.device)

    qcorr, _perms, params, meas_keys = dense_draws(cfg, keys)
    coins = _draw_coins(meas_keys, total)                # [T, S, total]
    r_q = m["r_q"] ^ gf2_matmul(params & 1, m["l_q"])
    r_nq = m["r_nq"].expand(keys.shape[0], s, 2 * total)
    noisy = cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0
    if noisy:
        from qba_tpu_torch.qsim.noise import noise_draws

        bx, bz, mflip = noise_draws(meas_keys, total, cfg.p_depolarize,
                                    cfg.p_measure_flip)
        r_q = r_q ^ gf2_matmul(bx, m["z_q"]) ^ gf2_matmul(bz, m["x_q"])
        r_nq = r_nq ^ gf2_matmul(bx, m["z_nq"]) ^ gf2_matmul(bz, m["x_nq"])
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
