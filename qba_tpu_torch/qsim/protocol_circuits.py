"""The protocol's two circuit families on the dense engines —
counterpart of :mod:`qba_tpu.qsim.protocol_circuits` (the dense half;
``generate_lists_stabilizer`` and the ``stabilizer_gen_*`` functions
belong to the GF(2) path, ROADMAP A7).

Qubit layout: ``(n_parties + 1)`` groups of ``n_qubits``; group 0 is the
QSD's extra copy, group 1 the commander's particles.
"""

from __future__ import annotations

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


def generate_lists_dense(cfg: QBAConfig, keys: torch.Tensor,
                         impl: str = "xla"):
    """Dense-path list generation for trial keys ``[T, 2]``: one Born
    sample of the joint circuit per list position, every trial and
    position in one batch.

    ``impl`` selects the circuit executor (:meth:`Circuit.compile`):
    ``"xla"``, ``"pallas"`` or ``"auto"``.  Each position runs only the
    circuit family its ``qcorr`` bit selects, on that position's
    measurement key (the JAX package runs both on the same key and
    selects: the result is the same).

    Returns ``(lists int32 [T, n_parties + 1, size_l], qcorr bool [T,
    size_l])``: row 0 is the QSD's extra copy, row 1 the commander.
    """
    n, nq, s = cfg.n_parties, cfg.n_qubits, cfg.size_l
    if keys.dim() != 2:
        raise ValueError(f"keys must be [T, 2]; got {tuple(keys.shape)}")
    noise = (cfg.p_depolarize, cfg.p_measure_flip)
    run_q = gen_q_corr_circuit(n, nq).compile(impl, *noise)
    run_nq = gen_nq_corr_circuit(n, nq).compile(impl, *noise)

    qcorr, _perms, params, meas_keys = dense_draws(cfg, keys)
    bits = torch.empty(qcorr.shape + ((n + 1) * nq,), dtype=torch.int32,
                       device=keys.device)
    bits[qcorr] = run_q(meas_keys[qcorr], params[qcorr])
    bits[~qcorr] = run_nq(meas_keys[~qcorr])

    # Party i's bits across positions, then decode.
    per_party = bits.reshape(-1, s, n + 1, nq).transpose(1, 2)
    lists = measure_to_ints(per_party.reshape(-1, n + 1, s * nq), s, nq)
    return lists, qcorr
