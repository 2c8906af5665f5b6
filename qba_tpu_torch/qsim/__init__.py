"""Quantum resource generation — counterpart of :mod:`qba_tpu.qsim`: the
factorized sampler (the production path), the dense circuit path
(circuits, statevectors and the protocol's two circuit families) and the
stabilizer path (the batched GF(2) engine at any party count)."""

from qba_tpu_torch.qsim.circuit import Circuit, Gate
from qba_tpu_torch.qsim.protocol_circuits import (
    generate_lists_dense,
    generate_lists_stabilizer,
    not_q_correlated,
    q_correlated,
)
from qba_tpu_torch.qsim.sampler import generate_lists


def generate_lists_for(cfg, keys):
    """Dispatch list generation on ``cfg.qsim_path``: ``factorized`` is
    the closed-form sampler, ``dense`` the joint circuits on the plain
    per-gate engine, ``dense_pallas`` the same on the fused circuit
    kernel (``impl="auto"``: the kernel for CUDA keys, the plain engine
    for CPU keys), ``stabilizer`` the batched GF(2) engine (its sweep a
    kernel for CUDA keys)."""
    if cfg.qsim_path == "factorized":
        return generate_lists(cfg, keys)
    if cfg.qsim_path == "stabilizer":
        return generate_lists_stabilizer(cfg, keys)
    impl = "auto" if cfg.qsim_path == "dense_pallas" else "xla"
    return generate_lists_dense(cfg, keys, impl)


from qba_tpu_torch.qsim.compat import Drewom, QCircuit, QGate  # noqa: E402

__all__ = [
    "Circuit",
    "Drewom",
    "Gate",
    "QCircuit",
    "QGate",
    "generate_lists",
    "generate_lists_dense",
    "generate_lists_for",
    "generate_lists_stabilizer",
    "not_q_correlated",
    "q_correlated",
]
