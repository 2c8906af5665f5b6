"""qba_tpu_torch — the PyTorch/CUDA port of :mod:`qba_tpu`.

The same detectable Quantum Byzantine Agreement simulation, on PyTorch
tensors with an explicit trial axis, with the voting round run by a
hand-written CUDA kernel for Hopper (``ops/csrc/fused_round.cu``).  A
trial is a pure function of its threefry key, and for the same keys every
per-trial output (decisions, success, accepted sets, overflow) equals the
JAX package's.  This package imports neither JAX nor :mod:`qba_tpu`.
"""

from qba_tpu_torch.config import QBAConfig


def run_trials(cfg, keys=None, *, device=None, partitionable=None):
    """Re-export of :func:`qba_tpu_torch.backends.torch_backend.run_trials`
    (``device=None`` means CUDA; ``partitionable``: JAX's threefry mode,
    None for the current one)."""
    from qba_tpu_torch.backends.torch_backend import run_trials as _run

    return _run(cfg, keys, device=device, partitionable=partitionable)


__all__ = ["QBAConfig", "run_trials"]
__version__ = "0.1.0"
