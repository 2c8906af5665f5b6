"""Warnings the port raises when it runs something other than what was
asked — counterpart of :mod:`qba_tpu.diagnostics` (the warning class
and its ``reason``; the JAX package's decision recorder has no
counterpart yet)."""

import warnings


class QBADemotionWarning(UserWarning):
    """A requested engine gave way to another that computes the same
    results: the megakernel to the fused per-round engine when counters
    are collected or no sharded plan exists, the gen entry to host
    generation under the ``tp`` mesh, or a circuit past the dense cap to
    the stabilizer tableau engine.  ``reason`` is the JAX package's
    recorded reason for the same demotion, where it records one."""

    def __init__(self, message: str = "", reason: str | None = None):
        super().__init__(message)
        self.reason = reason


def warn_demotion(message: str, reason: str, stacklevel: int = 2) -> None:
    """Warn :class:`QBADemotionWarning` with ``reason``; ``stacklevel`` is
    relative to the caller."""
    warnings.warn(QBADemotionWarning(message, reason),
                  stacklevel=stacklevel + 1)
