"""Warnings the port raises when it runs something other than what was
asked — counterpart of :mod:`qba_tpu.diagnostics` (the warning class
only; the JAX package's decision recorder has no counterpart yet)."""


class QBADemotionWarning(UserWarning):
    """A requested engine gave way to another that computes the same
    results: the megakernel to the fused per-round engine when counters
    are collected, or a circuit past the dense cap to the stabilizer
    tableau engine."""
