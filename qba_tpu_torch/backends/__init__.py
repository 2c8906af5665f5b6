"""Execution backends of the port: the batched PyTorch runner."""

from qba_tpu_torch.backends.torch_backend import (
    MonteCarloResult,
    run_trials,
    trial_keys,
)

__all__ = ["MonteCarloResult", "run_trials", "trial_keys"]
