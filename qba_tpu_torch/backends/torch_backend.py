"""Batched Monte-Carlo runner on PyTorch — counterpart of
:mod:`qba_tpu.backends.jax_backend`.

A trial is a pure function of its key, so a batch is one call of
:func:`qba_tpu_torch.rounds.engine.run_trial` on ``[trials, 2]`` keys,
which runs the round engine ``run_trial`` picks (``auto``: the trial
megakernel on CUDA, ``xla`` on the CPU).  ``trial_pack`` changes nothing
here: the CUDA kernels already run one block per trial.
``device=None`` means CUDA: with no CUDA device :func:`run_trials`
raises rather than quietly running on the CPU; pass ``device="cpu"`` to
run the plain PyTorch path.  The key tree follows JAX's threefry mode
(:mod:`qba_tpu_torch.random`): ``partitionable=None`` reads the current
mode once, and the bool goes down to every draw and kernel of the batch.
"""

from __future__ import annotations

import dataclasses

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops.setup_kernel import keys_kernel
from qba_tpu_torch.rounds.engine import TrialResult, run_trial


@dataclasses.dataclass
class MonteCarloResult:
    """Aggregate over a trial batch."""

    trials: TrialResult  # all per-trial fields, leading axis = trials
    success_rate: torch.Tensor  # float32 scalar

    @property
    def n_trials(self) -> int:
        return self.trials.decisions.shape[0]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_trials: no CUDA device (device=None means CUDA); "
                "pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def trial_keys(cfg: QBAConfig, device=None, *,
               partitionable: bool | None = None) -> torch.Tensor:
    """The batch's key tree root: one key ``[2]`` per trial from the
    config seed (``split(key(seed), trials)``; on CUDA one launch of the
    key entry, :func:`~qba_tpu_torch.ops.setup_kernel.keys_kernel`)."""
    return keys_kernel(cfg.seed, cfg.trials, device=device,
                       partitionable=partitionable)


def batched_trials(cfg: QBAConfig, keys: torch.Tensor, *,
                   partitionable: bool | None = None) -> TrialResult:
    return run_trial(cfg, keys, partitionable=partitionable)


def aggregate(trials: TrialResult) -> MonteCarloResult:
    """Fold a trial batch into the Monte-Carlo summary."""
    return MonteCarloResult(
        trials=trials,
        success_rate=trials.success.to(torch.float32).mean(),
    )


def run_trials(cfg: QBAConfig, keys: torch.Tensor | None = None, *,
               device=None,
               partitionable: bool | None = None) -> MonteCarloResult:
    """Run ``cfg.trials`` protocol executions (or one per given key) on
    ``device`` (default: CUDA), in ``partitionable``'s threefry mode
    (None: the current mode)."""
    dev = resolve_device(device)
    p = jr.resolve_mode(partitionable)
    if keys is None:
        keys = trial_keys(cfg, dev, partitionable=p)
    return aggregate(batched_trials(cfg, keys.to(dev), partitionable=p))


def fence(res):
    """Synchronization fence for wall-clock timing: waits for the CUDA
    work queued so far (a no-op on the CPU).  Returns ``res``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return res
