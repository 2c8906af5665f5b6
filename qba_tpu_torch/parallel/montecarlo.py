"""Trial-sharded Monte-Carlo batches (dp x sp) — counterpart of
:mod:`qba_tpu.parallel.montecarlo`.

``dp`` splits the trials into contiguous chunks, each run on its row's
device; ``sp`` (list positions) is placement only here.  Results equal
the single-device :func:`qba_tpu_torch.backends.torch_backend.run_trials`
for the same keys: a trial is a pure function of its key.
"""

from __future__ import annotations

import dataclasses

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.backends.torch_backend import (
    MonteCarloResult,
    aggregate,
    batched_trials,
    trial_keys,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.parallel.mesh import (
    Mesh,
    axis_sizes,
    dp_devices,
    require_divisible,
)
from qba_tpu_torch.rounds.engine import TrialResult


def cat_trials(parts: list[TrialResult], device) -> TrialResult:
    """The trial batches ``parts`` as one, on ``device``."""
    if len(parts) == 1:
        return parts[0]

    def cat(xs):
        if xs[0] is None:
            return None
        if dataclasses.is_dataclass(xs[0]):
            return type(xs[0])(**{f.name: cat([getattr(x, f.name) for x in xs])
                                  for f in dataclasses.fields(xs[0])})
        return torch.cat([x.to(device) for x in xs])

    return cat(parts)


def run_trials_sharded(cfg: QBAConfig, mesh: Mesh,
                       keys: torch.Tensor | None = None, *,
                       partitionable: bool | None = None) -> MonteCarloResult:
    """Run ``cfg.trials`` protocol executions sharded over ``mesh``.

    ``mesh`` axes used (others are ignored): ``dp`` shards the trial
    batch (``cfg.trials`` must be divisible by it); ``sp`` — if present —
    must divide ``cfg.size_l``.  Results are identical to the
    single-device ``run_trials`` for the same keys (and threefry mode,
    ``partitionable``; None: the current mode).
    """
    axes = axis_sizes(mesh)
    dp = axes.get("dp", 1)
    sp = axes.get("sp", 1)
    devices = dp_devices(mesh)
    p = jr.resolve_mode(partitionable)
    if keys is None:
        keys = trial_keys(cfg, devices[0], partitionable=p)
    require_divisible(keys.shape[0], dp, "trials", "dp")
    require_divisible(cfg.size_l, sp, "size_l", "sp")
    parts = [batched_trials(cfg, k.to(dev), partitionable=p)
             for k, dev in zip(keys.chunk(dp), devices)]
    return aggregate(cat_trials(parts, devices[0]))
