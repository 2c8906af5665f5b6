"""Sequential statistics and adaptive trial allocation — counterpart of
:mod:`qba_tpu.stats`, with the same exports.

:mod:`~qba_tpu_torch.stats.estimators` turns chunk counts into certified
rates (point estimate + CI), :mod:`~qba_tpu_torch.stats.sequential`
provides anytime-valid stopping rules, :mod:`~qba_tpu_torch.stats.targets`
parses the shared ``target=`` grammar, :mod:`~qba_tpu_torch.stats.allocate`
spends a shared chunk budget across a cell grid where the answer is least
known, and :mod:`~qba_tpu_torch.stats.device` compiles the stopping
predicate into the integer tables the device-resident loop consults.
Copies of the JAX package's host arithmetic: the port imports nothing of
:mod:`qba_tpu`.
"""

from qba_tpu_torch.stats.allocate import AdaptiveAllocator
from qba_tpu_torch.stats.device import stop_tables
from qba_tpu_torch.stats.estimators import (
    RateEstimate,
    StreamingRate,
    SweepEstimators,
    clopper_pearson_ci,
    rate_estimate,
    round_histogram,
    success_rate,
    wilson_ci,
)
from qba_tpu_torch.stats.sequential import SPRT, MixtureMartingaleCI, StopDecision
from qba_tpu_torch.stats.targets import Target, parse_target

__all__ = [
    "AdaptiveAllocator",
    "MixtureMartingaleCI",
    "RateEstimate",
    "SPRT",
    "StopDecision",
    "StreamingRate",
    "SweepEstimators",
    "Target",
    "clopper_pearson_ci",
    "parse_target",
    "rate_estimate",
    "round_histogram",
    "stop_tables",
    "success_rate",
    "wilson_ci",
]
