"""Per-phase wall-clock timers and throughput metrics — a copy of
:mod:`qba_tpu.obs.timers`.

``PhaseTimers`` is a *view* over a
:class:`~qba_tpu_torch.obs.telemetry.SpanRecorder`: ``time(phase)``
records a span named ``phase``, and the totals/counts are per-name
aggregates of the recorded spans.  Passing a shared recorder
(``spans=``) makes every timed phase appear in the run's exported trace;
the default constructs a private recorder.  A span is device time only
where it was fenced (:meth:`~qba_tpu_torch.obs.telemetry.SpanRecorder.fence`,
``torch.cuda.synchronize()``, or a readback that waits for the card).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.obs.telemetry import Span, SpanRecorder


class PhaseTimers:
    """Accumulating named wall-clock timers over a span recorder.

    ``with timers.time("rounds"): ...`` accumulates into ``total("rounds")``;
    a phase may be entered repeatedly (per chunk / per rep).  Extra
    keyword args to ``time`` become span args in the exported trace.
    """

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        spans: SpanRecorder | None = None,
    ) -> None:
        self.spans = spans if spans is not None else SpanRecorder(clock=clock)

    @contextlib.contextmanager
    def time(self, phase: str, **args) -> Iterator["Span"]:
        with self.spans.span(phase, **args) as sp:
            yield sp

    def total(self, phase: str) -> float:
        return sum(
            sp.dur
            for sp in self.spans.spans
            if sp.name == phase and sp.dur is not None
        )

    def count(self, phase: str) -> int:
        return sum(
            1
            for sp in self.spans.spans
            if sp.name == phase and sp.dur is not None
        )

    def summary(self) -> dict[str, dict[str, float]]:
        return self.spans.totals()

    def render(self) -> str:
        rows = [
            f"  {phase:<16} {d['total_s']:.4f}s  (x{int(d['count'])})"
            for phase, d in sorted(self.summary().items())
        ]
        return "phase timings:\n" + "\n".join(rows) if rows else "phase timings: none"


def throughput(cfg: QBAConfig, n_trials: int, seconds: float) -> dict[str, float]:
    """Throughput triple for a completed batch.

    ``rounds_per_sec`` counts protocol voting rounds (``n_rounds`` per
    trial) — the repo's headline metric.
    """
    if seconds <= 0:
        raise ValueError("seconds must be > 0")
    return {
        "trials_per_sec": n_trials / seconds,
        "rounds_per_sec": n_trials * cfg.n_rounds / seconds,
        "positions_per_sec": n_trials * cfg.size_l / seconds,
    }
