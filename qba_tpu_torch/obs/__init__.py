"""Observability for the port — counterpart of the parts of
:mod:`qba_tpu.obs` the sweeps, the studies and the serving worker use:
the structured event log (:mod:`~qba_tpu_torch.obs.events`), spans
(:mod:`~qba_tpu_torch.obs.telemetry`), the phase timers over them
(:mod:`~qba_tpu_torch.obs.timers`), run manifests and the ``--telemetry``
session (:mod:`~qba_tpu_torch.obs.manifest`), run reports
(:mod:`~qba_tpu_torch.obs.report`), interval statistics for studies
(:mod:`~qba_tpu_torch.obs.stats`), the matplotlib-gated plots
(:mod:`~qba_tpu_torch.obs.plots`) and the ``--profile-dir`` hook on
``torch.profiler`` (:mod:`~qba_tpu_torch.obs.profiling`)."""

from qba_tpu_torch.obs.events import Event, EventLog, Level, stdout_log
from qba_tpu_torch.obs.manifest import (
    collect_manifest,
    load_manifest,
    telemetry_session,
    validate_manifest,
)
from qba_tpu_torch.obs.profiling import profile_trace
from qba_tpu_torch.obs.report import render_sweep, render_verdict
from qba_tpu_torch.obs.telemetry import Span, SpanRecorder
from qba_tpu_torch.obs.timers import PhaseTimers, throughput

__all__ = ["Event", "EventLog", "Level", "PhaseTimers", "Span",
           "SpanRecorder", "collect_manifest", "load_manifest",
           "profile_trace", "render_sweep", "render_verdict", "stdout_log",
           "telemetry_session", "throughput", "validate_manifest"]
