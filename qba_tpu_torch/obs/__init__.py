"""Observability for the port — counterpart of the parts of
:mod:`qba_tpu.obs` the sweeps use: the structured event log
(:mod:`~qba_tpu_torch.obs.events`), spans
(:mod:`~qba_tpu_torch.obs.telemetry`) and the phase timers over them
(:mod:`~qba_tpu_torch.obs.timers`)."""

from qba_tpu_torch.obs.events import Event, EventLog, Level, stdout_log
from qba_tpu_torch.obs.telemetry import Span, SpanRecorder
from qba_tpu_torch.obs.timers import PhaseTimers, throughput

__all__ = ["Event", "EventLog", "Level", "PhaseTimers", "Span",
           "SpanRecorder", "stdout_log", "throughput"]
