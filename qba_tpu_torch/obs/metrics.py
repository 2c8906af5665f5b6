"""Live fleet metrics — a copy of :mod:`qba_tpu.obs.metrics`: one
registered name table (:data:`METRICS`), three instrument kinds (counter,
gauge, histogram) and a renderer of the Prometheus text format with
OpenMetrics-style ``# {...}`` exemplars carrying trace ids.  The names,
labels and text are the JAX package's, so one scraper reads either
package's front end.

* **One name table.** Every emission names a key of :data:`METRICS`;
  the registry raises on anything else.
* **No new sockets.** Point-in-time facts (queue depth, heartbeat
  staleness, crash-ledger totals) are *collected* from the queue
  directory at scrape time via :meth:`MetricsRegistry.add_collector`;
  workers never push: the heartbeat and summary files they already
  write are the transport.

The front end serves ``GET /metrics`` from this module; it imports
neither torch nor any engine.
"""

from __future__ import annotations

import math
import threading

__all__ = [
    "METRICS",
    "MetricsRegistry",
    "default_buckets",
    "validate_exposition",
]

# The single registered metric-name table.  name -> (kind, help text,
# allowed label keys).  Adding a metric means adding a row here first;
# emitting an unregistered name raises.
METRICS: dict[str, tuple[str, str, tuple[str, ...]]] = {
    "qba_intake_requests_total": (
        "counter", "Requests received at the fleet frontend.", ()),
    "qba_admission_decisions_total": (
        "counter", "Admission decisions by action and typed reason.",
        ("action", "reason")),
    "qba_results_forwarded_total": (
        "counter", "Results settled back to clients, by outcome.",
        ("outcome",)),
    "qba_request_latency_seconds": (
        "histogram", "Worker-reported request latency.", ()),
    "qba_request_queue_wait_seconds": (
        "histogram", "Queue wait from producer mtime to claim.", ()),
    "qba_queue_files": (
        "gauge", "Files per queue box (inbox/claimed/outbox/dead/...).",
        ("box",)),
    "qba_queue_reclaims": (
        "gauge", "Stale-claim reclaims summed over replica exit "
        "summaries and the crash ledger.", ()),
    "qba_queue_dead_letters": (
        "gauge", "Dead-lettered requests currently in dead/.", ()),
    "qba_replica_heartbeat_staleness_seconds": (
        "gauge", "Monotonic now minus last heartbeat, per replica.",
        ("replica",)),
    "qba_fleet_replicas": (
        "gauge", "Replicas per supervisor health class.", ("state",)),
    "qba_supervisor_deaths": (
        "gauge", "Worker deaths recorded in the crash ledger.", ()),
    "qba_supervisor_quarantined": (
        "gauge", "Requests quarantined as poison.", ()),
    "qba_atlas_cells_total": (
        "counter", "Atlas campaign cell outcomes by status.",
        ("status",)),
    "qba_atlas_budget_trials_total": (
        "counter", "Trials of budget spent by atlas campaigns.", ()),
}

_KINDS = ("counter", "gauge", "histogram")


def default_buckets() -> tuple[float, ...]:
    """Latency-shaped histogram buckets (seconds)."""
    return (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
            30.0, 60.0)


def _check_labels(name: str, labels: dict[str, str] | None) -> tuple:
    kind, _, allowed = METRICS[name]
    labels = labels or {}
    if set(labels) != set(allowed):
        raise ValueError(
            f"metric {name} takes labels {sorted(allowed)}, "
            f"got {sorted(labels)}"
        )
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class MetricsRegistry:
    """Counters, gauges and histograms over the registered name table.

    Thread-safe (the frontend's asyncio loop, the supervisor thread and
    scrape-time collectors may all touch it).  Exemplar trace ids are
    kept per series — the most recent one wins — and rendered in
    OpenMetrics ``# {trace_id="..."} value`` form.
    """

    def __init__(self, buckets: tuple[float, ...] | None = None):
        self._lock = threading.Lock()
        self._buckets = tuple(buckets or default_buckets())
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        # (name, labelkey) -> [bucket counts..., +Inf count, sum]
        self._hists: dict[tuple, list[float]] = {}
        self._exemplars: dict[tuple, tuple[str, float]] = {}
        self._collectors: list = []

    # -- registration guard ------------------------------------------

    @staticmethod
    def _require(name: str, kind: str) -> None:
        row = METRICS.get(name)
        if row is None:
            raise ValueError(f"unregistered metric name: {name!r} "
                             "(add it to qba_tpu_torch.obs.metrics.METRICS)")
        if row[0] != kind:
            raise ValueError(f"metric {name} is a {row[0]}, not a {kind}")

    # -- instruments -------------------------------------------------

    def inc(self, name: str, value: float = 1.0, *,
            labels: dict[str, str] | None = None,
            exemplar: str | None = None) -> None:
        self._require(name, "counter")
        key = (name, _check_labels(name, labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value
            if exemplar:
                self._exemplars[key] = (exemplar, value)

    def set_gauge(self, name: str, value: float, *,
                  labels: dict[str, str] | None = None) -> None:
        self._require(name, "gauge")
        key = (name, _check_labels(name, labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, *,
                labels: dict[str, str] | None = None,
                exemplar: str | None = None) -> None:
        self._require(name, "histogram")
        key = (name, _check_labels(name, labels))
        with self._lock:
            row = self._hists.setdefault(
                key, [0.0] * (len(self._buckets) + 2))
            for i, edge in enumerate(self._buckets):
                if value <= edge:
                    row[i] += 1
            row[len(self._buckets)] += 1  # +Inf / _count
            row[len(self._buckets) + 1] += value  # _sum
            if exemplar:
                self._exemplars[key] = (exemplar, value)

    # -- scrape-time collection --------------------------------------

    def add_collector(self, fn) -> None:
        """Register ``fn(registry)`` to run at the top of each render.

        Collectors set point-in-time gauges (queue depth, heartbeat
        staleness) so scrapes always reflect the on-disk now rather
        than the last push.
        """
        self._collectors.append(fn)

    # -- exposition --------------------------------------------------

    def render(self) -> str:
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:  # a sick collector must not kill /metrics
                pass
        lines: list[str] = []
        with self._lock:
            for name in sorted(METRICS):
                kind, help_text, _ = METRICS[name]
                series = self._series_for(name)
                if not series:
                    continue
                lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
                lines.extend(series)
        return "\n".join(lines) + "\n" if lines else "\n"

    def _series_for(self, name: str) -> list[str]:
        kind = METRICS[name][0]
        out: list[str] = []
        if kind == "counter":
            store = self._counters
        elif kind == "gauge":
            store = self._gauges
        else:
            store = self._hists
        for (nm, labelkey), val in sorted(store.items()):
            if nm != name:
                continue
            if kind in ("counter", "gauge"):
                line = f"{name}{_label_str(labelkey)} {_fmt(val)}"
                out.append(self._with_exemplar(line, (nm, labelkey),
                                               kind == "counter"))
            else:
                base = dict(labelkey)
                cum = 0.0
                for i, edge in enumerate(self._buckets):
                    cum = val[i]
                    lk = tuple(sorted(
                        {**base, "le": _fmt(edge)}.items()))
                    out.append(f"{name}_bucket{_label_str(lk)} "
                               f"{_fmt(cum)}")
                lk = tuple(sorted({**base, "le": "+Inf"}.items()))
                count = val[len(self._buckets)]
                line = f"{name}_bucket{_label_str(lk)} {_fmt(count)}"
                out.append(self._with_exemplar(line, (nm, labelkey),
                                               True))
                out.append(f"{name}_sum{_label_str(labelkey)} "
                           f"{_fmt(val[len(self._buckets) + 1])}")
                out.append(f"{name}_count{_label_str(labelkey)} "
                           f"{_fmt(count)}")
        return out

    def _with_exemplar(self, line: str, key: tuple,
                       allowed: bool) -> str:
        ex = self._exemplars.get(key)
        if not (allowed and ex):
            return line
        trace_id, value = ex
        return f'{line} # {{trace_id="{_escape(trace_id)}"}} {_fmt(value)}'

    # -- snapshots (tests, summaries) --------------------------------

    def counter_value(self, name: str,
                      labels: dict[str, str] | None = None) -> float:
        self._require(name, "counter")
        key = (name, _check_labels(name, labels))
        with self._lock:
            return self._counters.get(key, 0.0)


def validate_exposition(text: str) -> list[str]:
    """Check Prometheus-text well-formedness; return problems found.

    An empty return means the exposition parsed clean (the tests and
    ``chip_smoke.py`` read a live ``GET /metrics`` scrape through it).
    """
    problems: list[str] = []
    typed: dict[str, str] = {}
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[3] not in _KINDS:
                problems.append(f"line {i}: malformed TYPE: {line!r}")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            problems.append(f"line {i}: unknown comment: {line!r}")
            continue
        sample, _, exemplar = line.partition(" # ")
        if exemplar and not exemplar.startswith("{"):
            problems.append(f"line {i}: malformed exemplar: {line!r}")
        name = sample.split("{", 1)[0].split(" ", 1)[0]
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
        if base not in typed:
            problems.append(f"line {i}: sample before TYPE: {name}")
        if base not in METRICS:
            problems.append(f"line {i}: unregistered metric: {base}")
        fields = sample.rsplit(" ", 1)
        if len(fields) != 2:
            problems.append(f"line {i}: no value: {line!r}")
            continue
        value = fields[1]
        if value != "+Inf":
            try:
                float(value)
            except ValueError:
                problems.append(f"line {i}: bad value {value!r}")
    return problems
