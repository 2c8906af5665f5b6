"""Fleet observability: cross-replica aggregation into one summary — a
copy of :mod:`qba_tpu.serve.fleet.summary`, writing the same
``fleet_summary.json``.

Per-request attribution already exists: every result carries
``replica_id``, ``queue_wait_s`` and ``latency_s`` (its ``request``
span's duration), and every replica writes a ``summary-<id>.json`` at
exit.  This module merges those per-process artifacts into
``fleet_summary.json``:

* per-replica request counts and p50/p99 latency (from the replicas'
  own span-derived summaries),
* fleet-wide p50/p99 latency and queue-wait distributions recomputed
  from the outbox results: the numbers a client experienced,
* admission decision counts (from the front end's controller), and
* totals: completed/errored/reclaimed/expired and aggregate req/min.

Span *files* merge via :func:`qba_tpu_torch.obs.telemetry.
spans_from_jsonl` when a telemetry dir is given, so Perfetto can show
the whole fleet on one timeline.  Opens no device.
"""

from __future__ import annotations

import json
import os
from typing import Any

from qba_tpu_torch.obs.telemetry import span_latency_summary, spans_from_jsonl
from qba_tpu_torch.obs.tracing import stitch_traces, trace_summary
from qba_tpu_torch.serve.queuefs import queue_paths, write_json_atomic

FLEET_SUMMARY_SCHEMA = "qba-tpu/fleet-summary/v1"


def _load_results(outbox: str, consumed: str | None = None) -> list[dict[str, Any]]:
    """All result payloads for one fleet run.  The front-end moves a
    result from ``outbox/`` to ``consumed/`` once it is forwarded to
    its caller, so both directories together are the run's results;
    on a filename collision (a request id reused over a live queue
    dir) the outbox copy — the newer, not-yet-forwarded one — wins."""
    by_name: dict[str, dict[str, Any]] = {}
    for directory in (consumed, outbox):
        if directory is None:
            continue
        try:
            names = sorted(os.listdir(directory))
        except OSError:
            continue
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(directory, name)) as f:
                    by_name[name] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
    return [by_name[name] for name in sorted(by_name)]


def _replica_summaries(queue_dir: str) -> dict[str, dict[str, Any]]:
    out: dict[str, dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(queue_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("summary-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(queue_dir, name)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        rid = payload.get("replica_id") or name[len("summary-"):-len(".json")]
        out[str(rid)] = payload
    return out


class _DurSpan:
    """Minimal span stand-in feeding span_latency_summary from result
    latencies (the result's latency_s IS its request-span duration)."""

    __slots__ = ("name", "dur")

    def __init__(self, name: str, dur: float):
        self.name = name
        self.dur = dur


def _distribution(name: str, durs: list[float]) -> dict[str, Any]:
    return span_latency_summary([_DurSpan(name, d) for d in durs], name)


def merge_fleet_spans(telemetry_dir: str) -> list:
    """Every span from every per-request ``spans.jsonl`` under the
    fleet telemetry dir, on one list — the cross-process merge (each
    request span already carries its ``replica_id`` arg)."""
    spans = []
    try:
        entries = sorted(os.listdir(telemetry_dir))
    except OSError:
        return spans
    for entry in entries:
        path = os.path.join(telemetry_dir, entry, "spans.jsonl")
        if os.path.isfile(path):
            spans.extend(spans_from_jsonl(path))
    return spans


def fleet_summary(
    queue_dir: str,
    *,
    admission_summary: dict[str, Any] | None = None,
    frontend_status: dict[str, Any] | None = None,
    elapsed_s: float | None = None,
    telemetry_dir: str | None = None,
    self_healing: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Aggregate one fleet run's artifacts into a summary dict.

    ``self_healing`` is the supervisor's totals
    (:meth:`~qba_tpu_torch.serve.fleet.supervisor.FleetSupervisor.summary`);
    independent of it, quarantined poison requests are totalled from
    their crash-report results and the on-disk crash ledger, so the
    summary stays truthful even for a run whose supervisor died."""
    paths = queue_paths(queue_dir)
    results = _load_results(paths["outbox"], paths["consumed"])
    ok = [r for r in results if not r.get("error")]
    per_replica: dict[str, dict[str, Any]] = {}
    for r in ok:
        rid = str(r.get("replica_id"))
        slot = per_replica.setdefault(
            rid, {"completed": 0, "latencies": [], "queue_waits": []}
        )
        slot["completed"] += 1
        if r.get("latency_s") is not None:
            slot["latencies"].append(float(r["latency_s"]))
        if r.get("queue_wait_s") is not None:
            slot["queue_waits"].append(float(r["queue_wait_s"]))
    replicas: dict[str, dict[str, Any]] = {}
    for rid, slot in sorted(per_replica.items()):
        replicas[rid] = {
            "completed": slot["completed"],
            "latency": _distribution("request", slot["latencies"]),
            "queue_wait": _distribution("queue_wait", slot["queue_waits"]),
        }
    exit_summaries = _replica_summaries(queue_dir)
    for rid, payload in exit_summaries.items():
        replicas.setdefault(rid, {})["exit_summary"] = {
            k: payload.get(k)
            for k in ("completed", "expired", "reclaimed", "restored_plans",
                      "latency", "queue_wait")
        }
    summary: dict[str, Any] = {
        "schema": FLEET_SUMMARY_SCHEMA,
        "results": len(results),
        "completed": len(ok),
        "errored": len(results) - len(ok),
        "replicas": replicas,
        "latency": _distribution(
            "request",
            [float(r["latency_s"]) for r in ok if r.get("latency_s") is not None],
        ),
        "queue_wait": _distribution(
            "queue_wait",
            [
                float(r["queue_wait_s"])
                for r in ok
                if r.get("queue_wait_s") is not None
            ],
        ),
        "reclaimed": sum(
            int(p.get("reclaimed") or 0) for p in exit_summaries.values()
        ),
        "expired": sum(
            int(p.get("expired") or 0) for p in exit_summaries.values()
        ),
    }
    # Poison-quarantine totals: every dead-lettered request's
    # structured crash report, keyed by request id.
    crash_reports = {
        str(r.get("request_id")): r["crash_report"]
        for r in results
        if r.get("crash_report")
    }
    summary["quarantined"] = len(crash_reports)
    if crash_reports:
        summary["crash_reports"] = crash_reports
    try:
        with open(paths["crash_ledger"]) as f:
            ledger = json.load(f)
    except (OSError, json.JSONDecodeError):
        ledger = None
    if ledger is not None:
        summary["crash_ledger"] = {
            "blamed_requests": len(ledger.get("blame") or {}),
            "quarantined": len(ledger.get("quarantined") or {}),
            "deaths": len(ledger.get("deaths") or []),
            "hung_killed": len(ledger.get("hung_killed") or []),
            "benched": [
                e.get("replica_id")
                for e in (ledger.get("bench_events") or [])
            ],
        }
    if elapsed_s is not None and elapsed_s > 0:
        summary["elapsed_s"] = elapsed_s
        summary["requests_per_min"] = len(ok) / elapsed_s * 60.0
    if admission_summary is not None:
        summary["admission"] = admission_summary
    if frontend_status is not None:
        summary["frontend"] = frontend_status
    if self_healing is not None:
        summary["self_healing"] = self_healing
    if telemetry_dir is not None:
        merged = merge_fleet_spans(telemetry_dir)
        summary["spans"] = {
            "count": len(merged),
            "request": span_latency_summary(merged, "request"),
        }
    # Stitched-trace satellite: one causally-ordered trace per request
    # (intake -> settle) with an orphan-span count that a healthy run
    # must hold at zero, plus span-coverage percentiles.
    stitched = stitch_traces(queue_dir, telemetry_dir=telemetry_dir)
    if stitched["traces"] or stitched["orphan_spans"]:
        summary["traces"] = trace_summary(stitched)
    return summary


def write_fleet_summary(queue_dir: str, summary: dict[str, Any]) -> str:
    path = os.path.join(queue_dir, "fleet_summary.json")
    write_json_atomic(path, summary)
    return path
