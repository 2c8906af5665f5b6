"""Cross-process causal tracing: one stitched trace per fleet request — a
copy of :mod:`qba_tpu.obs.tracing`, reading and writing the same
``trace-events.jsonl`` lines and span files.

A request's life crosses process boundaries (front-end intake,
admission, the file queue, a worker, sometimes the supervisor, settle)
and each hop keeps time on its own clock:

* **Identity travels with the trace**: :func:`mint_trace_id` runs at
  the request's origin (the front end's ``_intake``, the atlas
  campaign's ``_stamp_trace``), the id rides the queue-file JSON as
  ``EvalRequest.trace_id``, the worker's root span *adopts* it, and the
  supervisor's lifecycle events stamp it.
* **Wall-clock anchoring**: :class:`~qba_tpu_torch.obs.telemetry.
  SpanRecorder` timestamps are ``perf_counter`` seconds, meaningless
  across processes.  The worker stamps ``t0_epoch`` (``time.time()`` at
  submit) into the root span's args; the stitcher shifts each span file
  onto the epoch axis by ``t0_epoch - root.t0``.
* **No dark time**: the queue wait is *synthesized* from the measured
  ``queue_wait_s`` as a span ending at the worker's anchor, and the
  settle-side wait (the result sitting in ``outbox/`` until the front
  end forwards it) from the worker's end and the settle event, so the
  union of child spans covers the root.

Standard library only: the front end imports it and opens no device.
"""

from __future__ import annotations

import json
import os
import time
import uuid

from .telemetry import Span, _percentile, spans_from_jsonl

__all__ = [
    "TRACE_CONTEXT_SCHEMA",
    "TRACE_EVENTS_NAME",
    "TraceEventLog",
    "mint_span_id",
    "mint_trace_id",
    "read_trace_events",
    "stitch_traces",
    "stitched_chrome_trace",
    "trace_summary",
]

TRACE_CONTEXT_SCHEMA = "qba-tpu/trace-context/v1"
TRACE_EVENTS_NAME = "trace-events.jsonl"

# Mirrors qba_tpu_torch.serve.engine.REQUEST_SPAN without importing the
# engine (torch) into the front end.
ROOT_SPAN_NAME = "request"

# Lifecycle events a stitched trace understands.  "settle" closes the
# trace; supervisor events render as instants on the lifecycle track.
LIFECYCLE_EVENTS = (
    "intake", "admit", "defer", "reject", "settle",
    "kill", "death", "release", "quarantine",
)


def mint_trace_id() -> str:
    """Mint a fresh trace id.

    Called only where a request originates: everything downstream of
    intake must adopt the id riding the queue file, or its spans can
    never stitch back to the request.
    """
    return uuid.uuid4().hex


def mint_span_id() -> str:
    """A short span id for the intake span (the worker root's parent)."""
    return uuid.uuid4().hex[:16]


# ---------------------------------------------------------------------------
# event log: append-only JSONL beside the queue boxes


class TraceEventLog:
    """Append-only lifecycle event log in the fleet queue directory.

    One line per event, O_APPEND semantics: the frontend and the
    supervisor (threads or processes) interleave whole lines safely.
    Events are wall-clock (``time.time()``) — the same axis the
    stitcher anchors worker spans onto.
    """

    def __init__(self, queue_dir: str):
        self.path = os.path.join(queue_dir, TRACE_EVENTS_NAME)

    def emit(self, event: str, trace_id: str | None,
             request_id: str | None, **fields) -> dict:
        rec = {
            "schema": TRACE_CONTEXT_SCHEMA,
            "event": event,
            "trace_id": trace_id,
            "request_id": request_id,
            "t": time.time(),
        }
        rec.update(fields)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec


def read_trace_events(queue_dir: str) -> list[dict]:
    """All lifecycle events, in emission order; malformed lines skipped."""
    path = os.path.join(queue_dir, TRACE_EVENTS_NAME)
    events: list[dict] = []
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError:
        return events
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and rec.get("event"):
            events.append(rec)
    return events


# ---------------------------------------------------------------------------
# stitching


def _worker_segments(telemetry_dir: str | None):
    """Yield (trace_id | None, segment) per exported spans.jsonl.

    A segment is the one worker-side execution of a request: its spans
    shifted onto the epoch axis via the root's ``t0_epoch`` anchor.
    Files without a root span or without an anchor yield trace_id None
    — the caller counts their spans as orphans.
    """
    if not telemetry_dir or not os.path.isdir(telemetry_dir):
        return
    for entry in sorted(os.listdir(telemetry_dir)):
        path = os.path.join(telemetry_dir, entry, "spans.jsonl")
        spans = spans_from_jsonl(path)
        if not spans:
            continue
        root = next(
            (s for s in spans
             if s.name == ROOT_SPAN_NAME and s.parent is None), None)
        anchor = (root.args.get("t0_epoch")
                  if root is not None else None)
        trace_id = (root.args.get("trace_id")
                    if root is not None else None)
        if root is None or anchor is None or root.dur is None:
            yield None, {"entry": entry, "spans": spans}
            continue
        offset = float(anchor) - root.t0
        shifted = [
            Span(name=s.name, index=s.index, parent=s.parent,
                 depth=s.depth, t0=s.t0 + offset, dur=s.dur,
                 cat=s.cat, fenced=s.fenced, args=s.args)
            for s in spans if s.dur is not None
        ]
        yield trace_id, {
            "entry": entry,
            "spans": shifted,
            "root_t0": root.t0 + offset,
            "root_end": root.t0 + offset + root.dur,
            "replica_id": root.args.get("replica_id"),
            "queue_wait_s": root.args.get("queue_wait_s"),
            "request_id": root.args.get("request_id"),
        }


def _union_length(intervals: list[tuple[float, float]]) -> float:
    total = 0.0
    end = -float("inf")
    for lo, hi in sorted(intervals):
        if hi <= end:
            continue
        total += hi - max(lo, end)
        end = hi
    return total


def stitch_traces(queue_dir: str,
                  telemetry_dir: str | None = None) -> dict:
    """Stitch lifecycle events + worker span files into causal traces.

    Returns ``{"traces": {trace_id: trace}, "orphan_spans": int}``.
    Each trace holds wall-clock ``spans`` (dicts: name/t0/dur/track/
    args), instant ``events``, ``closed`` (a settle event exists), and
    ``coverage`` (union of child spans over the root interval) when
    computable.  Orphans are worker spans that cannot be attributed to
    any intaken request — the fleet-summary ``traces`` block asserts
    this count is zero.
    """
    events = read_trace_events(queue_dir)
    by_trace: dict[str, list[dict]] = {}
    for ev in events:
        tid = ev.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(ev)

    segments: dict[str, list[dict]] = {}
    orphan_spans = 0
    for tid, seg in _worker_segments(telemetry_dir):
        if tid is None or tid not in by_trace:
            orphan_spans += len(seg["spans"])
            continue
        segments.setdefault(tid, []).append(seg)

    traces: dict[str, dict] = {}
    for tid, evs in by_trace.items():
        evs = sorted(evs, key=lambda e: e.get("t", 0.0))
        intake = next((e for e in evs if e["event"] == "intake"), None)
        settle = next((e for e in evs if e["event"] == "settle"), None)
        segs = sorted(segments.get(tid, []),
                      key=lambda s: s["root_t0"])
        request_id = (intake or (evs and evs[0]) or {}).get("request_id")
        t_in = intake["t"] if intake else (
            segs[0]["root_t0"] if segs else evs[0]["t"])
        ends = [e["t"] for e in evs] + [s["root_end"] for s in segs]
        t_out = settle["t"] if settle else max(ends)
        t_out = max(t_out, t_in)

        spans: list[dict] = [{
            "name": ROOT_SPAN_NAME, "t0": t_in,
            "dur": t_out - t_in, "track": "lifecycle",
            "args": {"trace_id": tid, "request_id": request_id},
        }]
        children: list[tuple[float, float]] = []

        decision = next(
            (e for e in evs if e["event"] in ("admit", "defer", "reject")),
            None)
        if intake and decision and decision["t"] >= intake["t"]:
            spans.append({
                "name": "frontend.admission", "t0": intake["t"],
                "dur": decision["t"] - intake["t"],
                "track": "lifecycle",
                "args": {k: decision.get(k)
                         for k in ("event", "reason") if k in decision},
            })
            children.append((intake["t"], decision["t"]))

        for seg in segs:
            track = seg.get("replica_id") or seg["entry"]
            qw = seg.get("queue_wait_s")
            if qw is not None:
                spans.append({
                    "name": "queue.wait",
                    "t0": seg["root_t0"] - float(qw),
                    "dur": float(qw), "track": "lifecycle",
                    "args": {"queue_wait_s": qw},
                })
                children.append(
                    (seg["root_t0"] - float(qw), seg["root_t0"]))
            for s in seg["spans"]:
                spans.append({
                    "name": s.name, "t0": s.t0, "dur": s.dur,
                    "track": track, "depth": s.depth, "cat": s.cat,
                    "args": s.args,
                })
            children.append((seg["root_t0"], seg["root_end"]))

        if segs and settle and settle["t"] > segs[-1]["root_end"]:
            spans.append({
                "name": "queue.result_wait",
                "t0": segs[-1]["root_end"],
                "dur": settle["t"] - segs[-1]["root_end"],
                "track": "lifecycle", "args": {},
            })
            children.append((segs[-1]["root_end"], settle["t"]))

        coverage = None
        if t_out > t_in and children:
            clipped = [(max(lo, t_in), min(hi, t_out))
                       for lo, hi in children
                       if min(hi, t_out) > max(lo, t_in)]
            coverage = _union_length(clipped) / (t_out - t_in)

        traces[tid] = {
            "trace_id": tid,
            "request_id": request_id,
            "t0": t_in,
            "dur": t_out - t_in,
            "closed": settle is not None,
            "coverage": coverage,
            "spans": spans,
            "events": evs,
            "segments": len(segs),
        }
    return {"traces": traces, "orphan_spans": orphan_spans}


def trace_summary(stitched: dict) -> dict:
    """The fleet-summary ``traces`` block, from stitched traces."""
    traces = stitched["traces"]
    coverages = sorted(
        t["coverage"] for t in traces.values()
        if t["coverage"] is not None)
    block = {
        "count": len(traces),
        "closed": sum(1 for t in traces.values() if t["closed"]),
        "open": sum(1 for t in traces.values() if not t["closed"]),
        "orphan_spans": stitched["orphan_spans"],
        "coverage": None,
    }
    if coverages:
        block["coverage"] = {
            "count": len(coverages),
            "p50": _percentile(coverages, 50.0),
            "p99": _percentile(coverages, 99.0),
            "min": coverages[0],
        }
    return block


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event export


def stitched_chrome_trace(stitched: dict,
                          trace_ids: list[str] | None = None) -> dict:
    """Chrome trace-event JSON for Perfetto: one process per trace,
    one thread per track (lifecycle + each worker segment), instant
    events for supervisor lifecycle stamps."""
    events: list[dict] = []
    traces = stitched["traces"]
    ids = trace_ids if trace_ids is not None else sorted(traces)
    for pid, tid in enumerate(ids, start=1):
        trace = traces[tid]
        label = trace.get("request_id") or tid
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"request {label} [{tid[:8]}]"},
        })
        tracks: dict[str, int] = {}

        def _tid(track: str, tracks=tracks, pid=pid,
                 events=events) -> int:
            if track not in tracks:
                tracks[track] = len(tracks)
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tracks[track], "args": {"name": track},
                })
            return tracks[track]

        for span in trace["spans"]:
            events.append({
                "ph": "X", "name": span["name"],
                "cat": span.get("cat", "lifecycle"),
                "pid": pid, "tid": _tid(span["track"]),
                "ts": round(span["t0"] * 1e6, 3),
                "dur": round(max(span["dur"], 0.0) * 1e6, 3),
                "args": span.get("args", {}),
            })
        for ev in trace["events"]:
            events.append({
                "ph": "i", "s": "p", "name": f"fleet.{ev['event']}",
                "cat": "lifecycle", "pid": pid, "tid": _tid("lifecycle"),
                "ts": round(ev["t"] * 1e6, 3),
                "args": {k: v for k, v in ev.items()
                         if k not in ("t", "schema")},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
