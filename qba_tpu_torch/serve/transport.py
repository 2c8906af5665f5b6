"""Network-free transports for the evaluation service — a copy of
:mod:`qba_tpu.serve.transport` on the port's server, speaking the same
two protocols, so a queue directory or a JSONL stream is served by
either package's worker:

* **jsonl** — one :class:`EvalRequest` JSON object per stdin line, one
  :class:`EvalResult` JSON object per stdout line (completion order),
  run summary on stderr at EOF:
  ``python -m qba_tpu_torch serve --transport jsonl < requests.jsonl``.
* **file-queue** — a queue directory with ``inbox/`` (drop ``*.json``
  request files; the server claims them atomically by rename into
  ``claimed/``), ``outbox/`` (one result file per request, written via
  temp-file + rename so readers never see partial JSON), and a ``stop``
  sentinel file that triggers drain + ``summary.json`` + clean exit.

Both transports keep the stream flowing on bad input: a malformed or
invalid request becomes an error :class:`EvalResult`, never a server
crash.  Batching policy: requests are pumped as they arrive (full
chunks dispatch immediately); a partial chunk is flushed when the
input goes quiet (EOF on jsonl, an empty poll on file-queue), so tail
requests never wait on traffic that isn't coming.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Any, Iterable

from qba_tpu_torch.serve.engine import QBAServer
from qba_tpu_torch.serve.queuefs import (
    FlightRecorder,
    HeartbeatWriter,
    queue_paths,
    request_slug,
    result_path as _result_path_for,
    write_json_atomic,
)
from qba_tpu_torch.serve.request import EvalResult, decode_request_line
from qba_tpu_torch.serve.timing import MAX_RECLAIMS, WORKER_POLL_S

#: Test-only crash hook (the chaos harness's poison-request injector),
#: with the JAX package's name and meaning: when this variable is set, a
#: worker that claims a request whose id contains its value hard-exits
#: mid-claim with :data:`CRASH_HOOK_EXIT`, as a fatal fault would, and
#: leaves its claim for the supervisor to blame.  Unset, the check never
#: runs.
CRASH_HOOK_ENV = "QBA_TEST_CRASH_HOOK"
CRASH_HOOK_EXIT = 113


def _emit_jsonl(out: IO[str], results: Iterable[EvalResult]) -> int:
    n = 0
    for res in results:
        out.write(json.dumps(res.to_json()) + "\n")
        n += 1
    if n:
        out.flush()
    return n


def serve_jsonl(
    server: QBAServer,
    in_stream: IO[str],
    out_stream: IO[str],
    *,
    max_requests: int | None = None,
) -> dict[str, Any]:
    """Drive ``server`` from a JSONL stream until EOF (or
    ``max_requests``); returns the final :meth:`QBAServer.stats`."""
    seen = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        seen += 1
        try:
            req = decode_request_line(line)
            server.submit(req)
        except ValueError as e:
            rid = "<undecoded>"
            try:
                rid = str(json.loads(line).get("request_id", rid))
            except (json.JSONDecodeError, AttributeError):
                pass
            _emit_jsonl(out_stream, [EvalResult.failure(rid, str(e))])
        else:
            _emit_jsonl(out_stream, server.pump())
        if max_requests is not None and seen >= max_requests:
            break
    _emit_jsonl(out_stream, server.flush())
    return server.stats()


# Queue layout + atomicity helpers live in qba_tpu_torch.serve.queuefs,
# which imports no engine.
_write_json = write_json_atomic
_result_path = _result_path_for


def _reclaim_stale(
    paths: dict[str, str],
    attempts: dict[str, int],
    live: set[str],
    timeout_s: float,
    max_reclaims: int,
    emit,
) -> int:
    """Crash recovery for the file-queue claim protocol: a worker that
    died mid-request leaves its claim file in ``claimed/`` with no
    result — this moves such stale claims back to ``inbox/`` so any
    consumer can retry them.

    Bounds (so one poison request can't loop forever): the k-th reclaim
    of a file requires age ``timeout_s * 2**k`` (exponential backoff —
    a request that keeps killing workers is retried at 1x, 2x, 4x...),
    and after ``max_reclaims`` attempts the file is dead-lettered to
    ``dead/`` with a structured error result in the outbox.  ``live``
    names this process's own in-progress claims, which are never stale.

    Age is measured from the claim file's mtime, which every consumer
    re-stamps to the claim instant right after the claim rename (the
    rename alone would preserve the producer's enqueue-time mtime, and
    inbox wait must not count toward claim staleness — N replicas
    share this directory, and a backlogged request older than the
    timeout would otherwise be stolen from its live claimant the
    moment it was claimed).
    """
    reclaimed = 0
    now = time.time()
    try:
        names = sorted(
            n for n in os.listdir(paths["claimed"]) if n.endswith(".json")
        )
    except OSError:
        return 0
    for name in names:
        if name in live:
            continue
        path = os.path.join(paths["claimed"], name)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue  # raced away
        k = attempts.get(name, 0)
        if k >= max_reclaims:
            try:
                # qba-protocol: dead-letter
                os.replace(path, os.path.join(paths["dead"], name))
            except OSError:
                continue
            emit([
                EvalResult.failure(
                    os.path.splitext(name)[0],
                    f"dead-lettered after {k} reclaim attempts without a "
                    "result (every claimant died mid-request)",
                )
            ])
            continue
        if age < timeout_s * (2 ** k):
            continue
        try:
            # qba-protocol: reclaim
            os.replace(path, os.path.join(paths["inbox"], name))
        except OSError:
            continue
        attempts[name] = k + 1
        reclaimed += 1
    return reclaimed


def serve_file_queue(
    server: QBAServer,
    queue_dir: str,
    *,
    poll_s: float = WORKER_POLL_S,
    max_requests: int | None = None,
    reclaim_timeout_s: float | None = None,
    max_reclaims: int = MAX_RECLAIMS,
) -> dict[str, Any]:
    """Drive ``server`` from ``queue_dir`` until the ``stop`` sentinel
    appears (or ``max_requests`` requests have been consumed); returns
    the final stats (also written to ``summary.json``).

    Claim lifecycle: ``inbox/ -> claimed/`` (atomic rename at claim)
    ``-> done/`` once the request's result lands in the outbox.  With
    ``reclaim_timeout_s`` set, claims older than the (exponentially
    backed-off) timeout that belong to no live consumer are pushed back
    to the inbox — crash recovery for a worker killed mid-request —
    with at most ``max_reclaims`` retries before dead-lettering
    (:func:`_reclaim_stale`)."""
    paths = queue_paths(queue_dir)
    for key in ("inbox", "claimed", "done", "dead", "outbox"):
        os.makedirs(paths[key], exist_ok=True)

    # request_id -> this process's claim file awaiting its result.
    claim_of: dict[str, str] = {}
    reclaim_attempts: dict[str, int] = {}
    reclaimed_total = 0

    # Fleet workers (replica_id set) heartbeat their lifecycle phase at
    # every transition so the supervisor can tell busy from hung and
    # blame a crash on the in-flight request (docs/SERVING.md
    # "Self-healing").  The writer lives in queuefs and also
    # rides along on the server for the dispatch/readback phases.
    hb = None
    flight = None
    if server.replica_id is not None:
        hb = HeartbeatWriter(queue_dir, server.replica_id)
        server.heartbeat = hb
        hb.beat("idle")
        # The flight recorder rides beside the heartbeat: a bounded
        # ring of recent lifecycle events, flushed atomically on every
        # note, so a worker that dies without warning (SIGKILL, a
        # fatal fault) leaves its last moments on disk for the
        # supervisor's crash report.
        flight = FlightRecorder(queue_dir, server.replica_id)
        server.flight = flight
        flight.note("boot", queue_dir=queue_dir)
    crash_token = os.environ.get(CRASH_HOOK_ENV)

    def settle(name: str) -> None:
        try:
            # qba-protocol: settle
            os.replace(
                os.path.join(paths["claimed"], name),
                os.path.join(paths["done"], name),
            )
        except OSError:
            pass  # already moved (e.g. reclaimed by a peer); result wins

    def emit(results: Iterable[EvalResult]) -> None:
        for res in results:
            _write_json(_result_path(paths["outbox"], res.request_id), res.to_json())
            if flight is not None:
                flight.note(
                    "emit", request_id=res.request_id,
                    trace_id=res.trace_id,
                    outcome="error" if res.error else "ok",
                )
            name = claim_of.pop(res.request_id, None)
            if name is not None:
                settle(name)

    seen = 0
    try:
        while True:
            if reclaim_timeout_s is not None:
                round_reclaimed = _reclaim_stale(
                    paths, reclaim_attempts, set(claim_of.values()),
                    reclaim_timeout_s, max_reclaims, emit,
                )
                reclaimed_total += round_reclaimed
                if round_reclaimed and flight is not None:
                    flight.note("reclaim", count=round_reclaimed)
            names = sorted(
                n for n in os.listdir(paths["inbox"]) if n.endswith(".json")
            )
            # Work-sharing watermark: one pipeline-full of queued trials
            # per consumer.  Past it, serve what we hold before claiming
            # more — the flush window is when peer replicas sharing this
            # queue dir claim the rest of the inbox.  A lone consumer
            # still drains everything, a watermark's worth at a time.
            prefetch = max(1, server.depth) * server.scheduler.chunk_trials
            for name in names:
                if server.backlog_trials >= prefetch:
                    emit(server.flush())
                claimed = os.path.join(paths["claimed"], name)
                try:
                    # qba-protocol: claim
                    os.replace(os.path.join(paths["inbox"], name), claimed)
                except OSError:
                    continue  # another consumer claimed it
                seen += 1
                # The request file's mtime is its enqueue time
                # (producers write via temp + rename, and the rename
                # into claimed/ preserves it) — so claim time minus
                # mtime IS the queue wait, attributed separately from
                # device time on the result.  Capture it, then stamp
                # claim time onto the file: peers judge claim
                # staleness by this same mtime, and without the
                # re-stamp a request that waited longer than the
                # reclaim timeout in the inbox would look stale the
                # instant it was claimed and be stolen from its live
                # claimant (re-executed, then dead-lettered).
                claim_t = time.time()
                try:
                    queue_wait = max(
                        0.0, claim_t - os.path.getmtime(claimed)
                    )
                except OSError:
                    queue_wait = None
                try:
                    # qba-protocol: restamp
                    os.utime(claimed, (claim_t, claim_t))
                except OSError:
                    pass  # raced away; the eventual result still wins
                # The claim-phase heartbeat names the file slug BEFORE
                # decode: if this worker dies anywhere past this point
                # (decode, submit, dispatch), the supervisor knows
                # which request to blame.
                if hb is not None:
                    hb.beat("claim", [os.path.splitext(name)[0]])
                if flight is not None:
                    flight.note(
                        "claim", request_slug=os.path.splitext(name)[0],
                        queue_wait_s=queue_wait,
                    )
                try:
                    with open(claimed) as f:
                        req = decode_request_line(f.read())
                    if crash_token and crash_token in req.request_id:
                        # Test-only poison hook: die like a fatal fault
                        # would, with no cleanup and no result, the claim
                        # left in claimed/ for the supervisor to blame.
                        os._exit(CRASH_HOOK_EXIT)
                    server.submit(req, queue_wait_s=queue_wait)
                except ValueError as e:
                    emit([EvalResult.failure(os.path.splitext(name)[0], str(e))])
                    settle(name)
                else:
                    claim_of[req.request_id] = name
                    emit(server.pump())
                if max_requests is not None and seen >= max_requests:
                    emit(server.flush())
                    return _finish(server, paths, reclaimed_total)
            if os.path.exists(paths["stop"]):
                emit(server.flush())
                return _finish(server, paths, reclaimed_total)
            if not names:
                # Quiet inbox: flush stragglers in partial chunks so a
                # lone request is never stuck behind an unfilled chunk.
                if server.busy:
                    emit(server.flush())
                if hb is not None:
                    hb.beat("idle")
                time.sleep(poll_s)
    finally:
        emit(server.flush())


def _finish(
    server: QBAServer, paths: dict[str, str], reclaimed: int = 0
) -> dict[str, Any]:
    stats = server.stats()
    stats["reclaimed"] = reclaimed
    path = paths["summary"]
    if server.replica_id is not None:
        # One summary file per replica: N pool workers sharing a queue
        # directory must not clobber each other's exit summaries —
        # fleet_summary() aggregates the per-replica files.
        path = os.path.join(
            os.path.dirname(path),
            f"summary-{request_slug(server.replica_id)}.json",
        )
    _write_json(path, stats)
    return stats
