"""File-queue layout, atomic writes, heartbeats and the flight recorder —
a copy of :mod:`qba_tpu.serve.queuefs`, so both packages' workers and
the JAX package's fleet front-end read and write one on-disk protocol.

Requests are dropped into ``inbox/`` and claimed by atomic rename into
``claimed/``, results land in ``outbox/`` via temp-file + rename, and a
``stop`` sentinel triggers drain.  The atlas store and the sweep
checkpoints use :func:`write_json_atomic` and :func:`request_slug` too.
This module imports no engine and no torch.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any

from qba_tpu_torch.serve.timing import IDLE_REBEAT_S


def queue_paths(queue_dir: str) -> dict[str, str]:
    return {
        "inbox": os.path.join(queue_dir, "inbox"),
        "claimed": os.path.join(queue_dir, "claimed"),
        "done": os.path.join(queue_dir, "done"),
        "dead": os.path.join(queue_dir, "dead"),
        "outbox": os.path.join(queue_dir, "outbox"),
        "consumed": os.path.join(queue_dir, "consumed"),
        "stop": os.path.join(queue_dir, "stop"),
        "summary": os.path.join(queue_dir, "summary.json"),
        "crash_ledger": os.path.join(queue_dir, "crash_ledger.json"),
    }


def write_json_atomic(path: str, payload: dict[str, Any]) -> None:
    """Temp-file + rename: a concurrent reader sees the old file or the
    new one, never a partial write.  The temp name is writer-unique so
    concurrent writers of the same path don't interleave into one temp
    file before their renames."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    # qba-protocol: publish
    os.replace(tmp, path)


#: Longest id that may map to itself; longer ones are truncated and
#: hash-suffixed so two ids differing only past this point still get
#: distinct (and filesystem-legal, NAME_MAX-safe) queue filenames.
_SLUG_MAX = 100


def request_slug(request_id: str) -> str:
    """Filesystem-safe **injective** slug for a request id (shared by
    result files and per-request telemetry directories).

    A short id that is already filesystem-safe maps to itself;
    anything else maps to its sanitized (and truncated) form plus a
    short hash of the raw id.  Injectivity matters because distinct
    client-supplied ids must never share a queue filename — ``'a/b'``
    and ``'a_b'`` colliding would overwrite one request's inbox file
    with the other's and resolve both pending futures from a single
    result.  The hash suffix is joined with ``~``, a character the
    sanitizer never passes through, so a literal id crafted to look
    like ``<sanitized>~<digest>`` cannot collide with a hashed slug:
    self-mapped slugs never contain ``~``, hashed ones always do.
    """
    safe = "".join(
        c if c.isalnum() or c in "-_." else "_" for c in request_id
    )
    if safe == request_id and safe and len(safe) <= _SLUG_MAX:
        return safe
    digest = hashlib.sha1(
        request_id.encode("utf-8", "surrogatepass")
    ).hexdigest()[:10]
    return f"{safe[:_SLUG_MAX] or 'request'}~{digest}"


def result_path(outbox: str, request_id: str) -> str:
    return os.path.join(outbox, request_slug(request_id) + ".json")


def inbox_request_path(inbox: str, request_id: str) -> str:
    return os.path.join(inbox, request_slug(request_id) + ".json")


def drop_request(inbox: str, payload: dict[str, Any], request_id: str) -> str:
    """Write one request file into the inbox atomically; returns the
    path.  This is the producer half of the claim protocol — the
    rename guarantees a consumer never reads partial JSON."""
    path = inbox_request_path(inbox, request_id)
    write_json_atomic(path, payload)
    return path


# ---------------------------------------------------------------------------
# Worker heartbeats (the self-healing layer's observation channel).

HEARTBEAT_SCHEMA = "qba-tpu/heartbeat/v1"

#: Lifecycle phases a worker reports, in rough hot-loop order.  The
#: supervisor's watchdog is phase-aware: ``compile`` (a bucket's first
#: dispatch: on the card the kernels' build and load) legitimately runs
#: orders of magnitude longer than the others, so a long compile is
#: "busy", not "hung".
HEARTBEAT_PHASES = ("idle", "claim", "compile", "dispatch", "readback")


def heartbeat_path(queue_dir: str, replica_id: str) -> str:
    return os.path.join(
        queue_dir, f"heartbeat-{request_slug(replica_id)}.json"
    )


class HeartbeatWriter:
    """Atomic-rename heartbeat file for one file-queue worker.

    Written by the *worker side only* (transport claim loop + server
    dispatch/readback transitions) — the supervisor and the rest of the
    fleet front half may read heartbeats but never write them.  A
    heartbeat write never touches a device, so beating inside the
    dispatch hot loop costs one small ``os.replace``.

    The stamp is ``time.monotonic()`` (CLOCK_MONOTONIC is machine-wide
    on Linux, so the supervisor process can age it against its own
    monotonic clock without wall-time step hazards).  ``seq`` increases
    on every write as a second staleness witness.  Idle re-beats are
    throttled to ``idle_rebeat_s`` so a quiet worker refreshes its
    liveness without hammering the queue dir every poll tick.
    """

    def __init__(
        self,
        queue_dir: str,
        replica_id: str,
        *,
        idle_rebeat_s: float = IDLE_REBEAT_S,
    ) -> None:
        self.path = heartbeat_path(queue_dir, replica_id)
        self.replica_id = replica_id
        self.idle_rebeat_s = idle_rebeat_s
        self.seq = 0
        self._last_phase: str | None = None
        self._last_write = 0.0

    def beat(self, phase: str, request_ids: tuple[str, ...] | list[str] = ()) -> bool:
        """Record a phase transition; returns True if a file write
        happened (idle->idle re-beats inside the throttle window are
        skipped — the previous stamp is still fresh)."""
        if phase not in HEARTBEAT_PHASES:
            raise ValueError(
                f"unknown heartbeat phase {phase!r}; one of {HEARTBEAT_PHASES}"
            )
        now = time.monotonic()
        if (
            phase == "idle"
            and self._last_phase == "idle"
            and now - self._last_write < self.idle_rebeat_s
        ):
            return False
        self.seq += 1
        payload = {
            "schema": HEARTBEAT_SCHEMA,
            "replica_id": self.replica_id,
            "pid": os.getpid(),
            "seq": self.seq,
            "phase": phase,
            "request_ids": list(request_ids),
            "monotonic": now,
            "stamp": time.time(),
        }
        try:
            write_json_atomic(self.path, payload)
        except OSError:
            return False  # a missing queue dir must never kill the worker
        self._last_phase = phase
        self._last_write = now
        return True


def read_heartbeat(queue_dir: str, replica_id: str) -> dict[str, Any] | None:
    """The last heartbeat one replica wrote, or None (never booted far
    enough to beat, or the file is mid-rename — atomic writes mean a
    readable file is always complete)."""
    try:
        with open(heartbeat_path(queue_dir, replica_id)) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return payload if isinstance(payload, dict) else None


def heartbeat_ages(queue_dir: str) -> dict[str, float]:
    """Per-replica heartbeat staleness in seconds: monotonic now minus
    the replica's last stamp.  Scans ``heartbeat-*.json`` so the
    frontend can report staleness with no supervisor attached (the
    ``GET /status`` satellite) and the metrics collector can gauge it
    at scrape time — both read-only, no new sockets."""
    ages: dict[str, float] = {}
    now = time.monotonic()
    try:
        names = os.listdir(queue_dir)
    except OSError:
        return ages
    for name in names:
        if not (name.startswith("heartbeat-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(queue_dir, name)) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(payload, dict):
            continue
        rid = payload.get("replica_id")
        stamp = payload.get("monotonic")
        if isinstance(rid, str) and isinstance(stamp, (int, float)):
            ages[rid] = max(0.0, now - float(stamp))
    return ages


# ---------------------------------------------------------------------------
# Flight recorder (the worker's recent history, read by the supervisor).

FLIGHT_SCHEMA = "qba-tpu/flight-recorder/v1"

#: Ring capacity: enough to hold a full request's lifecycle transitions
#: several times over, small enough that every flush is one tiny atomic
#: rename beside the heartbeat.
FLIGHT_CAPACITY = 64


def flight_path(queue_dir: str, replica_id: str) -> str:
    return os.path.join(
        queue_dir, f"flight-{request_slug(replica_id)}.json"
    )


class FlightRecorder:
    """Bounded ring of recent structured worker events, flushed
    atomically beside the heartbeat on every note.

    Same write discipline as the heartbeat — worker side only, atomic
    rename, and a missing queue dir never kills the worker.
    The flush-per-note policy is the point: the recorder exists for the
    moment the worker dies *without warning* (SIGKILL, poison
    ``os._exit``), so the on-disk tail must always be current.  The
    supervisor embeds the tail into ``crash_report``s, showing what the
    worker was doing when it died.
    """

    def __init__(
        self,
        queue_dir: str,
        replica_id: str,
        *,
        capacity: int = FLIGHT_CAPACITY,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = flight_path(queue_dir, replica_id)
        self.replica_id = replica_id
        self.capacity = capacity
        self.events: list[dict[str, Any]] = []
        self.seq = 0

    def note(self, event: str, **fields: Any) -> dict[str, Any]:
        """Append one event (wall + monotonic stamped) and flush."""
        self.seq += 1
        rec = {
            "seq": self.seq,
            "event": event,
            "monotonic": time.monotonic(),
            "stamp": time.time(),
            **fields,
        }
        self.events.append(rec)
        if len(self.events) > self.capacity:
            del self.events[: len(self.events) - self.capacity]
        try:
            write_json_atomic(self.path, {
                "schema": FLIGHT_SCHEMA,
                "replica_id": self.replica_id,
                "pid": os.getpid(),
                "capacity": self.capacity,
                "events": self.events,
            })
        except OSError:
            pass  # same contract as the heartbeat writer
        return rec


def read_flight_recorder(
    queue_dir: str, replica_id: str, *, tail: int | None = None
) -> dict[str, Any] | None:
    """The replica's flight-recorder file (optionally truncated to the
    last ``tail`` events), or None if it never recorded."""
    try:
        with open(flight_path(queue_dir, replica_id)) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(payload, dict):
        return None
    if tail is not None and isinstance(payload.get("events"), list):
        payload = {**payload, "events": payload["events"][-tail:]}
    return payload
