"""Fleet self-healing: watchdog, crash-loop breaker, poison quarantine —
a copy of :mod:`qba_tpu.serve.fleet.supervisor` over the port's pool.

The pool tolerates exactly one failure shape: a worker killed cleanly
whose stale claim a *survivor* reclaims.  This module adds the
supervision loop that handles the rest, so the serving fleet keeps
making progress while some of its workers misbehave:

* **watchdog**: workers heartbeat their lifecycle phase
  (:class:`qba_tpu_torch.serve.queuefs.HeartbeatWriter`); the
  supervisor ages each replica's last beat against a *phase-aware*
  timeout (a bucket's first dispatch, which builds and loads its
  kernels, gets :data:`WATCHDOG_PHASE_SCALE` x the base budget, so a
  long build is "busy", not "hung") and SIGKILLs replicas whose beat
  has gone stale: the only way to catch a SIGSTOP'd or wedged worker,
  which never exits and never beats.
* **blame attribution**: every observed death is cross-referenced
  against the dead worker's last heartbeat: the in-flight request ids
  at death go into a crash ledger keyed by request fingerprint, pinned
  to a request and a replica.  The dead worker's claim is released back
  to the inbox at once, without waiting out the reclaim timeout.
* **poison quarantine**: a request blamed for ``poison_threshold``
  deaths is dead-lettered *now* with a structured crash report
  (``{blamed_replicas, phases, exit_codes, reclaim_count}``), short-
  circuiting the transport's reclaim ladder: one poison request costs
  at most ``poison_threshold`` workers, not ``max_reclaims + 1``.
* **crash-loop breaker**: ``breaker_k`` deaths of one slot inside
  ``breaker_window_s`` bench it: the pool stops respawning it and the
  admission controller releases its share of the capacity window
  (:meth:`~qba_tpu_torch.serve.fleet.admission.AdmissionController.
  bench_replica`), so the fleet degrades gracefully instead of
  queueing against phantom capacity.

The supervisor only *reads* heartbeats (writes stay on the worker side)
and never opens a device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from qba_tpu_torch.obs.tracing import TraceEventLog
from qba_tpu_torch.serve.queuefs import (
    queue_paths,
    read_flight_recorder,
    read_heartbeat,
    request_slug,
    result_path,
    write_json_atomic,
)
from qba_tpu_torch.serve.request import EvalResult
from qba_tpu_torch.serve.timing import (
    BOOT_GRACE_SCALE,
    BREAKER_K,
    BREAKER_WINDOW_S,
    POISON_THRESHOLD,
    SUPERVISOR_POLL_S,
    WATCHDOG_PHASE_SCALE,
    WATCHDOG_S,
)

CRASH_LEDGER_SCHEMA = "qba-tpu/crash-ledger/v1"

# WATCHDOG_PHASE_SCALE is re-exported from qba_tpu_torch.serve.timing (the
# single source for every protocol timing constant) — existing callers
# keep importing it from here.
__all__ = ["FleetSupervisor", "WATCHDOG_PHASE_SCALE", "CRASH_LEDGER_SCHEMA"]

#: Phases during which a death is attributable to the in-flight
#: request(s) the heartbeat names.  An ``idle`` death blames nobody.
_BLAMABLE_PHASES = ("claim", "compile", "dispatch", "readback")


class FleetSupervisor:
    """Poll-driven supervision of one :class:`~qba_tpu_torch.serve.fleet.
    pool.ReplicaPool` (duck-typed: tests drive it with stub pools).

    One :meth:`poll` is one supervision step — classify, kill hung,
    attribute deaths, quarantine or release claims, trip the breaker,
    respawn, persist the crash ledger.  :meth:`run` loops it for the
    CLI's supervisor thread.  The clock is injectable so tests can age
    heartbeats without sleeping.
    """

    def __init__(
        self,
        pool,
        *,
        admission=None,
        watchdog_s: float = WATCHDOG_S,
        breaker_k: int = BREAKER_K,
        breaker_window_s: float = BREAKER_WINDOW_S,
        poison_threshold: int = POISON_THRESHOLD,
        boot_grace_s: float | None = None,
        clock=time.monotonic,
    ) -> None:
        if watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0, got {watchdog_s}")
        if breaker_k < 1:
            raise ValueError(f"breaker_k must be >= 1, got {breaker_k}")
        if poison_threshold < 1:
            raise ValueError(
                f"poison_threshold must be >= 1, got {poison_threshold}"
            )
        self.pool = pool
        self.queue_dir = pool.queue_dir
        self.paths = queue_paths(self.queue_dir)
        self.admission = admission
        self.watchdog_s = watchdog_s
        self.breaker_k = breaker_k
        self.breaker_window_s = breaker_window_s
        self.poison_threshold = poison_threshold
        # Workers importing torch take seconds to boot before their first
        # beat — a fresh pid with no heartbeat yet is booting, not hung.
        self.boot_grace_s = (
            boot_grace_s
            if boot_grace_s is not None
            else BOOT_GRACE_SCALE * watchdog_s
        )
        self._clock = clock
        # Lifecycle trace events: kill /
        # death / release / quarantine stamps carrying the blamed
        # request's trace id, so a stitched trace shows the
        # supervisor's interventions on the request's own timeline.
        self.trace_log = TraceEventLog(self.queue_dir)
        #: Tail length of the dead worker's flight recorder embedded in
        #: death events and crash reports.
        self.flight_tail = 16
        self._first_seen: dict[tuple[str, int], float] = {}
        self._handled_deaths: set[tuple[str, int]] = set()
        self._death_events: list[dict[str, Any]] = []
        # Crash ledger: request fingerprint (claim-file slug) ->
        # accumulated blame evidence across worker deaths.
        self.ledger: dict[str, dict[str, Any]] = {}
        self.quarantined: dict[str, dict[str, Any]] = {}
        self.bench_events: list[dict[str, Any]] = []
        self.hung_killed: list[dict[str, Any]] = []
        self.polls = 0

    # ---- classification ----------------------------------------------
    def classify(self, replica) -> dict[str, Any]:
        """One replica's health verdict: ``state`` is one of
        ``healthy|busy|hung|dead`` plus the evidence (phase, beat age,
        pid) the verdict rests on."""
        rid = replica.replica_id
        pid = replica.proc.pid
        now = self._clock()
        out: dict[str, Any] = {"replica_id": rid, "pid": pid}
        if not replica.alive:
            out["state"] = "dead"
            out["exit_code"] = replica.proc.returncode
            return out
        hb = read_heartbeat(self.queue_dir, rid)
        if hb is None or hb.get("pid") != pid:
            # No beat from THIS incarnation yet (a respawn inherits the
            # dead pid's stale file): booting, with a grace period.
            first = self._first_seen.setdefault((rid, pid), now)
            age = now - first
            out["phase"] = "boot"
            out["beat_age_s"] = age
            out["state"] = "hung" if age > self.boot_grace_s else "healthy"
            return out
        phase = str(hb.get("phase", "idle"))
        age = now - float(hb.get("monotonic", now))
        allowed = self.watchdog_s * WATCHDOG_PHASE_SCALE.get(phase, 1.0)
        out["phase"] = phase
        out["beat_age_s"] = age
        out["request_ids"] = list(hb.get("request_ids") or [])
        if age > allowed:
            out["state"] = "hung"
        elif phase == "idle":
            out["state"] = "healthy"
        else:
            out["state"] = "busy"
        return out

    def health(self) -> dict[str, dict[str, Any]]:
        """Per-replica health map for ``GET /status`` — classification
        plus bench state, no side effects."""
        out: dict[str, dict[str, Any]] = {}
        benched = getattr(self.pool, "benched", set())
        for r in self.pool.replicas:
            verdict = self.classify(r)
            verdict["benched"] = r.replica_id in benched
            out[r.replica_id] = verdict
        return out

    # ---- one supervision step ----------------------------------------
    def poll(self) -> dict[str, Any]:
        """One step: kill hung workers, attribute + recover every new
        death, trip the breaker, respawn, persist the crash ledger."""
        self.polls += 1
        verdicts = {r.replica_id: self.classify(r) for r in self.pool.replicas}
        killed = []
        for rid, v in verdicts.items():
            if v["state"] != "hung":
                continue
            try:
                self.pool.kill(rid)
            except ValueError:
                continue  # exited on its own between classify and kill
            event = {
                "replica_id": rid,
                "pid": v["pid"],
                "phase": v.get("phase"),
                "beat_age_s": v.get("beat_age_s"),
                "at": time.time(),
            }
            self.hung_killed.append(event)
            killed.append(rid)
            for req_id in v.get("request_ids") or [None]:
                trace_id, request_id = (
                    self._trace_of(request_slug(req_id))
                    if req_id is not None else (None, None)
                )
                self.trace_log.emit(
                    "kill", trace_id, request_id or req_id,
                    replica_id=rid, pid=v["pid"], phase=v.get("phase"),
                    beat_age_s=v.get("beat_age_s"),
                )
        deaths = self._handle_deaths()
        benched = self._trip_breaker()
        respawned = self.pool.respawn_dead()
        self._write_ledger()
        return {
            "verdicts": verdicts,
            "hung_killed": killed,
            "deaths": deaths,
            "benched": benched,
            "respawned": respawned,
        }

    def run(
        self,
        stop_event: threading.Event,
        poll_s: float = SUPERVISOR_POLL_S,
    ) -> None:
        """Poll until ``stop_event`` is set (the CLI's supervisor
        thread body)."""
        while not stop_event.is_set():
            self.poll()
            stop_event.wait(poll_s)

    # ---- death attribution + recovery --------------------------------
    def _handle_deaths(self) -> list[dict[str, Any]]:
        new: list[dict[str, Any]] = []
        for r in self.pool.replicas:
            if r.alive:
                continue
            key = (r.replica_id, r.proc.pid)
            if key in self._handled_deaths:
                continue
            self._handled_deaths.add(key)
            exit_code = (
                r.proc.returncode
                if r.proc.returncode is not None
                else getattr(r, "returncode", None)
            )
            hb = read_heartbeat(self.queue_dir, r.replica_id)
            phase, rids = "unknown", []
            if hb is not None and hb.get("pid") == r.proc.pid:
                phase = str(hb.get("phase", "unknown"))
                rids = list(hb.get("request_ids") or [])
            event = {
                "replica_id": r.replica_id,
                "pid": r.proc.pid,
                "exit_code": exit_code,
                "phase": phase,
                "request_ids": rids,
                "at": self._clock(),
                "wall": time.time(),
            }
            # Capture the flight-recorder tail NOW: a respawn of this
            # slot will overwrite flight-<slug>.json, but the death
            # event (and any crash report built from it) must keep the
            # dead incarnation's last moments.
            event["flight_recorder"] = read_flight_recorder(
                self.queue_dir, r.replica_id, tail=self.flight_tail
            )
            self._death_events.append(event)
            new.append(event)
            for rid in rids or [None]:
                trace_id, request_id = (
                    self._trace_of(request_slug(rid))
                    if rid is not None else (None, None)
                )
                self.trace_log.emit(
                    "death", trace_id, request_id or rid,
                    replica_id=r.replica_id, pid=r.proc.pid,
                    exit_code=exit_code, phase=phase,
                )
            if phase in _BLAMABLE_PHASES:
                for rid in rids:
                    self._blame(request_slug(rid), event)
        return new

    def _blame(self, slug: str, death: dict[str, Any]) -> None:
        """Charge one request fingerprint with one worker death, then
        recover its claim: quarantine at the poison threshold, release
        back to the inbox below it."""
        entry = self.ledger.setdefault(
            slug, {"deaths": [], "releases": 0, "quarantined": False}
        )
        entry["deaths"].append(
            {
                "replica_id": death["replica_id"],
                "pid": death["pid"],
                "phase": death["phase"],
                "exit_code": death["exit_code"],
                "flight_recorder": death.get("flight_recorder"),
            }
        )
        if entry["quarantined"]:
            return
        if len(entry["deaths"]) >= self.poison_threshold:
            self._quarantine(slug, entry)
        elif self._release_claim(slug):
            entry["releases"] += 1

    def _trace_of(self, slug: str) -> tuple[str | None, str | None]:
        """(trace_id, request_id) from wherever the request's queue
        file currently sits — the trace context rides the file JSON, so
        supervisor events can stamp the same id the worker adopted."""
        for key in ("claimed", "inbox", "dead"):
            path = os.path.join(self.paths[key], f"{slug}.json")
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(payload, dict):
                return (payload.get("trace_id"),
                        payload.get("request_id", slug))
        return None, slug

    def _claim_file(self, slug: str) -> tuple[str, str] | None:
        """Where the blamed request's file currently sits: the dead
        worker's claim, or the inbox (a peer's reclaim ladder may have
        already pushed it back)."""
        for key in ("claimed", "inbox"):
            path = os.path.join(self.paths[key], f"{slug}.json")
            if os.path.exists(path):
                return key, path
        return None

    def _release_claim(self, slug: str) -> bool:
        """Push a dead worker's claim straight back to the inbox — the
        fast path the watchdog enables: re-served within one poll, not
        one reclaim timeout."""
        loc = self._claim_file(slug)
        if loc is None or loc[0] != "claimed":
            return False
        trace_id, request_id = self._trace_of(slug)
        try:
            # qba-protocol: release
            os.replace(
                loc[1], os.path.join(self.paths["inbox"], f"{slug}.json")
            )
        except OSError:
            return False
        self.trace_log.emit("release", trace_id, request_id, slug=slug)
        return True

    def _quarantine(self, slug: str, entry: dict[str, Any]) -> None:
        """Dead-letter a poison request NOW with its crash report —
        wherever its file sits, it must never reach another worker."""
        request_id = slug
        trace_id = None
        loc = self._claim_file(slug)
        if loc is not None:
            try:
                with open(loc[1]) as f:
                    payload = json.loads(f.read())
                request_id = str(payload.get("request_id", slug))
                trace_id = payload.get("trace_id")
            except (OSError, json.JSONDecodeError, AttributeError):
                pass
            try:
                os.makedirs(self.paths["dead"], exist_ok=True)
                # qba-protocol: quarantine
                os.replace(
                    loc[1], os.path.join(self.paths["dead"], f"{slug}.json")
                )
            except OSError:
                pass  # raced away; the crash-report result still wins
        deaths = entry["deaths"]
        # The last blamed worker's flight-recorder tail (captured at
        # death time, before any respawn overwrote the file): the
        # crash report shows what the worker was doing when it died.
        flight = next(
            (d["flight_recorder"] for d in reversed(deaths)
             if d.get("flight_recorder")),
            None,
        ) or {"replica_id": deaths[-1]["replica_id"] if deaths else None,
              "events": []}
        report = {
            "blamed_replicas": [d["replica_id"] for d in deaths],
            "phases": [d["phase"] for d in deaths],
            "exit_codes": [d["exit_code"] for d in deaths],
            "reclaim_count": entry["releases"],
            "flight_recorder": flight,
        }
        entry["quarantined"] = True
        self.quarantined[slug] = {"request_id": request_id, **report}
        self.trace_log.emit("quarantine", trace_id, request_id,
                            slug=slug, deaths=len(deaths))
        self.trace_log.emit("settle", trace_id, request_id,
                            outcome="quarantined")
        res = EvalResult.failure(
            request_id,
            f"quarantined as poison: blamed for {len(deaths)} worker "
            f"death(s) (replicas {report['blamed_replicas']}, phases "
            f"{report['phases']}) — dead-lettered without further retries",
        )
        res.trace_id = trace_id
        res.crash_report = report
        try:
            write_json_atomic(
                result_path(self.paths["outbox"], request_id), res.to_json()
            )
        except OSError:
            pass  # outbox gone (teardown); the ledger still records it

    # ---- breaker ------------------------------------------------------
    def _trip_breaker(self) -> list[str]:
        now = self._clock()
        benched: list[str] = []
        already = getattr(self.pool, "benched", set())
        for r in self.pool.replicas:
            rid = r.replica_id
            if rid in already or rid in benched:
                continue
            recent = [
                e
                for e in self._death_events
                if e["replica_id"] == rid
                and now - e["at"] <= self.breaker_window_s
            ]
            if len(recent) < self.breaker_k:
                continue
            self.pool.bench(rid)
            released = (
                self.admission.bench_replica(rid)
                if self.admission is not None
                else 0
            )
            self.bench_events.append(
                {
                    "replica_id": rid,
                    "deaths_in_window": len(recent),
                    "window_s": self.breaker_window_s,
                    "capacity_released": released,
                    "at": time.time(),
                }
            )
            benched.append(rid)
        return benched

    # ---- persistence / reporting -------------------------------------
    def _write_ledger(self) -> None:
        try:
            write_json_atomic(self.paths["crash_ledger"], self.ledger_json())
        except OSError:
            pass

    def ledger_json(self) -> dict[str, Any]:
        return {
            "schema": CRASH_LEDGER_SCHEMA,
            "blame": self.ledger,
            "quarantined": self.quarantined,
            "bench_events": self.bench_events,
            "hung_killed": self.hung_killed,
            "deaths": self._death_events,
        }

    def summary(self) -> dict[str, Any]:
        """The ``self_healing`` block of ``fleet_summary.json``."""
        return {
            "watchdog_s": self.watchdog_s,
            "polls": self.polls,
            "deaths": len(self._death_events),
            "hung_killed": len(self.hung_killed),
            "respawned": len(getattr(self.pool, "restarted", [])),
            "benched": sorted(getattr(self.pool, "benched", set())),
            "quarantined": dict(self.quarantined),
            "releases": sum(e["releases"] for e in self.ledger.values()),
        }
