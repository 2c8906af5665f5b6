"""The campaign driver: enumerate → admit → steer → certify → render — a
copy of :mod:`qba_tpu.atlas.campaign` over the port's worker.

One :class:`CampaignDriver` owns one campaign over one atlas store.
Its loop is deliberately plain; the correctness story is in the
invariants, not the control flow:

* **At-least-once delivery, exactly-once effect.**  Results are
  processed (ledger persisted, store record written) *before* they are
  acknowledged to the executor.  A ``kill -9`` of the driver between
  persist and ack makes the result arrive again on resume; the handler
  recognizes the finalized cell and drops the duplicate.  Zero lost,
  zero duplicated cells: the file queue's claim guarantees, observed at
  campaign level.
* **The ledger is the only state.**  A restarted driver re-derives the
  cube from the spec (``enumerate_cells`` is pure), reconciles it
  against the store (certified/refused cells are never re-admitted),
  recovers in-flight request ids through the executor, and continues.
* **Determinism.**  Per-cell results are pure functions of ``(config,
  seed, chunk index)``, escalation is driven only by per-cell budget
  exhaustion, and steering order never changes what any cell computes,
  so an interrupted-and-resumed campaign produces a store with the same
  identity digest as an uninterrupted one, and the same digest as the
  JAX package's campaign over the same spec.

Back-pressure: every submission goes through
``AdmissionController.try_admit(req, batch=True)``.  ``defer`` stops
this round's submissions; the driver drains results (which settle
capacity) and re-offers next round.  ``reject`` becomes an explicit
refusal record, so every enumerated cell ends certified or refused.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

from qba_tpu_torch.atlas.cube import (
    AtlasCell,
    CampaignSpec,
    build_request,
    enumerate_cells,
    request_id_for,
)
from qba_tpu_torch.atlas.steer import frontier_plan
from qba_tpu_torch.atlas.store import (
    CELL_SCHEMA,
    LEDGER_SCHEMA,
    AtlasStore,
    record_satisfies,
)
from qba_tpu_torch.obs.metrics import MetricsRegistry
from qba_tpu_torch.obs.tracing import mint_span_id, mint_trace_id
from qba_tpu_torch.serve.fleet.admission import ADMIT, DEFER, AdmissionController
from qba_tpu_torch.serve.queuefs import drop_request, queue_paths, request_slug
from qba_tpu_torch.serve.request import EvalRequest, EvalResult


def _stamp_trace(req: EvalRequest) -> EvalRequest:
    """Mint trace context for one atlas cell request.

    The campaign driver is this request's frontend — no fleet intake
    ever sees it before the queue file — so the trace id is born here
    and only *adopted* downstream."""
    if req.trace_id:
        return req
    return dataclasses.replace(
        req, trace_id=mint_trace_id(), parent_span_id=mint_span_id()
    )


class LocalExecutor:
    """In-process executor: one :class:`~qba_tpu_torch.serve.engine.QBAServer`
    behind the same submit/poll/ack/recover surface as the fleet.  The
    test and smoke path: synchronous, deterministic, no queue dir.
    Nothing survives the process, so :meth:`recover` always answers
    ``gone`` and a restarted driver simply re-submits."""

    def __init__(self, server=None, **server_kw) -> None:
        self._server = server
        self._server_kw = server_kw
        self._pending: list[EvalRequest] = []

    def submit(self, req: EvalRequest) -> None:
        self._pending.append(req)

    def poll(self) -> list[dict[str, Any]]:
        if not self._pending:
            return []
        from qba_tpu_torch.serve.engine import QBAServer, serve_batch

        if self._server is None:
            self._server = QBAServer(**self._server_kw)
        reqs, self._pending = self._pending, []
        return [r.to_json() for r in serve_batch(self._server, reqs)]

    def recover(self, request_id: str) -> tuple[str, dict[str, Any] | None]:
        return ("gone", None)

    def ack(self, request_id: str) -> None:
        pass

    def stop(self) -> None:
        pass


class FleetExecutor:
    """File-queue executor: requests dropped into a fleet ``inbox/``,
    results read from ``outbox/`` and moved to ``consumed/`` only on
    :meth:`ack` — i.e. only after the driver has persisted their
    effect, which is what makes driver kills loss-free.  The pool and
    supervisor run elsewhere (CLI or test harness); this class touches
    nothing but the queue directory, and opens no device, like the rest
    of the fleet's front half."""

    def __init__(self, queue_dir: str) -> None:
        self.paths = queue_paths(queue_dir)
        for key in ("inbox", "claimed", "done", "dead", "outbox", "consumed"):
            os.makedirs(self.paths[key], exist_ok=True)

    def submit(self, req: EvalRequest) -> None:
        drop_request(self.paths["inbox"], req.to_json(), req.request_id)

    def poll(self) -> list[dict[str, Any]]:
        import json

        out: list[dict[str, Any]] = []
        outbox = self.paths["outbox"]
        try:
            names = sorted(os.listdir(outbox))
        except OSError:
            return out
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(outbox, name)) as f:
                    payload = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # mid-rename or torn teardown; next poll
            if isinstance(payload, dict):
                out.append(payload)
        return out

    def recover(self, request_id: str) -> tuple[str, dict[str, Any] | None]:
        """Where is an in-flight request after a driver restart?
        ``result`` — its result is in the outbox (unacked; the caller
        processes it normally); ``pending`` — still queued or claimed
        by a worker; ``gone`` — no trace (e.g. submitted to a queue
        that was since recreated): re-submit."""
        import json

        name = request_slug(request_id) + ".json"
        res = os.path.join(self.paths["outbox"], name)
        if os.path.exists(res):
            try:
                with open(res) as f:
                    payload = json.load(f)
                if isinstance(payload, dict):
                    return ("result", payload)
            except (OSError, json.JSONDecodeError):
                return ("pending", None)  # mid-rename: poll will see it
        for box in ("inbox", "claimed", "dead"):
            if os.path.exists(os.path.join(self.paths[box], name)):
                return ("pending", None)
        return ("gone", None)

    def ack(self, request_id: str) -> None:
        """Move a processed result out of the outbox.  Crash-safe in
        both directions: ack-after-persist means a missed ack only
        re-delivers (handled idempotently), never loses."""
        name = request_slug(request_id) + ".json"
        src = os.path.join(self.paths["outbox"], name)
        try:
            os.replace(src, os.path.join(self.paths["consumed"], name))
        except OSError:
            pass  # already acked, or outbox torn down

    def stop(self) -> None:
        pass


class CampaignDriver:
    """Runs one campaign spec against one store through one executor.

    ``max_results`` interrupts the driver after processing that many
    results (the test harness's stand-in for ``kill -9`` — the ledger
    on disk at that point is exactly what a real kill would leave);
    ``on_result(count, payload)`` fires after each processed result
    (the CLI's chaos-kill hook).  ``admission`` is the caller's: its
    ceiling needs the memory and kind of the device the executor runs
    on, which only the caller knows.
    """

    def __init__(
        self,
        store: AtlasStore,
        spec: CampaignSpec,
        executor,
        *,
        admission: AdmissionController,
        log: Callable[[str], None] = lambda s: None,
        poll_s: float = 0.05,
        idle_timeout_s: float = 180.0,
        max_results: int | None = None,
        on_result: Callable[[int, dict[str, Any]], None] | None = None,
        metrics: MetricsRegistry | None = None,
    ) -> None:
        self.store = store
        self.spec = spec
        self.executor = executor
        # Driver-owned metrics plane: campaign outcomes and budget spend
        # land in the same registered-name table the fleet exposes.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.admission = admission
        self.log = log
        self.poll_s = poll_s
        self.idle_timeout_s = idle_timeout_s
        self.max_results = max_results
        self.on_result = on_result
        self.cells: dict[str, AtlasCell] = {
            c.key: c for c in enumerate_cells(spec)
        }
        self.order: list[str] = list(self.cells)
        self.results_processed = 0

    # ---- ledger ------------------------------------------------------
    def _fresh_ledger(self) -> dict[str, Any]:
        return {
            "schema": LEDGER_SCHEMA,
            "campaign": self.spec.to_json(),
            "campaign_key": self.spec.campaign_key(),
            "cells": {
                key: {
                    "coords": cell.coords,
                    "status": "pending",
                    "attempt": 0,
                    "request_id": None,
                    "successes": 0,
                    "n_trials": 0,
                    "admission": None,
                    "refusal": None,
                }
                for key, cell in self.cells.items()
            },
            "steering": None,
        }

    def _load_ledger(self) -> dict[str, Any]:
        led = self.store.load_ledger()
        if led is None:
            return self._fresh_ledger()
        if led.get("campaign_key") != self.spec.campaign_key():
            raise ValueError(
                f"ledger at {self.store.ledger_path} belongs to campaign "
                f"{led.get('campaign_key')!r}, not {self.spec.campaign_key()!r}"
                " — refusing to resume a different campaign's ledger"
            )
        # The cube is re-derived, never trusted from disk: a ledger cell
        # set differing from the enumeration is a corruption finding.
        missing = set(self.cells) - set(led.get("cells", {}))
        if missing:
            raise ValueError(
                f"ledger is missing {len(missing)} enumerated cell(s), "
                f"e.g. {sorted(missing)[:3]} — corrupt ledger"
            )
        return led

    def _reconcile_store(self, ledger: dict[str, Any]) -> int:
        """Cells the store already answers are never re-admitted: a
        certified record satisfying this campaign's target (or any
        record finalized by this same campaign target) closes the
        ledger cell.  Returns how many cells were closed this way."""
        closed = 0
        for key, entry in ledger["cells"].items():
            if entry["status"] in ("certified", "refused"):
                continue
            rec = self.store.load_cell(key)
            if rec is None:
                continue
            same_target = rec.get("target") == self.spec.target
            if rec.get("status") == "certified" and (
                same_target or record_satisfies(rec, self.spec.target)
            ):
                entry.update(
                    status="certified",
                    successes=rec.get("successes", 0),
                    n_trials=rec.get("n_trials", 0),
                    attempt=max(0, int(rec.get("attempts", 1)) - 1),
                )
                closed += 1
            elif rec.get("status") == "refused" and same_target:
                entry.update(
                    status="refused",
                    successes=rec.get("successes", 0),
                    n_trials=rec.get("n_trials", 0),
                    refusal=rec.get("refusal"),
                    attempt=max(0, int(rec.get("attempts", 1)) - 1),
                )
                closed += 1
        return closed

    def _recover_inflight(self, ledger: dict[str, Any]) -> None:
        """Driver-restart path: every ``submitted`` cell's request id is
        located through the executor — landed results get processed,
        queued/claimed work is left to arrive, vanished requests go
        back to pending for re-admission."""
        for key, entry in list(ledger["cells"].items()):
            if entry["status"] != "submitted":
                continue
            rid = entry["request_id"] or request_id_for(key, entry["attempt"])
            state, payload = self.executor.recover(rid)
            if state == "result" and payload is not None:
                self._handle(ledger, payload)
            elif state == "gone":
                entry["status"] = "pending"
                entry["request_id"] = None
                self.log(f"atlas: {rid} lost in flight; re-admitting")

    # ---- result handling --------------------------------------------
    @staticmethod
    def _cell_key_of(request_id: str) -> str | None:
        if not request_id.startswith("atlas-"):
            return None
        body = request_id[len("atlas-"):]
        key, sep, _ = body.rpartition("-a")
        return key if sep else None

    def _handle(self, ledger: dict[str, Any], payload: dict[str, Any]) -> bool:
        """Process one result payload; returns True if it advanced the
        campaign (False for stale/foreign/duplicate payloads, which are
        acked and dropped)."""
        try:
            res = EvalResult.from_json(payload)
        except (TypeError, ValueError):
            rid = payload.get("request_id")
            if isinstance(rid, str):
                self.executor.ack(rid)
            return False
        rid = res.request_id
        key = self._cell_key_of(rid)
        entry = ledger["cells"].get(key) if key else None
        if (
            entry is None
            or entry["status"] != "submitted"
            or entry["request_id"] != rid
        ):
            self.executor.ack(rid)  # duplicate delivery or stale attempt
            return False
        self.admission.settle(rid, res.n_trials)
        if res.n_trials:
            self.metrics.inc(
                "qba_atlas_budget_trials_total",
                float(res.n_trials),
                exemplar=res.trace_id,
            )
        if res.error:
            refusal = {
                "reason": (
                    "crash_quarantine" if res.crash_report else "error"
                ),
                "detail": res.error,
            }
            if res.crash_report:
                refusal["crash_report"] = res.crash_report
            self._finalize(ledger, key, res, status="refused", refusal=refusal)
        else:
            entry["successes"] = res.successes
            entry["n_trials"] = res.n_trials
            reason = (res.stop or {}).get("reason")
            if reason in ("decided_above", "decided_below", "ci_width"):
                self._finalize(ledger, key, res, status="certified")
            elif entry["attempt"] < self.spec.max_escalations:
                entry["attempt"] += 1
                entry["status"] = "pending"
                entry["request_id"] = None
                self.metrics.inc(
                    "qba_atlas_cells_total",
                    labels={"status": "escalated"},
                    exemplar=res.trace_id,
                )
                self.log(
                    f"atlas: {key} unresolved at {res.n_trials} trials; "
                    f"escalating to wave {entry['attempt']}"
                )
            else:
                self._finalize(
                    ledger, key, res, status="refused",
                    refusal={
                        "reason": "budget_exhausted",
                        "detail": (
                            f"target unresolved after {res.n_trials} trials "
                            f"over {entry['attempt'] + 1} wave(s)"
                        ),
                    },
                )
        self._save(ledger)
        self.executor.ack(rid)  # persist-then-ack: kills re-deliver, never lose
        return True

    def _finalize(
        self,
        ledger: dict[str, Any],
        key: str,
        res: EvalResult,
        *,
        status: str,
        refusal: dict[str, Any] | None = None,
    ) -> None:
        cell = self.cells[key]
        entry = ledger["cells"][key]
        ci = res.ci
        if ci is None and res.n_trials > 0:
            from qba_tpu_torch.stats.estimators import rate_estimate

            ci = rate_estimate(res.successes, res.n_trials).to_json()
        record = {
            "schema": CELL_SCHEMA,
            "cell_key": key,
            "coords": cell.coords,
            "config": cell.fingerprint,
            "target": self.spec.target,
            "chunk_trials": self.spec.chunk_trials,
            "status": status,
            "stop": res.stop,
            "ci": ci,
            "successes": res.successes,
            "n_trials": res.n_trials,
            "attempts": entry["attempt"] + 1,
            "refusal": refusal,
            "provenance": {
                "producer": "campaign",
                "campaign_key": self.spec.campaign_key(),
                "request_id": res.request_id,
                "replica_id": res.replica_id,
                "engine": res.engine,
                "bucket": res.bucket,
                "latency_s": res.latency_s,
                "queue_wait_s": res.queue_wait_s,
                "admission": entry.get("admission"),
            },
            "manifest": res.manifest,
        }
        self.store.write_cell(record)
        entry["status"] = status
        entry["refusal"] = refusal
        entry["successes"] = res.successes
        entry["n_trials"] = res.n_trials
        self.metrics.inc(
            "qba_atlas_cells_total",
            labels={"status": status},
            exemplar=res.trace_id,
        )

    def _refuse_admission(
        self, ledger: dict[str, Any], key: str, decision
    ) -> None:
        """An admission REJECT is a final, explicit refusal — the cell
        can never be served by this fleet, and the store keeps the
        evidence on disk, not a silent gap."""
        cell = self.cells[key]
        entry = ledger["cells"][key]
        refusal = {
            "reason": f"admission_{decision.reason}",
            "detail": decision.detail,
            "admission": decision.to_json(),
        }
        record = {
            "schema": CELL_SCHEMA,
            "cell_key": key,
            "coords": cell.coords,
            "config": cell.fingerprint,
            "target": self.spec.target,
            "chunk_trials": self.spec.chunk_trials,
            "status": "refused",
            "stop": None,
            "ci": None,
            "successes": 0,
            "n_trials": 0,
            "attempts": entry["attempt"] + 1,
            "refusal": refusal,
            "provenance": {
                "producer": "campaign",
                "campaign_key": self.spec.campaign_key(),
            },
            "manifest": None,
        }
        self.store.write_cell(record)
        entry["status"] = "refused"
        entry["refusal"] = refusal
        self.metrics.inc(
            "qba_atlas_cells_total", labels={"status": "refused"}
        )

    def _save(self, ledger: dict[str, Any]) -> None:
        self.store.save_ledger(ledger)

    # ---- the loop ----------------------------------------------------
    def run(self) -> dict[str, Any]:
        ledger = self._load_ledger()
        reused = self._reconcile_store(ledger)
        if reused:
            self.log(f"atlas: {reused} cell(s) already answered by the store")
        self._recover_inflight(ledger)
        self._save(ledger)
        last_progress = time.monotonic()
        interrupted = False
        while True:
            pending = [
                k for k in self.order
                if ledger["cells"][k]["status"] == "pending"
            ]
            submitted = [
                k for k in self.order
                if ledger["cells"][k]["status"] == "submitted"
            ]
            if not pending and not submitted:
                break
            if pending:
                observed = {
                    k: (e["successes"], e["n_trials"])
                    for k, e in ledger["cells"].items()
                    if e["n_trials"] > 0
                }
                ranked, plan = frontier_plan(
                    self.order, observed, pending, self.spec.target
                )
                ledger["steering"] = plan
                for key in ranked:
                    entry = ledger["cells"][key]
                    req = _stamp_trace(build_request(
                        self.cells[key], self.spec, entry["attempt"]
                    ))
                    dec = self.admission.try_admit(req, batch=True)
                    entry["admission"] = dec.to_json()
                    if dec.action == ADMIT:
                        entry["status"] = "submitted"
                        entry["request_id"] = req.request_id
                        self.executor.submit(req)
                        last_progress = time.monotonic()
                    elif dec.action == DEFER:
                        # Back-pressure: stop offering, drain settles,
                        # re-offer next round.
                        break
                    else:
                        self._refuse_admission(ledger, key, dec)
                self._save(ledger)
                submitted = [
                    k for k in self.order
                    if ledger["cells"][k]["status"] == "submitted"
                ]
            progressed = False
            for payload in self.executor.poll():
                if self._handle(ledger, payload):
                    progressed = True
                    last_progress = time.monotonic()
                    self.results_processed += 1
                    if self.on_result is not None:
                        self.on_result(self.results_processed, payload)
                    if (
                        self.max_results is not None
                        and self.results_processed >= self.max_results
                    ):
                        interrupted = True
                        break
            if interrupted:
                break
            if not progressed and submitted:
                if time.monotonic() - last_progress > self.idle_timeout_s:
                    stuck = [
                        ledger["cells"][k]["request_id"] for k in submitted
                    ]
                    raise RuntimeError(
                        f"campaign stalled: no result for "
                        f"{self.idle_timeout_s:.0f}s with {len(stuck)} "
                        f"request(s) in flight, e.g. {stuck[:3]}"
                    )
                time.sleep(self.poll_s)
        summary = self.summary(ledger)
        summary["interrupted"] = interrupted
        if not interrupted:
            from qba_tpu_torch.atlas.render import render_atlas

            atlas = render_atlas(self.store, self.spec.target)
            summary["atlas"] = {
                "slices": len(atlas.get("slices", [])),
                "path": self.store.atlas_path,
            }
        self.log(
            f"atlas: campaign {'interrupted' if interrupted else 'complete'}"
            f" — {summary['certified']} certified, "
            f"{summary['refused']} refused, "
            f"{summary['open']} open of {summary['cells']}"
        )
        return summary

    def summary(self, ledger: dict[str, Any]) -> dict[str, Any]:
        by_status: dict[str, int] = {}
        for entry in ledger["cells"].values():
            by_status[entry["status"]] = by_status.get(entry["status"], 0) + 1
        return {
            "campaign_key": self.spec.campaign_key(),
            "cells": len(ledger["cells"]),
            "certified": by_status.get("certified", 0),
            "refused": by_status.get("refused", 0),
            "open": by_status.get("pending", 0) + by_status.get("submitted", 0),
            "by_status": by_status,
            "results_processed": self.results_processed,
            "admission": self.admission.summary(),
            "store_digest": self.store.digest(),
            "metrics": {
                "escalated": self.metrics.counter_value(
                    "qba_atlas_cells_total", {"status": "escalated"}
                ),
                "budget_trials": self.metrics.counter_value(
                    "qba_atlas_budget_trials_total"
                ),
            },
        }
