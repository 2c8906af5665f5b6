"""The fleet front end: asyncio sockets in, file queue out — a copy of
:mod:`qba_tpu.serve.fleet.frontend`, speaking the same wire format, so
it drives either package's workers.

One asyncio TCP server speaks the service's wire model: one
:class:`~qba_tpu_torch.serve.request.EvalRequest` JSON object per line
in, one :class:`~qba_tpu_torch.serve.request.EvalResult` JSON object
per line out (completion order), plus a minimal HTTP mode on the same
port (``POST`` any path with a JSONL body answers 200 with the result
lines; ``GET /metrics`` the Prometheus text, any other ``GET`` the live
fleet status).  Requests without a ``request_id`` get one assigned
here.

The front end does **no device work**: it opens no CUDA context, and
its only job is admission
(:class:`~qba_tpu_torch.serve.fleet.admission.AdmissionController`)
plus moving JSON between sockets and the file queue.  Admitted requests
are dropped into ``inbox/`` (temp + rename), the workers' claim,
reclaim, dead-letter and deadline machinery is the whole fault story,
and a poller watches ``outbox/`` to route each result back to the
connection that asked, after settling its priced capacity, which is the
moment a deferred request gets retried.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import threading
from collections import deque
from typing import Any

from qba_tpu_torch.obs.metrics import MetricsRegistry
from qba_tpu_torch.obs.tracing import TraceEventLog, mint_span_id, mint_trace_id
from qba_tpu_torch.serve.fleet.admission import ADMIT, DEFER, AdmissionController
from qba_tpu_torch.serve.queuefs import (
    drop_request,
    heartbeat_ages,
    queue_paths,
    result_path,
)
from qba_tpu_torch.serve.request import EvalRequest, EvalResult
from qba_tpu_torch.serve.timing import FRONTEND_POLL_S


class FleetFrontend:
    """One listening socket bridging clients to the shared queue."""

    def __init__(
        self,
        queue_dir: str,
        admission: AdmissionController | None = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        poll_s: float = FRONTEND_POLL_S,
        request_prefix: str = "fl",
        max_requests: int | None = None,
        health_provider=None,
        metrics: MetricsRegistry | None = None,
    ) -> None:
        self.queue_dir = queue_dir
        self.paths = queue_paths(queue_dir)
        os.makedirs(self.paths["inbox"], exist_ok=True)
        os.makedirs(self.paths["outbox"], exist_ok=True)
        os.makedirs(self.paths["consumed"], exist_ok=True)
        self.admission = admission
        self.host = host
        self.port = port  # 0 = ephemeral; replaced by the bound port
        self.poll_s = poll_s
        self.max_requests = max_requests
        # Zero-arg callable returning the supervisor's per-replica
        # health map (``FleetSupervisor.health``) for ``GET /status``.
        # A callable, not the supervisor itself: the front-end must not
        # grow a pool/process dependency.
        self.health_provider = health_provider
        # Live metrics plane: push counters at the decision points below,
        # pull point-in-time gauges from the queue dir at scrape time.
        # ``GET /metrics`` renders this.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.add_collector(self._collect_queue_metrics)
        # Lifecycle event log: the frontend is the minting site for
        # trace ids and stamps intake / admission / settle onto each
        # trace's timeline.
        self.trace_log = TraceEventLog(queue_dir)
        self._trace_ids: dict[str, str] = {}  # rid -> trace_id
        self._ids = itertools.count()
        self._prefix = request_prefix
        self._futures: dict[str, asyncio.Future] = {}
        self._admitted: dict[str, dict[str, Any]] = {}  # rid -> decision json
        self._deferred: deque[EvalRequest] = deque()
        self.requests_seen = 0  # valid requests accepted off sockets
        self.results_forwarded = 0
        self._release = asyncio.Event()
        self._done = asyncio.Event()
        self._server: asyncio.AbstractServer | None = None
        self._tasks: list[asyncio.Task] = []
        self._connections: set[asyncio.Task] = set()
        # Thread-mode plumbing (start_in_thread/stop_in_thread).
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None

    # ---- lifecycle ---------------------------------------------------
    async def start(self) -> None:
        """Bind the socket and start the outbox/admission pollers;
        ``self.port`` holds the actual port after this returns."""
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._tasks = [
            asyncio.ensure_future(self._watch_outbox()),
            asyncio.ensure_future(self._retry_deferred()),
        ]

    async def serve_until_done(self) -> None:
        """Run until :meth:`request_stop` (or ``max_requests`` requests
        have been fully answered), then shut down cleanly."""
        if self._server is None:
            await self.start()
        await self._done.wait()
        await self._shutdown()

    def request_stop(self) -> None:
        self._done.set()

    async def _shutdown(self) -> None:
        assert self._server is not None
        self._server.close()
        await self._server.wait_closed()
        # Let in-flight connection handlers finish writing their last
        # results (wait_closed does not wait for handler coroutines).
        if self._connections:
            await asyncio.wait(self._connections, timeout=30)
        for t in [*self._tasks, *self._connections]:
            t.cancel()
        for t in [*self._tasks, *self._connections]:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def run(self) -> None:
        """Blocking convenience: serve on a fresh event loop."""
        asyncio.run(self.serve_until_done())

    def start_in_thread(self) -> int:
        """Run the front-end on a daemon thread; returns the bound port
        once the socket is listening (for in-process drivers: tests and
        examples/load_gen.py)."""
        ready = threading.Event()

        def _main() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            loop.run_until_complete(self.start())
            ready.set()
            loop.run_until_complete(self.serve_until_done())
            loop.close()

        self._thread = threading.Thread(target=_main, daemon=True)
        self._thread.start()
        if not ready.wait(timeout=60):
            raise RuntimeError("fleet frontend failed to start listening")
        return self.port

    def stop_in_thread(self, timeout_s: float = 60.0) -> None:
        if self._loop is not None and self._thread is not None:
            try:
                self._loop.call_soon_threadsafe(self._done.set)
            except RuntimeError:
                pass  # loop already closed: max_requests ended the serve
            self._thread.join(timeout=timeout_s)

    # ---- request intake ----------------------------------------------
    def _assign_id(self) -> str:
        while True:
            rid = f"{self._prefix}{next(self._ids):05d}"
            if rid not in self._futures and not os.path.exists(
                result_path(self.paths["outbox"], rid)
            ):
                # The outbox check keeps a restarted front-end (whose
                # counter restarts at fl00000 over the same queue dir)
                # from watching a leftover result file and resolving a
                # fresh request with a stale payload.
                return rid

    def _intake(self, payload: dict[str, Any]) -> tuple[str, asyncio.Future]:
        """Admit one decoded request payload; always returns a future
        that resolves to the result JSON (rejections resolve it
        immediately)."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        rid = str(payload.get("request_id") or self._assign_id())
        # Trace context is minted HERE (the fleet's one minting site)
        # before any refusal branch, so even a rejected request gets a
        # closed trace.  A client-supplied trace id is adopted, not
        # replaced: identity travels with the trace.
        trace_id = str(payload.get("trace_id") or mint_trace_id())
        intake_span = str(payload.get("parent_span_id") or mint_span_id())
        payload = {**payload, "request_id": rid, "trace_id": trace_id,
                   "parent_span_id": intake_span}
        self.metrics.inc("qba_intake_requests_total", exemplar=trace_id)
        self.trace_log.emit("intake", trace_id, rid, span_id=intake_span)

        def _refuse(error: str, reason: str,
                    decision_json: dict[str, Any] | None = None) -> None:
            res = EvalResult.failure(rid, error)
            res.trace_id = trace_id
            res.admission = decision_json
            self.trace_log.emit("reject", trace_id, rid, reason=reason)
            self.trace_log.emit("settle", trace_id, rid, outcome="rejected")
            fut.set_result(res.to_json())

        if rid in self._futures:
            _refuse(f"request id already pending: {rid!r}", "duplicate_id")
            return rid, fut
        if os.path.exists(result_path(self.paths["outbox"], rid)):
            # A leftover result under this id (client id reuse, or a
            # previous fleet run over the same queue dir) would resolve
            # this request instantly with the stale payload while the
            # fresh one still executes — refuse instead.
            _refuse(
                f"request id {rid!r} already has a result in the "
                "outbox (id reuse over a live queue dir); pick a "
                "fresh id",
                "stale_result",
            )
            return rid, fut
        try:
            req = EvalRequest.from_json(payload)
        except (ValueError, TypeError) as e:
            _refuse(str(e), "undecodable")
            return rid, fut
        self.requests_seen += 1
        if self.admission is None:
            self._futures[rid] = fut
            self._trace_ids[rid] = trace_id
            self.trace_log.emit("admit", trace_id, rid)
            drop_request(self.paths["inbox"], req.to_json(), rid)
            self._maybe_close_intake()
            return rid, fut
        decision = self.admission.try_admit(req)
        self.metrics.inc(
            "qba_admission_decisions_total",
            labels={"action": str(decision.action),
                    "reason": str(decision.reason or "ok")},
            exemplar=trace_id,
        )
        if decision.action == ADMIT:
            self._futures[rid] = fut
            self._admitted[rid] = decision.to_json()
            self._trace_ids[rid] = trace_id
            self.trace_log.emit("admit", trace_id, rid,
                                reason=decision.reason)
            drop_request(self.paths["inbox"], req.to_json(), rid)
        elif decision.action == DEFER:
            self._futures[rid] = fut
            self._admitted[rid] = decision.to_json()
            self._trace_ids[rid] = trace_id
            self.trace_log.emit("defer", trace_id, rid,
                                reason=decision.reason)
            self._deferred.append(req)
        else:
            _refuse(
                f"rejected: {decision.reason} ({decision.detail})",
                str(decision.reason), decision.to_json(),
            )
        self._maybe_close_intake()
        return rid, fut

    def _maybe_close_intake(self) -> None:
        if (
            self.max_requests is not None
            and self.requests_seen >= self.max_requests
            and not self._futures
            and not self._deferred
        ):
            self._done.set()

    # ---- background pollers ------------------------------------------
    async def _watch_outbox(self) -> None:
        """Route finished results from the outbox back to their
        callers, settling priced capacity as they land."""
        while True:
            landed = []
            for rid in list(self._futures):
                path = result_path(self.paths["outbox"], rid)
                if not os.path.exists(path):
                    continue
                try:
                    with open(path) as f:
                        payload = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue  # racing the writer's rename; next poll wins
                fut = self._futures.pop(rid, None)
                if fut is None or fut.done():
                    continue
                decision = self._admitted.pop(rid, None)
                if decision is not None:
                    payload["admission"] = decision
                if self.admission is not None:
                    self.admission.settle(rid, payload.get("n_trials"))
                    self._release.set()
                self.results_forwarded += 1
                trace_id = self._trace_ids.pop(rid, None) or payload.get(
                    "trace_id"
                )
                outcome = "error" if payload.get("error") else "ok"
                self.metrics.inc("qba_results_forwarded_total",
                                 labels={"outcome": outcome},
                                 exemplar=trace_id)
                for metric, key in (
                    ("qba_request_latency_seconds", "latency_s"),
                    ("qba_request_queue_wait_seconds", "queue_wait_s"),
                ):
                    value = payload.get(key)
                    if isinstance(value, (int, float)):
                        self.metrics.observe(metric, float(value),
                                             exemplar=trace_id)
                self.trace_log.emit("settle", trace_id, rid,
                                    outcome=outcome)
                fut.set_result(payload)
                try:
                    # Consume the result file: a forwarded result left
                    # in outbox/ would answer a future request under a
                    # reused id with this (by then stale) payload, and
                    # the watch loop would keep rereading it.  Moved,
                    # not deleted — fleet_summary() recomputes the
                    # client-experienced latency/queue-wait
                    # distributions from consumed/ + outbox/.
                    # qba-protocol: consume
                    os.replace(
                        path,
                        os.path.join(
                            self.paths["consumed"], os.path.basename(path)
                        ),
                    )
                except OSError:
                    pass
                landed.append(rid)
            if landed:
                self._maybe_close_intake()
            await asyncio.sleep(self.poll_s)

    async def _retry_deferred(self) -> None:
        """Re-run admission for deferred requests (FIFO, head-of-line)
        every time a settle releases capacity."""
        while True:
            await self._release.wait()
            self._release.clear()
            while self._deferred and self.admission is not None:
                req = self._deferred[0]
                # record=False: a still-full retry must not append a
                # DEFER per settle event — the decision ledger stays a
                # pure function of the request stream and settle
                # points, not of settle timing.  Only the retry that
                # resolves (admit or reject) is recorded.
                decision = self.admission.try_admit(req, record=False)
                if decision.action == DEFER:
                    break
                self.admission.record(decision)
                self._deferred.popleft()
                rid = req.request_id
                self._admitted[rid] = decision.to_json()
                trace_id = self._trace_ids.get(rid) or req.trace_id
                self.metrics.inc(
                    "qba_admission_decisions_total",
                    labels={"action": str(decision.action),
                            "reason": str(decision.reason or "ok")},
                    exemplar=trace_id,
                )
                if decision.action == ADMIT:
                    self.trace_log.emit("admit", trace_id, rid,
                                        reason=decision.reason,
                                        deferred=True)
                    drop_request(self.paths["inbox"], req.to_json(), rid)
                else:  # became unservable — resolve the waiting future
                    fut = self._futures.pop(rid, None)
                    self._admitted.pop(rid, None)
                    self._trace_ids.pop(rid, None)
                    self.trace_log.emit("reject", trace_id, rid,
                                        reason=decision.reason)
                    self.trace_log.emit("settle", trace_id, rid,
                                        outcome="rejected")
                    if fut is not None and not fut.done():
                        res = EvalResult.failure(
                            rid,
                            f"rejected: {decision.reason} ({decision.detail})",
                        )
                        res.trace_id = trace_id
                        res.admission = decision.to_json()
                        fut.set_result(res.to_json())
            self._maybe_close_intake()

    # ---- connection handling -----------------------------------------
    async def _handle_connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._connections.add(task)
            task.add_done_callback(self._connections.discard)
        try:
            first = await reader.readline()
            if not first:
                return
            head = first.decode("utf-8", "replace")
            if head.split(" ", 1)[0] in ("GET", "POST", "PUT"):
                await self._handle_http(head, reader, writer)
            else:
                await self._handle_jsonl(head, reader, writer)
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_jsonl(self, first_line: str, reader, writer) -> None:
        """Raw JSONL: results stream back in completion order."""
        lock = asyncio.Lock()  # serialize concurrent result writes
        pending: list[asyncio.Task] = []

        async def forward(fut: asyncio.Future) -> None:
            payload = await fut
            async with lock:
                writer.write((json.dumps(payload) + "\n").encode())
                await writer.drain()

        async def take(raw: str) -> None:
            raw = raw.strip()
            if not raw:
                return
            try:
                payload = json.loads(raw)
                if not isinstance(payload, dict):
                    raise ValueError(
                        f"request must be a JSON object, got {payload!r:.80}"
                    )
            except (json.JSONDecodeError, ValueError) as e:
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                fut.set_result(
                    EvalResult.failure("<undecoded>", str(e)).to_json()
                )
            else:
                _, fut = self._intake(payload)
            pending.append(asyncio.ensure_future(forward(fut)))

        await take(first_line)
        while True:
            line = await reader.readline()
            if not line:
                break
            await take(line.decode("utf-8", "replace"))
        if pending:
            await asyncio.gather(*pending)

    async def _handle_http(self, request_line: str, reader, writer) -> None:
        """Minimal HTTP: ``GET /metrics`` -> Prometheus text,
        ``GET`` anything else -> status JSON; ``POST`` (JSONL body)
        -> 200 with one result line per request."""
        parts = request_line.split(" ")
        method = parts[0]
        path = parts[1] if len(parts) > 1 else "/"
        content_type = b"application/json"
        length = 0
        while True:
            line = await reader.readline()
            if not line or line in (b"\r\n", b"\n"):
                break
            name, _, value = line.decode("utf-8", "replace").partition(":")
            if name.strip().lower() == "content-length":
                try:
                    length = int(value.strip())
                except ValueError:
                    pass
        if method == "GET" and path.split("?", 1)[0] == "/metrics":
            content_type = b"text/plain; version=0.0.4; charset=utf-8"
            body = self.metrics.render().encode()
        elif method == "GET":
            body = json.dumps(self.status(), default=str).encode()
        else:
            raw = await reader.readexactly(length) if length else b""
            futs = []
            for line_text in raw.decode("utf-8", "replace").splitlines():
                if not line_text.strip():
                    continue
                try:
                    payload = json.loads(line_text)
                    if not isinstance(payload, dict):
                        raise ValueError("request must be a JSON object")
                except (json.JSONDecodeError, ValueError) as e:
                    fut: asyncio.Future = (
                        asyncio.get_running_loop().create_future()
                    )
                    fut.set_result(
                        EvalResult.failure("<undecoded>", str(e)).to_json()
                    )
                    futs.append(fut)
                else:
                    futs.append(self._intake(payload)[1])
            results = await asyncio.gather(*futs) if futs else []
            body = "".join(json.dumps(r) + "\n" for r in results).encode()
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: " + content_type + b"\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"Connection: close\r\n\r\n" + body
        )
        await writer.drain()

    # ---- reporting ---------------------------------------------------
    def status(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "requests_seen": self.requests_seen,
            "results_forwarded": self.results_forwarded,
            "pending": len(self._futures),
            "deferred": len(self._deferred),
            "admission": (
                self.admission.summary() if self.admission is not None else None
            ),
        }
        # Per-replica heartbeat staleness in seconds (monotonic now
        # minus last stamp) — reported whether or not a supervisor is
        # attached; with one, the health class rides along.
        ages = heartbeat_ages(self.queue_dir)
        if self.health_provider is not None:
            try:
                replicas = self.health_provider()
                for rid, verdict in replicas.items():
                    if isinstance(verdict, dict):
                        verdict["staleness_s"] = (
                            verdict.get("beat_age_s")
                            if verdict.get("beat_age_s") is not None
                            else ages.get(rid)
                        )
                out["replicas"] = replicas
            except Exception as e:  # status must never take the socket down
                out["replicas"] = {"error": str(e)}
        elif ages:
            out["replicas"] = {
                rid: {"staleness_s": age} for rid, age in sorted(ages.items())
            }
        return out

    # ---- metrics collection ------------------------------------------
    def _collect_queue_metrics(self, reg: MetricsRegistry) -> None:
        """Scrape-time gauges from the queue dir: depth per box,
        dead letters, reclaims, heartbeat staleness, health classes,
        crash-ledger totals.  Read-only — workers publish through the
        files they already write, never a new socket."""
        for box in ("inbox", "claimed", "outbox", "dead", "consumed",
                    "done"):
            try:
                depth = len(os.listdir(self.paths[box]))
            except OSError:
                depth = 0
            reg.set_gauge("qba_queue_files", depth, labels={"box": box})
            if box == "dead":
                reg.set_gauge("qba_queue_dead_letters", depth)
        for rid, age in heartbeat_ages(self.queue_dir).items():
            reg.set_gauge("qba_replica_heartbeat_staleness_seconds",
                          age, labels={"replica": rid})
        reclaims = 0
        try:
            names = os.listdir(self.queue_dir)
        except OSError:
            names = []
        for name in names:
            if name.startswith("summary-") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.queue_dir, name)) as f:
                        reclaims += int(json.load(f).get("reclaimed", 0))
                except (OSError, ValueError, TypeError):
                    pass
        try:
            with open(self.paths["crash_ledger"]) as f:
                ledger = json.load(f)
        except (OSError, ValueError):
            ledger = None
        if isinstance(ledger, dict):
            blame = ledger.get("blame", {})
            if isinstance(blame, dict):
                reclaims += sum(
                    int(e.get("releases", 0)) for e in blame.values()
                    if isinstance(e, dict)
                )
                reg.set_gauge(
                    "qba_supervisor_quarantined",
                    sum(1 for e in blame.values()
                        if isinstance(e, dict) and e.get("quarantined")),
                )
            deaths = ledger.get("deaths")
            if isinstance(deaths, list):
                reg.set_gauge("qba_supervisor_deaths", len(deaths))
        reg.set_gauge("qba_queue_reclaims", reclaims)
        if self.health_provider is not None:
            try:
                states: dict[str, int] = {}
                for verdict in self.health_provider().values():
                    if isinstance(verdict, dict):
                        state = str(verdict.get("state", "unknown"))
                        states[state] = states.get(state, 0) + 1
                for state, count in states.items():
                    reg.set_gauge("qba_fleet_replicas", count,
                                  labels={"state": state})
            except Exception:
                pass
