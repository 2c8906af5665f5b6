"""The long-lived evaluation engine: double-buffered chunk dispatch —
counterpart of :mod:`qba_tpu.serve.engine`.

Life of a request:

1. **submit** — the request's config is validated, its trial keys are
   derived exactly as a direct run would
   (:func:`~qba_tpu_torch.backends.torch_backend.trial_keys`: a split of
   ``key(seed)``, on the host), and the key table is queued under the
   request's shape bucket.  A per-request :class:`SpanRecorder` opens the
   ``request`` root span here — the latency clock starts at arrival.
2. **dispatch** — full chunks go to the device: the chunk's key rows are
   uploaded as int64 and
   :func:`~qba_tpu_torch.backends.torch_backend.run_trials` runs the
   bucket config on them (on the card under ``auto``: one launch of the
   keyed trial megakernel).  The launches return before the card
   finishes, so the span around them measures host time only and is not
   fenced.
3. **readback** — with ``depth`` chunks in flight, the host reads back
   the *trailing* chunk while the card computes the newer ones: one copy
   of the chunk's decisions, success and overflow, packed on the card at
   dispatch.  The readback span is fenced: it waits for the card.
4. **finish** — when a request's last trial lands (or its precision
   target decides), its root span closes: that duration IS the reported
   latency, and the server's p50/p99 summary aggregates exactly those
   spans.  Each request also gets a validated run manifest.

With ``dispatch="device"`` a targeted request with at least one whole
chunk of budget and no per-trial decisions runs its whole budget as one
device loop over its own key table
(:func:`~qba_tpu_torch.ops.sweep_loop.device_loop_prefix`: one CUDA
graph launch and one readback on the card), on any engine and list
path; a request that asks for per-trial decisions, or whose budget is
under one chunk, takes the host bucket stream.

A chunk whose kernel refuses its shapes, fails to build or fails to
launch becomes an error result for each request it carried, naming the
failure; it is never re-run on the plain versions.  A CUDA fault that
ruins the context propagates and ends the worker, whose claims the next
worker reclaims.  Given a ``cache_dir`` the server restores the saved
shapes from ``<cache_dir>/plans.json`` at boot (building their kernels
and tables, :func:`~qba_tpu_torch.serve.persist.load_plans`) and saves
them back on every flush.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.backends.torch_backend import resolve_device
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.obs.manifest import (
    collect_manifest,
    probe_stats_snapshot,
    validate_manifest,
    write_manifest,
)
from qba_tpu_torch.obs.telemetry import (
    Span,
    SpanRecorder,
    _percentile,
    span_latency_summary,
)
from qba_tpu_torch.ops._build import KernelBuildError
from qba_tpu_torch.ops._launch import KernelLaunchError, KernelUnsupported
from qba_tpu_torch.serve import persist
from qba_tpu_torch.serve.request import EvalRequest, EvalResult
from qba_tpu_torch.serve.scheduler import BucketScheduler, Chunk, bucket_label

# The per-request root span name; the latency summary keys on it.
REQUEST_SPAN = "request"

# What a chunk's kernels raise when they refuse its shapes, fail to
# build or fail to launch with the CUDA context intact.  A fault that
# ruins the context (an illegal address) raises PyTorch's own error,
# which ends the worker: every later chunk would fail with it.
_KERNEL_ERRORS = (KernelBuildError, KernelLaunchError, KernelUnsupported)


@dataclasses.dataclass
class _Active:
    """Server-side state of one in-progress request."""

    req: EvalRequest
    cfg: QBAConfig
    bucket: QBAConfig
    recorder: SpanRecorder
    root_ctx: Any  # open context manager of the root span
    root_span: Span
    probe_before: dict[str, int]
    success: np.ndarray
    overflow: np.ndarray
    arrived: float = 0.0  # time.monotonic() at submit
    deadline_s: float | None = None  # resolved wall-clock budget
    queue_wait_s: float | None = None  # transport wait before submit
    decisions: np.ndarray | None = None  # allocated at first readback
    filled: int = 0
    chunks: int = 0
    # Precision-targeted requests: the parsed target and its live
    # stopping rule.  Sound on the segment stream because the FIFO
    # cursor fills each request's trials as a contiguous prefix — the
    # rule sees exactly the trials [0, filled), in order.
    target: Any = None  # qba_tpu_torch.stats.Target | None
    rule: Any = None  # live stopping rule | None
    # Device early finish: "device" requests bypass the bucket scheduler
    # and run their whole targeted budget as ONE device loop; key_data
    # holds the request's full key table until that dispatch.
    dispatch: str = "host"
    key_data: np.ndarray | None = None

    @property
    def overdue(self) -> bool:
        return (
            self.deadline_s is not None
            and time.monotonic() - self.arrived > self.deadline_s
        )


def request_keys(cfg: QBAConfig) -> np.ndarray:
    """The request's trial keys as the host key table, uint32 ``[trials,
    2]`` (the JAX package's ``key_data`` form): ``split(key(seed),
    trials)``, derived on the CPU before anything is in flight."""
    keys = jr.split(jr.key(cfg.seed, "cpu"), cfg.trials)
    # qba-lint: sync-ok (host data: the key table is derived on the CPU)
    return keys.numpy().astype(np.uint32)


class QBAServer:
    """Persistent evaluation engine on one device (``device=None``: CUDA,
    raising without a card; ``"cpu"`` runs the plain versions).
    Single-threaded by design: one recorder per request keeps span
    nesting well-formed, and the overlap comes from CUDA's asynchronous
    launches, not host threads."""

    def __init__(
        self,
        *,
        chunk_trials: int = 64,
        depth: int = 2,
        telemetry_dir: str | None = None,
        cache_dir: str | None = None,
        warm_start: bool = True,
        deadline_s: float | None = None,
        replica_id: str | None = None,
        dispatch: str = "host",
        device=None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if dispatch not in ("host", "device"):
            raise ValueError(
                f"dispatch must be 'host' or 'device', got {dispatch!r}"
            )
        self.device = resolve_device(device)
        self.scheduler = BucketScheduler(chunk_trials)
        self.depth = depth
        self.deadline_s = deadline_s
        # "device": precision-targeted requests run their whole budget
        # as a single device loop instead of riding the per-chunk bucket
        # stream.  Untargeted requests — and targeted ones that need
        # per-trial decisions or are smaller than one chunk — still
        # take the host path on a device server.
        self.dispatch = dispatch
        self._device_pending: list[str] = []
        # Fleet attribution: stamped on every result, manifest, and
        # request span when this server is one worker of a pool.
        self.replica_id = replica_id
        self._expired = 0
        # Set by the file-queue transport when replica_id is set: a
        # queuefs.HeartbeatWriter stamping the lifecycle phase
        # (compile/dispatch/readback here; idle/claim in the transport
        # loop) and a queuefs.FlightRecorder ring beside it.
        self.heartbeat = None
        self.flight = None
        self.telemetry_dir = telemetry_dir
        self.cache_dir = cache_dir
        self.recorder = SpanRecorder()  # server-level chunk spans
        self.restored_plans = 0
        self._active: dict[str, _Active] = {}
        self._in_flight: list[tuple[Chunk, torch.Tensor]] = []
        self._bucket_decisions: dict[QBAConfig, list[dict]] = {}
        self._served_buckets: list[QBAConfig] = []
        self._request_spans: list[Span] = []
        self._completed = 0
        if cache_dir is not None and warm_start:
            self.restored_plans = persist.load_plans(cache_dir, self.device)

    # ---- intake ------------------------------------------------------
    def submit(
        self, req: EvalRequest, *, queue_wait_s: float | None = None
    ) -> None:
        """Validate and queue one request (the latency clock starts
        here).  ``queue_wait_s`` is the transport-measured wait before
        this submit, echoed on the result.  Raises ``ValueError`` on a
        bad config, a bad target or a duplicate id — transports turn
        that into an error result."""
        if req.request_id in self._active:
            raise ValueError(f"request id already in flight: {req.request_id!r}")
        cfg = req.config()
        target = rule = None
        if req.target is not None:
            from qba_tpu_torch.stats import parse_target

            target = parse_target(req.target)
            rule = target.make_rule()
        # Device early-finish eligibility: a targeted request with at
        # least one whole chunk of budget and no per-trial decision
        # payload.  Everything else takes the host bucket stream.
        device_mode = (
            self.dispatch == "device"
            and target is not None
            and not req.return_decisions
            and cfg.trials >= self.scheduler.chunk_trials
        )
        key_data = request_keys(cfg)
        recorder = SpanRecorder()
        probe_before = probe_stats_snapshot()
        bucket = self.scheduler.bucket_for(cfg)
        span_args: dict[str, Any] = dict(
            request_id=req.request_id,
            bucket=bucket_label(bucket),
            trials=cfg.trials,
            # Wall-clock anchor: SpanRecorder time is perf_counter
            # seconds, meaningless across processes.
            t0_epoch=time.time(),
        )
        if req.trace_id is not None:
            # Adopt — never re-mint — the trace id that rode the queue
            # file from the request's origin.
            span_args["trace_id"] = req.trace_id
        if req.parent_span_id is not None:
            span_args["parent_span_id"] = req.parent_span_id
        if self.replica_id is not None:
            span_args["replica_id"] = self.replica_id
        if queue_wait_s is not None:
            span_args["queue_wait_s"] = queue_wait_s
        if device_mode:
            span_args["dispatch"] = "device"
        root_ctx = recorder.span(REQUEST_SPAN, cat="serve", **span_args)
        root_span = root_ctx.__enter__()
        if device_mode:
            self._device_pending.append(req.request_id)
        else:
            self.scheduler.enqueue(req.request_id, cfg, key_data)
        if bucket not in self._served_buckets:
            self._served_buckets.append(bucket)
        self._active[req.request_id] = _Active(
            req=req,
            cfg=cfg,
            bucket=bucket,
            recorder=recorder,
            root_ctx=root_ctx,
            root_span=root_span,
            probe_before=probe_before,
            success=np.zeros(cfg.trials, dtype=bool),
            overflow=np.zeros(cfg.trials, dtype=bool),
            arrived=time.monotonic(),
            deadline_s=(
                req.deadline_s if req.deadline_s is not None
                else self.deadline_s
            ),
            queue_wait_s=queue_wait_s,
            target=target,
            rule=rule,
            dispatch="device" if device_mode else "host",
            key_data=key_data if device_mode else None,
        )
        if self.flight is not None:
            self.flight.note(
                "submit", request_id=req.request_id,
                trace_id=req.trace_id, bucket=span_args["bucket"],
                trials=cfg.trials,
            )

    # ---- dispatch / drain --------------------------------------------
    def pump(self) -> list[EvalResult]:
        """Dispatch every *full* chunk, draining as the double buffer
        fills; returns requests completed along the way.  Partial
        chunks wait for more same-bucket traffic until :meth:`flush`."""
        done: list[EvalResult] = self.expire_overdue()
        done.extend(self._pump_device())
        while self.scheduler.has_full_chunk():
            chunk = self.scheduler.next_chunk()
            assert chunk is not None
            done.extend(self._dispatch(chunk))
        return done

    def flush(self) -> list[EvalResult]:
        """Dispatch all pending trials (padding partial chunks), drain
        every in-flight chunk, and save the plans."""
        done: list[EvalResult] = self.expire_overdue()
        done.extend(self._pump_device())
        while True:
            chunk = self.scheduler.next_chunk()
            if chunk is None:
                break
            done.extend(self._dispatch(chunk))
        while self._in_flight:
            done.extend(self._drain_one())
        if self.cache_dir is not None:
            persist.save_plans(self.cache_dir, self._served_buckets,
                               device=self.device)
        return done

    def expire_overdue(self) -> list[EvalResult]:
        """Turn every request past its wall-clock deadline into a
        structured error result NOW — still-queued trials are cancelled,
        in-flight ones compute but their readback segments are
        discarded.  This runs at the head of every :meth:`pump` and
        :meth:`flush`."""
        overdue = [ar for ar in self._active.values() if ar.overdue]
        return [
            self._abort(
                ar,
                f"deadline exceeded: {ar.deadline_s}s wall clock, "
                f"{ar.filled}/{ar.cfg.trials} trials complete",
                expired=True,
            )
            for ar in overdue
        ]

    def _abort(self, ar: _Active, error: str, *, expired: bool) -> EvalResult:
        """Close ``ar`` with an error result: its deadline expired or a
        chunk of it failed.  Still-queued trials are cancelled; the
        result carries the validated manifest and how far it got."""
        from qba_tpu_torch.stats.estimators import rate_estimate

        self.scheduler.cancel(ar.req.request_id)
        if ar.req.request_id in self._device_pending:
            self._device_pending.remove(ar.req.request_id)
        del self._active[ar.req.request_id]
        ar.root_ctx.__exit__(None, None, None)
        self._request_spans.append(ar.root_span)
        if expired:
            self._expired += 1
        latency = float(ar.root_span.dur or 0.0)
        label = bucket_label(ar.bucket)
        # qba-lint: sync-ok (host data: the request's success bits)
        k_part = int(ar.success[: ar.filled].sum())
        stats_block: dict[str, Any] = {
            "success_rate": rate_estimate(k_part, ar.filled).to_json(),
            "trials_requested": ar.cfg.trials,
            "trials_completed": ar.filled,
        }
        if ar.target is not None:
            stats_block["target"] = ar.target.to_json()
            stats_block["stop"] = None  # the rule did not stop it
        extra = {
            "request_id": ar.req.request_id,
            "bucket": label,
            "latency_s": latency,
            "chunks": ar.chunks,
            "restored_plans": self.restored_plans,
            "expired": expired,
            "trials_completed": ar.filled,
            "stats": stats_block,
            **self._attribution(ar),
        }
        if not expired:
            extra["error"] = error
        manifest = validate_manifest(
            collect_manifest(
                ar.cfg,
                device=self.device,
                command="serve",
                decisions=self._bucket_decisions.get(ar.bucket, []),
                probe_stats_before=ar.probe_before,
                spans=ar.recorder,
                extra=extra,
            )
        )
        if self.telemetry_dir is not None:
            self._write_telemetry(ar, manifest)
        res = EvalResult.failure(ar.req.request_id, error)
        res.latency_s = latency
        res.bucket = label
        res.chunks = ar.chunks
        res.manifest = manifest
        res.replica_id = self.replica_id
        res.queue_wait_s = ar.queue_wait_s
        res.trace_id = ar.req.trace_id
        if ar.rule is not None and ar.filled:
            # Partial-progress estimate: anytime-valid over the prefix it
            # did complete.
            res.ci = ar.rule.estimate().to_json()
        return res

    def close(self) -> list[EvalResult]:
        return self.flush()

    def _attribution(self, ar: _Active) -> dict[str, Any]:
        """Fleet attribution fields for a request's manifest extra."""
        out: dict[str, Any] = {}
        if self.replica_id is not None:
            out["replica_id"] = self.replica_id
        if ar.queue_wait_s is not None:
            out["queue_wait_s"] = ar.queue_wait_s
        return out

    @property
    def busy(self) -> bool:
        """True while any trial is queued or any chunk is in flight."""
        return (
            bool(self._in_flight)
            or bool(self._device_pending)
            or self.scheduler.pending_trials() > 0
        )

    @property
    def backlog_trials(self) -> int:
        """Trials accepted but not yet read back: queued in the
        scheduler plus in-flight chunks (padded) plus device-pending
        targeted budgets — the file-queue transport's watermark."""
        device_pending = sum(
            self._active[rid].cfg.trials
            for rid in self._device_pending
            if rid in self._active
        )
        return (
            self.scheduler.pending_trials()
            + len(self._in_flight) * self.scheduler.chunk_trials
            + device_pending
        )

    def _phase(self, bucket: QBAConfig) -> str:
        """``"compile"`` for a bucket's first dispatch (on the card it
        builds and loads the kernels), else ``"dispatch"``."""
        return "compile" if bucket not in self._bucket_decisions else "dispatch"

    # ---- device early finish -----------------------------------------
    def _pump_device(self) -> list[EvalResult]:
        """Run every device-pending targeted request to its stop chunk,
        one device loop each (requests already expired are skipped)."""
        done: list[EvalResult] = []
        pending, self._device_pending = self._device_pending, []
        for rid in pending:
            ar = self._active.get(rid)
            if ar is not None:
                done.append(self._run_device(ar))
        return done

    def _run_device(self, ar: _Active) -> EvalResult:
        """One targeted request as ONE device loop
        (:func:`~qba_tpu_torch.ops.sweep_loop.device_loop_prefix`) over
        the request's own key table: the device decides when to stop,
        and the host reads back the counts and per-trial success bits
        once.  The budget is floor-quantized to whole chunks
        (``trials // chunk_trials``); the host replay of the per-chunk
        counts through the request's rule reaches the same StopDecision
        the host segment stream would have at that chunk boundary."""
        from qba_tpu_torch.diagnostics import (
            QBAWarning,
            record_decisions,
            warn_and_record,
        )
        from qba_tpu_torch.ops.sweep_loop import (
            GraphLoopError,
            device_loop_prefix,
        )
        from qba_tpu_torch.stats.device import stop_tables

        ct = self.scheduler.chunk_trials
        n_chunks = ar.cfg.trials // ct
        label = bucket_label(ar.bucket)
        assert ar.key_data is not None
        if self.heartbeat is not None:
            self.heartbeat.beat(self._phase(ar.bucket), [ar.req.request_id])
        lo, hi = stop_tables(ar.target, n_chunks, ct)
        try:
            with record_decisions() as decisions:
                with ar.recorder.span(
                    "serve.device_loop", cat="serve", bucket=label,
                    budget_chunks=n_chunks, chunk_trials=ct,
                ) as sp:
                    keys = torch.from_numpy(
                        ar.key_data[: n_chunks * ct].astype(np.int64)
                    ).to(self.device)
                    # The loop's one readback ends inside: fenced.
                    i_stop, counts_h, ovf_h, succ_h, info = (
                        device_loop_prefix(ar.bucket, n_chunks, ct, keys,
                                           lo, hi, self.device))
                    sp.fenced = True
                    sp.args.update(info)
        except (*_KERNEL_ERRORS, GraphLoopError) as e:
            return self._abort(
                ar, f"device loop of bucket {label} failed: "
                f"{type(e).__name__}: {e}", expired=False)
        if ar.bucket not in self._bucket_decisions:
            self._bucket_decisions[ar.bucket] = list(decisions)
        dec = None
        for c in range(i_stop):
            ar.success[c * ct : (c + 1) * ct] = succ_h[c * ct : (c + 1) * ct]
            # qba-lint: sync-ok (host data: the loop's readback)
            ar.overflow[c * ct : (c + 1) * ct] = bool(ovf_h[c])
            ar.filled += ct
            ar.chunks += 1
            # qba-lint: sync-ok (host data: the loop's readback)
            ar.rule.observe(int(counts_h[c]), ct)
            dec = ar.rule.decision()
            if dec is not None:
                break
        # A decision landing exactly on the final budget chunk is
        # consistent: the loop exits on i == n_chunks either way.
        if ar.chunks != i_stop or (dec is None and i_stop < n_chunks):
            warn_and_record(
                "serve device stop diverged from the host rule: device "
                f"stopped after {i_stop} chunks, host replay after "
                f"{ar.chunks}",
                QBAWarning,
                site="serve._run_device",
                device_stop=i_stop,
                host_stop=ar.chunks,
            )
        return self._finish(
            ar, stop=dec if dec is not None else ar.rule.exhausted()
        )

    def _dispatch(self, chunk: Chunk) -> list[EvalResult]:
        from qba_tpu_torch.backends.torch_backend import run_trials
        from qba_tpu_torch.diagnostics import record_decisions

        label = bucket_label(chunk.bucket)
        rids = sorted({seg.request_id for seg in chunk.segments})
        phase = self._phase(chunk.bucket)
        if self.heartbeat is not None:
            self.heartbeat.beat(phase, rids)
        if self.flight is not None:
            self.flight.note(phase, bucket=label, chunk=chunk.index,
                             request_ids=rids)
        try:
            with record_decisions() as decisions:
                with self.recorder.span(
                    "serve.dispatch", cat="serve", bucket=label,
                    chunk=chunk.index, trials=chunk.used,
                    padded=self.scheduler.chunk_trials - chunk.used,
                    # The label leaves the list generation out.
                    qsim_path=chunk.bucket.qsim_path,
                ):
                    keys = torch.from_numpy(chunk.key_data.astype(np.int64))
                    if self.device.type == "cuda":
                        # From pinned memory the upload queues behind the
                        # chunks in flight instead of waiting for them.
                        keys = keys.pin_memory().to(self.device,
                                                    non_blocking=True)
                    trials = run_trials(chunk.bucket, keys,
                                        device=self.device).trials
                    # One packed tensor: the readback is one copy.
                    packed = torch.cat(
                        [trials.decisions.to(torch.int32),
                         trials.success[:, None].to(torch.int32),
                         trials.overflow[:, None].to(torch.int32)], dim=1)
        except _KERNEL_ERRORS as e:
            return self._fail_chunk(chunk, e)
        if chunk.bucket not in self._bucket_decisions:
            # First dispatch of this bucket: every request served from it
            # carries the decisions recorded then in its manifest.
            self._bucket_decisions[chunk.bucket] = list(decisions)
        self._in_flight.append((chunk, packed))
        done: list[EvalResult] = []
        # Double buffer: keep up to depth-1 newer chunks computing on
        # the device while the oldest one is read back on the host.
        while len(self._in_flight) > self.depth - 1:
            done.extend(self._drain_one())
        return done

    def _fail_chunk(self, chunk: Chunk, exc: Exception) -> list[EvalResult]:
        """Every request ``chunk`` carried, as an error result naming the
        failure (a kernel that refused the chunk, did not build or did not
        launch)."""
        error = (f"chunk {chunk.index} of bucket {bucket_label(chunk.bucket)} "
                 f"failed at dispatch: {type(exc).__name__}: {exc}")
        return [self._abort(self._active[rid], error, expired=False)
                for rid in dict.fromkeys(s.request_id for s in chunk.segments)
                if rid in self._active]

    def _drain_one(self) -> list[EvalResult]:
        chunk, packed = self._in_flight.pop(0)
        label = bucket_label(chunk.bucket)
        rids = sorted({seg.request_id for seg in chunk.segments})
        if self.heartbeat is not None:
            self.heartbeat.beat("readback", rids)
        if self.flight is not None:
            self.flight.note("readback", bucket=label, chunk=chunk.index,
                             request_ids=rids)
        with self.recorder.span(
            "serve.readback", cat="serve", bucket=label, chunk=chunk.index
        ) as sp:
            # The one copy waits for the card: fenced.
            host = packed.cpu().numpy()
            sp.fenced = True
        decisions = host[:, :-2]
        success = host[:, -2].astype(bool)
        overflow = host[:, -1].astype(bool)
        done: list[EvalResult] = []
        for seg in chunk.segments:
            ar = self._active.get(seg.request_id)
            if ar is None:
                # Request expired (deadline) or resolved between dispatch
                # and readback — its computed rows are discarded.
                continue
            with ar.recorder.span(
                "serve.chunk", cat="serve",
                chunk=chunk.index, trials=seg.length, bucket=label,
            ):
                if ar.decisions is None:
                    ar.decisions = np.zeros(
                        (ar.cfg.trials,) + decisions.shape[1:], decisions.dtype
                    )
                dst = slice(seg.req_start, seg.req_start + seg.length)
                src = slice(seg.chunk_start, seg.chunk_start + seg.length)
                ar.success[dst] = success[src]
                ar.decisions[dst] = decisions[src]
                ar.overflow[dst] = overflow[src]
            ar.filled += seg.length
            ar.chunks += 1
            if ar.rule is not None:
                # The segment extended the request's contiguous prefix to
                # [0, filled): the rule sees chunk counts in trial order.
                # qba-lint: sync-ok (host data: the chunk's readback)
                ar.rule.observe(int(success[src].sum()), seg.length)
            if ar.filled == ar.cfg.trials:
                done.append(self._finish(ar))
            elif (
                ar.rule is not None and (dec := ar.rule.decision()) is not None
            ):
                # Resolved early: cancel the still-queued trials and
                # answer now with the partial prefix + stop decision.
                self.scheduler.cancel(ar.req.request_id)
                done.append(self._finish(ar, stop=dec))
        return done

    def _finish(self, ar: _Active, stop=None) -> EvalResult:
        """Close a request: complete (``filled == trials``) or resolved
        early by its precision target (``stop`` from the rule).  The
        result covers exactly the contiguous prefix ``[0, filled)``."""
        from qba_tpu_torch.benchmark import engine_description
        from qba_tpu_torch.stats.estimators import rate_estimate
        from qba_tpu_torch.stats.estimators import success_rate as _success_rate

        if ar.rule is not None and stop is None:
            # A targeted request that filled its whole budget: the rule
            # fired exactly at the end or reports budget_exhausted.
            dec = ar.rule.decision()
            stop = dec if dec is not None else ar.rule.exhausted()
        del self._active[ar.req.request_id]
        ar.root_ctx.__exit__(None, None, None)
        self._request_spans.append(ar.root_span)
        self._completed += 1
        latency = float(ar.root_span.dur or 0.0)
        label = bucket_label(ar.bucket)
        n_done = ar.filled
        # qba-lint: sync-ok (host data: the request's results)
        k_done = int(ar.success[:n_done].sum())
        # Every manifest carries a certified rate: point estimate + CI.
        stats_block: dict[str, Any] = {
            "success_rate": rate_estimate(k_done, n_done).to_json(),
            "trials_requested": ar.cfg.trials,
            "trials_completed": n_done,
        }
        if ar.target is not None:
            stats_block["target"] = ar.target.to_json()
            stats_block["stop"] = stop.to_json() if stop is not None else None
        if ar.dispatch == "device":
            stats_block["dispatch"] = "device"
        manifest = validate_manifest(
            collect_manifest(
                ar.cfg,
                device=self.device,
                command="serve",
                decisions=self._bucket_decisions.get(ar.bucket, []),
                probe_stats_before=ar.probe_before,
                spans=ar.recorder,
                extra={
                    "request_id": ar.req.request_id,
                    "bucket": label,
                    "latency_s": latency,
                    "chunks": ar.chunks,
                    "restored_plans": self.restored_plans,
                    "stats": stats_block,
                    **self._attribution(ar),
                },
            )
        )
        if self.telemetry_dir is not None:
            self._write_telemetry(ar, manifest)
        if self.flight is not None:
            self.flight.note(
                "finish", request_id=ar.req.request_id,
                trace_id=ar.req.trace_id, latency_s=latency,
            )
        # The device loop never materializes per-trial decisions — its
        # eligibility gate already excluded return_decisions requests.
        assert ar.decisions is not None or not ar.req.return_decisions
        return EvalResult(
            request_id=ar.req.request_id,
            n_trials=n_done,
            successes=k_done,
            success_rate=_success_rate(k_done, n_done),
            # qba-lint: sync-ok (host data: the request's results)
            any_overflow=bool(ar.overflow[:n_done].any()),
            latency_s=latency,
            engine=engine_description(ar.cfg, self.device),
            bucket=label,
            chunks=ar.chunks,
            success=[bool(x) for x in ar.success[:n_done]],
            decisions=(
                # qba-lint: sync-ok (host data: the request's results)
                ar.decisions[:n_done].tolist()
                if ar.req.return_decisions and ar.decisions is not None
                else None
            ),
            manifest=manifest,
            stop=stop.to_json() if stop is not None else None,
            ci=(
                stop.estimate.to_json()
                if stop is not None and stop.estimate is not None
                else None
            ),
            replica_id=self.replica_id,
            queue_wait_s=ar.queue_wait_s,
            trace_id=ar.req.trace_id,
        )

    def _write_telemetry(self, ar: _Active, manifest: dict) -> None:
        slug = "".join(
            c if c.isalnum() or c in "-_." else "_" for c in ar.req.request_id
        ) or "request"
        directory = os.path.join(self.telemetry_dir or ".", slug)
        os.makedirs(directory, exist_ok=True)
        write_manifest(os.path.join(directory, "run_manifest.json"), manifest)
        ar.recorder.write_jsonl(os.path.join(directory, "spans.jsonl"))
        ar.recorder.write_chrome_trace(os.path.join(directory, "trace.json"))

    # ---- reporting ---------------------------------------------------
    def latency_summary(
        self, percentiles: tuple[float, ...] = (50.0, 99.0)
    ) -> dict[str, Any]:
        """p50/p99 (etc.) over completed requests, computed from the
        closed ``request`` spans themselves."""
        return span_latency_summary(
            self._request_spans, REQUEST_SPAN, percentiles
        )

    def queue_wait_summary(
        self, percentiles: tuple[float, ...] = (50.0, 99.0)
    ) -> dict[str, Any]:
        """Distribution of transport queue waits across finished
        requests (the ``queue_wait_s`` arg on each ``request`` span)."""
        waits = sorted(
            float(sp.args["queue_wait_s"])
            for sp in self._request_spans
            if "queue_wait_s" in sp.args
        )
        summary: dict[str, Any] = {"count": len(waits)}
        if not waits:
            return summary
        summary["mean_s"] = sum(waits) / len(waits)
        summary["max_s"] = waits[-1]
        for q in percentiles:
            summary[f"p{q:g}_s"] = _percentile(waits, q)
        return summary

    def stats(self) -> dict[str, Any]:
        from qba_tpu_torch.ops import kernel_launches
        from qba_tpu_torch.ops._build import build_dir, loaded_libraries

        return {
            "replica_id": self.replica_id,
            "dispatch": self.dispatch,
            "device": str(self.device),
            "completed": self._completed,
            "expired": self._expired,
            "in_flight_chunks": len(self._in_flight),
            "pending_trials": self.scheduler.pending_trials(),
            "buckets": [bucket_label(b) for b in self._served_buckets],
            "restored_plans": self.restored_plans,
            "latency": self.latency_summary(),
            "queue_wait": self.queue_wait_summary(),
            # In place of the JAX package's resolver caches: the kernels'
            # build directory, the libraries this process loaded and
            # each kernel's launches.
            "resolver": {"build_dir": str(build_dir()),
                         "kernels_loaded": loaded_libraries(),
                         "kernel_launches": kernel_launches()},
        }


def serve_batch(server: QBAServer, requests: list[EvalRequest]) -> list[EvalResult]:
    """Convenience in-process loop: submit everything, pump as full
    chunks form, flush at the end.  Bad requests become error results;
    result order is completion order (error results appear at the point
    of rejection)."""
    results: list[EvalResult] = []
    for req in requests:
        try:
            server.submit(req)
        except (ValueError, TypeError) as e:
            rid = getattr(req, "request_id", "<unknown>")
            results.append(EvalResult.failure(str(rid), str(e)))
            continue
        results.extend(server.pump())
    results.extend(server.flush())
    return results
