"""Target-aware admission: price a request before it touches the queue —
a copy of :mod:`qba_tpu.serve.fleet.admission` priced by the port's own
memory model.

The front end must not let traffic wedge the pool: a shape whose
per-trial footprint leaves less than one chunk on one device can never
execute (:func:`qba_tpu_torch.analysis.memory.trial_ceiling`), and a
burst of huge trial budgets would bury small requests in queue wait.  So
every request is **priced** before it is enqueued:

* the price is the request's trial budget, discounted by its precision
  target when it has one (:meth:`qba_tpu_torch.stats.Target.
  planning_trials`: the Wald expected-sample-size bound, quantized up
  to whole device chunks, since the scheduler dispatches chunk-granular
  work);
* the controller keeps a live ledger of priced-but-unfinished trials
  against a fleet-wide capacity window (``replicas × window_chunks ×
  chunk_trials`` by default) and **admits**, **defers** (capacity is
  temporarily full: retry after a release), or **rejects** (the request
  can never be served: invalid, unservable shape, or bigger than the
  whole window) with a typed reason;
* :meth:`AdmissionController.settle` releases a request's priced
  capacity when its result lands; an early-stopped target releases the
  *unused* remainder to the next tenant at the same moment.

Decisions are a pure function of the request sequence and settle
points (no clocks, no randomness), so a fixed stream always yields the
same decision list, and the JAX package's controller yields the same
list for it wherever the memory ceiling does not bind.  The device's
memory is the caller's ``hbm_bytes`` (the fleet reads it with
``nvidia-smi``, :func:`~qba_tpu_torch.analysis.memory.
device_memory_bytes`), and ``device`` is the one its workers run on,
for which the ceiling prices the engine they resolve; nothing here
opens a device.  The port's worker
serves no mesh: a ``tp > 1`` mesh raises and names ROADMAP A12b.
"""

from __future__ import annotations

import dataclasses
from typing import Any

#: Decision vocabulary: ``action`` is one of ADMIT/DEFER/REJECT and
#: ``reason`` one of REASONS (typed, so callers can switch on it).
ADMIT = "admit"
DEFER = "defer"
REJECT = "reject"

REASONS = (
    "capacity_available",  # admit: priced trials fit the live window
    "window_full",  # defer: retry once in-flight work settles
    "invalid_request",  # reject: config/target failed validation
    "unservable_shape",  # reject: memory ceiling below one chunk
    "oversized_request",  # reject: price exceeds the whole fleet window
)


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """One typed admission verdict, echoed on the wire
    (``EvalResult.admission``) and into the fleet summary."""

    action: str
    reason: str
    request_id: str
    bucket: str = ""
    priced_trials: int = 0
    outstanding_trials: int = 0  # ledger total AFTER this decision
    capacity_trials: int = 0
    detail: str = ""

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class AdmissionController:
    """Live capacity ledger + pricing for one fleet front-end.

    ``capacity_trials`` is the fleet-wide outstanding-work window: how
    many priced trials may be admitted-but-unsettled at once.  The
    default models each replica holding ``window_chunks`` chunks of
    work (its double-buffer depth plus queue headroom); the CLI exposes
    it directly for operators with measured numbers.
    """

    def __init__(
        self,
        *,
        chunk_trials: int = 64,
        replicas: int = 1,
        capacity_trials: int | None = None,
        window_chunks: int = 8,
        hbm_bytes: int,
        device: str = "cuda",
        mesh_shape: tuple[int, int] | None = None,
    ) -> None:
        if chunk_trials < 1:
            raise ValueError(f"chunk_trials must be >= 1, got {chunk_trials}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if mesh_shape is not None:
            dp, tp = mesh_shape
            if dp < 1 or tp < 1:
                raise ValueError(
                    f"mesh_shape must be (dp >= 1, tp >= 1), got {mesh_shape}"
                )
            if tp > 1:
                raise ValueError(
                    f"mesh_shape {mesh_shape}: the port's worker serves no "
                    "tp mesh, so admission has no sharded ceiling to price "
                    "against (ROADMAP A12b)"
                )
            mesh_shape = (dp, tp)
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.mesh_shape = mesh_shape
        self.device = device
        self.chunk_trials = chunk_trials
        self.replicas = replicas
        self.capacity_trials = (
            capacity_trials
            if capacity_trials is not None
            else replicas * window_chunks * chunk_trials
        )
        self.hbm_bytes = hbm_bytes
        self._outstanding: dict[str, int] = {}  # request_id -> priced
        self._ceilings: dict[str, int] = {}  # bucket label -> ceiling
        self.decisions: list[AdmissionDecision] = []
        self.released_trials = 0  # settled price, incl. early-stop refunds
        # Degraded-mode accounting: the supervisor's crash-loop breaker
        # shrinks the window when it benches a replica, so admission
        # keeps pricing against capacity that actually exists.
        self._base_capacity = self.capacity_trials
        self._benched: set[str] = set()
        # Batch-hint state (campaign drivers): request ids whose first
        # batch-mode DEFER is already on the ledger, so re-polls of the
        # same still-deferred id stay silent until it resolves.
        self._batch_deferred: set[str] = set()

    @property
    def outstanding_trials(self) -> int:
        return sum(self._outstanding.values())

    # ---- pricing -----------------------------------------------------
    def _chunk_quantize(self, trials: int) -> int:
        chunks = -(-trials // self.chunk_trials)
        return chunks * self.chunk_trials

    def price(self, req) -> tuple[int, str]:
        """(priced_trials, detail) for one request: the trial budget,
        target-discounted, rounded up to whole device chunks."""
        if req.target is None:
            return self._chunk_quantize(req.trials), "full budget"
        from qba_tpu_torch.stats import parse_target

        target = parse_target(req.target)
        planned = target.planning_trials(req.trials)
        return (
            self._chunk_quantize(planned),
            f"target plans {planned} of {req.trials} budget trials",
        )

    def _ceiling(self, req) -> int:
        """Trial ceiling for the request's shape bucket on one device,
        memoized per bucket label (the ceiling is pure shape
        arithmetic)."""
        from qba_tpu_torch.analysis.memory import trial_ceiling
        from qba_tpu_torch.serve.scheduler import bucket_config, bucket_label

        bucket = bucket_config(req.config(), self.chunk_trials)
        label = bucket_label(bucket)
        if label not in self._ceilings:
            self._ceilings[label] = trial_ceiling(bucket, self.hbm_bytes,
                                                  self.device)
        return self._ceilings[label]

    # ---- the decision ------------------------------------------------
    def try_admit(
        self, req, *, record: bool = True, batch: bool = False
    ) -> AdmissionDecision:
        """Price and decide one request.  ``admit`` records the price
        in the ledger (the caller MUST eventually :meth:`settle`);
        ``defer`` and ``reject`` leave the ledger untouched.

        ``record=False`` keeps the decision out of :attr:`decisions`
        (the ledger still mutates on admit) — the front-end's deferred
        retry loop uses it so a still-full re-poll of the deferred
        head doesn't append a DEFER per settle event: the decision
        list stays a pure function of the request stream and settle
        points, not of settle *timing*.  A retry that resolves
        (admit/reject) is recorded by the caller via :meth:`record`.

        ``batch=True`` is the campaign-driver hint (retry contract in
        the atlas campaign driver): a driver submitting
        hundreds of cells re-offers every still-open cell each round,
        so per-rid only the FIRST ``defer/window_full`` is recorded —
        later re-offers of the same deferred id return the live
        verdict without touching the decision list until the id
        resolves (admit or reject), which is recorded and clears the
        id.  The recorded ledger therefore stays a pure function of
        the distinct request stream and settle points, however many
        times the driver polls.
        """
        rid = req.request_id
        dec = self._evaluate(req)
        if batch and record:
            if dec.action == DEFER:
                if rid in self._batch_deferred:
                    record = False  # re-offer of a recorded defer: silent
                else:
                    self._batch_deferred.add(rid)
            else:
                # The deferred id resolved (admit or reject): record it
                # and forget the defer so a future re-submission of the
                # same id starts fresh.
                self._batch_deferred.discard(rid)
        if record:
            self.decisions.append(dec)
        return dec

    def _evaluate(self, req) -> AdmissionDecision:
        """Price and decide without touching the decision list (the
        ledger of outstanding trials still mutates on admit) — the
        single decision procedure behind plain, retry (``record=
        False``), and batch admission."""
        from qba_tpu_torch.serve.scheduler import bucket_config, bucket_label

        rid = req.request_id
        try:
            label = bucket_label(bucket_config(req.config(), self.chunk_trials))
            ceiling = self._ceiling(req)
            priced, detail = self.price(req)
        except ValueError as e:
            return self._decide(
                REJECT, "invalid_request", rid, detail=str(e), record=False
            )
        if ceiling < self.chunk_trials:
            return self._decide(
                REJECT, "unservable_shape", rid, bucket=label, priced=priced,
                detail=(
                    f"trial ceiling {ceiling} < chunk_trials "
                    f"{self.chunk_trials}: one chunk of this shape "
                    f"exhausts the {self.hbm_bytes} B of one device"
                ),
                record=False,
            )
        if priced > self.capacity_trials:
            return self._decide(
                REJECT, "oversized_request", rid, bucket=label, priced=priced,
                detail=(
                    f"priced {priced} trials > fleet window "
                    f"{self.capacity_trials}: would wedge every other tenant"
                ),
                record=False,
            )
        if self.outstanding_trials + priced > self.capacity_trials:
            return self._decide(
                DEFER, "window_full", rid, bucket=label, priced=priced,
                detail=(
                    f"{self.outstanding_trials} trials outstanding; retry "
                    "after a release"
                ),
                record=False,
            )
        self._outstanding[rid] = priced
        return self._decide(
            ADMIT, "capacity_available", rid, bucket=label, priced=priced,
            detail=detail, record=False,
        )

    def record(self, decision: AdmissionDecision) -> None:
        """Append a decision obtained with ``try_admit(record=False)``
        to the ledger — the retry loop's way of recording only the
        final verdict of a deferred request, not every failed poll."""
        self.decisions.append(decision)

    def bench_replica(self, replica_id: str) -> int:
        """Release one benched replica's share of the capacity window
        (the supervisor's crash-loop breaker): with a
        slot permanently out of service, admitting against its share
        would queue requests against phantom capacity.  The share is
        the per-replica slice of the *initial* window; returns the
        trials actually released (0 on a repeat bench of the same id).
        Deterministic like every other decision input: the window is a
        pure function of the bench events, not of time."""
        if replica_id in self._benched:
            return 0
        self._benched.add(replica_id)
        share = min(self._base_capacity // self.replicas, self.capacity_trials)
        self.capacity_trials -= share
        return share

    def settle(self, request_id: str, executed_trials: int | None = None) -> int:
        """Release a finished request's priced capacity; returns the
        trials released.  ``executed_trials`` (from the result) lets
        the summary report how much of the price an early stop
        refunded — the release itself is always the full price, which
        is what makes deferred admits retry-able the moment any
        tenant finishes."""
        priced = self._outstanding.pop(request_id, 0)
        self.released_trials += priced
        return priced

    def _decide(
        self,
        action: str,
        reason: str,
        rid: str,
        *,
        bucket: str = "",
        priced: int = 0,
        detail: str = "",
        record: bool = True,
    ) -> AdmissionDecision:
        assert reason in REASONS, reason
        dec = AdmissionDecision(
            action=action,
            reason=reason,
            request_id=rid,
            bucket=bucket,
            priced_trials=priced,
            outstanding_trials=self.outstanding_trials,
            capacity_trials=self.capacity_trials,
            detail=detail,
        )
        if record:
            self.decisions.append(dec)
        return dec

    def summary(self) -> dict[str, Any]:
        """Decision counts + ledger state for the fleet summary."""
        by_action: dict[str, int] = {}
        by_reason: dict[str, int] = {}
        for dec in self.decisions:
            by_action[dec.action] = by_action.get(dec.action, 0) + 1
            by_reason[dec.reason] = by_reason.get(dec.reason, 0) + 1
        return {
            "decisions": len(self.decisions),
            "by_action": by_action,
            "by_reason": by_reason,
            "capacity_trials": self.capacity_trials,
            "base_capacity_trials": self._base_capacity,
            "benched_replicas": sorted(self._benched),
            "outstanding_trials": self.outstanding_trials,
            "released_trials": self.released_trials,
            "bucket_ceilings": dict(self._ceilings),
            "mesh_shape": (
                list(self.mesh_shape) if self.mesh_shape is not None else None
            ),
            # The JAX controller's default; the port prices no tp mesh
            # (ROADMAP A12b), so no comms pattern enters a price.
            "tp_comms": "ring",
        }
