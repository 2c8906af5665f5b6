"""Request/result model of the evaluation service — a copy of
:mod:`qba_tpu.serve.request`, whose JSON it reads and writes byte for
byte.

An :class:`EvalRequest` is the question "n parties, d traitors,
adversary A: failure probability at sizeL=L?" as a typed,
transport-friendly record.  It exposes only the fields a *caller* owns
(protocol shape, adversary model, trials/seed, engine preference);
everything the engine derives (w, slots, kernel plan) comes back in the
per-request run manifest instead.

Identity contract: :meth:`EvalRequest.config` builds the exact
:class:`~qba_tpu_torch.config.QBAConfig` a direct
:func:`~qba_tpu_torch.backends.torch_backend.run_trials` call would use,
and the server draws the request's trial keys from that config's seed
with the same key-tree recipe, so a served result equals the direct run
trial for trial.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.stats.estimators import success_rate as _success_rate


@dataclasses.dataclass(frozen=True)
class EvalRequest:
    """One evaluation question.  ``request_id`` is caller-chosen and
    opaque; the server echoes it on the result and names the request's
    telemetry directory with it."""

    request_id: str
    n_parties: int
    size_l: int
    n_dishonest: int = 0
    trials: int = 1
    seed: int = 0
    round_engine: str = "auto"
    qsim_path: str = "factorized"
    delivery: str = "sync"
    p_late: float = 0.0
    racy_mode: str = "loss"
    attack_scope: str = "delivery"
    # Adversary zoo + imperfect resources: the strategy is part of the
    # bucket identity, so distinct strategies never share a chunk.
    strategy: str = "reference"
    p_depolarize: float = 0.0
    p_measure_flip: float = 0.0
    tiled_block: int | None = None
    trial_pack: int | None = None
    # Per-request wall-clock deadline (seconds from submit); None defers
    # to the server's default.  An overdue request gets a structured
    # error EvalResult (with manifest) instead of wedging the stream.
    deadline_s: float | None = None
    # Precision target (qba_tpu_torch.stats.parse_target grammar, e.g.
    # "decide vs 1/3 @ 95%" or "ci_width<=0.02"): "run until resolved
    # or deadline".  ``trials`` becomes the budget ceiling; the server
    # stops filling the request once its stopping rule fires and
    # returns the partial prefix with the stop decision (docs/STATS.md).
    target: str | None = None
    # Per-trial decisions are O(trials * n_parties) ints on the wire;
    # callers that only want the rate leave this off.
    return_decisions: bool = False
    # Trace context (docs/OBSERVABILITY.md, schema
    # qba-tpu/trace-context/v1): minted once at the request's origin
    # (fleet frontend intake, or the atlas campaign) and adopted
    # — never re-minted — by every hop downstream.  It rides the
    # queue-file JSON so the worker's root span, the supervisor's
    # lifecycle events, and the settle all stitch into one causal
    # trace.  ``parent_span_id`` is the origin's intake span.
    trace_id: str | None = None
    parent_span_id: str | None = None

    def config(self) -> QBAConfig:
        """The request as a validated config — raises ``ValueError``
        exactly where the CLI would (the transport turns that into an
        error result, not a server crash)."""
        return QBAConfig(
            n_parties=self.n_parties,
            size_l=self.size_l,
            n_dishonest=self.n_dishonest,
            trials=self.trials,
            seed=self.seed,
            round_engine=self.round_engine,
            qsim_path=self.qsim_path,
            delivery=self.delivery,
            p_late=self.p_late,
            racy_mode=self.racy_mode,
            attack_scope=self.attack_scope,
            strategy=self.strategy,
            p_depolarize=self.p_depolarize,
            p_measure_flip=self.p_measure_flip,
            tiled_block=self.tiled_block,
            trial_pack=self.trial_pack,
        )

    def fingerprint(self) -> dict[str, Any]:
        """The manifest-grade config fingerprint (explicit fields plus
        derived shape parameters) — reuses the run-manifest's recipe so
        a request and its manifest agree field for field."""
        from qba_tpu_torch.obs.manifest import config_fingerprint

        return config_fingerprint(self.config())

    def to_json(self) -> dict[str, Any]:
        return {"kind": "eval_request", **dataclasses.asdict(self)}

    @classmethod
    def from_json(cls, payload: dict[str, Any]) -> "EvalRequest":
        """Strict decode: unknown keys are an error (a typo'd field
        silently ignored would answer a different question than asked)."""
        data = dict(payload)
        data.pop("kind", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown request field(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        if "request_id" not in data:
            raise ValueError("request is missing 'request_id'")
        return cls(**data)


@dataclasses.dataclass
class EvalResult:
    """The answer to one :class:`EvalRequest`.

    ``latency_s`` is the request's span duration (submit -> results on
    host), i.e. the span tree IS the latency instrument — the server's
    p50/p99 summary aggregates exactly these spans
    (docs/SERVING.md).  ``manifest`` is the full validated run manifest
    for this request (schema ``qba-tpu/run-manifest/v1``)."""

    request_id: str
    n_trials: int
    successes: int
    success_rate: float
    any_overflow: bool
    latency_s: float
    engine: str  # resolved engine attribution, e.g. "pallas_fused/group"
    bucket: str  # the shape bucket this request dispatched on
    chunks: int  # device chunks this request's trials spanned
    success: list[bool] = dataclasses.field(default_factory=list)
    decisions: list[list[int]] | None = None
    manifest: dict[str, Any] | None = None
    error: str | None = None
    # Precision-targeted requests only: the StopDecision (as JSON) and
    # the anytime-valid rate estimate at stop.  ``n_trials`` is then the
    # trials actually executed (<= the requested budget).
    stop: dict[str, Any] | None = None
    ci: dict[str, Any] | None = None
    # Fleet attribution (docs/SERVING.md "Fleet"): which pool replica
    # served the request, and how long it sat in the shared queue
    # before a worker claimed it — ``latency_s`` minus ``queue_wait_s``
    # is the replica-side (dispatch + device + readback) share.
    replica_id: str | None = None
    queue_wait_s: float | None = None
    # Typed admission decision (qba_tpu_torch.serve.fleet.admission), attached
    # by the front-end: action, reason, and the priced trial capacity.
    admission: dict[str, Any] | None = None
    # Poison-request quarantine (qba_tpu_torch.serve.fleet.supervisor): a
    # request dead-lettered for killing workers carries the structured
    # blame evidence — ``{blamed_replicas, phases, exit_codes,
    # reclaim_count}`` — so the caller learns *why* it will never be
    # retried, not just that it failed.
    crash_report: dict[str, Any] | None = None
    # The request's trace id, echoed back so the caller (and the
    # frontend's settle event) can resolve the stitched trace without
    # a side lookup.
    trace_id: str | None = None

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kind"] = "eval_result"
        return d

    @classmethod
    def from_json(cls, payload: dict[str, Any]) -> "EvalResult":
        data = dict(payload)
        data.pop("kind", None)
        return cls(**data)

    @classmethod
    def failure(cls, request_id: str, error: str) -> "EvalResult":
        """An error reply that still round-trips the transport (bad
        request, engine failure) — the stream keeps flowing."""
        return cls(
            request_id=request_id,
            n_trials=0,
            successes=0,
            # Uniform empty-result handling (stats satellite): nan on
            # zero trials, from the single source of truth.
            success_rate=_success_rate(0, 0),
            any_overflow=False,
            latency_s=0.0,
            engine="",
            bucket="",
            chunks=0,
            error=error,
        )


def decode_request_line(line: str) -> EvalRequest:
    """One JSONL transport line -> request (raises ``ValueError`` on
    malformed JSON or unknown/missing fields)."""
    try:
        payload = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed request JSON: {e}") from None
    if not isinstance(payload, dict):
        raise ValueError(f"request must be a JSON object, got {payload!r:.80}")
    return EvalRequest.from_json(payload)
