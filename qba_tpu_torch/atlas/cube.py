"""Campaign spec + 4-D cube enumeration — a copy of
:mod:`qba_tpu.atlas.cube` on the port's request model and config.

A campaign is the cube (parties × dishonest × strategy × noise) at one
protocol depth ``size_l``, one seed, and one precision target.  This
module turns a :class:`CampaignSpec` into the deterministic, deduped
list of :class:`AtlasCell`\\ s the driver admits — each cell carrying
the validated :class:`~qba_tpu_torch.config.QBAConfig`, its sweep-dialect
config fingerprint, and the content-address key the store files it
under.

Determinism contract: ``enumerate_cells`` is a pure function of the
spec — same spec, same cell list in the same order, with the same
keys.  Campaign resume depends on this: a restarted driver re-derives
the cube and reconciles it against the ledger instead of trusting any
in-memory state.  The cells' keys are the JAX package's for the same
spec, so either package's campaign fills the other's store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Sequence

from qba_tpu_torch.atlas.store import canonical_json, cell_key
from qba_tpu_torch.serve.request import EvalRequest

CAMPAIGN_SPEC_SCHEMA = "qba-tpu/atlas-spec/v1"


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """The four axes plus execution policy for one atlas campaign.

    ``dishonest`` entries are either absolute traitor counts (integral
    values) or fractions of ``n_parties`` (values in (0, 1), floored
    per party count — ``1/3`` enumerates the paper's resilience
    boundary at every n).  Entries exceeding a given ``n`` are skipped
    for that n; duplicates collapsing to the same (n, d) are deduped.

    ``budget_trials`` is the wave-0 per-cell trial budget; a cell whose
    stopping rule is still unresolved at budget exhaustion escalates:
    its budget multiplies by ``escalation`` up to ``max_escalations``
    times before the campaign records an explicit truncation refusal.
    Frontier cells are exactly the ones that escalate — the allocator's
    straddling tier ranks them first (see :mod:`qba_tpu_torch.atlas.steer`).
    """

    parties: tuple[int, ...]
    dishonest: tuple[float, ...]
    strategies: tuple[str, ...] = ("reference",)
    noise_points: tuple[tuple[float, float], ...] = ((0.0, 0.0),)
    size_l: int = 4
    seed: int = 0
    chunk_trials: int = 256
    budget_trials: int = 1024
    escalation: float = 4.0
    max_escalations: int = 2
    target: str = "decide vs 1/3 @ 95%"
    qsim_path: str = "factorized"
    round_engine: str = "auto"

    def __post_init__(self) -> None:
        if not self.parties:
            raise ValueError("campaign needs at least one party count")
        if not self.dishonest:
            raise ValueError("campaign needs at least one dishonest value")
        if self.budget_trials < 1:
            raise ValueError(f"budget_trials must be >= 1, got {self.budget_trials}")
        if self.escalation < 1.0:
            raise ValueError(f"escalation must be >= 1, got {self.escalation}")
        if self.max_escalations < 0:
            raise ValueError(
                f"max_escalations must be >= 0, got {self.max_escalations}"
            )
        # Parse eagerly so an unparseable target fails at spec build,
        # not mid-campaign on the first admission.
        from qba_tpu_torch.stats.targets import parse_target

        parse_target(self.target)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["schema"] = CAMPAIGN_SPEC_SCHEMA
        return d

    @classmethod
    def from_json(cls, payload: dict[str, Any]) -> "CampaignSpec":
        data = dict(payload)
        schema = data.pop("schema", CAMPAIGN_SPEC_SCHEMA)
        if schema != CAMPAIGN_SPEC_SCHEMA:
            raise ValueError(
                f"bad campaign spec schema {schema!r}; "
                f"expected {CAMPAIGN_SPEC_SCHEMA}"
            )
        for key in ("parties", "dishonest", "strategies"):
            if key in data:
                data[key] = tuple(data[key])
        if "noise_points" in data:
            data["noise_points"] = tuple(
                (float(p), float(q)) for p, q in data["noise_points"]
            )
        return cls(**data)

    def campaign_key(self) -> str:
        """Identity of the campaign itself (ledger ownership check): a
        short hash of the canonicalized spec.  A ledger written by a
        different spec must not be resumed into — same refusal
        discipline as ``QBACheckpointMismatch`` in the sweep layer."""
        return hashlib.sha256(
            canonical_json(self.to_json()).encode()
        ).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class AtlasCell:
    """One enumerated cube cell: content-address key, human-facing
    coordinates, the validated base config, and its fingerprint."""

    key: str
    coords: dict[str, Any]
    config: Any  # QBAConfig — typed loosely to keep this module light
    fingerprint: dict[str, Any]


def parse_dishonest(tokens: Sequence[str]) -> tuple[float, ...]:
    """CLI-side parse of the dishonest axis: ``"0" "2" "1/3" "0.4"`` —
    integral values are counts, fractions/floats in (0, 1) scale with
    the party count."""
    out: list[float] = []
    for tok in tokens:
        text = str(tok).strip()
        if "/" in text:
            num, _, den = text.partition("/")
            try:
                val = float(num) / float(den)
            except (ValueError, ZeroDivisionError):
                raise ValueError(f"bad dishonest value {tok!r}") from None
        else:
            try:
                val = float(text)
            except ValueError:
                raise ValueError(f"bad dishonest value {tok!r}") from None
        if val < 0:
            raise ValueError(f"dishonest value must be >= 0, got {tok!r}")
        out.append(val)
    return tuple(out)


def resolve_dishonest(n_parties: int, dishonest: Sequence[float]) -> list[int]:
    """Concrete traitor counts for one party count: counts pass
    through, fractions floor, out-of-range values drop, duplicates
    dedup — ascending order."""
    counts: set[int] = set()
    for d in dishonest:
        if 0 < float(d) < 1:
            c = int(math.floor(n_parties * float(d)))
        else:
            c = int(d)
            if c != d:
                raise ValueError(
                    f"dishonest value {d!r} is neither a count nor a "
                    "fraction in (0, 1)"
                )
        if 0 <= c <= n_parties:
            counts.add(c)
    return sorted(counts)


def enumerate_cells(spec: CampaignSpec) -> list[AtlasCell]:
    """The deduped cube, in deterministic (parties, dishonest,
    strategy, noise) lexicographic order.  Each cell's config is
    validated at enumeration time — an invalid combination fails the
    whole campaign here, before anything is admitted."""
    from qba_tpu_torch.config import QBAConfig

    cells: list[AtlasCell] = []
    seen: set[str] = set()
    for n in spec.parties:
        for d in resolve_dishonest(n, spec.dishonest):
            for strat in spec.strategies:
                for p_dep, p_mf in spec.noise_points:
                    cfg = QBAConfig(
                        n_parties=n,
                        size_l=spec.size_l,
                        n_dishonest=d,
                        trials=spec.budget_trials,
                        seed=spec.seed,
                        qsim_path=spec.qsim_path,
                        round_engine=spec.round_engine,
                        strategy=strat,
                        p_depolarize=p_dep,
                        p_measure_flip=p_mf,
                    )
                    fp = dataclasses.asdict(cfg)
                    fp.pop("trials", None)
                    key = cell_key(fp)
                    if key in seen:
                        continue
                    seen.add(key)
                    cells.append(
                        AtlasCell(
                            key=key,
                            coords={
                                "n_parties": n,
                                "n_dishonest": d,
                                "strategy": strat,
                                "p_depolarize": p_dep,
                                "p_measure_flip": p_mf,
                                "size_l": spec.size_l,
                            },
                            config=cfg,
                            fingerprint=fp,
                        )
                    )
    return cells


def attempt_trials(spec: CampaignSpec, attempt: int) -> int:
    """Trial budget for escalation wave ``attempt`` (0-based):
    ``budget_trials * escalation**attempt``, rounded up to a whole
    number of chunks so the device chunk ladder stays aligned across
    waves."""
    raw = spec.budget_trials * (spec.escalation ** attempt)
    chunks = max(1, math.ceil(raw / spec.chunk_trials))
    return chunks * spec.chunk_trials


def request_id_for(cell_key_: str, attempt: int) -> str:
    """Deterministic, slug-safe request id for one cell attempt — a
    resumed driver re-derives the id and recognizes in-flight or
    already-landed results for it."""
    return f"atlas-{cell_key_}-a{attempt}"


def build_request(
    cell: AtlasCell, spec: CampaignSpec, attempt: int
) -> EvalRequest:
    """The targeted :class:`EvalRequest` for one cell attempt.  The
    request's trial count is the attempt's budget ceiling; its target
    makes the server stop early once the rule fires — admission prices
    the *target* (``Target.planning_trials``), not the ceiling."""
    return EvalRequest(
        request_id=request_id_for(cell.key, attempt),
        n_parties=cell.coords["n_parties"],
        size_l=spec.size_l,
        n_dishonest=cell.coords["n_dishonest"],
        trials=attempt_trials(spec, attempt),
        seed=spec.seed,
        round_engine=spec.round_engine,
        qsim_path=spec.qsim_path,
        strategy=cell.coords["strategy"],
        p_depolarize=cell.coords["p_depolarize"],
        p_measure_flip=cell.coords["p_measure_flip"],
        target=spec.target,
    )
