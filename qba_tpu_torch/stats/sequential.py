"""Anytime-valid stopping rules over streaming binomial counts — a copy
of :mod:`qba_tpu.stats.sequential`.

Two rules, both safe to consult after *every* chunk without inflating
error rates (the "anytime validity" docs/STATS.md spells out):

* :class:`SPRT` — Wald's sequential probability ratio test for
  ``success_rate ⋛ threshold`` hypotheses, with an indifference region
  ``threshold ± delta``.  Error rates are bounded by the classical
  boundary choice ``A = (1-β)/α``, ``B = β/(1-α)``.
* :class:`MixtureMartingaleCI` — a Beta(½,½)-mixture martingale
  confidence sequence; its running interval covers the true rate at
  every sample size simultaneously with probability ≥ confidence, so a
  "stop when the CI is narrow enough" rule stays honest.

Each rule emits a typed :class:`StopDecision` when it fires.  Rules are
pure host-side arithmetic over integer counts — deterministic given the
observation sequence, which the allocator keeps deterministic given seed
and arrival order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from qba_tpu_torch.stats.estimators import RateEstimate, rate_estimate

__all__ = [
    "MixtureMartingaleCI",
    "SPRT",
    "StopDecision",
]

#: StopDecision.reason vocabulary (docs/STATS.md).
STOP_REASONS = (
    "decided_above",  # SPRT accepted p >= threshold + delta
    "decided_below",  # SPRT accepted p <= threshold - delta
    "ci_width",  # confidence-sequence width reached the target
    "budget_exhausted",  # trial budget ran out before the rule fired
)


@dataclasses.dataclass(frozen=True)
class StopDecision:
    """Why a sequential run stopped, after how many trials, and at what
    bound.  ``bound`` is rule-specific: the crossed log-likelihood-ratio
    boundary for SPRT, the achieved CI width for the width rule, and the
    remaining CI width for ``budget_exhausted``."""

    reason: str
    n_trials: int
    bound: float
    threshold: float | None = None
    estimate: RateEstimate | None = None

    def __post_init__(self):
        if self.reason not in STOP_REASONS:
            raise ValueError(
                f"unknown stop reason {self.reason!r}; "
                f"choose from {STOP_REASONS}"
            )

    @property
    def decided(self) -> bool:
        return self.reason in ("decided_above", "decided_below")

    def to_json(self) -> dict[str, Any]:
        return {
            "reason": self.reason,
            "n_trials": self.n_trials,
            "bound": self.bound,
            "threshold": self.threshold,
            "estimate": (
                self.estimate.to_json() if self.estimate is not None else None
            ),
        }


def _clip_p(p: float) -> float:
    return min(max(p, 1e-9), 1.0 - 1e-9)


class MixtureMartingaleCI:
    """Beta(½,½)-mixture martingale confidence sequence.

    For a candidate rate ``p`` the mixture likelihood ratio after ``k``
    successes in ``n`` trials is

        ``M_n(p) = B(k+½, n-k+½) / B(½, ½) / (p^k (1-p)^(n-k))``

    which is a nonnegative martingale with ``E[M] = 1`` when ``p`` is the
    true rate; by Ville's inequality ``P[sup_n M_n(p) >= 1/alpha] <=
    alpha``.  The running confidence set ``{p : M_n(p) < 1/alpha}`` is an
    interval (log M is convex in ``logit p``), found here by bisection
    from the MLE outward.  Optionally doubles as a stopping rule: with
    ``target_width`` set, :meth:`decision` fires when the interval is
    narrow enough.
    """

    def __init__(
        self, confidence: float = 0.95, target_width: float | None = None
    ):
        if not 0.0 < confidence < 1.0:
            raise ValueError(
                f"confidence must be in (0, 1), got {confidence}"
            )
        if target_width is not None and not 0.0 < target_width <= 1.0:
            raise ValueError(
                f"target_width must be in (0, 1], got {target_width}"
            )
        self.confidence = confidence
        self.target_width = target_width
        self.k = 0
        self.n = 0

    def observe(self, k: int, n: int) -> None:
        if not 0 <= k <= n:
            raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
        self.k += int(k)
        self.n += int(n)

    def width_at(self, k: int, n: int) -> float:
        """Interval width at totals ``(k, n)`` without touching this
        rule's state — the probe the device stop tables are built from
        (stats/device.py).  Evaluates exactly the arithmetic
        :meth:`decision` consults, so "``width_at(k, n) <=
        target_width``" IS the host stopping predicate at those totals.
        """
        probe = MixtureMartingaleCI(
            confidence=self.confidence, target_width=self.target_width
        )
        probe.k, probe.n = int(k), int(n)
        lo, hi = probe.interval()
        return hi - lo

    def interval_at(self, k: int, n: int) -> tuple[float, float]:
        """The running interval at totals ``(k, n)``, state-free (the
        straddle probe used by the device allocator's verification
        tests)."""
        probe = MixtureMartingaleCI(
            confidence=self.confidence, target_width=self.target_width
        )
        probe.k, probe.n = int(k), int(n)
        return probe.interval()

    def _log_mixture(self, p: float) -> float:
        """log M_n(p) for the current counts."""
        a = b = 0.5
        k, n = self.k, self.n
        p = _clip_p(p)
        lbeta = math.lgamma(k + a) + math.lgamma(n - k + b) - math.lgamma(
            n + a + b
        )
        lbeta0 = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
        return (
            lbeta - lbeta0 - (k * math.log(p) + (n - k) * math.log1p(-p))
        )

    def interval(self) -> tuple[float, float]:
        """The running confidence interval ``{p : M_n(p) < 1/alpha}``."""
        if self.n == 0:
            return (0.0, 1.0)
        crit = math.log(1.0 / (1.0 - self.confidence))
        p_hat = self.k / self.n
        # log M is minimized at the MLE and increases monotonically
        # toward each endpoint, so each boundary is a 1-d bisection.
        if self._log_mixture(p_hat) >= crit:
            # Degenerate (tiny n): the whole set may be empty around the
            # MLE under clipping; report the vacuous interval.
            return (0.0, 1.0)

        def boundary(lo: float, hi: float, rising_at_hi: bool) -> float:
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                if (self._log_mixture(mid) >= crit) == rising_at_hi:
                    hi = mid
                else:
                    lo = mid
            return 0.5 * (lo + hi)

        lower = (
            0.0
            if self._log_mixture(0.0) < crit
            else boundary(0.0, p_hat, rising_at_hi=False)
        )
        upper = (
            1.0
            if self._log_mixture(1.0) < crit
            else boundary(p_hat, 1.0, rising_at_hi=True)
        )
        return (lower, upper)

    def estimate(self) -> RateEstimate:
        lo, hi = self.interval()
        return RateEstimate(
            k=self.k,
            n=self.n,
            rate=self.k / self.n if self.n else float("nan"),
            lo=lo,
            hi=hi,
            method="mixture_martingale",
            confidence=self.confidence,
        )

    def decision(self) -> StopDecision | None:
        """Fires when the running CI width reaches ``target_width``."""
        if self.target_width is None or self.n == 0:
            return None
        est = self.estimate()
        if est.width <= self.target_width:
            return StopDecision(
                reason="ci_width",
                n_trials=self.n,
                bound=est.width,
                estimate=est,
            )
        return None

    def exhausted(self) -> StopDecision:
        """The budget ran out first; report the CI actually achieved."""
        est = self.estimate()
        return StopDecision(
            reason="budget_exhausted",
            n_trials=self.n,
            bound=est.width,
            estimate=est,
        )


class SPRT:
    """Wald's SPRT for ``H0: p <= threshold - delta`` vs
    ``H1: p >= threshold + delta``.

    The log-likelihood ratio ``LLR = sum log f(x; p1)/f(x; p0)`` with
    ``p0 = threshold - delta``, ``p1 = threshold + delta`` is compared
    against ``log((1-beta)/alpha)`` (accept H1: ``decided_above``) and
    ``log(beta/(1-alpha))`` (accept H0: ``decided_below``).  Inside the
    indifference region ``(p0, p1)`` either decision is acceptable; the
    test's expected sample size there is largest.

    The rule also owns a :class:`MixtureMartingaleCI` fed the same
    counts, so the estimate reported at stop carries an *anytime-valid*
    interval — a fixed-n Wilson interval at a data-dependent stopping
    time would overstate precision (docs/STATS.md).
    """

    def __init__(
        self,
        threshold: float,
        alpha: float = 0.05,
        beta: float = 0.05,
        delta: float = 0.05,
        confidence: float | None = None,
    ):
        if not 0.0 < threshold < 1.0:
            raise ValueError(
                f"threshold must be in (0, 1), got {threshold}"
            )
        if not 0.0 < alpha < 1.0 or not 0.0 < beta < 1.0:
            raise ValueError(f"alpha/beta must be in (0, 1): {alpha}, {beta}")
        if delta <= 0.0:
            raise ValueError(f"delta must be positive, got {delta}")
        self.threshold = threshold
        self.alpha = alpha
        self.beta = beta
        self.delta = delta
        self.p0 = _clip_p(threshold - delta)
        self.p1 = _clip_p(threshold + delta)
        self.log_a = math.log((1.0 - beta) / alpha)  # accept H1 above this
        self.log_b = math.log(beta / (1.0 - alpha))  # accept H0 below this
        self._s = math.log(self.p1 / self.p0)  # per-success increment
        self._f = math.log((1.0 - self.p1) / (1.0 - self.p0))  # per-failure
        self.llr = 0.0
        self.n = 0
        self.k = 0
        self.ci = MixtureMartingaleCI(
            confidence=confidence if confidence is not None else 1.0 - alpha
        )

    def llr_at(self, k: int, n: int) -> float:
        """The LLR at totals ``(k, n)`` — a pure function of the counts.
        :meth:`observe` keeps ``self.llr`` in exactly this totals form
        (not a per-chunk float accumulation), so the host stopping
        predicate is path-independent and the device stop tables
        (stats/device.py) can reproduce it exactly."""
        return k * self._s + (n - k) * self._f

    def observe(self, k: int, n: int) -> None:
        """Fold a chunk's counts into the running LLR (the per-trial LLR
        is linear in the success count, so chunk aggregation is exact;
        the stored value is recomputed from totals — see
        :meth:`llr_at`)."""
        if not 0 <= k <= n:
            raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
        self.n += int(n)
        self.k += int(k)
        self.llr = self.llr_at(self.k, self.n)
        self.ci.observe(k, n)

    def decision(self) -> StopDecision | None:
        if self.n == 0:
            return None
        if self.llr >= self.log_a:
            return StopDecision(
                reason="decided_above",
                n_trials=self.n,
                bound=self.log_a,
                threshold=self.threshold,
                estimate=self.ci.estimate(),
            )
        if self.llr <= self.log_b:
            return StopDecision(
                reason="decided_below",
                n_trials=self.n,
                bound=self.log_b,
                threshold=self.threshold,
                estimate=self.ci.estimate(),
            )
        return None

    def exhausted(self) -> StopDecision:
        est = self.ci.estimate()
        return StopDecision(
            reason="budget_exhausted",
            n_trials=self.n,
            bound=self.llr,
            threshold=self.threshold,
            estimate=est,
        )

    def estimate(self) -> RateEstimate:
        return (
            self.ci.estimate()
            if self.n
            else rate_estimate(0, 0, confidence=self.ci.confidence)
        )
