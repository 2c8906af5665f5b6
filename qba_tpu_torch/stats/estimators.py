"""Streaming sufficient statistics over :class:`ChunkResult` streams — a
copy of :mod:`qba_tpu.stats.estimators` (the port imports nothing of
:mod:`qba_tpu`).

Every Monte-Carlo path in the repo reduces a chunk of trials to the same
sufficient statistics on the host side of the readback — a success count,
an overflow count, and (when decisions are returned) a first-accept-round
counter vector.  This module owns the step from those counts to *certified*
rates: point estimate plus a binomial confidence interval, computed the
same way whether the counts came from ``run_sweep``, a surface cell, a
serve request, or a study script.  Everything here is pure Python/NumPy on
plain integers — no device state — so every engine/backend feeds
it identically and the numbers in a manifest never depend on which kernel
produced the trials.

Two interval families:

* **Wilson** (:func:`wilson_ci`) — the score interval.  Closed form,
  excellent coverage for moderate ``n``.
* **Clopper–Pearson** (:func:`clopper_pearson_ci`) — the exact interval
  from inverting the binomial tail tests.  Conservative (coverage ≥ the
  nominal level at every ``(n, p)``), used where a guarantee-flavoured
  statement is wanted (docs/STATS.md).  Implemented via a pure-Python
  regularized incomplete beta (Lentz continued fraction + ``lgamma``) so
  there is no SciPy dependency.

The empty case is uniform by fiat: ``n == 0`` → rate ``nan`` (None in
JSON), interval ``[0, 1]``.  That is the single source of truth
``SweepResult.success_rate`` routes through.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Any, Iterable, Mapping

__all__ = [
    "RateEstimate",
    "StreamingRate",
    "SweepEstimators",
    "clopper_pearson_ci",
    "rate_estimate",
    "round_histogram",
    "success_rate",
    "wilson_ci",
]


def success_rate(successes: int, n_trials: int) -> float:
    """The repo-wide point estimate: ``k/n``, ``nan`` when ``n == 0``.

    Single source of truth for the empty case — sweep results, surface
    cells and serve results all call this instead of dividing inline.
    """
    return successes / n_trials if n_trials else float("nan")


def _z_value(confidence: float) -> float:
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    return NormalDist().inv_cdf(0.5 + confidence / 2.0)


def wilson_ci(
    k: int, n: int, confidence: float = 0.95
) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion.

    ``n == 0`` returns the vacuous ``(0.0, 1.0)``.
    """
    z = _z_value(confidence)
    return wilson_ci_z(k, n, z)


def wilson_ci_z(k: int, n: int, z: float) -> tuple[float, float]:
    """Wilson interval parameterized by the z-value directly (the form
    ``obs/stats.py`` historically exposed)."""
    if n == 0:
        return (0.0, 1.0)
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta (Lentz's method)."""
    MAXIT, EPS, FPMIN = 200, 3e-14, 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < FPMIN:
        d = FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, MAXIT + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < FPMIN:
            d = FPMIN
        c = 1.0 + aa / c
        if abs(c) < FPMIN:
            c = FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < EPS:
            return h
    raise RuntimeError(f"betacf failed to converge (a={a}, b={b}, x={x})")


def betainc_reg(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta ``I_x(a, b)`` — pure Python, no SciPy.

    This is the binomial tail: ``P[X <= k] = I_{1-p}(n-k, k+1)`` for
    ``X ~ Binomial(n, p)`` (equivalently ``P[X >= k] = I_p(k, n-k+1)``).
    """
    if not 0.0 <= x <= 1.0:
        raise ValueError(f"x must be in [0, 1], got {x}")
    if x == 0.0:
        return 0.0
    if x == 1.0:
        return 1.0
    ln_front = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log1p(-x)
    )
    front = math.exp(ln_front)
    # Use the continued fraction on the side where it converges fast.
    if x < (a + 1.0) / (a + b + 2.0):
        return front * _betacf(a, b, x) / a
    return 1.0 - front * _betacf(b, a, 1.0 - x) / b


def _beta_ppf(a: float, b: float, q: float) -> float:
    """Quantile of Beta(a, b) by bisection on :func:`betainc_reg`.

    Bisection (not Newton) on a monotone CDF: ~50 iterations give ~1e-15
    absolute precision, plenty for interval endpoints, and it cannot
    diverge.
    """
    lo, hi = 0.0, 1.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if betainc_reg(a, b, mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def clopper_pearson_ci(
    k: int, n: int, confidence: float = 0.95
) -> tuple[float, float]:
    """Exact (Clopper–Pearson) binomial interval.

    Inverts the binomial tail tests: ``lo`` is the p with
    ``P[X >= k] = alpha/2`` and ``hi`` the p with ``P[X <= k] = alpha/2``,
    via the beta-quantile identities.  Coverage is ≥ ``confidence`` for
    every ``(n, p)`` — conservative by construction.  ``n == 0`` returns
    the vacuous ``(0.0, 1.0)``.
    """
    if n == 0:
        return (0.0, 1.0)
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    alpha = 1.0 - confidence
    lo = 0.0 if k == 0 else _beta_ppf(k, n - k + 1, alpha / 2.0)
    hi = 1.0 if k == n else _beta_ppf(k + 1, n - k, 1.0 - alpha / 2.0)
    return (lo, hi)


_METHODS = {
    "wilson": wilson_ci,
    "clopper_pearson": clopper_pearson_ci,
}


@dataclasses.dataclass(frozen=True)
class RateEstimate:
    """A certified rate: count, trials, point estimate, CI, and how the
    CI was computed.  This is the shape manifests and atlas records
    carry: no bare rate without its ``lo``/``hi``."""

    k: int
    n: int
    rate: float  # nan when n == 0
    lo: float
    hi: float
    method: str
    confidence: float

    @property
    def width(self) -> float:
        return self.hi - self.lo

    def to_json(self) -> dict[str, Any]:
        return {
            "k": self.k,
            "n": self.n,
            # JSON has no nan; None is the uniform empty-result encoding.
            "rate": None if self.n == 0 else self.rate,
            "lo": self.lo,
            "hi": self.hi,
            "method": self.method,
            "confidence": self.confidence,
        }


def rate_estimate(
    k: int,
    n: int,
    method: str = "wilson",
    confidence: float = 0.95,
) -> RateEstimate:
    """Point estimate + CI as one :class:`RateEstimate`."""
    try:
        ci = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown CI method {method!r}; choose from {sorted(_METHODS)}"
        ) from None
    lo, hi = ci(k, n, confidence)
    return RateEstimate(
        k=k,
        n=n,
        rate=success_rate(k, n),
        lo=lo,
        hi=hi,
        method=method,
        confidence=confidence,
    )


class StreamingRate:
    """A binomial proportion accumulated chunk-by-chunk.

    ``observe(k, n)`` folds one chunk's counts in; :meth:`estimate` is the
    current certified rate.  Order-independent (sums of counts), so the
    adaptive allocator's reordering cannot change the final estimate.
    """

    def __init__(self, method: str = "wilson", confidence: float = 0.95):
        if method not in _METHODS:
            raise ValueError(
                f"unknown CI method {method!r}; choose from {sorted(_METHODS)}"
            )
        self.method = method
        self.confidence = confidence
        self.k = 0
        self.n = 0

    def observe(self, k: int, n: int) -> None:
        if not 0 <= k <= n:
            raise ValueError(f"need 0 <= k <= n, got k={k}, n={n}")
        self.k += int(k)
        self.n += int(n)

    def estimate(self) -> RateEstimate:
        return rate_estimate(
            self.k, self.n, method=self.method, confidence=self.confidence
        )


class SweepEstimators:
    """The host-side statistics sink for a chunked sweep: one
    :class:`StreamingRate` per tracked event class (success, overflow),
    fed from :class:`~qba_tpu_torch.sweep.ChunkResult` aggregates.

    ``ChunkResult.overflow`` is a per-chunk *any* flag, not a count, so
    the overflow rate here is the rate of overflowing **chunks** — the
    honest statistic available from the checkpoint format.
    """

    def __init__(self, method: str = "wilson", confidence: float = 0.95):
        self.success = StreamingRate(method=method, confidence=confidence)
        self.overflow_chunks = StreamingRate(
            method=method, confidence=confidence
        )

    def observe_chunk(self, chunk) -> None:
        """Fold one ``ChunkResult`` (anything with ``.trials``,
        ``.successes``, ``.overflow``) into the running statistics."""
        self.success.observe(chunk.successes, chunk.trials)
        self.overflow_chunks.observe(1 if chunk.overflow else 0, 1)

    def observe_all(self, chunks: Iterable[Any]) -> "SweepEstimators":
        for c in chunks:
            self.observe_chunk(c)
        return self

    def summary(self) -> dict[str, Any]:
        """The manifest-ready block (every rate is a full estimate)."""
        return {
            "success_rate": self.success.estimate().to_json(),
            "overflow_chunk_rate": self.overflow_chunks.estimate().to_json(),
        }


def round_histogram(
    first_accept_rounds: Iterable[int] | Mapping[int, int],
    n_rounds: int,
    confidence: float = 0.95,
    method: str = "wilson",
) -> list[dict[str, Any]]:
    """Counter-derived round histogram with a CI per bin.

    Accepts either raw per-trial first-accept rounds or a pre-counted
    ``{round: count}`` mapping.  Each bin's frequency is a binomial
    proportion of the total trial count, so each carries the same
    certified-rate shape as everything else in a manifest.  Bins are
    emitted for ``0..n_rounds`` inclusive (the sentinel ``n_rounds``
    bucket is "never accepted").
    """
    if isinstance(first_accept_rounds, Mapping):
        counts = {int(r): int(c) for r, c in first_accept_rounds.items()}
    else:
        counts = {}
        for r in first_accept_rounds:
            counts[int(r)] = counts.get(int(r), 0) + 1
    total = sum(counts.values())
    bins = []
    for r in range(n_rounds + 1):
        k = counts.get(r, 0)
        est = rate_estimate(k, total, method=method, confidence=confidence)
        bins.append({"round": r, **est.to_json()})
    return bins
