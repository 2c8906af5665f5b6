"""Host-exact stop tables for the device-resident sequential loop — the
host part of :mod:`qba_tpu.stats.device`, copied.

The device-resident targeted sweep (``run_sweep(dispatch="device")``)
carries only integer counts from chunk to chunk on the card (a CUDA
graph's WHILE node, :mod:`qba_tpu_torch.ops.sweep_loop`), so the
stopping predicate must be expressible over ``(cumulative successes K,
chunks completed i)`` with nothing but integer compares.  Both stopping
rules allow it, because their decisions are pure functions of the
totals:

* :class:`~qba_tpu_torch.stats.sequential.SPRT` — the aggregate LLR
  ``K·s + (N−K)·f`` is monotone nondecreasing in ``K`` (``s>0>f``), so
  each boundary crossing is a single integer threshold on ``K``;
* :class:`~qba_tpu_torch.stats.sequential.MixtureMartingaleCI` — the
  interval width at ``(K, N)`` is unimodal in ``K`` (widest near
  ``N/2``), so the fire set ``{K : width ≤ target}`` is a pair of end
  intervals.

:func:`stop_tables` precomputes, for every possible chunk count
``i ∈ [0, n_chunks]`` with ``N = i·chunk_trials``, the thresholds
``lo[i]``/``hi[i]`` such that the host rule fires at totals ``(K, N)``
iff ``K <= lo[i]`` or ``K >= hi[i]``.  Each threshold is found by
bisection over ``K`` **evaluating the host rule's own float
arithmetic** (:meth:`SPRT.llr_at` / :meth:`MixtureMartingaleCI.width_at`),
so the device predicate agrees with the host loop's ``rule.decision()``
at every reachable count.

Sentinels: ``lo[i] = -1`` / ``hi[i] = N+1`` mean "never fires at this
``i``" (no cumulative count can be ``<= -1`` or ``>= N+1``).  Index 0
always holds sentinels — a rule with zero observations never fires,
and the device loop must run at least one chunk, like the host loop.

Also here: :func:`device_ci_interval`, the float32 mixture-CI
bisection the device surface orders cells by (widest first), in plain
PyTorch; the ``surface_pick`` kernel
(:mod:`qba_tpu_torch.ops.surface_loop`) computes the same in CUDA.
Scheduling order tolerates float32: per-cell stop decisions always go
through the exact integer tables above.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qba_tpu_torch.stats.sequential import SPRT, MixtureMartingaleCI
from qba_tpu_torch.stats.targets import Target

__all__ = ["stop_tables", "device_ci_interval"]


def _bisect_threshold(fires, lo_k: int, hi_k: int, first_true: bool) -> int:
    """Boundary of a monotone indicator over the integer range
    ``[lo_k, hi_k]``.  ``first_true=True``: smallest K with
    ``fires(K)`` given the indicator is nondecreasing in K (caller has
    checked ``fires(hi_k)``); ``first_true=False``: largest K with
    ``fires(K)`` given it is nonincreasing (caller has checked
    ``fires(lo_k)``)."""
    lo, hi = lo_k, hi_k
    if first_true:
        while lo < hi:
            mid = (lo + hi) // 2
            if fires(mid):
                hi = mid
            else:
                lo = mid + 1
        return lo
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fires(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _decide_thresholds(rule: SPRT, n: int) -> tuple[int, int]:
    """(lo, hi) stop thresholds for the SPRT at total trials ``n``.
    ``llr_at(K, n)`` is monotone nondecreasing in K, and float rounding
    preserves monotonicity (each term is a monotone product), so both
    crossings are clean bisections on the host's own arithmetic."""
    lo, hi = -1, n + 1
    if rule.llr_at(n, n) >= rule.log_a:
        hi = _bisect_threshold(
            lambda k: rule.llr_at(k, n) >= rule.log_a, 0, n, first_true=True
        )
    if rule.llr_at(0, n) <= rule.log_b:
        lo = _bisect_threshold(
            lambda k: rule.llr_at(k, n) <= rule.log_b, 0, n, first_true=False
        )
    return lo, hi


def _width_thresholds(rule: MixtureMartingaleCI, n: int) -> tuple[int, int]:
    """(lo, hi) stop thresholds for the width rule at total trials
    ``n``: fire iff ``width_at(K, n) <= target_width``.  Width is
    unimodal in K (widest near n/2), so the fire set is the two end
    intervals; each boundary is a bisection on the half-range."""
    w = rule.target_width
    mid = n // 2
    if rule.width_at(mid, n) <= w and rule.width_at(mid + (n % 2), n) <= w:
        # Fires even at the widest counts: every K stops.
        return n, 0
    lo, hi = -1, n + 1
    if rule.width_at(0, n) <= w:
        lo = _bisect_threshold(
            lambda k: rule.width_at(k, n) <= w, 0, mid, first_true=False
        )
    if rule.width_at(n, n) <= w:
        hi = _bisect_threshold(
            lambda k: rule.width_at(k, n) <= w, mid, n, first_true=True
        )
    return lo, hi


def stop_tables(
    target: Target, n_chunks: int, chunk_trials: int
) -> tuple[np.ndarray, np.ndarray]:
    """Integer stop thresholds on cumulative successes, one row per
    possible chunk count: after ``i`` chunks (``N = i·chunk_trials``
    trials) the host rule fires iff ``K <= lo[i]`` or ``K >= hi[i]``.

    Exact by construction: every threshold is located by bisection over
    the host rule's own decision arithmetic at those totals (monotone
    in K for the SPRT LLR; unimodal for the CI width), so the device
    loop's condition (the ``sweep_stop`` kernel) stops at exactly the
    chunk boundary the host loop's per-chunk ``rule.decision()`` would.
    """
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if chunk_trials < 1:
        raise ValueError(f"chunk_trials must be >= 1, got {chunk_trials}")
    rule = target.make_rule()
    lo = np.full(n_chunks + 1, -1, dtype=np.int32)
    hi = np.zeros(n_chunks + 1, dtype=np.int32)
    hi[0] = 1  # sentinel: N = 0, no count reaches K >= 1
    for i in range(1, n_chunks + 1):
        n = i * chunk_trials
        if target.kind == "decide":
            lo_i, hi_i = _decide_thresholds(rule, n)
        else:
            lo_i, hi_i = _width_thresholds(rule, n)
        lo[i], hi[i] = lo_i, hi_i
    return lo, hi


# Bounds of the candidate rate inside the float32 mixture (as float32).
_P_MIN, _P_MAX = 1e-7, 1.0 - 1e-7


def device_ci_interval(k, n, confidence: float, iters: int = 60):
    """The float32 mixture-martingale interval at totals ``(k, n)``,
    elementwise over tensors ``k`` and ``n`` (one entry a cell): the same
    Beta(½,½) mixture and MLE-outward bisection as
    :meth:`MixtureMartingaleCI.interval`, in float32 and ``iters`` steps
    a side, the JAX package's ``device_ci_interval`` operation for
    operation.  ``n == 0``, or a mixture already past the critical value
    at the MLE, gives the vacuous ``(0, 1)``.  Returns ``(lo, hi)``
    float32 tensors.

    Used only to order cells inside the device surface: float32 endpoints
    may differ from the host's float64 interval in the last ulps, which
    can reorder near-tied cells but never changes a stop decision."""
    k = torch.as_tensor(k).to(torch.float32)
    n = torch.as_tensor(n).to(torch.float32)
    dev = k.device

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    crit = f32(math.log(1.0 / (1.0 - confidence)))
    half = f32(0.5)
    lbeta = (torch.lgamma(k + half) + torch.lgamma((n - k) + half)
             - torch.lgamma((n + half) + half))
    lbeta0 = f32(math.log(math.pi))  # log B(1/2, 1/2)

    def log_mixture(p):
        p = torch.clamp(p, _P_MIN, _P_MAX)
        return (lbeta - lbeta0) - (k * torch.log(p)
                                   + (n - k) * torch.log1p(-p))

    zero, one = torch.zeros_like(k), torch.ones_like(k)
    p_hat = torch.where(n > 0, k / torch.clamp(n, min=1.0), half)

    def boundary(lo, hi, rising_at_hi: bool):
        for _ in range(iters):
            mid = half * (lo + hi)
            cross = (log_mixture(mid) >= crit) == rising_at_hi
            lo, hi = torch.where(cross, lo, mid), torch.where(cross, mid, hi)
        return half * (lo + hi)

    lower = torch.where(log_mixture(zero) < crit, zero,
                        boundary(zero, p_hat, False))
    upper = torch.where(log_mixture(one) < crit, one,
                        boundary(p_hat, one, True))
    degenerate = (n == 0) | (log_mixture(p_hat) >= crit)
    return (torch.where(degenerate, zero, lower),
            torch.where(degenerate, one, upper))
