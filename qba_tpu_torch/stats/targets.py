"""The precision-target grammar: one string, parsed once, shared by
``run_sweep`` and ``run_surface`` — a copy of
:mod:`qba_tpu.stats.targets`, so a target means the same in both
packages.

Two target kinds::

    decide vs 1/3                  # SPRT vs a threshold, 95% default
    decide vs 0.5 @ 99%            # explicit confidence
    decide vs 1/3 +-0.02           # explicit indifference half-width
    ci_width<=0.002 @ 95%          # mixture-martingale width rule

Thresholds accept decimals or simple fractions (``1/3`` — the paper's
``nDishonest < nParties/3`` boundary is the motivating case).  The
parsed :class:`Target` is frozen and JSON-serializable so manifests and
checkpoints can carry the *spec*, and :meth:`Target.make_rule`
constructs a fresh stopping rule per cell/request.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

from qba_tpu_torch.stats.sequential import SPRT, MixtureMartingaleCI, _clip_p

__all__ = ["Target", "parse_target"]

#: Default indifference half-width for ``decide`` targets without an
#: explicit ``+-d``: wide enough that the paper-boundary cells (true
#: rates well away from 1/3) decide in a handful of chunks.
DEFAULT_DELTA = 0.05
DEFAULT_CONFIDENCE = 0.95

_DECIDE_RE = re.compile(
    r"^decide\s+vs\s+(?P<thresh>[0-9./]+)"
    r"(?:\s*\+-\s*(?P<delta>[0-9.]+))?"
    r"(?:\s*@\s*(?P<conf>[0-9.]+)\s*%)?$"
)
_WIDTH_RE = re.compile(
    r"^ci_width\s*<=\s*(?P<width>[0-9.]+)"
    r"(?:\s*@\s*(?P<conf>[0-9.]+)\s*%)?$"
)


def _parse_number(text: str, what: str) -> float:
    """A decimal or a simple fraction like ``1/3``."""
    if "/" in text:
        num, _, den = text.partition("/")
        try:
            return float(num) / float(den)
        except (ValueError, ZeroDivisionError):
            raise ValueError(f"bad {what} {text!r}") from None
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"bad {what} {text!r}") from None


@dataclasses.dataclass(frozen=True)
class Target:
    """A parsed precision target.  ``kind`` is ``"decide"`` or
    ``"ci_width"``; ``spec`` keeps the original string for manifests."""

    kind: str
    confidence: float
    spec: str
    threshold: float | None = None  # decide only
    delta: float = DEFAULT_DELTA  # decide only
    width: float | None = None  # ci_width only

    def make_rule(self):
        """A fresh stopping rule (one per cell / per serve request —
        rules are stateful accumulators and must not be shared)."""
        if self.kind == "decide":
            alpha = 1.0 - self.confidence
            return SPRT(
                threshold=self.threshold,
                alpha=alpha,
                beta=alpha,
                delta=self.delta,
                confidence=self.confidence,
            )
        return MixtureMartingaleCI(
            confidence=self.confidence, target_width=self.width
        )

    def planning_trials(self, budget: int) -> int:
        """A-priori trial price of this target for capacity planning
        (the fleet admission layer, docs/SERVING.md "Fleet").

        Deterministic, pure arithmetic, and deliberately a *planning
        estimate* rather than a guarantee — ``budget`` stays the hard
        ceiling and early stops release the difference:

        * ``decide`` — Wald's zero-drift expected-sample-size
          approximation at the indifference boundary ``p = threshold``
          (the worst case): ``E[N] ≈ -log_a · log_b / E[Z²]`` where
          ``Z`` is the per-trial log-likelihood-ratio increment.
        * ``ci_width`` — the anytime Hoeffding-style fixed point
          ``n = (log(1/α) + log(n+1)) / (2 (w/2)²)`` for the mixture
          sequence to reach half-width ``w/2``.
        """
        if budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        alpha = 1.0 - self.confidence
        if self.kind == "decide":
            p0 = _clip_p(self.threshold - self.delta)
            p1 = _clip_p(self.threshold + self.delta)
            s = math.log(p1 / p0)
            f = math.log((1.0 - p1) / (1.0 - p0))
            log_a = math.log((1.0 - alpha) / alpha)
            log_b = math.log(alpha / (1.0 - alpha))
            p = self.threshold
            second_moment = p * s * s + (1.0 - p) * f * f
            expected = -log_a * log_b / second_moment
        else:
            half = self.width / 2.0
            expected = 1.0
            for _ in range(32):
                expected = (
                    math.log(1.0 / alpha) + math.log(expected + 1.0)
                ) / (2.0 * half * half)
        return max(1, min(budget, math.ceil(expected)))

    def to_json(self) -> dict[str, Any]:
        return {
            "kind": self.kind,
            "confidence": self.confidence,
            "threshold": self.threshold,
            "delta": self.delta if self.kind == "decide" else None,
            "width": self.width,
            "spec": self.spec,
        }


def parse_target(spec: str) -> Target:
    """Parse a target string (grammar in the module docstring).

    Raises ``ValueError`` on anything unrecognized — serve surfaces the
    message in the request's error result, the CLI at argparse time.
    """
    text = spec.strip()
    m = _DECIDE_RE.match(text)
    if m:
        threshold = _parse_number(m.group("thresh"), "threshold")
        if not 0.0 < threshold < 1.0:
            raise ValueError(
                f"decide threshold must be in (0, 1), got {threshold}"
            )
        delta = (
            float(m.group("delta")) if m.group("delta") else DEFAULT_DELTA
        )
        conf = (
            float(m.group("conf")) / 100.0
            if m.group("conf")
            else DEFAULT_CONFIDENCE
        )
        if not 0.0 < conf < 1.0:
            raise ValueError(f"confidence must be in (0, 100)%, got {conf}")
        return Target(
            kind="decide",
            confidence=conf,
            threshold=threshold,
            delta=delta,
            spec=text,
        )
    m = _WIDTH_RE.match(text)
    if m:
        width = float(m.group("width"))
        if not 0.0 < width <= 1.0:
            raise ValueError(f"ci width must be in (0, 1], got {width}")
        conf = (
            float(m.group("conf")) / 100.0
            if m.group("conf")
            else DEFAULT_CONFIDENCE
        )
        if not 0.0 < conf < 1.0:
            raise ValueError(f"confidence must be in (0, 100)%, got {conf}")
        return Target(kind="ci_width", confidence=conf, width=width, spec=text)
    raise ValueError(
        f"unrecognized target {spec!r}; expected 'decide vs <p> [+-d] "
        f"[@ NN%]' or 'ci_width<=<w> [@ NN%]'"
    )
