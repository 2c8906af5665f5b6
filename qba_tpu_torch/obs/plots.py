"""Optional Monte-Carlo plotting utilities (matplotlib-gated) — a copy
of :mod:`qba_tpu.obs.plots` (the port imports nothing of
:mod:`qba_tpu`).

The reference imports matplotlib and never uses it (``tfg.py:2``,
SURVEY §2.18 "none needed (optionally a plotting util for Monte-Carlo
results)").  Here the optional plotting layer earns its keep with the two
plots a protocol study actually needs:

* convergence of the Monte-Carlo success-rate estimate over trials, and
* success rate vs a swept protocol parameter (the security-parameter
  study: how fast agreement probability approaches 1 in ``size_l``).

Both are single-series line charts: one hue, no legend (the title names
the series), recessive grid, a ±2σ binomial uncertainty band instead of
per-point labels.  Import of matplotlib is deferred and failure-gated so
the framework never requires it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_HUE = "#2563eb"  # single categorical hue; band/grid stay neutral
_INK = "#374151"
_GRID = "#d1d5db"


class PlottingUnavailableError(RuntimeError):
    """matplotlib is not installed (it is an optional dependency).

    A dedicated type so the CLI can turn exactly this condition into a
    clean usage error while letting every other ``RuntimeError`` (CUDA
    and kernel errors) propagate with a traceback.
    """


def _require_pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover - matplotlib is optional
        raise PlottingUnavailableError(
            "plotting requires matplotlib, which is not installed; "
            "qba_tpu_torch works without it everywhere else"
        ) from e
    return plt


def _style(ax) -> None:
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(_GRID)
    ax.tick_params(colors=_INK, labelsize=9)
    ax.grid(axis="y", color=_GRID, linewidth=0.6, alpha=0.6)
    ax.set_axisbelow(True)


def _band(n: np.ndarray, rate: np.ndarray) -> np.ndarray:
    """±2σ binomial standard error of the rate estimate."""
    with np.errstate(divide="ignore", invalid="ignore"):
        se = np.sqrt(rate * (1.0 - rate) / np.maximum(n, 1))
    return 2.0 * se


def plot_convergence(sweep, path: str) -> str:
    """Cumulative success-rate vs trials from a
    :class:`qba_tpu_torch.sweep.SweepResult`; writes a PNG to ``path``."""
    plt = _require_pyplot()
    chunks = sorted(sweep.chunks, key=lambda c: c.chunk)
    n = np.cumsum([c.trials for c in chunks])
    s = np.cumsum([c.successes for c in chunks])
    rate = s / n
    band = _band(n, rate)

    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
    _style(ax)
    ax.fill_between(n, rate - band, rate + band, color=_HUE, alpha=0.15, lw=0)
    ax.plot(n, rate, color=_HUE, lw=2)
    ax.set_xlabel("trials", color=_INK)
    ax.set_ylabel("success rate", color=_INK)
    cfg = sweep.cfg
    ax.set_title(
        f"Monte-Carlo convergence — n={cfg.n_parties}, sizeL={cfg.size_l}, "
        f"d={cfg.n_dishonest}",
        color=_INK,
        fontsize=10,
    )
    ax.set_ylim(0.0, 1.05)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_param_study(
    values: Sequence[float],
    rates: Sequence[float],
    trials: int,
    xlabel: str,
    path: str,
    title: str | None = None,
    log_x: bool = False,
) -> str:
    """Success rate vs a swept parameter; writes a PNG to ``path``."""
    plt = _require_pyplot()
    x = np.asarray(values, dtype=float)
    y = np.asarray(rates, dtype=float)
    # Sort by x so an unordered --values list still draws a monotone line
    # (unsorted points would zigzag and self-overlap the band).
    order = np.argsort(x, kind="stable")
    x, y = x[order], y[order]
    band = _band(np.full_like(y, trials), y)

    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
    _style(ax)
    ax.fill_between(x, y - band, y + band, color=_HUE, alpha=0.15, lw=0)
    ax.plot(x, y, color=_HUE, lw=2, marker="o", markersize=5)
    if log_x:
        ax.set_xscale("log", base=2)
    ax.set_xlabel(xlabel, color=_INK)
    ax.set_ylabel("success rate", color=_INK)
    ax.set_title(
        title or f"success rate vs {xlabel} ({trials} trials/point)",
        color=_INK,
        fontsize=10,
    )
    ax.set_ylim(0.0, 1.05)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
