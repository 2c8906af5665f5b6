"""Render the atlas: per-slice validity surfaces and the measured noise
fence — a copy of :mod:`qba_tpu.atlas.render`, writing the same
``atlas.json`` (schema ``qba-tpu/atlas/v1``).

The rendered atlas is the phase diagram a campaign exists to produce:
for every (strategy, noise, size_l) slice, a (n_parties × n_dishonest)
grid of certified success rates with their anytime-valid CI bands, each
point flagged frontier/interior; plus the noise-detectability fence
(``ki7_fence``, docs/KNOWN_ISSUES.md KI-7) as a **measured curve**: the
all-honest (d = 0) false-abort rate across the noise axis with
confidence bands, against the per-bit flip probability ``pflip =
(2p/3)(1 − q) + q(1 − 2p/3)``.

Per-slice width accounting: frontier cells (CI straddling the
threshold, or refused on budget) escalate until they resolve or
exhaust, so their CI widths end at or below the interior cells that
certified on a coarse wave-0 CI; ``render_atlas`` computes both maxima
per slice (``widths_ok``).

Plotting is optional and import-gated (matplotlib is not a
dependency): :func:`plot_slices` writes one PNG per slice plus the
fence when matplotlib is importable, and reports cleanly when not.
"""

from __future__ import annotations

from typing import Any

from qba_tpu_torch.atlas.steer import is_frontier
from qba_tpu_torch.atlas.store import AtlasStore
from qba_tpu_torch.serve.queuefs import write_json_atomic

ATLAS_SCHEMA = "qba-tpu/atlas/v1"


def measured_pflip(p_depolarize: float, p_measure_flip: float) -> float:
    """Per-measured-bit flip probability under both channels (the
    composition of docs/KNOWN_ISSUES.md KI-7)."""
    p, q = p_depolarize, p_measure_flip
    return (2.0 * p / 3.0) * (1.0 - q) + q * (1.0 - 2.0 * p / 3.0)


def _slice_key(coords: dict[str, Any]) -> tuple:
    return (
        str(coords.get("strategy")),
        float(coords.get("p_depolarize", 0.0)),
        float(coords.get("p_measure_flip", 0.0)),
        int(coords.get("size_l", 0)),
    )


def render_atlas(
    store: AtlasStore, target: str | None = None
) -> dict[str, Any]:
    """Build (and atomically write) ``atlas.json`` from every cell in
    the store.  ``target`` defaults to the store ledger's campaign
    target; without either, frontier classification is skipped (every
    cell renders as interior)."""
    if target is None:
        led = store.load_ledger()
        if led is not None:
            target = (led.get("campaign") or {}).get("target")
    slices: dict[tuple, dict[str, Any]] = {}
    fence_points: dict[tuple, list[dict[str, Any]]] = {}
    total = 0
    for _name, rec in store.iter_cells():
        total += 1
        coords = rec.get("coords") or {}
        skey = _slice_key(coords)
        sl = slices.setdefault(
            skey,
            {
                "strategy": skey[0],
                "p_depolarize": skey[1],
                "p_measure_flip": skey[2],
                "size_l": skey[3],
                "points": [],
            },
        )
        ci = rec.get("ci") or {}
        lo = ci.get("lo")
        hi = ci.get("hi")
        width = (
            float(hi) - float(lo)
            if lo is not None and hi is not None
            else None
        )
        frontier = bool(target) and is_frontier(rec, target)
        sl["points"].append(
            {
                "n_parties": coords.get("n_parties"),
                "n_dishonest": coords.get("n_dishonest"),
                "status": rec.get("status"),
                "rate": ci.get("rate"),
                "lo": lo,
                "hi": hi,
                "ci_width": width,
                "n_trials": rec.get("n_trials"),
                "attempts": rec.get("attempts"),
                "frontier": frontier,
                "refusal": (rec.get("refusal") or {}).get("reason"),
            }
        )
        # The noise fence: the all-honest column, across noise.  The fence
        # is about *false aborts* — agreement failing with zero
        # traitors — so the y-axis is 1 - success with flipped bands.
        if coords.get("n_dishonest") == 0 and rec.get("status") != "refused":
            fkey = (
                str(coords.get("strategy")),
                int(coords.get("size_l", 0)),
                int(coords.get("n_parties", 0)),
            )
            point = {
                "p_depolarize": skey[1],
                "p_measure_flip": skey[2],
                "pflip": measured_pflip(skey[1], skey[2]),
                "n_trials": rec.get("n_trials"),
            }
            if lo is not None and hi is not None and ci.get("rate") is not None:
                point["false_abort_rate"] = 1.0 - float(ci["rate"])
                point["lo"] = 1.0 - float(hi)
                point["hi"] = 1.0 - float(lo)
            fence_points.setdefault(fkey, []).append(point)
    out_slices = []
    for skey in sorted(slices):
        sl = slices[skey]
        sl["points"].sort(
            key=lambda p: (p["n_parties"] or 0, p["n_dishonest"] or 0)
        )
        fw = [
            p["ci_width"] for p in sl["points"]
            if p["frontier"] and p["ci_width"] is not None
        ]
        iw = [
            p["ci_width"] for p in sl["points"]
            if not p["frontier"] and p["ci_width"] is not None
        ]
        sl["frontier_cells"] = sum(1 for p in sl["points"] if p["frontier"])
        sl["frontier_max_width"] = max(fw) if fw else None
        sl["interior_max_width"] = max(iw) if iw else None
        sl["widths_ok"] = (
            sl["frontier_max_width"] <= sl["interior_max_width"] + 1e-12
            if fw and iw
            else True
        )
        out_slices.append(sl)
    fences = []
    for fkey in sorted(fence_points):
        pts = sorted(fence_points[fkey], key=lambda p: p["pflip"])
        fences.append(
            {
                "strategy": fkey[0],
                "size_l": fkey[1],
                "n_parties": fkey[2],
                "points": pts,
            }
        )
    atlas = {
        "schema": ATLAS_SCHEMA,
        "target": target,
        "cells": total,
        "store_digest": store.digest(),
        "slices": out_slices,
        "ki7_fence": fences,
    }
    write_json_atomic(store.atlas_path, atlas)
    return atlas


def plot_slices(store: AtlasStore, out_dir: str) -> list[str]:
    """PNG renders (one heatmap per slice + one fence figure); returns
    the written paths, or [] when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    import os

    atlas = render_atlas(store)
    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []
    for i, sl in enumerate(atlas["slices"]):
        parties = sorted({p["n_parties"] for p in sl["points"]})
        dish = sorted({p["n_dishonest"] for p in sl["points"]})
        grid = [[float("nan")] * len(dish) for _ in parties]
        for p in sl["points"]:
            if p["rate"] is not None:
                grid[parties.index(p["n_parties"])][
                    dish.index(p["n_dishonest"])
                ] = p["rate"]
        fig, ax = plt.subplots(figsize=(6, 4))
        im = ax.imshow(
            grid, origin="lower", aspect="auto", vmin=0.0, vmax=1.0,
            cmap="viridis",
        )
        ax.set_xticks(range(len(dish)), [str(d) for d in dish])
        ax.set_yticks(range(len(parties)), [str(n) for n in parties])
        ax.set_xlabel("n_dishonest")
        ax.set_ylabel("n_parties")
        ax.set_title(
            f"{sl['strategy']} p={sl['p_depolarize']} "
            f"q={sl['p_measure_flip']} L={sl['size_l']}"
        )
        for p in sl["points"]:
            if p["frontier"]:
                ax.plot(
                    dish.index(p["n_dishonest"]),
                    parties.index(p["n_parties"]),
                    "r+", markersize=12,
                )
        fig.colorbar(im, label="agreement success rate")
        path = os.path.join(out_dir, f"slice_{i:02d}.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    if atlas["ki7_fence"]:
        fig, ax = plt.subplots(figsize=(6, 4))
        for fence in atlas["ki7_fence"]:
            pts = [p for p in fence["points"] if "false_abort_rate" in p]
            if not pts:
                continue
            xs = [p["pflip"] for p in pts]
            ys = [p["false_abort_rate"] for p in pts]
            los = [p["lo"] for p in pts]
            his = [p["hi"] for p in pts]
            label = (
                f"{fence['strategy']} n={fence['n_parties']} "
                f"L={fence['size_l']}"
            )
            ax.plot(xs, ys, "o-", label=label)
            ax.fill_between(xs, los, his, alpha=0.2)
        ax.set_xlabel("pflip = (2p/3)(1-q) + q(1-2p/3)")
        ax.set_ylabel("all-honest false-abort rate")
        ax.set_title("noise-detectability fence (measured)")
        ax.legend(fontsize=7)
        path = os.path.join(out_dir, "ki7_fence.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written
