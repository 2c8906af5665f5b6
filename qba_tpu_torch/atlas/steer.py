"""Cross-cell frontier steering — the campaign's submission order; a copy
of :mod:`qba_tpu.atlas.steer` on the port's allocator.

The per-cell stopping rule decides *when a cell is done*; this module
decides *which cell's budget is spent next*, reusing the
:class:`~qba_tpu_torch.stats.AdaptiveAllocator`'s tiering across the whole
cube: cells whose running CI still straddles the validity threshold
(the phase-transition **frontier**) outrank cells whose answer is
already clearly on one side (the **interior**).  Frontier cells get
submitted — and, on budget exhaustion, escalated — first; interior
cells certify at whatever coarse CI their first wave produced.

The plan is a pure function of the observed per-cell counts: the
allocator is rebuilt from scratch each round, fed one aggregate
``preload`` per observed cell, and its ``_priority`` tuple orders the
open cells.  No RNG, no timing input — a resumed driver derives the
same plan from the same ledger, which the resume differential test
pins.  The allocator's summary (with its trace) is stored in the
campaign ledger's ``steering`` block, so the rendered atlas can show
*why* each cell got the budget it did.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from qba_tpu_torch.stats import AdaptiveAllocator
from qba_tpu_torch.stats.targets import Target, parse_target

#: Tier names in allocator priority order (allocate.py's trace reasons).
TIERS = ("bootstrap", "straddling", "undecided")


def frontier_plan(
    cell_keys: Sequence[str],
    observed: Mapping[str, tuple[int, int]],
    open_keys: Sequence[str],
    target: Target | str,
    budget_chunks: int = 1,
) -> tuple[list[str], dict[str, Any]]:
    """Rank the open cells by frontier priority.

    ``cell_keys`` is the full enumerated cube in enumeration order
    (ties break by this index, mirroring the allocator), ``observed``
    maps cell key -> aggregate ``(successes, trials)`` seen so far
    (certified, refused, and escalated-away attempts all count — the
    evidence exists regardless of what the ledger did with it), and
    ``open_keys`` is the subset still needing work.  Returns the open
    keys most-urgent-first plus the allocator summary (tier + CI width
    per cell, trace) for the ledger's ``steering`` block.
    """
    want = parse_target(target) if isinstance(target, str) else target
    # budget_chunks only gates next_cell(), which this planner never
    # calls — pass something valid and let _priority do the ranking.
    alloc = AdaptiveAllocator(
        list(cell_keys), want, budget_chunks=max(1, budget_chunks)
    )
    index_of = {key: i for i, key in enumerate(cell_keys)}
    for key, (k, n) in sorted(observed.items(), key=lambda kv: index_of.get(kv[0], 0)):
        if key in index_of and n > 0:
            alloc.preload(index_of[key], int(k), int(n))
    ranked = sorted(
        (key for key in open_keys if key in index_of),
        key=lambda key: alloc._priority(alloc.cells[index_of[key]]),
    )
    tiers: dict[str, str] = {}
    widths: dict[str, float | None] = {}
    for key in open_keys:
        if key not in index_of:
            continue
        cell = alloc.cells[index_of[key]]
        prio = alloc._priority(cell)
        tiers[key] = TIERS[prio[0]]
        widths[key] = (
            float(cell.rule.estimate().width) if cell.chunks_run else None
        )
    plan = {
        "target": want.to_json(),
        "open": list(ranked),
        "tiers": tiers,
        "ci_widths": widths,
        "allocator": alloc.summary(),
    }
    return ranked, plan


def is_frontier(record: Mapping[str, Any], target: Target | str) -> bool:
    """Is a finished cell on the validity frontier?  Yes when its final
    CI still contains the decide threshold (a ``ci_width`` certification
    that never excluded it, or a truncation refusal), or when it
    escalated past wave 0 before resolving — both mean the allocator's
    straddling tier kept feeding it.  ``decide``-certified cells are
    interior by definition: their CI cleared the threshold."""
    want = parse_target(target) if isinstance(target, str) else target
    if want.kind != "decide":
        return False
    ci = record.get("ci")
    if isinstance(ci, dict) and ci.get("lo") is not None:
        lo, hi = float(ci["lo"]), float(ci["hi"])
        if lo <= want.threshold <= hi:
            return True
    refusal = record.get("refusal")
    if isinstance(refusal, dict) and refusal.get("reason") == "budget_exhausted":
        return True
    return False
