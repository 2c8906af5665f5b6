"""Adaptive trial allocation across a cell grid — a copy of
:mod:`qba_tpu.stats.allocate`.

Given a grid of cells (surface points), a shared precision target, and a
total chunk budget, the allocator decides which cell runs its next chunk.
The policy is Coz-shaped (PAPERS.md): spend the budget where it moves the
answer — cells whose confidence interval still straddles the decision
boundary — instead of uniformly.

Determinism argument (docs/STATS.md): the allocator consumes only the
per-cell running counts, which are themselves pure functions of the seed
and the set of chunks executed (:func:`qba_tpu_torch.sweep.chunk_keys`); scheduling is
priority-then-index with no RNG and no timing input, so the full
(cell, chunk) execution sequence — and therefore every chunk result and
the final estimates — is reproducible given the seed and arrival order.
A resumed run replays checkpointed chunks through the same rules in
chunk order before scheduling new work, landing in an identical state.

The allocation *order* never changes the final estimates for the chunks
actually executed: each cell's chunk ``i`` draws keys from
``fold_in(key(seed), i)`` regardless of when the allocator scheduled it,
so adaptive and uniform schedules produce bit-identical per-chunk
results.
"""

from __future__ import annotations

from typing import Any, Sequence

from qba_tpu_torch.stats.sequential import StopDecision
from qba_tpu_torch.stats.targets import Target

__all__ = ["AdaptiveAllocator"]


class _Cell:
    __slots__ = ("index", "label", "rule", "chunks_run", "decision")

    def __init__(self, index: int, label: str, target: Target):
        self.index = index
        self.label = label
        self.rule = target.make_rule()
        self.chunks_run = 0
        self.decision: StopDecision | None = None


class AdaptiveAllocator:
    """Largest-uncertainty-first chunk scheduler over a cell grid.

    Protocol: call :meth:`next_cell` to get the index of the cell that
    should run its next chunk (or ``None`` when every cell is resolved
    or the budget is spent), run that cell's next chunk, then
    :meth:`record` its counts.  The allocator folds the counts into the
    cell's stopping rule and logs a trace row.

    Priority at each step, among unresolved cells:

    1. **bootstrap** — cells with zero observed chunks, in index order
       (every cell gets one chunk before any cell gets two);
    2. **straddling** — for ``decide`` targets, cells whose running CI
       contains the threshold, widest CI first (they need the most
       evidence to resolve); for ``ci_width`` targets every unresolved
       cell straddles by definition;
    3. **undecided** — remaining unresolved cells (CI already excludes
       the threshold but the SPRT boundary has not been crossed),
       widest CI first.

    Ties break by cell index.  No randomness anywhere.
    """

    def __init__(
        self,
        labels: Sequence[str],
        target: Target,
        budget_chunks: int,
    ):
        if not labels:
            raise ValueError("allocator needs at least one cell")
        if budget_chunks < 1:
            raise ValueError(
                f"budget_chunks must be >= 1, got {budget_chunks}"
            )
        self.target = target
        self.budget_chunks = budget_chunks
        self.spent_chunks = 0
        self.cells = [
            _Cell(i, label, target) for i, label in enumerate(labels)
        ]
        #: Allocation log: one row per scheduling step, manifest-ready.
        self.trace: list[dict[str, Any]] = []

    # -- scheduling ---------------------------------------------------

    def _priority(self, cell: _Cell) -> tuple:
        """Sort key: lower sorts first."""
        if cell.chunks_run == 0:
            return (0, cell.index)
        est = cell.rule.estimate()
        width = est.width
        if self.target.kind == "decide":
            straddles = est.lo <= self.target.threshold <= est.hi
        else:
            straddles = True
        tier = 1 if straddles else 2
        # Widest interval first within the tier.
        return (tier, -width, cell.index)

    def next_cell(self) -> int | None:
        """Index of the cell to run next; ``None`` when done."""
        if self.spent_chunks >= self.budget_chunks:
            return None
        open_cells = [c for c in self.cells if c.decision is None]
        if not open_cells:
            return None
        best = min(open_cells, key=self._priority)
        tier = self._priority(best)[0]
        self.trace.append(
            {
                "step": self.spent_chunks,
                "cell": best.index,
                "label": best.label,
                "reason": ("bootstrap", "straddling", "undecided")[tier],
                "ci_width": (
                    best.rule.estimate().width if best.chunks_run else None
                ),
            }
        )
        return best.index

    def record(self, index: int, k: int, n: int) -> StopDecision | None:
        """Fold one executed chunk's counts into cell ``index``.  Returns
        the cell's stop decision if this chunk resolved it."""
        cell = self.cells[index]
        cell.rule.observe(k, n)
        cell.chunks_run += 1
        self.spent_chunks += 1
        dec = cell.rule.decision()
        if dec is not None:
            cell.decision = dec
        return dec

    def preload(self, index: int, k: int, n: int) -> StopDecision | None:
        """Replay a checkpointed chunk on resume: identical rule and
        budget accounting to :meth:`record` (the chunk really was
        executed, by a previous run) with the trace row marked
        ``resume`` instead of a scheduling reason."""
        cell = self.cells[index]
        self.trace.append(
            {
                "step": self.spent_chunks,
                "cell": index,
                "label": cell.label,
                "reason": "resume",
                "ci_width": None,
            }
        )
        return self.record(index, k, n)

    # -- results ------------------------------------------------------

    def finish(self) -> None:
        """Mark every unresolved cell ``budget_exhausted``."""
        for cell in self.cells:
            if cell.decision is None:
                cell.decision = cell.rule.exhausted()

    def decisions(self) -> list[StopDecision]:
        """Per-cell decisions (``finish()`` first to close open cells)."""
        return [
            c.decision
            if c.decision is not None
            else c.rule.exhausted()
            for c in self.cells
        ]

    def summary(self) -> dict[str, Any]:
        """Manifest-ready allocator report."""
        return {
            "target": self.target.to_json(),
            "budget_chunks": self.budget_chunks,
            "spent_chunks": self.spent_chunks,
            "cells": [
                {
                    "index": c.index,
                    "label": c.label,
                    "chunks_run": c.chunks_run,
                    "decision": (
                        c.decision.to_json()
                        if c.decision is not None
                        else None
                    ),
                }
                for c in self.cells
            ],
            "trace": list(self.trace),
        }
