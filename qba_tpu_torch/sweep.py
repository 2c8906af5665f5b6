"""Chunked, checkpoint-resumable Monte-Carlo sweeps — counterpart of
:mod:`qba_tpu.sweep`.

A sweep runs chunks of trials; chunk ``i``'s keys are
``split(fold_in(key(seed), i), chunk_trials)``, a pure function of
``(seed, i)``, so a resumed sweep consumes the same randomness as an
uninterrupted one and every chunk equals the JAX package's for the same
config.  Progress is checkpointed as JSON (the config fingerprint and
per-chunk counts) in the JAX package's format: both ``QBAConfig``\\ s have
the same fields in the same order, so a checkpoint written by either
package resumes in the other.

``run_sweep`` runs a fixed budget of chunks (double-buffered: chunk k+1
is dispatched before chunk k is read back) or, with ``target=``, one
chunk at a time until the target's anytime-valid stopping rule fires.
``dispatch="device"`` keeps that loop on the card: one CUDA graph whose
WHILE node runs a captured chunk and a kernel that evaluates the stop
tables (:mod:`qba_tpu_torch.ops.sweep_loop`), one launch and one
readback for the whole budget.  ``run_surface`` runs a (strategy x noise
x sizeL) grid of sweeps, uniformly or, with ``target=``, by the adaptive
allocator; with ``dispatch="device"`` the whole adaptive grid is one
CUDA graph whose WHILE node picks a cell and switches into its captured
chunk (:mod:`qba_tpu_torch.ops.surface_loop`).  Every surface cell
carries its run manifest (:mod:`qba_tpu_torch.obs.manifest`).

Entry points run on CUDA unless the caller passes ``device="cpu"``:
``device=None`` raises without a card.  The JAX package's
``QBA_COMPILE_CACHE`` has no counterpart: the port's kernels are cached
by their build (``ops/_build.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.backends.torch_backend import resolve_device
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.diagnostics import (
    QBACheckpointMismatch,
    QBAWarning,
    record_decisions,
    warn_and_record,
)
from qba_tpu_torch.obs.events import EventLog
from qba_tpu_torch.obs.manifest import collect_manifest
from qba_tpu_torch.obs.timers import PhaseTimers
from qba_tpu_torch.stats.estimators import SweepEstimators
from qba_tpu_torch.stats.estimators import success_rate as _success_rate
from qba_tpu_torch.stats.sequential import StopDecision
from qba_tpu_torch.stats.targets import Target, parse_target


@dataclasses.dataclass(frozen=True)
class ChunkResult:
    chunk: int
    trials: int
    successes: int
    overflow: bool
    # Per-chunk phase timings (seconds) where the sweep timed them; None
    # in checkpoints written without.  compare=False: a resumed sweep's
    # chunks compare equal to an uninterrupted run's.
    dispatch_s: float | None = dataclasses.field(default=None, compare=False)
    readback_s: float | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    cfg: QBAConfig
    chunks: tuple[ChunkResult, ...]
    resumed_chunks: int  # how many chunks came from the checkpoint
    # Targeted runs only: why the run stopped, with the anytime-valid
    # estimate at stop.  compare=False: a targeted run that executed the
    # same chunks as a fixed-budget run compares equal to it.
    stop: StopDecision | None = dataclasses.field(default=None, compare=False)
    # Which control loop produced the chunks: "host" (one readback a
    # chunk) or "device" (the loop on the device, one readback).
    dispatch: str = dataclasses.field(default="host", compare=False)

    @property
    def n_trials(self) -> int:
        return sum(c.trials for c in self.chunks)

    @property
    def successes(self) -> int:
        return sum(c.successes for c in self.chunks)

    @property
    def success_rate(self) -> float:
        # nan on zero trials, everywhere.
        return _success_rate(self.successes, self.n_trials)

    @property
    def any_overflow(self) -> bool:
        return any(c.overflow for c in self.chunks)

    def estimators(
        self, method: str = "wilson", confidence: float = 0.95
    ) -> SweepEstimators:
        """The certified-rate view of this sweep."""
        return SweepEstimators(
            method=method, confidence=confidence
        ).observe_all(self.chunks)

    def stats_summary(
        self, method: str = "wilson", confidence: float = 0.95
    ) -> dict[str, Any]:
        """Report-ready statistics block: every rate carries a CI, the
        stop decision rides along on targeted runs."""
        out = self.estimators(method=method, confidence=confidence).summary()
        out["n_trials"] = self.n_trials
        out["dispatch"] = self.dispatch
        if self.stop is not None:
            out["stop"] = self.stop.to_json()
        return out


def chunk_keys(cfg: QBAConfig, chunk: int, chunk_trials: int,
               device=None) -> torch.Tensor:
    """The chunk's trial keys int64 ``[chunk_trials, 2]`` on ``device``
    — a pure function of (seed, chunk), so a resumed sweep consumes
    randomness identical to an uninterrupted one."""
    root = jr.fold_in(jr.key(cfg.seed, device), chunk)
    return jr.split(root, chunk_trials)


def _config_fingerprint(cfg: QBAConfig) -> dict[str, Any]:
    # ``trials`` is chunk sizing, not part of the scientific question:
    # the (forceable) chunk_trials check owns that disagreement.
    d = dataclasses.asdict(cfg)
    d.pop("trials", None)
    return d


def _atomic_write_json(path: str, payload: dict[str, Any]) -> None:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(
    path: str, cfg: QBAConfig, chunk_trials: int, force: bool = False
) -> list[ChunkResult]:
    """Completed chunks from ``path``; [] if absent.

    Raises :class:`~qba_tpu_torch.diagnostics.QBACheckpointMismatch` (a
    ``ValueError``) on a config or chunk-size mismatch: a checkpoint is
    only valid for the exact sweep.  ``force=True`` downgrades the
    *chunk_trials* mismatch to a warning and returns ``[]``, so the
    caller re-chunks from scratch (the next save overwrites).  A
    *config* mismatch is never forceable.
    """
    if not os.path.exists(path):
        return []
    with open(path) as f:
        payload = json.load(f)
    # Older checkpoints recorded ``trials`` inside the fingerprint.
    stored = dict(payload.get("config") or {})
    stored.pop("trials", None)
    want = _config_fingerprint(cfg)
    if stored != want:
        raise QBACheckpointMismatch(
            f"checkpoint {path} was written for a different config: "
            f"{stored} != {want}",
            kind="config",
            path=path,
            checkpoint_fingerprint=stored,
            requested_fingerprint=want,
        )
    if payload.get("chunk_trials") != chunk_trials:
        err = QBACheckpointMismatch(
            f"checkpoint {path} used chunk_trials={payload.get('chunk_trials')}, "
            f"requested {chunk_trials}",
            kind="chunk_trials",
            path=path,
            checkpoint_fingerprint=payload.get("chunk_trials"),
            requested_fingerprint=chunk_trials,
        )
        if not force:
            raise err
        warn_and_record(
            f"{err} — resume_force: discarding the checkpoint and "
            "re-chunking from scratch",
            QBACheckpointMismatch,
            site="sweep.load_checkpoint",
            path=path,
            checkpoint_chunk_trials=payload.get("chunk_trials"),
            requested_chunk_trials=chunk_trials,
        )
        return []
    return [ChunkResult(**c) for c in payload["chunks"]]


def save_checkpoint(
    path: str,
    cfg: QBAConfig,
    chunk_trials: int,
    chunks: list[ChunkResult],
    stats: dict[str, Any] | None = None,
) -> None:
    payload = {
        "config": _config_fingerprint(cfg),
        "chunk_trials": chunk_trials,
        "chunks": [dataclasses.asdict(c) for c in chunks],
    }
    if stats is not None:
        # Targeted runs persist the target spec and the stop state; the
        # chunk data alone rebuilds the rule on replay.
        payload["stats"] = stats
    _atomic_write_json(path, payload)


def _default_runner(chunk_trials: int, log: EventLog | None, device):
    """One device's batch, or the chunk dp-sharded over every visible
    CUDA device when there are several and they divide the chunk."""
    from qba_tpu_torch.backends.torch_backend import batched_trials

    n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n == 1 or chunk_trials % n != 0:
        if log and n > 1:
            log.info(
                "sweep",
                "chunk size not divisible by device count; running "
                "single-device",
                devices=n,
                chunk_trials=chunk_trials,
            )
        return batched_trials
    from qba_tpu_torch.parallel import make_mesh, run_trials_sharded

    mesh = make_mesh({"dp": n})
    if log:
        log.info("sweep", "chunks dp-sharded over devices", devices=n)

    def runner(cfg, keys):
        return run_trials_sharded(cfg, mesh, keys).trials

    return runner


def _read_chunk(res) -> tuple[int, bool]:
    """A chunk's success count and overflow flag: one device-to-host
    copy, which waits for the chunk."""
    # qba-lint: sync-ok (the chunk's one readback, timed in a fenced span)
    k, o = torch.stack([res.success.sum(), res.overflow.any().long()]).tolist()
    return int(k), bool(o)


def run_chunk(
    cfg: QBAConfig,
    chunk: int,
    chunk_trials: int,
    runner,
    timers: PhaseTimers,
    device=None,
) -> ChunkResult:
    """Execute ONE chunk: dispatch span, fenced readback span,
    :class:`ChunkResult` out.  The sequential paths (``target=`` sweeps,
    the surface allocator) run this: a stopping rule must see chunk k's
    counts before deciding whether chunk k+1 runs at all."""
    keys = chunk_keys(cfg, chunk, chunk_trials, device)
    t0 = timers.total("dispatch")
    with timers.time("dispatch", chunk=chunk):
        res = runner(cfg, keys)
    dispatch_s = timers.total("dispatch") - t0
    t1 = timers.total("readback")
    with timers.time("readback", chunk=chunk) as sp:
        successes, overflow = _read_chunk(res)
        sp.fenced = True
    return ChunkResult(
        chunk=chunk,
        trials=chunk_trials,
        successes=successes,
        overflow=overflow,
        dispatch_s=dispatch_s,
        readback_s=timers.total("readback") - t1,
    )


def _replay_prefix(
    loaded: list[ChunkResult], rule, max_chunks: int
) -> tuple[list[ChunkResult], StopDecision | None]:
    """Feed checkpointed chunks to a fresh stopping rule in chunk order.

    Only the contiguous prefix starting at chunk 0 counts, so a resumed
    targeted run replays exactly the chunks an uninterrupted run would
    have executed and lands in the same rule state.  Replay stops at the
    first decision."""
    by_index = {c.chunk: c for c in loaded}
    replayed: list[ChunkResult] = []
    for i in range(max_chunks):
        c = by_index.get(i)
        if c is None:
            break
        rule.observe(c.successes, c.trials)
        replayed.append(c)
        dec = rule.decision()
        if dec is not None:
            return replayed, dec
    return replayed, None


def _run_sweep_targeted_device(
    cfg: QBAConfig,
    target: Target,
    n_chunks: int,
    chunk_trials: int,
    checkpoint: str | None,
    log: EventLog | None,
    timers: PhaseTimers,
    resume_force: bool,
    device: torch.device,
) -> SweepResult:
    """The ``dispatch="device"`` targeted path: the loop of
    :func:`~qba_tpu_torch.ops.sweep_loop.device_loop` (one CUDA graph
    launch and one readback on the card), then a host replay of the
    per-chunk counts through ``target``'s rule: the same executed chunks,
    the same :class:`StopDecision` and the same checkpoint as
    :func:`_run_sweep_targeted` for identical keys.  The span
    ``device_loop`` carries the loop's record (``dispatch``, readbacks,
    and on the card the graph's warm-up, capture, instantiate and loop
    seconds and the captured chunk's node types)."""
    from qba_tpu_torch.ops.sweep_loop import device_loop
    from qba_tpu_torch.stats.device import stop_tables

    rule = target.make_rule()
    loaded = (
        load_checkpoint(checkpoint, cfg, chunk_trials, force=resume_force)
        if checkpoint
        else []
    )
    chunks, decision = _replay_prefix(loaded, rule, n_chunks)
    resumed = len(chunks)
    extra = [c for c in loaded if c.chunk >= len(chunks)]
    if log and resumed:
        log.info(
            "sweep",
            "resumed targeted run from checkpoint",
            chunks=resumed,
            path=checkpoint,
            dispatch="device",
        )

    start = len(chunks)
    if decision is None and start < n_chunks:
        lo, hi = stop_tables(target, n_chunks, chunk_trials)
        k_start = sum(c.successes for c in chunks)
        with timers.time(
            "device_loop",
            budget_chunks=n_chunks - start,
            chunk_trials=chunk_trials,
        ) as sp:
            # The loop's one readback ends inside: the span is fenced.
            i_stop, counts, ovf, info = device_loop(
                cfg, n_chunks, chunk_trials, start, k_start, lo, hi, device)
            sp.fenced = True
            sp.args.update(info)
        for c in range(start, i_stop):
            cr = ChunkResult(
                chunk=c,
                trials=chunk_trials,
                successes=int(counts[c]),
                overflow=bool(ovf[c]),
            )
            chunks.append(cr)
            rule.observe(cr.successes, cr.trials)
            decision = rule.decision()
            if decision is not None:
                break
        executed = len(chunks)
        # A decision landing exactly on the final budget chunk is
        # consistent: the loop exits on i == n_chunks either way.
        if executed != i_stop or (decision is None and i_stop < n_chunks):
            # The stop tables are built by bisection over the rule's own
            # arithmetic, so a divergence is a real fault: warn, and keep
            # the (valid) executed chunks.
            warn_and_record(
                "device stop table diverged from the host rule: device "
                f"stopped after {i_stop} chunks, host replay after "
                f"{executed}",
                QBAWarning,
                site="sweep._run_sweep_targeted_device",
                device_stop=i_stop,
                host_stop=executed,
            )
        if checkpoint:
            save_checkpoint(
                checkpoint,
                cfg,
                chunk_trials,
                chunks + extra,
                stats={
                    "target": target.to_json(),
                    "stop": decision.to_json() if decision else None,
                    "dispatch": "device",
                },
            )

    stop = decision if decision is not None else rule.exhausted()
    if log:
        log.info(
            "sweep",
            "targeted sweep stopped",
            reason=stop.reason,
            n_trials=stop.n_trials,
            dispatch="device",
        )
    return SweepResult(
        cfg=cfg,
        chunks=tuple(chunks),
        resumed_chunks=resumed,
        stop=stop,
        dispatch="device",
    )


def _run_sweep_targeted(
    cfg: QBAConfig,
    target: Target,
    n_chunks: int,
    chunk_trials: int,
    checkpoint: str | None,
    log: EventLog | None,
    timers: PhaseTimers,
    runner,
    resume_force: bool,
    device: torch.device,
) -> SweepResult:
    """The ``target=`` path of :func:`run_sweep`: chunks run one at a
    time through ``target``'s stopping rule until it fires or the
    ``n_chunks`` budget is spent.  The executed chunks equal a
    fixed-budget run's prefix: the rule only chooses where it ends."""
    rule = target.make_rule()
    loaded = (
        load_checkpoint(checkpoint, cfg, chunk_trials, force=resume_force)
        if checkpoint
        else []
    )
    chunks, decision = _replay_prefix(loaded, rule, n_chunks)
    resumed = len(chunks)
    extra = [c for c in loaded if c.chunk >= len(chunks)]
    if log and resumed:
        log.info(
            "sweep",
            "resumed targeted run from checkpoint",
            chunks=resumed,
            path=checkpoint,
        )

    next_chunk = len(chunks)
    while decision is None and next_chunk < n_chunks:
        if runner is None:
            runner = _default_runner(chunk_trials, log, device)
        cr = run_chunk(cfg, next_chunk, chunk_trials, runner, timers, device)
        chunks.append(cr)
        rule.observe(cr.successes, cr.trials)
        decision = rule.decision()
        if checkpoint:
            save_checkpoint(
                checkpoint,
                cfg,
                chunk_trials,
                chunks + extra,
                stats={
                    "target": target.to_json(),
                    "stop": decision.to_json() if decision else None,
                },
            )
        if log:
            log.info(
                "sweep",
                "chunk done",
                chunk=cr.chunk,
                successes=cr.successes,
                trials=cr.trials,
                decided=decision is not None,
            )
        next_chunk += 1

    stop = decision if decision is not None else rule.exhausted()
    if log:
        log.info(
            "sweep",
            "targeted sweep stopped",
            reason=stop.reason,
            n_trials=stop.n_trials,
        )
    return SweepResult(
        cfg=cfg, chunks=tuple(chunks), resumed_chunks=resumed, stop=stop
    )


@dataclasses.dataclass(frozen=True)
class SurfaceCell:
    """One (strategy x noise x size_l) grid point of an adversary
    surface, with the run manifest of the config that ran (None where
    ``run_surface(with_manifest=False)``)."""

    strategy: str
    p_depolarize: float
    p_measure_flip: float
    size_l: int
    result: SweepResult
    manifest: dict[str, Any] | None = None


def _surface_grid(
    cfg: QBAConfig,
    strategies,
    noise_points,
    size_ls,
    checkpoint_dir: str | None,
) -> list[tuple[str, float, float, int, QBAConfig, str | None]]:
    """The flattened (strategy x noise x sizeL) cell list with per-cell
    configs and checkpoint paths, shared by both surface paths."""
    grid = []
    for strat in strategies:
        for p_dep, p_mf in noise_points:
            for size_l in size_ls:
                cfg_cell = dataclasses.replace(
                    cfg,
                    strategy=strat,
                    p_depolarize=p_dep,
                    p_measure_flip=p_mf,
                    size_l=size_l,
                )
                ckpt = None
                if checkpoint_dir:
                    os.makedirs(checkpoint_dir, exist_ok=True)
                    # Content-addressed cell filename (the atlas store's
                    # slug of the config fingerprint): cells of
                    # independent runs merge without renames.
                    from qba_tpu_torch.atlas.store import cell_slug

                    addressed = os.path.join(
                        checkpoint_dir,
                        cell_slug(_config_fingerprint(cfg_cell)) + ".json",
                    )
                    # An older coordinate-named file keeps resuming until
                    # the addressed one exists (load_checkpoint still
                    # checks its fingerprint).
                    legacy = os.path.join(
                        checkpoint_dir,
                        f"surface_{strat}_p{p_dep}_q{p_mf}_L{size_l}.json",
                    )
                    ckpt = (
                        legacy
                        if os.path.exists(legacy)
                        and not os.path.exists(addressed)
                        else addressed
                    )
                grid.append((strat, p_dep, p_mf, size_l, cfg_cell, ckpt))
    return grid


def _surface_labels(grid) -> list[str]:
    return [f"{strat}_p{p_dep}_q{p_mf}_L{size_l}"
            for strat, p_dep, p_mf, size_l, _, _ in grid]


def _surface_cells(grid, results, decisions_of, target, alloc_summary,
                   with_manifest, log, labels, device) -> list[SurfaceCell]:
    """The targeted paths' cells: each cell's result with, where asked,
    its manifest (the decisions recorded while it ran, and a ``stats``
    block with its certified rate, the target and the allocator's
    summary)."""
    cells: list[SurfaceCell] = []
    for idx, (strat, p_dep, p_mf, size_l, cfg_cell, _) in enumerate(grid):
        res = results[idx]
        manifest = None
        if with_manifest:
            stats_block = res.stats_summary(confidence=target.confidence)
            stats_block["target"] = target.to_json()
            stats_block["allocator"] = alloc_summary
            manifest = collect_manifest(
                cfg_cell,
                device=device,
                command="surface",
                decisions=decisions_of(idx),
                extra={"stats": stats_block},
            )
        cells.append(
            SurfaceCell(
                strategy=strat,
                p_depolarize=p_dep,
                p_measure_flip=p_mf,
                size_l=size_l,
                result=res,
                manifest=manifest,
            )
        )
        if log:
            log.info(
                "surface",
                "cell resolved",
                cell=labels[idx],
                reason=res.stop.reason,
                n_trials=res.n_trials,
            )
    return cells


def _run_surface_targeted_device(
    cfg: QBAConfig,
    strategies,
    noise_points,
    size_ls,
    target: Target,
    budget_chunks: int,
    chunk_trials: int,
    checkpoint_dir: str | None,
    log: EventLog | None,
    with_manifest: bool,
    resume_force: bool,
    device: torch.device,
) -> list[SurfaceCell]:
    """The ``dispatch="device"`` surface: the whole adaptive grid runs
    through :func:`~qba_tpu_torch.ops.surface_loop.device_surface_loop`
    (on the card one CUDA graph launch and one readback); the host replays
    the readback (the schedule and per-cell counts) through the same
    per-cell rules for typed :class:`StopDecision`\\ s, the allocator
    trace, per-cell checkpoints and manifests, the artifacts of
    :func:`_run_surface_targeted`.  The span ``device_loop`` carries the
    loop's record."""
    from qba_tpu_torch.ops.surface_loop import device_surface_loop
    from qba_tpu_torch.stats.device import stop_tables

    grid = _surface_grid(cfg, strategies, noise_points, size_ls, checkpoint_dir)
    labels = _surface_labels(grid)
    n_cells = len(grid)
    timers = PhaseTimers()
    rules = [target.make_rule() for _ in grid]
    cell_chunks: list[list[ChunkResult]] = [[] for _ in grid]
    cell_decision: list[StopDecision | None] = [None] * n_cells
    cell_resumed = [0] * n_cells
    trace: list[dict[str, Any]] = []

    # Resume: replay each cell's checkpointed contiguous prefix, in
    # cell-index order: the host allocator's rule state and budget.
    spent = 0
    for idx, (_, _, _, _, cfg_cell, ckpt) in enumerate(grid):
        if not ckpt:
            continue
        loaded = load_checkpoint(
            ckpt, cfg_cell, chunk_trials, force=resume_force
        )
        replayed, dec = _replay_prefix(loaded, rules[idx], budget_chunks)
        cell_chunks[idx] = replayed
        cell_decision[idx] = dec
        cell_resumed[idx] = len(replayed)
        for _ in replayed:
            trace.append(
                {
                    "step": spent,
                    "cell": idx,
                    "label": labels[idx],
                    "reason": "resume",
                    "ci_width": None,
                }
            )
            spent += 1
        if log and cell_resumed[idx]:
            log.info(
                "surface",
                "cell resumed from checkpoint",
                cell=labels[idx],
                chunks=cell_resumed[idx],
            )

    steps = max(0, budget_chunks - spent)
    open_cells = any(d is None for d in cell_decision)
    decisions_log: list[dict] = []
    if steps > 0 and open_cells:
        lo, hi = stop_tables(target, budget_chunks, chunk_trials)
        threshold = target.threshold if target.kind == "decide" else None
        with record_decisions() as decisions_log:
            with timers.time(
                "device_loop",
                budget_chunks=steps,
                cells=n_cells,
                chunk_trials=chunk_trials,
            ) as sp:
                # The loop's one readback ends inside: the span is fenced.
                out, info = device_surface_loop(
                    [g[4] for g in grid], steps, budget_chunks,
                    chunk_trials, target.confidence, threshold,
                    [r.k for r in rules], [len(c) for c in cell_chunks],
                    [d is not None for d in cell_decision], lo, hi, device)
                sp.fenced = True
                sp.args.update(info)

        # Host replay of the device schedule: exact rule state, exact
        # decisions, the allocator's trace.
        for s in range(out["step"]):
            idx = int(out["sched"][s])
            chunk_index = len(cell_chunks[idx])
            est_width = (
                rules[idx].estimate().width if chunk_index else None
            )
            cr = ChunkResult(
                chunk=chunk_index,
                trials=chunk_trials,
                successes=int(out["counts"][idx, chunk_index]),
                overflow=bool(out["ovf"][idx, chunk_index]),
            )
            cell_chunks[idx].append(cr)
            rules[idx].observe(cr.successes, cr.trials)
            trace.append(
                {
                    "step": spent,
                    "cell": idx,
                    "label": labels[idx],
                    "reason": (
                        "bootstrap", "straddling", "undecided"
                    )[int(out["tier"][s])],
                    "ci_width": est_width,
                }
            )
            spent += 1
            dec = rules[idx].decision()
            if dec is not None and cell_decision[idx] is None:
                cell_decision[idx] = dec
            if log:
                log.info(
                    "surface",
                    "allocated chunk done",
                    cell=labels[idx],
                    chunk=chunk_index,
                    successes=cr.successes,
                    decided=dec is not None,
                    dispatch="device",
                )

    for idx, (_, _, _, _, cfg_cell, ckpt) in enumerate(grid):
        if ckpt and len(cell_chunks[idx]) > cell_resumed[idx]:
            save_checkpoint(
                ckpt,
                cfg_cell,
                chunk_trials,
                cell_chunks[idx],
                stats={
                    "target": target.to_json(),
                    "stop": (
                        cell_decision[idx].to_json()
                        if cell_decision[idx]
                        else None
                    ),
                    "dispatch": "device",
                },
            )

    decisions = [
        cell_decision[i]
        if cell_decision[i] is not None
        else rules[i].exhausted()
        for i in range(n_cells)
    ]
    alloc_summary = {
        "target": target.to_json(),
        "budget_chunks": budget_chunks,
        "spent_chunks": spent,
        "dispatch": "device",
        "cells": [
            {
                "index": i,
                "label": labels[i],
                "chunks_run": len(cell_chunks[i]),
                "decision": decisions[i].to_json(),
            }
            for i in range(n_cells)
        ],
        "trace": trace,
    }
    results = [
        SweepResult(
            cfg=grid[idx][4],
            chunks=tuple(cell_chunks[idx]),
            resumed_chunks=cell_resumed[idx],
            stop=decisions[idx],
            dispatch="device",
        )
        for idx in range(n_cells)
    ]
    return _surface_cells(grid, results, lambda idx: list(decisions_log),
                          target, alloc_summary, with_manifest, log, labels,
                          device)


def _run_surface_targeted(
    cfg: QBAConfig,
    strategies,
    noise_points,
    size_ls,
    target: Target,
    budget_chunks: int,
    chunk_trials: int,
    checkpoint_dir: str | None,
    log: EventLog | None,
    runner,
    with_manifest: bool,
    resume_force: bool,
    device: torch.device,
) -> list[SurfaceCell]:
    """The ``target=`` path of :func:`run_surface`: one shared chunk
    budget spent across the grid by the adaptive allocator
    (:class:`~qba_tpu_torch.stats.AdaptiveAllocator`).  Each executed
    chunk is the same pure function of (cell config seed, chunk index)
    as in the uniform path; only the per-cell chunk counts differ."""
    from qba_tpu_torch.stats.allocate import AdaptiveAllocator

    grid = _surface_grid(cfg, strategies, noise_points, size_ls, checkpoint_dir)
    labels = _surface_labels(grid)
    alloc = AdaptiveAllocator(labels, target, budget_chunks)
    timers = PhaseTimers()
    cell_chunks: list[list[ChunkResult]] = [[] for _ in grid]
    cell_decisions: list[list[dict]] = [[] for _ in grid]
    cell_resumed = [0] * len(grid)

    # Resume: replay each cell's checkpointed contiguous prefix through
    # the allocator in cell-index order, chunk order within a cell.
    for idx, (_, _, _, _, cfg_cell, ckpt) in enumerate(grid):
        if not ckpt:
            continue
        loaded = load_checkpoint(ckpt, cfg_cell, chunk_trials, force=resume_force)
        by_index = {c.chunk: c for c in loaded}
        i = 0
        while i in by_index and alloc.cells[idx].decision is None:
            c = by_index[i]
            cell_chunks[idx].append(c)
            alloc.preload(idx, c.successes, c.trials)
            i += 1
        cell_resumed[idx] = len(cell_chunks[idx])
        if log and cell_resumed[idx]:
            log.info(
                "surface",
                "cell resumed from checkpoint",
                cell=labels[idx],
                chunks=cell_resumed[idx],
            )

    while (idx := alloc.next_cell()) is not None:
        cfg_cell, ckpt = grid[idx][4], grid[idx][5]
        if runner is None:
            runner = _default_runner(chunk_trials, log, device)
        chunk_index = len(cell_chunks[idx])
        with record_decisions() as decs:
            cr = run_chunk(cfg_cell, chunk_index, chunk_trials, runner,
                           timers, device)
        cell_decisions[idx].extend(decs)
        cell_chunks[idx].append(cr)
        dec = alloc.record(idx, cr.successes, cr.trials)
        if ckpt:
            save_checkpoint(
                ckpt,
                cfg_cell,
                chunk_trials,
                cell_chunks[idx],
                stats={
                    "target": target.to_json(),
                    "stop": dec.to_json() if dec else None,
                },
            )
        if log:
            log.info(
                "surface",
                "allocated chunk done",
                cell=labels[idx],
                chunk=chunk_index,
                successes=cr.successes,
                decided=dec is not None,
            )

    alloc.finish()
    decisions = alloc.decisions()
    results = [
        SweepResult(
            cfg=grid[idx][4],
            chunks=tuple(cell_chunks[idx]),
            resumed_chunks=cell_resumed[idx],
            stop=decisions[idx],
        )
        for idx in range(len(grid))
    ]
    return _surface_cells(grid, results, lambda idx: cell_decisions[idx],
                          target, alloc.summary(), with_manifest, log,
                          labels, device)


def run_surface(
    cfg: QBAConfig,
    strategies: tuple[str, ...] | list[str],
    noise_points: list[tuple[float, float]],
    size_ls: list[int],
    n_chunks: int = 1,
    chunk_trials: int | None = None,
    checkpoint_dir: str | None = None,
    log: EventLog | None = None,
    runner=None,
    with_manifest: bool = True,
    target: Target | str | None = None,
    budget_chunks: int | None = None,
    resume_force: bool = False,
    dispatch: str = "host",
    store_dir: str | None = None,
    device=None,
) -> list[SurfaceCell]:
    """The (strategy x noise x sizeL) adversary surface: every cell is a
    :func:`run_sweep` over the same runner, with the same key discipline
    and checkpoint format.

    ``noise_points`` are ``(p_depolarize, p_measure_flip)`` pairs.  With
    ``checkpoint_dir``, each cell checkpoints to its own file (named by
    the slug of its config fingerprint) and a re-run resumes cell by
    cell.  ``target`` switches to the precision-targeted path: the
    adaptive allocator spends one shared chunk budget (``budget_chunks``,
    default ``n_chunks x n_cells``) across the grid,
    largest-uncertainty-first, until every cell's rule resolves or the
    budget runs out.  ``store_dir`` publishes every finished cell into a
    content-addressed atlas store (:mod:`qba_tpu_torch.atlas.store`).

    With ``with_manifest`` (the default), each cell carries the run
    manifest collected around its own run
    (:func:`~qba_tpu_torch.obs.manifest.collect_manifest`, command
    ``"surface"``) with a ``stats`` block: the cell's certified rate and,
    on the targeted paths, the target and the allocator's summary.

    ``dispatch="device"`` (targeted runs only) moves the allocator loop
    onto the device: on CUDA the whole grid is one CUDA graph
    (:mod:`qba_tpu_torch.ops.surface_loop`), one launch and one readback;
    on the CPU the same passes run in Python.  Per-cell chunks and stop
    decisions equal the host allocator's; the schedule may reorder
    near-tied cells (float32 widths on the device against float64 on the
    host).  Every engine and list path runs in it.  It takes no custom
    ``runner``, and a CUDA driver without the graph's SWITCH node raises
    :class:`~qba_tpu_torch.ops.sweep_loop.GraphLoopUnsupported` before
    anything runs.

    ``device=None`` means CUDA (raises without a card); ``device="cpu"``
    runs the plain PyTorch path.
    """
    if dispatch not in ("host", "device"):
        raise ValueError(
            f"dispatch must be 'host' or 'device', got {dispatch!r}"
        )
    if dispatch == "device" and target is None:
        raise ValueError(
            "dispatch='device' needs a target: the device surface loop's "
            "condition is the all-cells-resolved predicate"
        )
    if dispatch == "device" and runner is not None:
        raise ValueError(
            "dispatch='device' cannot take a custom runner: the loop "
            "body switches into each cell's captured chunk"
        )
    dev = resolve_device(device)
    if dispatch == "device" and dev.type == "cuda":
        from qba_tpu_torch.ops.surface_loop import check_driver

        check_driver(dev)
    if chunk_trials is None:
        chunk_trials = cfg.trials
    if target is not None:
        if isinstance(target, str):
            target = parse_target(target)
        n_cells = len(strategies) * len(noise_points) * len(size_ls)
        budget = (budget_chunks if budget_chunks is not None
                  else n_chunks * n_cells)
        if dispatch == "device":
            cells = _run_surface_targeted_device(
                cfg, strategies, noise_points, size_ls, target, budget,
                chunk_trials, checkpoint_dir, log, with_manifest,
                resume_force, dev,
            )
        else:
            cells = _run_surface_targeted(
                cfg, strategies, noise_points, size_ls, target, budget,
                chunk_trials, checkpoint_dir, log, runner, with_manifest,
                resume_force, dev,
            )
        return _publish_surface_cells(cells, store_dir, target, chunk_trials)

    cells: list[SurfaceCell] = []
    grid = _surface_grid(cfg, strategies, noise_points, size_ls, checkpoint_dir)
    for strat, p_dep, p_mf, size_l, cfg_cell, ckpt in grid:
        with record_decisions() as decisions:
            res = run_sweep(
                cfg_cell,
                n_chunks=n_chunks,
                chunk_trials=chunk_trials,
                checkpoint=ckpt,
                log=log,
                runner=runner,
                resume_force=resume_force,
                device=dev,
            )
        manifest = (
            collect_manifest(
                cfg_cell,
                device=dev,
                command="surface",
                decisions=decisions,
                extra={"stats": res.stats_summary()},
            )
            if with_manifest
            else None
        )
        cells.append(
            SurfaceCell(
                strategy=strat,
                p_depolarize=p_dep,
                p_measure_flip=p_mf,
                size_l=size_l,
                result=res,
                manifest=manifest,
            )
        )
        if log:
            log.info(
                "surface",
                "cell done",
                strategy=strat,
                p_depolarize=p_dep,
                p_measure_flip=p_mf,
                size_l=size_l,
                success_rate=res.success_rate,
            )
    return _publish_surface_cells(cells, store_dir, None, chunk_trials)


def _publish_surface_cells(
    cells: list[SurfaceCell],
    store_dir: str | None,
    target: Target | None,
    chunk_trials: int,
) -> list[SurfaceCell]:
    """Optionally publish surface cells into a content-addressed atlas
    store (``run_surface(store_dir=...)``); always returns the cells."""
    if store_dir:
        from qba_tpu_torch.atlas.store import AtlasStore, record_from_surface_cell

        store = AtlasStore(store_dir)
        for cell in cells:
            store.write_cell(
                record_from_surface_cell(cell, target, chunk_trials)
            )
    return cells


def run_sweep(
    cfg: QBAConfig,
    n_chunks: int,
    chunk_trials: int | None = None,
    checkpoint: str | None = None,
    log: EventLog | None = None,
    timers: PhaseTimers | None = None,
    runner=None,
    target: Target | str | None = None,
    resume_force: bool = False,
    dispatch: str = "host",
    device=None,
) -> SweepResult:
    """Run ``n_chunks`` batches of ``chunk_trials`` trials each on
    ``device`` (``None``: CUDA, raising without a card; ``"cpu"``: the
    plain PyTorch path).

    ``runner(cfg, keys) -> TrialResult`` defaults to one device's batch
    (:func:`qba_tpu_torch.backends.torch_backend.batched_trials`), or to
    the chunk dp-sharded over every visible CUDA device when there are
    several and they divide the chunk.  With ``checkpoint``, completed
    chunks are persisted after each chunk and skipped on re-run.

    ``target`` (a :class:`~qba_tpu_torch.stats.Target` or its string
    form, e.g. ``"decide vs 1/3 @ 95%"`` / ``"ci_width<=0.002"``)
    switches to the precision-targeted path: chunks run one at a time
    through the target's anytime-valid stopping rule until it fires;
    ``n_chunks`` becomes the budget ceiling and ``SweepResult.stop``
    records the decision.  ``resume_force`` forwards to
    :func:`load_checkpoint`.

    ``dispatch`` selects the targeted run's control loop: ``"host"``
    (dispatch, readback, rule update, per chunk) or ``"device"`` (the
    loop on the device: on CUDA one graph launch and one readback for
    the whole budget, :mod:`qba_tpu_torch.ops.sweep_loop`; on the CPU
    the same passes in Python).  Both execute identical chunks and stop
    at the same chunk boundary.  ``"device"`` needs ``target`` and runs
    the built-in engine batch (any engine and list path): it takes no
    custom ``runner``.
    """
    if dispatch not in ("host", "device"):
        raise ValueError(
            f"dispatch must be 'host' or 'device', got {dispatch!r}"
        )
    if dispatch == "device":
        if target is None:
            raise ValueError(
                "dispatch='device' needs a target: the device loop's "
                "condition IS the stopping predicate (a fixed-budget "
                "sweep has nothing to decide on device — use the "
                "double-buffered host path)"
            )
        if runner is not None:
            raise ValueError(
                "dispatch='device' cannot take a custom runner: the "
                "loop body is the captured run_trial chunk"
            )
    dev = resolve_device(device)
    if chunk_trials is None:
        chunk_trials = cfg.trials
    timers = timers or PhaseTimers()

    if target is not None:
        if isinstance(target, str):
            target = parse_target(target)
        if dispatch == "device":
            return _run_sweep_targeted_device(
                cfg, target, n_chunks, chunk_trials, checkpoint, log,
                timers, resume_force, dev,
            )
        return _run_sweep_targeted(
            cfg, target, n_chunks, chunk_trials, checkpoint, log, timers,
            runner, resume_force, dev,
        )

    loaded = (
        load_checkpoint(checkpoint, cfg, chunk_trials, force=resume_force)
        if checkpoint
        else []
    )
    # A checkpoint may hold more chunks than this invocation asks for;
    # aggregate only the requested range (the file keeps the full set).
    chunks = [c for c in loaded if c.chunk < n_chunks]
    extra = [c for c in loaded if c.chunk >= n_chunks]
    done = {c.chunk for c in chunks}
    resumed = len(chunks)
    if log and resumed:
        log.info("sweep", "resumed from checkpoint", chunks=resumed, path=checkpoint)

    todo = [c for c in range(n_chunks) if c not in done]
    # Double-buffered pipeline: dispatch chunk k+1 before reading chunk
    # k back, so the readback's wait overlaps the next chunk's work;
    # depth 2 bounds device memory to two chunk batches.  A finished
    # chunk is drained and checkpointed even if the next dispatch raises.
    in_flight: list[tuple[int, Any, float]] = []

    def drain_one() -> None:
        chunk, res, dispatch_s = in_flight.pop(0)
        t0 = timers.total("readback")
        with timers.time("readback", chunk=chunk) as sp:
            successes, overflow = _read_chunk(res)
            sp.fenced = True
        cr = ChunkResult(
            chunk=chunk,
            trials=chunk_trials,
            successes=successes,
            overflow=overflow,
            dispatch_s=dispatch_s,
            readback_s=timers.total("readback") - t0,
        )
        chunks.append(cr)
        if checkpoint:
            save_checkpoint(checkpoint, cfg, chunk_trials, chunks + extra)
        if log:
            log.info(
                "sweep",
                "chunk done",
                chunk=chunk,
                successes=cr.successes,
                trials=cr.trials,
            )

    try:
        for chunk in todo:
            if runner is None:
                # Lazy: a fully-checkpointed re-run builds no runner.
                runner = _default_runner(chunk_trials, log, dev)
            keys = chunk_keys(cfg, chunk, chunk_trials, dev)
            t0 = timers.total("dispatch")
            with timers.time("dispatch", chunk=chunk):
                res = runner(cfg, keys)
            in_flight.append((chunk, res, timers.total("dispatch") - t0))
            if len(in_flight) >= 2:
                drain_one()
    finally:
        # Preserve completed work if a dispatch fails mid-pipeline.
        while in_flight:
            drain_one()

    chunks.sort(key=lambda c: c.chunk)
    return SweepResult(cfg=cfg, chunks=tuple(chunks), resumed_chunks=resumed)
