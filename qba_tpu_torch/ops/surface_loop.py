"""The device surface: the whole adaptive (strategy x noise x sizeL) grid
of a precision-targeted run as one loop on the device — counterpart of
the JAX package's single-dispatch surface (``qba_tpu/sweep.py::
_device_surface_loop``, a ``lax.while_loop`` whose body scores every open
cell and ``lax.switch``es into the chosen cell's chunk); not a
``pallas_call`` site.

A pass of the loop runs one chunk of one cell in three steps:

1. :func:`surface_pick` scores every cell from its totals (the float32
   mixture interval, :func:`~qba_tpu_torch.stats.device.device_ci_interval`:
   bootstrap cells first in index order, then cells whose interval
   straddles the threshold, then the rest, widest interval first, ties to
   the lower index) and stores the chosen cell, its chunk index and its
   tier;
2. the chosen cell's branch (:func:`branch_step`) runs its chunk on keys
   ``split(fold_in(key(seed), i), chunk_trials)``, ``i`` the cell's chunk
   index read from the carry (every cell shares the seed, so a cell's
   chunk ``i`` is its own ``run_sweep`` chunk ``i``), and copies the
   chunk's success and overflow flags into one slot that every branch
   shares (the chunk may run any engine and list path, as the sweep's
   graph loop's may: :mod:`qba_tpu_torch.ops.sweep_loop`);
3. :func:`surface_fold` folds the slot into the chosen cell's totals,
   decides the cell's stop from the exact integer stop tables
   (:func:`~qba_tpu_torch.stats.device.stop_tables`), records the chunk's
   count, overflow flag and schedule entry, advances the step and stores
   the loop's flag (``step < steps`` and some cell open).

The carry is one int32 tensor (:class:`SurfaceLayout`): the step, the
steps, the chosen cell, its chunk index and the flag, then each cell's
successes, chunks and done flag, the per-cell per-chunk counts and
overflow flags ``[n_cells, budget]`` and the schedule and tiers
``[steps]``.

On CUDA :func:`device_surface_loop` is one CUDA graph
(:func:`graph_surface_loop`): a WHILE node whose body is the captured
pick, a SWITCH node whose branch ``c`` is a copy of cell ``c``'s captured
chunk, and the captured fold; the kernels (``csrc/surface_loop.cu``) set
the SWITCH and WHILE handles.  One launch and one readback run the whole
surface.  The SWITCH node needs a driver of CUDA 12.8 or later
(:func:`check_driver`).  On the CPU the loop is :func:`plain_surface_loop`,
the same passes in Python, reading the flag back after each.

For CUDA tensors :func:`surface_pick` and :func:`surface_fold` launch the
hand-written kernels; for CPU tensors they run
:func:`surface_pick_reference` and :func:`surface_fold_reference`, their
plain versions.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops._launch import check, dispatch, timed_launch
from qba_tpu_torch.ops.sweep_loop import (
    BODY_NODE_TYPES,
    NODE_TYPE_NAMES,
    GraphLoopError,
    GraphLoopUnsupported,
    prepare_capture,
)
from qba_tpu_torch.stats.device import device_ci_interval

# The carry's head.
STEP, STEPS, CHOSEN, I_CUR, FLAG = range(5)
HEAD = 5
# The score of a cell that is done (the JAX loop's).
DONE_SCORE = 1e9
# The first driver with the SWITCH conditional node (CUDA 12.8).
SWITCH_DRIVER = 12080


class SurfaceLayout(NamedTuple):
    """Sizes of a surface carry: ``n_cells`` cells, ``budget`` chunks a
    cell at most, ``steps`` passes at most."""

    n_cells: int
    budget: int
    steps: int

    @property
    def size(self) -> int:
        return HEAD + 3 * self.n_cells + 2 * self.n_cells * self.budget \
            + 2 * self.steps

    def section(self, name: str) -> slice:
        """The carry's slice ``name``: ``k``, ``i``, ``done``,
        ``counts``, ``ovf`` (both flat ``[n_cells * budget]``),
        ``sched`` or ``tier``."""
        n, nb = self.n_cells, self.n_cells * self.budget
        sizes = {"k": n, "i": n, "done": n, "counts": nb, "ovf": nb,
                 "sched": self.steps, "tier": self.steps}
        start = HEAD
        for key, size in sizes.items():
            if key == name:
                return slice(start, start + size)
            start += size
        raise KeyError(name)


def new_surface_carry(layout: SurfaceLayout, k, i, done,
                      device) -> torch.Tensor:
    """The carry before the first pass: each cell's successes ``k``,
    chunks ``i`` and done flag ``done`` (sequences of ``n_cells``), the
    step 0 and the flag clear."""
    host = torch.zeros(layout.size, dtype=torch.int32)
    host[STEPS] = layout.steps
    for name, values in (("k", k), ("i", i), ("done", done)):
        host[layout.section(name)] = torch.as_tensor(
            [int(v) for v in values], dtype=torch.int32)
    return host.to(device)


def read_surface_carry(layout: SurfaceLayout, carry: torch.Tensor) -> dict:
    """The carry as numpy arrays (one device-to-host copy where it lies on
    a device): ``step``, ``chosen``, ``i_cur``, ``flag``, ``k``, ``i``,
    ``done``, ``counts`` and ``ovf`` ``[n_cells, budget]``, ``sched`` and
    ``tier``."""
    # qba-lint: sync-ok (the loop's one readback, after the graph ends)
    host = carry.cpu().numpy()
    out = dict(step=int(host[STEP]), chosen=int(host[CHOSEN]),
               i_cur=int(host[I_CUR]), flag=bool(host[FLAG]))
    for name in ("k", "i", "done", "counts", "ovf", "sched", "tier"):
        out[name] = host[layout.section(name)].astype(np.int64)
    out["done"] = out["done"].astype(bool)
    shape = (layout.n_cells, layout.budget)
    out["counts"] = out["counts"].reshape(shape)
    out["ovf"] = out["ovf"].reshape(shape).astype(bool)
    return out


def pick_constants(confidence: float) -> tuple[float, float]:
    """``(crit, lbeta0)``: the interval's critical value ``log(1 / (1 -
    confidence))`` and ``log B(1/2, 1/2)``, each taken to float32 once."""
    return (float(np.float32(math.log(1.0 / (1.0 - confidence)))),
            float(np.float32(math.log(math.pi))))


def surface_scores(k, i, done, chunk_trials: int, confidence: float,
                   threshold: float | None):
    """Each cell's float32 score and tier from its totals, in plain
    PyTorch on the tensors' device: ``k`` successes in ``i`` chunks of
    ``chunk_trials`` trials (integer tensors) and ``done`` (bool).  A done
    cell scores 1e9; else ``2 * tier + (bootstrap ? 0 : 1 - width)``, tier
    0 for a cell with no chunk, 1 for one whose interval straddles
    ``threshold`` (every open cell where it is None, a width target), 2
    for the rest.  Returns ``(score, tier, lo, hi)``."""
    dev = k.device
    lo, hi = device_ci_interval(k, i * chunk_trials, confidence)
    boot = i == 0
    if threshold is None:
        straddle = torch.ones_like(boot)
    else:
        thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
        straddle = (lo <= thr) & (thr <= hi)
    tier = torch.where(boot, 0, torch.where(straddle, 1, 2))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    done_score = torch.tensor(DONE_SCORE, dtype=torch.float32, device=dev)
    score = torch.where(done, done_score, tier.to(torch.float32) * 2.0
                        + torch.where(boot, zero, 1.0 - (hi - lo)))
    return score, tier, lo, hi


def surface_pick_reference(carry, ci, layout: SurfaceLayout,
                           chunk_trials: int, confidence: float,
                           threshold: float | None):
    """:func:`surface_pick` in plain PyTorch, on the carry's device:
    updates ``carry`` and ``ci`` in place and returns ``carry``."""
    i = carry[layout.section("i")]
    score, tier, lo, hi = surface_scores(
        carry[layout.section("k")], i, carry[layout.section("done")] != 0,
        chunk_trials, confidence, threshold)
    ci[0].copy_(lo)
    ci[1].copy_(hi)
    # qba-lint: sync-ok (plain version: CPU tensors only)
    chosen = int(torch.argmin(score))  # the first of equal scores
    # qba-lint: sync-ok (plain version: CPU tensors only)
    step = int(carry[STEP])
    carry[CHOSEN] = chosen
    # qba-lint: sync-ok (plain version: CPU tensors only)
    carry[I_CUR] = int(i[chosen])
    if 0 <= step < layout.steps:
        # qba-lint: sync-ok (plain version: CPU tensors only)
        carry[layout.section("tier").start + step] = int(tier[chosen])
    return carry


def surface_pick(carry, ci, layout: SurfaceLayout, chunk_trials: int,
                 confidence: float, threshold: float | None,
                 handle: int = 0):
    """One pick step: each cell's float32 interval into ``ci`` (float32
    ``[2, n_cells]``, lower ends then upper ends) and the chosen cell, its
    chunk index and (at the carry's step) its tier into ``carry`` (int32
    ``[layout.size]``).  ``threshold`` is the decide boundary, or None for
    a width target (every open cell straddles).  Returns ``carry``.

    CPU tensors run :func:`surface_pick_reference`.  CUDA tensors launch
    the kernel once; it takes exactly these dtypes and shapes, contiguous,
    on one device, and, with a nonzero ``handle`` (the SWITCH node's, in
    the surface's graph), also sets the handle to the chosen cell.  Any
    other input raises."""
    if not dispatch("surface_pick", (carry,)):
        if handle:
            raise ValueError("the graph's handle is set only on CUDA")
        return surface_pick_reference(carry, ci, layout, chunk_trials,
                                      confidence, threshold)
    dev = carry.device
    check("carry", carry, torch.int32, (layout.size,), dev)
    check("ci", ci, torch.float32, (2, layout.n_cells), dev)
    crit, lbeta0 = pick_constants(confidence)
    timed_launch(surface_pick, _lib().qba_surface_pick,
                 [carry.data_ptr(), ci.data_ptr(), layout.n_cells,
                  layout.budget, chunk_trials, crit, lbeta0,
                  0.0 if threshold is None else threshold,
                  int(threshold is not None), handle],
                 torch.cuda.current_stream(dev))
    return carry


surface_pick.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events
# (leave it None while a graph is captured).
surface_pick.events = None


def surface_fold_reference(success, overflow, lo, hi, carry,
                           layout: SurfaceLayout):
    """:func:`surface_fold` in plain PyTorch, on the carry's device:
    updates ``carry`` in place and returns it."""
    n, budget = layout.n_cells, layout.budget
    # qba-lint: sync-ok (plain version: CPU tensors only)
    chosen, i_cur, step = (int(carry[x]) for x in (CHOSEN, I_CUR, STEP))
    go = False
    if 0 <= chosen < n and 0 <= i_cur < budget and 0 <= step < layout.steps:
        # qba-lint: sync-ok (plain version: CPU tensors only)
        k = int(success.sum())
        # qba-lint: sync-ok (plain version: CPU tensors only)
        o = int(overflow.any())
        kc = layout.section("k").start + chosen
        # qba-lint: sync-ok (plain version: CPU tensors only)
        k_new = int(carry[kc]) + k
        # qba-lint: sync-ok (plain version: CPU tensors only)
        stopped = k_new <= int(lo[i_cur + 1]) or k_new >= int(hi[i_cur + 1])
        carry[kc] = k_new
        carry[layout.section("i").start + chosen] = i_cur + 1
        # qba-lint: sync-ok (plain version: CPU tensors only)
        carry[layout.section("done").start + chosen] = int(stopped)
        carry[layout.section("counts").start + chosen * budget + i_cur] = k
        carry[layout.section("ovf").start + chosen * budget + i_cur] = o
        carry[layout.section("sched").start + step] = chosen
        carry[STEP] = step + 1
        # qba-lint: sync-ok (plain version: CPU tensors only)
        go = step + 1 < layout.steps and not bool(
            carry[layout.section("done")].all())
    # qba-lint: sync-ok (plain version: CPU tensors only)
    carry[FLAG] = int(go)
    return carry


def surface_fold(success, overflow, lo, hi, carry, layout: SurfaceLayout,
                 handle: int = 0):
    """One fold step: the chunk in the slot (``success`` and ``overflow``
    bool ``[T]``) into the chosen cell's totals, its stop decision from
    ``lo``/``hi`` (int32 ``[budget + 1]``) at its new chunk count, the
    chunk's count, overflow flag and schedule entry, the step advanced and
    the loop's flag stored.  Nothing is stored where the chosen cell, its
    chunk index or the step lies outside the carry.  Returns ``carry``.

    CPU tensors run :func:`surface_fold_reference`.  CUDA tensors launch
    the kernel once; it takes exactly these dtypes and shapes, contiguous,
    on one device, and, with a nonzero ``handle`` (the WHILE node's, in
    the surface's graph), also sets the handle to the flag.  Any other
    input raises."""
    if not dispatch("surface_fold", (carry,)):
        if handle:
            raise ValueError("the graph's handle is set only on CUDA")
        return surface_fold_reference(success, overflow, lo, hi, carry,
                                      layout)
    dev, n_trials = carry.device, success.shape[0]
    check("success", success, torch.bool, (n_trials,), dev)
    check("overflow", overflow, torch.bool, (n_trials,), dev)
    check("lo", lo, torch.int32, (layout.budget + 1,), dev)
    check("hi", hi, torch.int32, (layout.budget + 1,), dev)
    check("carry", carry, torch.int32, (layout.size,), dev)
    timed_launch(surface_fold, _lib().qba_surface_fold,
                 [success.data_ptr(), overflow.data_ptr(), lo.data_ptr(),
                  hi.data_ptr(), carry.data_ptr(), n_trials, layout.n_cells,
                  layout.budget, handle],
                 torch.cuda.current_stream(dev))
    return carry


surface_fold.launches = 0
surface_fold.events = None


def branch_step(cfg: QBAConfig, chunk_trials: int, root, carry, slot) -> None:
    """Cell ``cfg``'s branch: chunk ``carry[I_CUR]``'s keys
    (``split(fold_in(root, i), chunk_trials)``),
    :func:`~qba_tpu_torch.rounds.engine.run_trial` on them, and the
    chunk's success and overflow flags copied into ``slot`` (bool ``[2,
    chunk_trials]``, made before any capture, shared by every branch).
    Nothing reads the host, so a CUDA graph can capture it."""
    from qba_tpu_torch.rounds.engine import run_trial

    keys = jr.split(jr.fold_in(root, carry[I_CUR]), chunk_trials)
    res = run_trial(cfg, keys)
    slot[0].copy_(res.success)
    slot[1].copy_(res.overflow)


def check_driver(device) -> int:
    """Raise :class:`GraphLoopUnsupported` unless ``device``'s driver has
    the SWITCH conditional node (CUDA 12.8); returns the driver's
    version."""
    driver, _runtime = versions(device)
    if driver < SWITCH_DRIVER:
        raise GraphLoopUnsupported(
            f"the device surface's graph switches into each cell's chunk "
            f"with a SWITCH conditional node, which needs a CUDA driver of "
            f"12.8 or later; this driver is {driver // 1000}."
            f"{driver % 1000 // 10}: use dispatch='host'")
    return driver


def versions(device) -> tuple[int, int]:
    """The CUDA driver's and runtime's versions (``1000 * major + 10 *
    minor``) on ``device``."""
    driver, runtime = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _check(_lib().qba_surface_versions(ctypes.byref(driver),
                                           ctypes.byref(runtime)), "versions")
    return driver.value, runtime.value


class SurfaceRun(NamedTuple):
    """What a surface loop needs besides its cells' configs."""

    layout: SurfaceLayout
    chunk_trials: int
    confidence: float
    threshold: float | None
    carry: torch.Tensor  # int32 [layout.size]
    ci: torch.Tensor  # float32 [2, n_cells]
    slot: torch.Tensor  # bool [2, chunk_trials]
    lo: torch.Tensor  # int32 [budget + 1]
    hi: torch.Tensor
    root: torch.Tensor  # the shared seed's key

    def pick(self, handle: int = 0):
        surface_pick(self.carry, self.ci, self.layout, self.chunk_trials,
                     self.confidence, self.threshold, handle)

    def fold(self, handle: int = 0):
        surface_fold(self.slot[0], self.slot[1], self.lo, self.hi,
                     self.carry, self.layout, handle)

    def branch(self, cfg: QBAConfig):
        branch_step(cfg, self.chunk_trials, self.root, self.carry, self.slot)


def plain_surface_loop(cfgs, run: SurfaceRun, go: bool):
    """The loop in Python: pick, the chosen cell's branch as a call, fold,
    while the flag holds, reading the chosen cell and the flag back each
    pass.  Returns the carry and the loop's record (readbacks)."""
    readbacks = 0
    while go:
        run.pick()
        run.branch(cfgs[int(run.carry[CHOSEN])])
        run.fold()
        go = bool(run.carry[FLAG])
        readbacks += 1
    return run.carry, dict(dispatch="plain", readbacks=readbacks)


def _capture(fn, pool, what: str) -> torch.cuda.CUDAGraph:
    """``fn`` captured into a graph that keeps its CUDA graph, in the
    memory pool ``pool``; a capture the runtime refuses raises
    :class:`GraphLoopError`."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(graph, pool=pool):
            fn()
    except RuntimeError as e:
        raise GraphLoopError(f"surface loop graph: capturing {what} "
                             f"failed: {e}") from e
    return graph


def _node_types(graph: torch.cuda.CUDAGraph, what: str) -> dict:
    """``graph``'s node types by name; raises :class:`GraphLoopError` for
    a node a conditional node's body may not hold."""
    from qba_tpu_torch.ops.sweep_loop import _lib as sweep_lib

    types = (ctypes.c_int * 16)()
    _check(sweep_lib().qba_sweep_graph_node_types(
        ctypes.c_void_p(graph.raw_cuda_graph()), types), "node types")
    bad = {NODE_TYPE_NAMES.get(t, t): n for t, n in enumerate(types)
           if n and t not in BODY_NODE_TYPES}
    if bad:
        raise GraphLoopError(f"{what} holds nodes a conditional node's body "
                             f"may not: {bad}")
    return {NODE_TYPE_NAMES.get(t, str(t)): n for t, n in enumerate(types)
            if n}


def graph_surface_loop(cfgs, run: SurfaceRun, go: bool):
    """The loop as one CUDA graph: the pick and the fold once eagerly,
    the carry restored, each captured (with the SWITCH and the WHILE
    handle); then, cell by cell in grid order, the cell's tables built
    (``prepare_capture``), its branch once eagerly, the slot and carry
    restored and the branch captured, every capture in one shared memory
    pool (one branch runs a pass, and what outlives it lies in the carry
    and the slot, made outside the pool); the WHILE node (handle default
    ``go``) whose body is pick, SWITCH (branch ``c`` a copy of cell ``c``'s
    capture) and fold, instantiated and uploaded to the device; one launch
    on the current stream and one readback of the carry.  Raises
    :class:`GraphLoopError`, with the CUDA error, where the graph cannot
    be built or launched.  Returns the carry (on
    the CPU) and the loop's record: the timings (s: warm-up, capture,
    instantiate, upload, loop), the node types of the pick, the fold and
    each branch, and the readbacks."""
    lib = _lib()
    dev = run.carry.device
    carry0, slot0 = run.carry.clone(), run.slot.clone()
    graph, body, exec_ = (ctypes.c_void_p() for _ in range(3))
    while_h, switch_h = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    _check(lib.qba_surface_graph_create(
        int(go), ctypes.byref(graph), ctypes.byref(while_h),
        ctypes.byref(body), ctypes.byref(switch_h)), "create")
    pool = torch.cuda.graph_pool_handle()
    captures = []
    try:
        t0 = time.perf_counter()
        run.pick()
        run.fold()
        # qba-lint: sync-ok (graph readback, timing fences)
        torch.cuda.synchronize(dev)
        warmup_s = [time.perf_counter() - t0]
        run.carry.copy_(carry0)
        t0 = time.perf_counter()
        captures.append(_capture(lambda: run.pick(switch_h.value), pool,
                                 "the pick"))
        captures.append(_capture(lambda: run.fold(while_h.value), pool,
                                 "the fold"))
        capture_s = [time.perf_counter() - t0]
        nodes = {"pick": _node_types(captures[0], "the pick"),
                 "fold": _node_types(captures[1], "the fold")}
        for c, cfg in enumerate(cfgs):
            prepare_capture(cfg, dev)
            t0 = time.perf_counter()
            run.branch(cfg)
            # qba-lint: sync-ok (graph readback, timing fences)
            torch.cuda.synchronize(dev)
            warmup_s.append(time.perf_counter() - t0)
            run.carry.copy_(carry0)
            run.slot.copy_(slot0)
            t0 = time.perf_counter()
            captures.append(_capture(lambda cfg=cfg: run.branch(cfg), pool,
                                     f"cell {c}'s chunk"))
            capture_s.append(time.perf_counter() - t0)
            nodes[f"branch_{c}"] = _node_types(captures[-1],
                                               f"cell {c}'s chunk")
        branches = (ctypes.c_void_p * len(cfgs))(
            *[g.raw_cuda_graph() for g in captures[2:]])
        t0 = time.perf_counter()
        pick, fold = (ctypes.c_void_p(g.raw_cuda_graph())
                      for g in captures[:2])
        _check(lib.qba_surface_graph_instantiate(
            graph, body, switch_h, pick, fold, branches, len(cfgs),
            ctypes.byref(exec_)), "instantiate")
        instantiate_s = time.perf_counter() - t0
        stream = torch.cuda.current_stream(dev)
        t0 = time.perf_counter()
        _check(lib.qba_surface_graph_upload(exec_, stream.cuda_stream),
               "upload")
        # qba-lint: sync-ok (graph readback, timing fences)
        torch.cuda.synchronize(dev)
        upload_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _check(lib.qba_surface_graph_launch(exec_, stream.cuda_stream),
               "launch")
        # The one readback: the whole carry, after the graph ends.
        # qba-lint: sync-ok (graph readback, timing fences)
        host = run.carry.cpu()
        loop_s = time.perf_counter() - t0
    finally:
        lib.qba_surface_graph_destroy(graph, exec_)
        del captures
    total = {}
    for counts in nodes.values():
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    return host, dict(
        dispatch="graph", readbacks=1, design="switch",
        warmup_s=sum(warmup_s), warmup_cell_s=warmup_s[1:],
        capture_s=sum(capture_s), capture_cell_s=capture_s[1:],
        instantiate_s=instantiate_s, upload_s=upload_s, loop_s=loop_s,
        body_nodes=nodes, body_nodes_total=total)


def device_surface_loop(cfgs, steps: int, budget: int, chunk_trials: int,
                        confidence: float, threshold: float | None, k, i,
                        done, lo, hi, device):
    """At most ``steps`` chunks over the cells ``cfgs`` (one config a
    cell, all of one seed), each cell starting from ``k`` successes in
    ``i`` chunks and its ``done`` flag, the budget ``budget`` chunks a
    cell and the stop tables ``lo``/``hi`` (int32 numpy ``[budget +
    1]``): the graph loop on CUDA (:func:`graph_surface_loop`), the plain
    loop on the CPU.  Returns the final carry
    (:func:`read_surface_carry`) and the loop's record (``dispatch``:
    ``"graph"`` or ``"plain"``, readbacks, passes, and the graph's
    timings)."""
    dev = torch.device(device)
    layout = SurfaceLayout(len(cfgs), budget, steps)
    tables = [torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(dev)
              for t in (lo, hi)]
    run = SurfaceRun(
        layout=layout, chunk_trials=chunk_trials, confidence=confidence,
        threshold=threshold,
        carry=new_surface_carry(layout, k, i, done, dev),
        ci=torch.zeros((2, layout.n_cells), dtype=torch.float32, device=dev),
        slot=torch.zeros((2, chunk_trials), dtype=torch.bool, device=dev),
        lo=tables[0], hi=tables[1], root=jr.key(cfgs[0].seed, dev))
    go = steps > 0 and not all(bool(d) for d in done)
    if dev.type != "cuda":
        host, info = plain_surface_loop(cfgs, run, go)
    elif go:
        host, info = graph_surface_loop(cfgs, run, go)
    else:
        # qba-lint: sync-ok (no pass to run: the carry is read back once)
        host, info = run.carry.cpu(), dict(dispatch="graph", readbacks=0)
    out = read_surface_carry(layout, host)
    info["passes"] = out["step"]
    return out, info


def _check(rc: int, what: str) -> None:
    if rc != 0:
        name = _lib().qba_surface_error_string(rc).decode()
        raise GraphLoopError(f"surface loop graph: {what} failed: CUDA "
                             f"error {rc} ({name})")


def _lib():
    from qba_tpu_torch.ops._build import load_library

    lib = load_library("surface_loop")
    if lib.qba_surface_pick.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ull = ctypes.c_ulonglong
        lib.qba_surface_pick.argtypes = [p, p, i, i, i, f, f, f, i, ull, p]
        lib.qba_surface_fold.argtypes = [p, p, p, p, p, i, i, i, ull, p]
        lib.qba_surface_versions.argtypes = [ctypes.POINTER(i),
                                             ctypes.POINTER(i)]
        lib.qba_surface_graph_create.argtypes = [
            ctypes.c_uint, ctypes.POINTER(p), ctypes.POINTER(ull),
            ctypes.POINTER(p), ctypes.POINTER(ull)]
        lib.qba_surface_graph_instantiate.argtypes = [
            p, p, ull, p, p, ctypes.POINTER(p), i, ctypes.POINTER(p)]
        lib.qba_surface_graph_launch.argtypes = [p, p]
        lib.qba_surface_graph_upload.argtypes = [p, p]
        lib.qba_surface_graph_destroy.argtypes = [p, p]
        lib.qba_surface_error_string.argtypes = [i]
        lib.qba_surface_error_string.restype = ctypes.c_char_p
        for fn in (lib.qba_surface_pick, lib.qba_surface_fold,
                   lib.qba_surface_versions, lib.qba_surface_graph_create,
                   lib.qba_surface_graph_instantiate,
                   lib.qba_surface_graph_upload, lib.qba_surface_graph_launch,
                   lib.qba_surface_graph_destroy):
            fn.restype = ctypes.c_int
    return lib
