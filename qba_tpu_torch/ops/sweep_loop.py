"""The device-resident stop loop of a precision-targeted run —
counterpart of the JAX package's ``lax.while_loop``
(``qba_tpu/sweep.py::_device_while``, ``_device_loop_foldin`` and
``_device_loop_prefix``); not a ``pallas_call`` site.

A pass of the loop is one chunk.  The sweep's step (:func:`chunk_step`)
derives chunk ``i``'s keys ``split(fold_in(key(seed), i), chunk_trials)``
on the device from the index in the carry; the serving worker's step
(:func:`prefix_step`) gathers rows ``[i * chunk_trials, (i + 1) *
chunk_trials)`` of the request's own key table.  Both run
:func:`~qba_tpu_torch.rounds.engine.run_trial` on the keys, then
:func:`sweep_stop`, which folds the chunk's counts into the carry and
evaluates the stop tables (:func:`~qba_tpu_torch.stats.device.stop_tables`)
and, in the worker's loop, stores the chunk's per-trial success bits.
The carry is one int32 tensor ``[3 + 2 * n_chunks]``: the chunk index
``i``, the running success count ``k_total``, the loop's flag, each
chunk's successes and each chunk's overflow flag (:func:`new_carry`,
:func:`read_carry`).

:func:`device_loop` and :func:`device_loop_prefix` run the loop through
:func:`run_loop`.  On CUDA it is one CUDA graph (:func:`graph_loop`):
the chunk is captured once (``torch.cuda.graph``, after an eager warm-up
pass), a WHILE conditional node takes a copy of it as its body, and the
kernel sets the node's handle (``csrc/sweep_loop.cu``), so the whole
budget is one graph launch and one readback.  Every engine
``run_trial`` runs takes part: the trial megakernel (one launch a
chunk), the per-round engines ``pallas_fused``, ``pallas`` and
``pallas_tiled`` (set-up, then each round's draws and round launches;
with ``collect_counters`` their counters too), and ``xla`` (its eager
rounds, as on the CPU, and ``auto``'s engine past the kernels' 64-bit
masks), over every list path: factorized, stabilizer, ``dense`` and
``dense_pallas``.  :func:`prepare_capture` first builds the per-config
tables a chunk reads (a captured chunk cannot copy from host memory).
A graph that cannot be built raises :class:`GraphLoopError` with the
CUDA error: there is no fallback to a host loop.  On the CPU the loop is
:func:`plain_loop`, the same passes in Python, reading the flag back
after each.

For CUDA tensors :func:`sweep_stop` launches the hand-written kernel; for
CPU tensors it runs :func:`sweep_stop_reference`, its plain version.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops._launch import check, dispatch, timed_launch

# The carry's head: the chunk index, the running success count, the flag.
HEAD = 3
# cudaGraphNodeType values a WHILE node's body may hold (kernel, memcpy,
# memset, child graph, empty, conditional); cudaGraphNodeTypeConditional
# is 13.
BODY_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 4: "child_graph",
                   5: "empty", 13: "conditional"}
NODE_TYPE_NAMES = {**BODY_NODE_TYPES, 3: "host", 6: "wait_event",
                   7: "event_record", 8: "ext_semaphore_signal",
                   9: "ext_semaphore_wait", 10: "mem_alloc", 11: "mem_free",
                   12: "batch_mem_op"}


def new_carry(n_chunks: int, start: int, k_start: int, device) -> torch.Tensor:
    """The loop's carry before chunk ``start``, ``k_start`` successes
    already counted (a resumed prefix)."""
    carry = torch.zeros(HEAD + 2 * n_chunks, dtype=torch.int32, device=device)
    carry[0] = start
    carry[1] = k_start
    return carry


def read_carry(carry: torch.Tensor):
    """``(i, k_total, counts int [n_chunks], overflow bool [n_chunks])``
    from a carry (one device-to-host copy where it lies on a device)."""
    # qba-lint: sync-ok (the loop's one readback, after the graph ends)
    host = carry.cpu().numpy()
    n = (host.shape[0] - HEAD) // 2
    return (int(host[0]), int(host[1]), host[HEAD:HEAD + n].astype(np.int64),
            host[HEAD + n:].astype(bool))


def loop_condition(i: int, k_total: int, lo, hi) -> bool:
    """The loop's condition at totals ``(i, k_total)``: the budget
    (``len(lo) - 1`` chunks) is not spent and the stop tables do not
    fire."""
    return i < len(lo) - 1 and not (k_total <= lo[i] or k_total >= hi[i])


def sweep_stop_reference(success, overflow, lo, hi, carry, succ_out=None):
    """:func:`sweep_stop` in plain PyTorch: updates ``carry`` (and
    ``succ_out``) in place and returns ``carry``."""
    n = (carry.shape[0] - HEAD) // 2
    i = int(carry[0])  # qba-lint: sync-ok (plain version: CPU tensors only)
    go = False
    if 0 <= i < n:
        if succ_out is not None:
            t = success.shape[0]
            succ_out[i * t:(i + 1) * t] = success
        # qba-lint: sync-ok (plain version: CPU tensors only)
        k = int(success.sum())
        # qba-lint: sync-ok (plain version: CPU tensors only)
        k_total = int(carry[1]) + k
        carry[HEAD + i] = k
        # qba-lint: sync-ok (plain version: CPU tensors only)
        carry[HEAD + n + i] = int(overflow.any())
        carry[0] = i + 1
        carry[1] = k_total
        # qba-lint: sync-ok (plain version: CPU tensors only)
        go = loop_condition(i + 1, k_total, lo.tolist(), hi.tolist())
    carry[2] = int(go)  # qba-lint: sync-ok (plain version: CPU tensors only)
    return carry


def sweep_stop(success, overflow, lo, hi, carry, handle: int = 0,
               succ_out=None):
    """One chunk's stop step: adds the chunk's successes (``success``
    bool ``[T]``) and its overflow (any of ``overflow`` bool ``[T]``) to
    the carry at its index ``i``, advances ``i`` and ``k_total``, and
    stores the loop's flag (:func:`loop_condition` at the new totals over
    ``lo``/``hi`` int32 ``[n_chunks + 1]``).  With ``succ_out`` (bool
    ``[n_chunks * T]``) it also stores ``success`` at rows ``[i * T, (i +
    1) * T)`` of it.  Nothing is stored past the budget.  Returns
    ``carry``.

    CPU tensors run :func:`sweep_stop_reference`.  CUDA tensors launch
    the kernel once; it takes exactly these dtypes and shapes, contiguous,
    on one device, and, with a nonzero ``handle`` (a WHILE node's
    conditional handle, inside the loop's graph), also sets the handle to
    the flag.  Any other input raises."""
    if not dispatch("sweep_stop", (carry,)):
        if handle:
            raise ValueError("the graph's handle is set only on CUDA")
        return sweep_stop_reference(success, overflow, lo, hi, carry,
                                    succ_out)
    dev, n_trials = carry.device, success.shape[0]
    n_chunks = (carry.shape[0] - HEAD) // 2
    check("success", success, torch.bool, (n_trials,), dev)
    check("overflow", overflow, torch.bool, (n_trials,), dev)
    check("lo", lo, torch.int32, (n_chunks + 1,), dev)
    check("hi", hi, torch.int32, (n_chunks + 1,), dev)
    check("carry", carry, torch.int32, (HEAD + 2 * n_chunks,), dev)
    if succ_out is not None:
        check("succ_out", succ_out, torch.bool, (n_chunks * n_trials,), dev)
    fn = _lib().qba_sweep_stop
    timed_launch(sweep_stop, fn,
                 [success.data_ptr(), overflow.data_ptr(), lo.data_ptr(),
                  hi.data_ptr(), carry.data_ptr(),
                  None if succ_out is None else succ_out.data_ptr(),
                  n_trials, n_chunks, handle],
                 torch.cuda.current_stream(dev))
    return carry


sweep_stop.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events
# (leave it None while a graph is captured).
sweep_stop.events = None


class GraphLoopError(RuntimeError):
    """A loop graph that the CUDA runtime would not build or launch."""


class GraphLoopUnsupported(ValueError):
    """A loop the graph cannot hold, refused at intake before any
    capture starts: the device surface on a driver without the SWITCH
    node (:func:`~qba_tpu_torch.ops.surface_loop.check_driver`)."""


def prepare_capture(cfg: QBAConfig, device) -> None:
    """Build ``cfg``'s per-config tables on ``device`` now, before the
    warm-up and the capture (a captured chunk cannot copy from the
    host): the stabilizer path's tableaux, operand matrices and affine
    maps; on the dense paths both circuit families' state functions with
    their gate matrices or the circuit kernel's tables."""
    from qba_tpu_torch.qsim import protocol_circuits as pc

    if cfg.qsim_path == "stabilizer":
        pc.prepare_tables(cfg, device)
    elif cfg.qsim_path in ("dense", "dense_pallas"):
        pc.prepare_dense(cfg, device)


def chunk_step(cfg: QBAConfig, chunk_trials: int, root, carry, lo, hi,
               handle: int = 0):
    """One pass of the loop: chunk ``carry[0]``'s keys (``split(fold_in(
    root, i), chunk_trials)``, :func:`qba_tpu_torch.sweep.chunk_keys` on
    the device), :func:`~qba_tpu_torch.rounds.engine.run_trial` on them
    (any engine and list path) and :func:`sweep_stop`.  After
    :func:`prepare_capture` and one eager pass nothing reads the host or
    copies from it, so a CUDA graph can capture it."""
    from qba_tpu_torch.rounds.engine import run_trial

    keys = jr.split(jr.fold_in(root, carry[0]), chunk_trials)
    res = run_trial(cfg, keys)
    sweep_stop(res.success.contiguous(), res.overflow.contiguous(), lo, hi,
               carry, handle)


def prefix_step(cfg: QBAConfig, chunk_trials: int, keys, offsets, carry,
                lo, hi, succ, handle: int = 0):
    """One pass of the serving worker's loop: rows ``carry[0] *
    chunk_trials + offsets`` (``offsets`` is ``arange(chunk_trials)``,
    made before the capture) of the request's key table ``keys`` (int64
    ``[n_chunks * chunk_trials, 2]``),
    :func:`~qba_tpu_torch.rounds.engine.run_trial` on them and
    :func:`sweep_stop`, which also stores the chunk's success bits in
    ``succ``.  As :func:`chunk_step`, any engine and list path: after
    :func:`prepare_capture` and one eager pass nothing reads the host or
    copies from it, so a CUDA graph can capture it."""
    from qba_tpu_torch.rounds.engine import run_trial

    rows = carry[0].to(torch.int64) * chunk_trials + offsets
    res = run_trial(cfg, keys.index_select(0, rows))
    sweep_stop(res.success.contiguous(), res.overflow.contiguous(), lo, hi,
               carry, handle, succ_out=succ)


def plain_loop(step, carry, go: bool) -> int:
    """The loop in Python: ``step(0)`` while the flag holds, reading the
    flag back after each pass.  Returns the readbacks."""
    readbacks = 0
    while go:
        step(0)
        go = bool(carry[2])
        readbacks += 1
    return readbacks


def graph_loop(step, carry, go: bool,
               readback: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The loop as one CUDA graph: ``step(0)`` once eagerly (the warm-up
    graph capture needs), the carry restored, ``step(handle)`` captured
    into a ``torch.cuda.CUDAGraph``, a WHILE node on ``handle`` (default
    ``go``) with a copy of the capture as its body, one launch on the
    current stream and one readback of ``readback`` (the carry, or a
    buffer that holds it).  Raises :class:`GraphLoopError`, with the
    CUDA error, where the graph cannot be built or launched.  Returns the
    readback (on the CPU) and the loop's record: the timings (s), the
    body's node types and the readbacks."""
    lib = _lib()
    dev = carry.device
    start = carry.clone()
    graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    exec_ = ctypes.c_void_p()
    _check(lib.qba_sweep_graph_create(int(go), ctypes.byref(graph),
                                      ctypes.byref(handle)), "create")
    chunk = None
    try:
        t0 = time.perf_counter()
        step(0)
        # qba-lint: sync-ok (graph readback, timing fences)
        torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t0
        carry.copy_(start)
        chunk = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(chunk):
            step(handle.value)
        capture_s = time.perf_counter() - t0
        body = ctypes.c_void_p(chunk.raw_cuda_graph())
        types = (ctypes.c_int * 16)()
        _check(lib.qba_sweep_graph_node_types(body, types), "node types")
        nodes = {NODE_TYPE_NAMES.get(t, str(t)): n
                 for t, n in enumerate(types) if n}
        bad = {t: n for t, n in enumerate(types)
               if n and t not in BODY_NODE_TYPES}
        if bad:
            raise GraphLoopError(
                "the captured chunk holds nodes a WHILE body may not: "
                f"{ {NODE_TYPE_NAMES.get(t, t): n for t, n in bad.items()} }")
        t0 = time.perf_counter()
        _check(lib.qba_sweep_graph_instantiate(graph, handle, body,
                                               ctypes.byref(exec_)),
               "instantiate")
        instantiate_s = time.perf_counter() - t0
        stream = torch.cuda.current_stream(dev)
        # qba-lint: sync-ok (graph readback, timing fences)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _check(lib.qba_sweep_graph_launch(exec_, stream.cuda_stream),
               "launch")
        # The one readback: the loop's whole carry, after the graph ends.
        # qba-lint: sync-ok (graph readback, timing fences)
        host = readback.cpu()
        loop_s = time.perf_counter() - t0
    finally:
        lib.qba_sweep_graph_destroy(graph, exec_)
        del chunk
    return host, dict(warmup_s=warmup_s, capture_s=capture_s,
                      instantiate_s=instantiate_s, loop_s=loop_s,
                      body_nodes=nodes, readbacks=1)


def run_loop(cfg: QBAConfig, step, carry, go: bool, readback):
    """Run ``step`` while the carry's flag holds (``go`` before the
    first pass): the graph loop on CUDA, after ``cfg``'s per-config
    tables are built (:func:`prepare_capture`), the plain loop on the
    CPU.  Returns ``readback`` on the CPU and the loop's record
    (``dispatch``: ``"graph"`` or ``"plain"``, readbacks, and the graph's
    timings)."""
    if carry.device.type != "cuda":
        return readback, dict(dispatch="plain",
                              readbacks=plain_loop(step, carry, go))
    info = dict(dispatch="graph", readbacks=0)
    if not go:
        # qba-lint: sync-ok (no pass to run: the carry is read back once)
        return readback.cpu(), info
    prepare_capture(cfg, carry.device)
    host, record = graph_loop(step, carry, go, readback)
    info.update(record)
    return host, info


def _tables(lo, hi, dev):
    """The stop tables ``lo``/``hi`` (numpy) as int32 tensors on ``dev``."""
    return [torch.from_numpy(np.ascontiguousarray(t, np.int32)).to(dev)
            for t in (lo, hi)]


def device_loop(cfg: QBAConfig, n_chunks: int, chunk_trials: int,
                start: int, k_start: int, lo, hi, device):
    """Chunks ``start, start + 1, ...`` of the budget ``n_chunks`` until
    the stop tables ``lo``/``hi`` (int32 numpy ``[n_chunks + 1]``) fire,
    ``k_start`` successes already counted, through :func:`run_loop`.
    Returns ``(i_stop, counts, overflow, info)`` with the per-chunk
    counts and flags ``[n_chunks]`` (entries before ``start`` and from
    ``i_stop`` on are 0) and ``info`` the loop's record."""
    dev = torch.device(device)
    carry = new_carry(n_chunks, start, k_start, dev)
    lo_d, hi_d = _tables(lo, hi, dev)
    root = jr.key(cfg.seed, dev)

    def step(handle):
        chunk_step(cfg, chunk_trials, root, carry, lo_d, hi_d, handle)

    host, info = run_loop(cfg, step, carry,
                          loop_condition(start, k_start, lo, hi), carry)
    i_stop, _k, counts, ovf = read_carry(host)
    return i_stop, counts, ovf, info


def device_loop_prefix(cfg: QBAConfig, n_chunks: int, chunk_trials: int,
                       keys, lo, hi, device):
    """The serving worker's early finish: chunks ``0, 1, ...`` of the
    budget ``n_chunks``, chunk ``i`` on rows ``[i * chunk_trials, (i + 1)
    * chunk_trials)`` of ``keys`` (int64 ``[n_chunks * chunk_trials, 2]``,
    contiguous, on ``device``), until the stop tables ``lo``/``hi`` fire,
    through :func:`run_loop` (on CUDA one launch and one readback of the
    carry and the success bits, which share one buffer).  Returns
    ``(i_stop, counts, overflow, success, info)``: per-chunk counts and
    flags ``[n_chunks]`` and each trial's success bit (numpy bool
    ``[n_chunks * chunk_trials]``), 0 from chunk ``i_stop`` on, as
    :func:`device_loop` returns them."""
    dev = torch.device(device)
    n_carry = 4 * (HEAD + 2 * n_chunks)
    buf = torch.zeros(n_carry + n_chunks * chunk_trials, dtype=torch.uint8,
                      device=dev)
    carry, succ = buf[:n_carry].view(torch.int32), buf[n_carry:].view(
        torch.bool)
    lo_d, hi_d = _tables(lo, hi, dev)
    offsets = torch.arange(chunk_trials, device=dev)

    def step(handle):
        prefix_step(cfg, chunk_trials, keys, offsets, carry, lo_d, hi_d,
                    succ, handle)

    host, info = run_loop(cfg, step, carry, loop_condition(0, 0, lo, hi),
                          buf)
    i_stop, _k, counts, ovf = read_carry(host[:n_carry].view(torch.int32))
    # qba-lint: sync-ok (host data: the loop's readback)
    return i_stop, counts, ovf, host[n_carry:].view(torch.bool).numpy(), info


def _check(rc: int, what: str) -> None:
    if rc != 0:
        name = _lib().qba_sweep_error_string(rc).decode()
        raise GraphLoopError(f"sweep loop graph: {what} failed: CUDA error "
                           f"{rc} ({name})")


def _lib():
    from qba_tpu_torch.ops._build import load_library

    lib = load_library("sweep_loop")
    if lib.qba_sweep_stop.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qba_sweep_stop.argtypes = [p, p, p, p, p, p, i, i,
                                       ctypes.c_ulonglong, p]
        lib.qba_sweep_graph_create.argtypes = [
            ctypes.c_uint, ctypes.POINTER(p),
            ctypes.POINTER(ctypes.c_ulonglong)]
        lib.qba_sweep_graph_instantiate.argtypes = [p, ctypes.c_ulonglong, p,
                                                    ctypes.POINTER(p)]
        lib.qba_sweep_graph_launch.argtypes = [p, p]
        lib.qba_sweep_graph_destroy.argtypes = [p, p]
        lib.qba_sweep_graph_node_types.argtypes = [
            p, ctypes.POINTER(ctypes.c_int)]
        lib.qba_sweep_error_string.argtypes = [ctypes.c_int]
        lib.qba_sweep_error_string.restype = ctypes.c_char_p
        for fn in (lib.qba_sweep_stop, lib.qba_sweep_graph_create,
                   lib.qba_sweep_graph_instantiate,
                   lib.qba_sweep_graph_launch, lib.qba_sweep_graph_destroy,
                   lib.qba_sweep_graph_node_types):
            fn.restype = ctypes.c_int
    return lib
