"""The device-resident stop loop of a precision-targeted sweep —
counterpart of the JAX package's ``lax.while_loop``
(``qba_tpu/sweep.py::_device_while`` and ``_device_loop_foldin``); not a
``pallas_call`` site.

A pass of the loop is one chunk (:func:`chunk_step`): chunk ``i``'s keys
``split(fold_in(key(seed), i), chunk_trials)`` derived on the device from
the index in the carry, :func:`~qba_tpu_torch.rounds.engine.run_trial` on
them, then :func:`sweep_stop`, which folds the chunk's counts into the
carry and evaluates the stop tables
(:func:`~qba_tpu_torch.stats.device.stop_tables`).  The carry is one
int32 tensor ``[3 + 2 * n_chunks]``: the chunk index ``i``, the running
success count ``k_total``, the loop's flag, each chunk's successes and
each chunk's overflow flag (:func:`new_carry`, :func:`read_carry`).

:func:`device_loop` runs the loop.  On CUDA it is one CUDA graph
(:func:`graph_loop`): the chunk is captured once (``torch.cuda.graph``,
after an eager warm-up pass), a WHILE conditional node takes a copy of it
as its body, and the kernel sets the node's handle
(``csrc/sweep_loop.cu``), so the whole budget is one graph launch and one
readback of the carry.  A graph that cannot be built raises with the
CUDA error: there is no fallback to a host loop.  On the CPU it is
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
    host = carry.cpu().numpy()
    n = (host.shape[0] - HEAD) // 2
    return (int(host[0]), int(host[1]), host[HEAD:HEAD + n].astype(np.int64),
            host[HEAD + n:].astype(bool))


def loop_condition(i: int, k_total: int, lo, hi) -> bool:
    """The loop's condition at totals ``(i, k_total)``: the budget
    (``len(lo) - 1`` chunks) is not spent and the stop tables do not
    fire."""
    return i < len(lo) - 1 and not (k_total <= lo[i] or k_total >= hi[i])


def sweep_stop_reference(success, overflow, lo, hi, carry):
    """:func:`sweep_stop` in plain PyTorch: updates ``carry`` in place
    and returns it."""
    n = (carry.shape[0] - HEAD) // 2
    i = int(carry[0])
    go = False
    if 0 <= i < n:
        k = int(success.sum())
        k_total = int(carry[1]) + k
        carry[HEAD + i] = k
        carry[HEAD + n + i] = int(overflow.any())
        carry[0] = i + 1
        carry[1] = k_total
        go = loop_condition(i + 1, k_total, lo.tolist(), hi.tolist())
    carry[2] = int(go)
    return carry


def sweep_stop(success, overflow, lo, hi, carry, handle: int = 0):
    """One chunk's stop step: adds the chunk's successes (``success``
    bool ``[T]``) and its overflow (any of ``overflow`` bool ``[T]``) to
    the carry at its index ``i``, advances ``i`` and ``k_total``, and
    stores the loop's flag (:func:`loop_condition` at the new totals over
    ``lo``/``hi`` int32 ``[n_chunks + 1]``).  Returns ``carry``.

    CPU tensors run :func:`sweep_stop_reference`.  CUDA tensors launch
    the kernel once; it takes exactly these dtypes and shapes, contiguous,
    on one device, and, with a nonzero ``handle`` (a WHILE node's
    conditional handle, inside the loop's graph), also sets the handle to
    the flag.  Any other input raises."""
    if not dispatch("sweep_stop", (carry,)):
        if handle:
            raise ValueError("the graph's handle is set only on CUDA")
        return sweep_stop_reference(success, overflow, lo, hi, carry)
    dev, n_trials = carry.device, success.shape[0]
    n_chunks = (carry.shape[0] - HEAD) // 2
    check("success", success, torch.bool, (n_trials,), dev)
    check("overflow", overflow, torch.bool, (n_trials,), dev)
    check("lo", lo, torch.int32, (n_chunks + 1,), dev)
    check("hi", hi, torch.int32, (n_chunks + 1,), dev)
    check("carry", carry, torch.int32, (HEAD + 2 * n_chunks,), dev)
    fn = _lib().qba_sweep_stop
    timed_launch(sweep_stop, fn,
                 [success.data_ptr(), overflow.data_ptr(), lo.data_ptr(),
                  hi.data_ptr(), carry.data_ptr(), n_trials, n_chunks,
                  handle], torch.cuda.current_stream(dev))
    return carry


sweep_stop.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events
# (leave it None while a graph is captured).
sweep_stop.events = None


def chunk_step(cfg: QBAConfig, chunk_trials: int, root, carry, lo, hi,
               handle: int = 0):
    """One pass of the loop: chunk ``carry[0]``'s keys (``split(fold_in(
    root, i), chunk_trials)``, :func:`qba_tpu_torch.sweep.chunk_keys` on
    the device), :func:`~qba_tpu_torch.rounds.engine.run_trial` on them
    and :func:`sweep_stop`.  Nothing reads the host, so a CUDA graph can
    capture it."""
    from qba_tpu_torch.rounds.engine import run_trial

    keys = jr.split(jr.fold_in(root, carry[0]), chunk_trials)
    res = run_trial(cfg, keys)
    sweep_stop(res.success.contiguous(), res.overflow.contiguous(), lo, hi,
               carry, handle)


def plain_loop(step, carry, go: bool) -> int:
    """The loop in Python: ``step(0)`` while the flag holds, reading the
    flag back after each pass.  Returns the readbacks."""
    readbacks = 0
    while go:
        step(0)
        go = bool(carry[2])
        readbacks += 1
    return readbacks


def graph_loop(step, carry, go: bool) -> tuple[torch.Tensor, dict]:
    """The loop as one CUDA graph: ``step(0)`` once eagerly (the warm-up
    graph capture needs), the carry restored, ``step(handle)`` captured
    into a ``torch.cuda.CUDAGraph``, a WHILE node on ``handle`` (default
    ``go``) with a copy of the capture as its body, one launch on the
    current stream and one readback of the carry.  Raises, with the
    CUDA error, where the graph cannot be built or run.  Returns the
    carry as read back (on the CPU) and the loop's record: the timings
    (s), the body's node types and the readbacks."""
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
            raise RuntimeError(
                "the captured chunk holds nodes a WHILE body may not: "
                f"{ {NODE_TYPE_NAMES.get(t, t): n for t, n in bad.items()} }")
        t0 = time.perf_counter()
        _check(lib.qba_sweep_graph_instantiate(graph, handle, body,
                                               ctypes.byref(exec_)),
               "instantiate")
        instantiate_s = time.perf_counter() - t0
        stream = torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _check(lib.qba_sweep_graph_launch(exec_, stream.cuda_stream),
               "launch")
        # The one readback: the loop's whole carry, after the graph ends.
        host = carry.cpu()
        loop_s = time.perf_counter() - t0
    finally:
        lib.qba_sweep_graph_destroy(graph, exec_)
        del chunk
    return host, dict(warmup_s=warmup_s, capture_s=capture_s,
                      instantiate_s=instantiate_s, loop_s=loop_s,
                      body_nodes=nodes, readbacks=1)


def device_loop(cfg: QBAConfig, n_chunks: int, chunk_trials: int,
                start: int, k_start: int, lo, hi, device):
    """Chunks ``start, start + 1, ...`` of the budget ``n_chunks`` until
    the stop tables ``lo``/``hi`` (int32 numpy ``[n_chunks + 1]``) fire,
    ``k_start`` successes already counted: the graph loop on CUDA, the
    plain loop on the CPU.  Returns ``(i_stop, counts, overflow, info)``
    with the per-chunk counts and flags ``[n_chunks]`` (entries before
    ``start`` and from ``i_stop`` on are 0) and ``info`` the loop's
    record (``dispatch``: ``"graph"`` or ``"plain"``, readbacks, and the
    graph's timings)."""
    dev = torch.device(device)
    carry = new_carry(n_chunks, start, k_start, dev)
    lo_d = torch.from_numpy(np.ascontiguousarray(lo, np.int32)).to(dev)
    hi_d = torch.from_numpy(np.ascontiguousarray(hi, np.int32)).to(dev)
    root = jr.key(cfg.seed, dev)
    go = loop_condition(start, k_start, lo.tolist(), hi.tolist())

    def step(handle):
        chunk_step(cfg, chunk_trials, root, carry, lo_d, hi_d, handle)

    if dev.type == "cuda":
        info = dict(dispatch="graph", readbacks=0)
        if go:
            carry, record = graph_loop(step, carry, go)
            info.update(record)
    else:
        info = dict(dispatch="plain", readbacks=plain_loop(step, carry, go))
    i_stop, _k, counts, ovf = read_carry(carry)
    return i_stop, counts, ovf, info


def _check(rc: int, what: str) -> None:
    if rc != 0:
        name = _lib().qba_sweep_error_string(rc).decode()
        raise RuntimeError(f"sweep loop graph: {what} failed: CUDA error "
                           f"{rc} ({name})")


def _lib():
    from qba_tpu_torch.ops._build import load_library

    lib = load_library("sweep_loop")
    if lib.qba_sweep_stop.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qba_sweep_stop.argtypes = [p, p, p, p, p, i, i,
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
