"""Per-batch records of the port's main path — the stand-in for the JAX
package's :mod:`~qba_tpu.analysis.traces`,
:mod:`~qba_tpu.analysis.intervals` and
:mod:`~qba_tpu.analysis.tracecache`.

The JAX checker reads jaxprs; the port has none.  Instead one small
batch per (config, engine) runs under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` and a launch-
seam observer (:data:`qba_tpu_torch.ops._launch.seam_observers`), and
:func:`trace_batch` records

* every dot PyTorch dispatches (``mm``, ``bmm``, ``addmm``, ...; a
  ``matmul``, ``einsum`` or ``linear`` reaches one of them): its
  dtype, contraction length, each operand's largest magnitude, whether
  both operands hold whole numbers, ``torch.get_float32_matmul_
  precision()`` and the call site inside the package;
* every kernel seam reached, by kernel name (a launch on CUDA, the
  plain version on the CPU), and on CUDA the wrappers' launch counts;
* the per-round carry: the pool or mailbox a per-round kernel reads
  each round (its first leaf's address, each leaf's shape, dtype and
  bytes);
* allocations of at least :data:`ALLOC_MIN_BYTES`, with the round they
  fall in, and on CUDA each round's bytes allocated
  (``torch.cuda.memory_stats``).

On CUDA a warm-up batch runs first (the kernels build and load); the
recorded batch is warm.  Records are cached per (config, engine, device,
trials, tp) until :func:`reset`, as ``tracecache`` caches jaxprs.  A
batch that raised is reported by every pass over it as the one finding
:func:`batch_error`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import traceback
import warnings

from qba_tpu_torch.analysis.findings import Finding

#: Ops whose float operands the exact-dot pass audits: PyTorch
#: dispatches ``matmul``, ``einsum`` and ``linear`` to these.
DOT_OPS = {
    "aten.mm.default": (0, 1), "aten.bmm.default": (0, 1),
    "aten.addmm.default": (1, 2), "aten.baddbmm.default": (1, 2),
    "aten.addbmm.default": (1, 2), "aten.dot.default": (0, 1),
    "aten.mv.default": (0, 1), "aten.addmv.default": (1, 2),
    "aten.vdot.default": (0, 1),
}

#: The per-round kernels whose first seam call opens a round, and the
#: seams that read the round's carried pool or mailbox.
ROUND_SEAMS = ("fused_round", "round_step", "tiled_verdict")
CARRY_SEAMS = ("fused_round", "round_step", "tiled_rebuild")

#: Allocations below this size are not recorded.
ALLOC_MIN_BYTES = 64 * 1024


@dataclasses.dataclass(frozen=True)
class DotRecord:
    """One float or integer dot of a traced batch."""

    op: str
    dtype: str
    k: int  # contraction length
    lhs_max: float  # largest magnitude of each operand
    rhs_max: float
    integral: bool  # both operands hold whole numbers
    precision: str  # torch.get_float32_matmul_precision() in force
    where: str  # call site "qba_tpu_torch/...:line"
    path: str  # "label/engine"


@dataclasses.dataclass
class BatchTrace:
    """What one traced batch dispatched (see the module docstring)."""

    path: str
    device: str
    trials: int = 0
    seams: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    launches: dict = dataclasses.field(default_factory=dict)
    carry: list = dataclasses.field(default_factory=list)
    dots: list = dataclasses.field(default_factory=list)
    allocs: list = dataclasses.field(default_factory=list)
    round_bytes: list = dataclasses.field(default_factory=list)
    demoted: str | None = None
    refused: str | None = None
    error: str | None = None


def batch_error(rec: BatchTrace) -> Finding:
    """The finding of a traced batch that raised (``rec.error``): every
    pass over the batch reports this one finding, and the driver keeps
    it once."""
    return Finding(ki="KI-5", check="traced-batch", path=rec.path,
                   message=f"the traced batch could not run: {rec.error}")


def _site() -> str:
    from qba_tpu_torch.analysis.transfers import package_site

    return package_site(traceback.extract_stack())


def _recorder(rec: BatchTrace):
    """The dispatch mode that fills ``rec``'s dots and allocations."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if name in DOT_OPS:
                rec.dots.append(_dot_record(rec.path, name, args,
                                            DOT_OPS[name]))
            elif (not func.is_view and func._overloadname != "out"
                    and not name.split(".")[1].endswith("_")):
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if (isinstance(t, torch.Tensor)
                            and t.device.type != "meta"  # a layout only
                            and t.numel() * t.element_size()
                            >= ALLOC_MIN_BYTES):
                        rec.allocs.append((
                            name, t.numel() * t.element_size(),
                            sum(rec.seams[s] for s in ROUND_SEAMS),
                            _site()))
            return out

    return Recorder()


def _dot_record(path: str, op: str, args, idx) -> DotRecord:
    import torch

    a, b = args[idx[0]], args[idx[1]]

    def stats(x):
        if x.numel() == 0:
            return 0.0, True
        mag = float(x.detach().abs().max())
        whole = (not x.is_floating_point() and not x.is_complex()) or (
            not x.is_complex() and bool((x == x.round()).all()))
        return mag, whole

    (am, ai), (bm, bi) = stats(a), stats(b)
    return DotRecord(op=op, dtype=str(a.dtype).replace("torch.", ""),
                     k=int(a.shape[-1]), lhs_max=am, rhs_max=bm,
                     integral=ai and bi,
                     precision=torch.get_float32_matmul_precision(),
                     where=_site(), path=path)


def _run_recorded(rec: BatchTrace, fn, cuda_device=None) -> None:
    """``fn()`` under the recorder and a seam observer filling ``rec``
    (with ``cuda_device``, each round's allocated bytes too)."""
    import torch

    from qba_tpu_torch.ops import _launch

    def observe(name, tensors):
        rec.seams[name] += 1
        if name in ROUND_SEAMS and cuda_device is not None:
            rec.round_bytes.append(torch.cuda.memory_stats(cuda_device)[
                "allocated_bytes.all.allocated"])
        if name in CARRY_SEAMS:
            rec.carry.append((name, tensors[0].data_ptr(), tuple(
                (tuple(x.shape), str(x.dtype), x.numel() * x.element_size())
                for x in tensors)))

    _launch.seam_observers.append(observe)
    try:
        with _recorder(rec):
            fn()
    finally:
        _launch.seam_observers.remove(observe)


def record(fn, path: str = "call") -> BatchTrace:
    """The records of one call ``fn()`` (no warm-up, not cached)."""
    rec = BatchTrace(path=path, device="")
    _run_recorded(rec, fn)
    return rec


@functools.lru_cache(maxsize=None)
def _memory_bytes(device_type: str) -> int:
    from qba_tpu_torch.analysis.memory import device_memory_bytes

    return device_memory_bytes(device_type)


def batch_trials(cfg, device, trials: int) -> int:
    """``trials``, cut to half the admission model's ceiling for ``cfg``
    (on the engine it names) on ``device``: the ``xla`` engine's dense
    checks hold gigabytes a trial at 33 parties."""
    import torch

    from qba_tpu_torch.analysis.memory import trial_ceiling

    dev = torch.device(device).type
    return max(1, min(trials, trial_ceiling(cfg, _memory_bytes(dev), dev)
                      // 2))


_cache: dict = {}
_hits = 0


def reset() -> None:
    """Drop every cached record."""
    global _hits
    _cache.clear()
    _hits = 0


def stats() -> dict:
    return {"trace_cache_entries": len(_cache), "trace_cache_hits": _hits}


def trace_batch(label: str, cfg, engine: str, device, trials: int = 8,
                tp: int | None = None, within=None) -> BatchTrace:
    """Record one batch of ``trials`` trials (:func:`batch_trials`) of
    ``cfg`` with its round engine set to ``engine`` on ``device``
    (``"cuda"`` or ``"cpu"``):
    ``run_trial``, or with ``tp`` the party-sharded batch on a
    ``{"dp": 1, "tp": tp}`` mesh of that one device.  A
    ``KernelUnsupported`` refusal is recorded in ``refused``, any other
    exception in ``error``; neither is raised.  ``within``, a context
    manager, is entered around the recorded batch alone (not the
    warm-up), so that what it records (a ``torch.profiler`` trace) is
    this batch's; the batch then runs even where the key is cached.  The
    batch runs in the current threefry mode, read once and part of the
    cache's key."""
    from qba_tpu_torch import random as jr

    global _hits
    p = jr.partitionable_mode()
    key = (cfg, engine, str(device), trials, tp, p)
    if key in _cache and within is None:
        _hits += 1
        return _cache[key]
    import torch

    from qba_tpu_torch.diagnostics import QBADemotionWarning
    from qba_tpu_torch.ops import _launch, kernel_wrappers
    from qba_tpu_torch.rounds.engine import run_trial

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(cfg, round_engine=engine)
    trials = batch_trials(cfg, dev, trials)
    keys = jr.split(jr.key(cfg.seed, dev), trials, partitionable=p)
    if tp is None:
        def batch():
            with jr.threefry_partitionable(p):
                return run_trial(cfg, keys)
    else:
        from qba_tpu_torch.parallel import make_mesh, run_trials_spmd

        mesh = make_mesh({"dp": 1, "tp": tp}, devices=[dev] * tp)

        def batch():
            with jr.threefry_partitionable(p):
                return run_trials_spmd(cfg, mesh, keys)

    path = f"{label}/{engine}" + (f"/tp={tp}" if tp else "")
    rec = BatchTrace(path=path, device=dev.type, trials=trials)
    cuda = dev.type == "cuda"

    wrappers = kernel_wrappers()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            if cuda:
                batch()  # warm-up: the kernels build and load
                torch.cuda.synchronize(dev)
            with within or contextlib.nullcontext():
                before = {k: fn.launches for k, fn in wrappers.items()}
                _run_recorded(rec, batch, dev if cuda else None)
                if cuda:
                    torch.cuda.synchronize(dev)
            rec.launches = {k: fn.launches - before[k]
                            for k, fn in wrappers.items()
                            if fn.launches != before[k]}
        except _launch.KernelUnsupported as exc:
            rec.refused = str(exc)
        except Exception as exc:
            rec.error = f"{type(exc).__name__}: {exc}"
    demotions = [w for w in caught
                 if issubclass(w.category, QBADemotionWarning)]
    if demotions:
        rec.demoted = str(demotions[0].message)
    _cache[key] = rec
    return rec
