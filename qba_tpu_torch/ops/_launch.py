"""Launch plumbing shared by the port's kernel wrappers.

Every wrapper (:func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round`,
``tiled_verdict``, ``tiled_rebuild``,
:func:`~qba_tpu_torch.ops.trial_megakernel.trial_megakernel`,
:func:`~qba_tpu_torch.ops.round_kernel.round_step` and
:func:`~qba_tpu_torch.ops.fused_circuit.fused_circuit`) follows one
contract: CPU tensors take the plain version, CUDA tensors launch the
hand-written kernel or raise; inputs are checked for exact dtype, shape,
contiguity and device before a launch; each launch adds one to the
wrapper's ``launches`` count and, when its ``events`` attribute is a
list, appends its ``(start, end)`` CUDA events.  Every call, launch or
plain version, first passes :func:`dispatch`, the wrapper's seam, which
tells each callable in :data:`seam_observers` (the invariant checker's
launch, carry and trace records, :mod:`qba_tpu_torch.analysis.trace`).
"""

from __future__ import annotations

import ctypes

import torch

from qba_tpu_torch.config import QBAConfig

# The kernels keep a receiver's accepted set and a packet's per-receiver
# verdicts as 64-bit masks.
KERNEL_MAX_W = 64

#: Callables ``observer(name, tensors)`` that :func:`dispatch` calls with
#: each wrapper's name and its seam tensors, before it picks the kernel
#: or the plain version.
seam_observers: list = []


class KernelUnsupported(NotImplementedError):
    """A kernel that refuses a config's shapes before any launch."""


class KernelLaunchError(RuntimeError):
    """A kernel launch the runtime refused (its configuration or
    resources) while the CUDA context stayed usable.  A fault that ruins
    the context raises PyTorch's own CUDA error instead."""


def check(name, x, dtype, shape, device):
    """Raise unless ``x`` has exactly this dtype and shape, is contiguous
    and lies on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def masks_fit(cfg: QBAConfig) -> bool:
    """Whether the kernels' 64-bit masks hold ``cfg``'s values and
    receivers (``w`` and ``n_lieutenants`` at most :data:`KERNEL_MAX_W`:
    up to 64 parties)."""
    return cfg.w <= KERNEL_MAX_W and cfg.n_lieutenants <= KERNEL_MAX_W


def check_kernel_shapes(cfg: QBAConfig, kernel: str) -> None:
    """Raise :class:`KernelUnsupported` where the 64-bit masks cannot
    hold ``cfg``'s values or receivers."""
    if not masks_fit(cfg):
        raise KernelUnsupported(
            f"the {kernel} kernel keeps values and receivers as 64-bit "
            f"masks (w <= {KERNEL_MAX_W}, n_lieutenants <= {KERNEL_MAX_W}); "
            f"w={cfg.w}, n_lieutenants={cfg.n_lieutenants} is not supported "
            "on CUDA"
        )


def dispatch(name: str, tensors) -> bool:
    """True to launch a kernel (the first of ``tensors`` is a CUDA
    tensor), False for the plain version (a CPU tensor); raises on any
    other device."""
    for observer in seam_observers:
        observer(name, tensors)
    dev = tensors[0].device
    if dev.type == "cuda":
        return True
    if dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return False


def write_out(name: str, new, out, src):
    """A plain version's successor ``new`` (a tuple of leaves) written
    into ``out``, the other buffer of the ping-pong pair the kernel
    writes, after the kernel's checks: the same shapes and dtypes, and
    no leaf that aliases its input ``src``.  ``new`` itself where
    ``out`` is None."""
    if out is None:
        return new
    for i, (o, x, s) in enumerate(zip(out, new, src)):
        if o.shape != x.shape or o.dtype != x.dtype:
            raise ValueError(f"{name} out[{i}] is {o.dtype}{list(o.shape)}, "
                             f"the result {x.dtype}{list(x.shape)}")
        if o.data_ptr() == s.data_ptr():
            raise ValueError(f"{name} out[{i}] aliases its input; pass the "
                             "other buffer of the ping-pong pair")
        o.copy_(x)
    return tuple(out)


def timed_launch(wrapper, fn, args, stream):
    """Launch ``fn(*args, stream)`` on ``stream``, count it on
    ``wrapper.launches`` and, when ``wrapper.events`` is a list, record
    its ``(start, end)`` CUDA events.  A launch that fails raises
    :class:`KernelLaunchError` where the context survives it (outside a
    graph capture, a synchronize tells), else the CUDA error itself.

    While ``stream`` is being captured, ``wrapper.events`` must be None:
    a recorded event would be an event-record node, which the graph
    loops' conditional bodies may not hold, so a list raises
    ``RuntimeError`` before anything is launched."""
    events = wrapper.events
    if events is not None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{wrapper.__name__}.events is a list while a CUDA graph is "
            "being captured: each launch would record an event node, which "
            "a graph loop's WHILE or SWITCH body may not hold; set it to "
            "None before the capture")
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record(stream)
    rc = fn(*args, stream.cuda_stream)
    if rc != 0:
        if not torch.cuda.is_current_stream_capturing():
            # A sticky fault (an earlier kernel's illegal address) raises
            # here, and every later CUDA call would raise it too.
            # qba-lint: sync-ok (a refused launch: tells a sticky fault from a refusal)
            torch.cuda.synchronize(stream.device)
        raise KernelLaunchError(f"{wrapper.__name__} kernel launch failed: "
                                f"CUDA error {rc}")
    wrapper.launches += 1
    if events is not None:
        end.record(stream)
        events.append((start, end))


def no_clock(clock) -> None:
    """Raise where a plain version is asked for a phase clock."""
    if clock is not None:
        raise ValueError("the phase clock runs only in the CUDA kernel")


def clock_ptr(clock, shape, device):
    """A phase-clock buffer's address after checking that it is int64
    ``shape`` on ``device``, or None without a clock."""
    if clock is None:
        return None
    check("clock", clock, torch.int64, shape, device)
    return clock.data_ptr()


def clock_breakdown(clock, names) -> dict:
    """A filled phase clock's breakdown (its last axis the phases
    ``names``, one row a block): per phase, warp 0's mean cycles per
    block and its share of the phases' sum; under ``"block"`` the mean
    and the largest of the blocks' sums (the slowest block bounds a
    one-wave launch)."""
    per_block = clock.reshape(-1, len(names)).double()
    # qba-lint: sync-ok (the phase clock's readout, after the timed launches)
    cycles = per_block.mean(0).tolist()
    total = sum(cycles) or 1.0
    out = {name: dict(cycles=c, share=c / total)
           for name, c in zip(names, cycles)}
    sums = per_block.sum(1)
    # qba-lint: sync-ok (the phase clock's readout, after the timed launches)
    out["block"] = dict(mean=float(sums.mean()), max=float(sums.max()))
    return out


def kernel_fn(library: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry point ``symbol`` of ``library`` with its ``ctypes``
    signature: ``n_ptrs`` pointers, ``n_ints`` ints, then the stream."""
    from qba_tpu_torch.ops._build import load_library

    fn = getattr(load_library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ptrs(*tensors):
    """The tensors' device addresses, in order."""
    return [x.data_ptr() for x in tensors]
