"""The neighbour-ring all-gather over the ``tp`` shards — counterpart of
:func:`qba_tpu.ops.ring_shuffle.build_ring_gather`.

On one card the shards of a party-sharded batch are one tensor with a
leading ``[n_tp, ...]`` axis.  :func:`ring_gather` returns, for every
shard, the tiled all-gather of the shards' segments along ``axis``:
``out[my]`` is the shards concatenated in tp order along that axis.
For CUDA tensors it launches ``csrc/ring_shuffle.cu``: one
thread-block cluster of ``n_tp`` blocks per tile of a segment, whose
blocks pass the tile around the ring through each other's shared memory
(``n_tp - 1`` hops, one cluster barrier each), the TPU kernel's remote
DMA schedule on one card.  For CPU tensors it runs
:func:`ring_gather_reference`, which follows the same hop schedule in
plain PyTorch.  A CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from qba_tpu_torch.ops._launch import dispatch, timed_launch

# The kernel moves bytes: every pool and mailbox leaf's element type
# (the xla engine's mailbox carries int64 lens), bool as its bytes.
RING_DTYPES = (torch.int8, torch.uint8, torch.bool, torch.int32, torch.int64)
# A cluster of at most 8 blocks is the portable size.
MAX_TP = 8


def _gathered_shape(x: torch.Tensor, axis: int):
    shape = list(x.shape)
    shape[axis + 1] *= x.shape[0]
    return shape


def ring_gather_reference(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The ring's hop schedule in plain PyTorch: ``x`` ``[n_tp, *shard]``
    -> ``[n_tp, *gathered]``, the segments concatenated along shard axis
    ``axis`` for every shard.  Shard ``my`` stores its own segment at its
    own offset; at hop ``k`` every shard forwards what it holds to its
    right-hand neighbour and stores the segment arriving from the left,
    which came from shard ``(my - k - 1) mod n_tp``, at that owner's
    offset (``qba_tpu/parallel/ring.py:53-82``)."""
    n_tp, chunk = x.shape[0], x.shape[axis + 1]
    out = torch.empty(_gathered_shape(x, axis), dtype=x.dtype,
                      device=x.device)
    held = [x[my] for my in range(n_tp)]
    for my in range(n_tp):
        out[my].narrow(axis, my * chunk, chunk).copy_(held[my])
    for k in range(n_tp - 1):
        held = [held[(my - 1) % n_tp] for my in range(n_tp)]
        for my in range(n_tp):
            src = (my - k - 1) % n_tp
            out[my].narrow(axis, src * chunk, chunk).copy_(held[my])
    return out


def ring_gather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every shard's tiled all-gather of ``x`` ``[n_tp, *shard]`` along
    shard axis ``axis``: ``[n_tp, *gathered]``.

    CPU tensors run :func:`ring_gather_reference`.  CUDA tensors launch
    the cluster ring kernel once; it takes a contiguous tensor of int8,
    uint8, bool, int32 or int64 and ``1 <= n_tp <= 8``.  Any other input
    raises.
    """
    if not dispatch("ring_gather", (x,)):
        return ring_gather_reference(x, axis)
    n_tp = x.shape[0]
    if x.dtype not in RING_DTYPES:
        raise TypeError(f"ring_gather takes {RING_DTYPES}; got {x.dtype}")
    if not 1 <= n_tp <= MAX_TP:
        raise ValueError(f"ring_gather: n_tp={n_tp} must be in 1..{MAX_TP} "
                         "(one thread-block cluster of n_tp blocks)")
    if not 0 <= axis < x.dim() - 1:
        raise ValueError(f"axis {axis} out of range for shards of "
                         f"{tuple(x.shape[1:])}")
    if not x.is_contiguous():
        raise ValueError("ring_gather: x must be contiguous")
    outer = math.prod(x.shape[1:axis + 1])
    seg = math.prod(x.shape[axis + 1:]) * x.element_size()
    out = torch.empty(_gathered_shape(x, axis), dtype=x.dtype,
                      device=x.device)
    timed_launch(ring_gather, _kernel(),
                 [x.data_ptr(), out.data_ptr(), n_tp, outer, seg],
                 torch.cuda.current_stream(x.device))
    return out


ring_gather.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
ring_gather.events = None


def _kernel():
    from qba_tpu_torch.ops._build import load_library

    fn = load_library("ring_shuffle").qba_ring_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
