"""Assembling the party-sharded pool or mailbox every round —
counterpart of :mod:`qba_tpu.parallel.ring`.

Shards on one card are one tensor ``[n_tp, *shard]``.  Both transports
give every shard the tiled all-gather of the shards along a shard axis,
bit-identically:

* ``"ring"`` (what ``auto`` resolves to) — the neighbour-ring kernel
  (:func:`qba_tpu_torch.ops.ring_shuffle.ring_gather`: a thread-block
  cluster a tile on CUDA, its plain hop schedule
  :func:`ring_gather_reference` on the CPU);
* ``"all_gather"`` — the escape hatch, :func:`all_gather`: plain tensor
  code (a concatenation, then a copy for each shard).

A ``tp`` row across more than one card (NCCL or peer memory under
``torch.distributed``) waits for ROADMAP A12b.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops.ring_shuffle import ring_gather, ring_gather_reference

#: The resolved comms vocabulary ("auto" resolves to one of these).
TP_COMMS_CHOICES = ("ring", "all_gather")

__all__ = ["TP_COMMS_CHOICES", "all_gather", "resolve_tp_comms",
           "ring_gather", "ring_gather_reference"]


def resolve_tp_comms(cfg: QBAConfig) -> str:
    """The comms path the party-sharded engine will use: forced values
    pass through; ``auto`` picks the ring."""
    if cfg.tp_comms in TP_COMMS_CHOICES:
        return cfg.tp_comms
    return "ring"


def all_gather(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every shard's tiled all-gather of ``x`` ``[n_tp, *shard]`` along
    shard axis ``axis``: the shards concatenated, then one copy for each
    shard, as ``jax.lax.all_gather(tiled=True)`` leaves every device its
    own."""
    whole = torch.cat(list(x), dim=axis)
    return whole.unsqueeze(0).expand(x.shape[0], *whole.shape).contiguous()
