"""Fixed-shape tensor encodings of the protocol's variable-size sets —
counterpart of :mod:`qba_tpu.core.types`.

* ``P``  -> bool mask ``[..., size_l]``
* ``v``  -> int32 ``[...]``
* ``L``  -> :class:`Evidence`: up to ``max_l`` position-expanded rows
  (row ``i`` holds its tuple's value at each list position of its ``P``,
  ``SENTINEL`` elsewhere), explicit per-row lengths and a row count.

Every field may carry leading batch axes (trials, receivers, packets).
"""

from __future__ import annotations

import dataclasses

import torch

SENTINEL = -1  # "past the end of this row's tuple"


@dataclasses.dataclass
class Evidence:
    """The set L of sub-list tuples carried by a packet."""

    vals: torch.Tensor  # int32[..., max_l, size_l], SENTINEL-padded
    lens: torch.Tensor  # int32[..., max_l]
    count: torch.Tensor  # int32[...], number of valid rows


@dataclasses.dataclass
class Packet:
    """One (P, v, L) protocol message."""

    p_mask: torch.Tensor  # bool[..., size_l]
    v: torch.Tensor  # int32[...]
    evidence: Evidence


def empty_evidence(max_l: int, size_l: int, batch=(), device=None) -> Evidence:
    return Evidence(
        vals=torch.full((*batch, max_l, size_l), SENTINEL, dtype=torch.int32,
                        device=device),
        lens=torch.zeros((*batch, max_l), dtype=torch.int32, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
    )
