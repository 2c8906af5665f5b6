"""Decision rule and success oracle — counterpart of
:mod:`qba_tpu.core.decide`, batched over leading axes.  An empty ``Vi``
decides the sentinel ``w`` (the reference would crash on ``min(set())``).
"""

from __future__ import annotations

import torch


def decide_order(vi_mask: torch.Tensor, v: torch.Tensor,
                 is_comm: torch.Tensor, w: int) -> torch.Tensor:
    """The commander decides its own ``v``; a lieutenant ``min(Vi)``
    over the accepted-set mask ``[..., w]``, or ``w`` when empty."""
    values = torch.arange(w, dtype=torch.int32, device=vi_mask.device)
    lieu = torch.where(vi_mask, values, w).amin(-1).to(torch.int32)
    return torch.where(is_comm, v.to(torch.int32), lieu)


def success_oracle(decisions: torch.Tensor,
                   honest: torch.Tensor) -> torch.Tensor:
    """Success iff the honest parties' decisions form a singleton set
    (all parties dishonest -> False)."""
    first = honest.to(torch.int8).argmax(-1, keepdim=True)
    ref = torch.gather(decisions, -1, first)
    agree = torch.where(honest, decisions == ref, True).all(-1)
    return honest.any(-1) & agree
