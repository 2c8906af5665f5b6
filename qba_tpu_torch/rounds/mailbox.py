"""The dense mailbox — counterpart of :mod:`qba_tpu.rounds.mailbox`.

One round's traffic as fixed-shape tensors: per trial, per sending
lieutenant, up to ``slots`` broadcast packets; every receiver reads every
``(sender, slot)`` cell and corruption happens at read time.  The port's
``xla`` engine (its eager oracle) runs on this layout; the kernel engine
runs on the compacted pool of :mod:`qba_tpu_torch.ops.round_kernel_tiled`.
"""

from __future__ import annotations

import dataclasses

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.types import SENTINEL


@dataclasses.dataclass
class Mailbox:
    """All packets broadcast by lieutenants in one round."""

    vals: torch.Tensor  # int32[T, senders, slots, max_l, size_l]
    lens: torch.Tensor  # int32[T, senders, slots, max_l]
    count: torch.Tensor  # int32[T, senders, slots]
    p_mask: torch.Tensor  # bool[T, senders, slots, size_l]
    v: torch.Tensor  # int32[T, senders, slots]
    sent: torch.Tensor  # bool[T, senders, slots]


def mailbox_from_step3a(cfg: QBAConfig, out_cells) -> Mailbox:
    """Step 3a's broadcasts in slot 0 of each sender row, the other slots
    empty."""
    o_vals, o_lens, o_count, o_p, o_v, o_sent = out_cells
    n_trials, n_s = o_sent.shape

    def slotted(x, fill):
        full = torch.full((n_trials, n_s, cfg.slots) + x.shape[2:], fill,
                          dtype=x.dtype, device=x.device)
        full[:, :, 0] = x
        return full

    return Mailbox(
        vals=slotted(o_vals, SENTINEL),
        lens=slotted(o_lens, 0),
        count=slotted(o_count, 0),
        p_mask=slotted(o_p, False),
        v=slotted(o_v, 0),
        sent=slotted(o_sent, False),
    )
