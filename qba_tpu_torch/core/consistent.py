"""Consistency predicate and evidence append — counterpart of
:mod:`qba_tpu.core.consistent`, batched over any leading axes.

Condition 1: valid rows share one length.  Condition 2: no in-tuple entry
of a valid row equals ``v``, exceeds ``w`` or is negative (the
reference's ``<= w`` off-by-one is kept).  Condition 3: no two valid rows
agree at a jointly populated position.  ``consistent_after_append`` is
the executable specification every round engine's verdict must equal.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.core.types import SENTINEL, Evidence


def _valid(ev: Evidence) -> torch.Tensor:
    max_l = ev.vals.shape[-2]
    rows = torch.arange(max_l, device=ev.vals.device)
    return rows < ev.count[..., None]  # bool[..., max_l]


def _cells_collide(ev: Evidence, valid: torch.Tensor) -> torch.Tensor:
    """Any pair of valid rows agreeing at a jointly populated position."""
    vals = ev.vals
    in_t = vals != SENTINEL
    eq = (
        (vals[..., :, None, :] == vals[..., None, :, :])
        & in_t[..., :, None, :]
        & in_t[..., None, :, :]
    ).any(-1)  # [..., max_l, max_l]
    max_l = vals.shape[-2]
    upper = torch.ones(max_l, max_l, dtype=torch.bool,
                       device=vals.device).triu(1)
    pair = valid[..., :, None] & valid[..., None, :] & upper
    return (eq & pair).any(-1).any(-1)


def consistent(v: torch.Tensor, ev: Evidence, w: int) -> torch.Tensor:
    """bool[...]: is (v, L) consistent?  Vacuously true for empty L."""
    valid = _valid(ev)
    in_t = ev.vals != SENTINEL
    cond1 = torch.where(valid, ev.lens == ev.lens[..., :1], True).all(-1)
    vv = v[..., None, None]
    bad = in_t & ((ev.vals == vv) | (ev.vals > w) | (ev.vals < 0))
    cond2 = ~(bad & valid[..., None]).any(-1).any(-1)
    cond3 = ~_cells_collide(ev, valid)
    return cond1 & cond2 & cond3


def sublist_row(p_mask: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """``tuple(Li[j] for j in P)`` position-expanded: ``li`` on ``P``,
    SENTINEL elsewhere (int32)."""
    return torch.where(p_mask, li.to(torch.int32), SENTINEL)


def append_own(ev: Evidence, p_mask: torch.Tensor,
               li: torch.Tensor) -> Evidence:
    """Add this party's sub-list to L with set semantics (no-op if an
    identical row exists; guarded against fullness)."""
    max_l = ev.vals.shape[-2]
    own = sublist_row(p_mask, li)
    own_len = p_mask.to(torch.int32).sum(-1)
    valid = _valid(ev)
    dup = (valid & (ev.vals == own[..., None, :]).all(-1)).any(-1)
    slot = torch.clamp(ev.count, max=max_l - 1)
    rows = torch.arange(max_l, device=ev.vals.device)
    write = ~dup[..., None] & (rows == slot[..., None])
    return Evidence(
        vals=torch.where(write[..., None], own[..., None, :], ev.vals),
        lens=torch.where(write, own_len[..., None], ev.lens),
        count=torch.where(dup, ev.count,
                          torch.clamp(ev.count + 1, max=max_l)),
    )


def consistent_after_append(v, ev: Evidence, p_mask, li, w: int):
    """``(consistent(v, L'), |L'|)`` for ``L' = append_own(ev, p_mask,
    li)``, without materializing ``L'`` (see the JAX function for the
    decomposition)."""
    max_l = ev.vals.shape[-2]
    valid = _valid(ev)
    in_t = ev.vals != SENTINEL
    own = sublist_row(p_mask, li)
    own_len = p_mask.to(torch.int32).sum(-1)

    dup = (valid & (ev.vals == own[..., None, :]).all(-1)).any(-1)
    appended = ~dup & (ev.count < max_l)
    new_count = torch.where(appended, ev.count + 1, ev.count)

    len0 = ev.lens[..., 0]
    cell_lens_ok = torch.where(valid, ev.lens == len0[..., None], True).all(-1)
    own_len_ok = ~appended | (ev.count == 0) | (own_len == len0)
    cond1 = cell_lens_ok & own_len_ok

    vv = v[..., None, None]
    bad_cell = (
        in_t & ((ev.vals == vv) | (ev.vals > w) | (ev.vals < 0))
        & valid[..., None]
    ).any(-1).any(-1)
    bad_own = appended & (
        p_mask & ((own == v[..., None]) | (own > w) | (own < 0))
    ).any(-1)
    cond2 = ~(bad_cell | bad_own)

    cells_ok = ~_cells_collide(ev, valid)
    own_hits = (
        p_mask[..., None, :] & in_t & (ev.vals == own[..., None, :])
        & valid[..., None]
    ).any(-1)
    own_ok = ~appended | ~own_hits.any(-1)
    cond3 = cells_ok & own_ok
    return cond1 & cond2 & cond3, new_count
