"""Acceptance semantics of one voting round, as plain tensor functions —
counterpart of the algebra in :mod:`qba_tpu.ops.verdict_algebra` that the
TPU round kernels share.

Three pieces, all batched over trials ``T``, pool packets ``P`` and
receivers ``R``:

* :func:`packet_facts` — the receiver-independent facts of each packet's
  evidence (out-of-range entries, row-length disagreement, colliding row
  pairs, and which values each list position holds);
* :func:`verdict` — every (packet, receiver) acceptance flag under the
  corruption flags of the round's draws: ``consistent_after_append``'s
  decomposition (:mod:`qba_tpu_torch.core.consistent`) plus delivery and
  the evidence-length check ``|L'| == round + 1``;
* :func:`accept_first_per_value` — the first ok packet per (receiver,
  order value) in packet order, excluding values already in ``vi``.

The TPU's lane-group and all-receiver variants are layout choices and
have no counterpart here.  Values are exact integers throughout.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.adversary.model import (
    CLEAR_L_BIT,
    CLEAR_P_BIT,
    DROP_BIT,
    FORGE_BIT,
    FORGE_P_BIT,
)
from qba_tpu_torch.core.types import SENTINEL


def packet_facts(vals: torch.Tensor, lens: torch.Tensor,
                 count: torch.Tensor, w: int):
    """Receiver-independent facts of ``vals`` int ``[T, P, max_l, S]``,
    ``lens`` ``[T, P, max_l]``, ``count`` ``[T, P]``.

    Returns ``(oob, lens_bad, cells_coll, pres)``: three bool ``[T, P]``
    and the value-presence table bool ``[T, P, S, w]`` (some valid row
    holds value ``x`` at position ``j``).
    """
    max_l = vals.shape[-2]
    rows = torch.arange(max_l, device=vals.device)
    valid = rows < count[..., None]  # [T, P, max_l]
    in_t = vals != SENTINEL
    live = valid[..., None] & in_t  # [T, P, max_l, S]
    oob = (live & ((vals > w) | (vals < 0))).any(-1).any(-1)
    lens_bad = (valid & (lens != lens[..., :1])).any(-1)
    cells_coll = torch.zeros_like(oob)
    for r in range(max_l):
        for s in range(r + 1, max_l):
            hit = in_t[..., r, :] & in_t[..., s, :] & (
                vals[..., r, :] == vals[..., s, :]
            )
            cells_coll |= valid[..., s] & hit.any(-1)
    in_range = live & (vals >= 0) & (vals < w)
    idx = torch.where(in_range, vals, w).long().transpose(-1, -2)
    pres = torch.zeros(vals.shape[:-2] + (vals.shape[-1], w + 1),
                       dtype=torch.bool, device=vals.device)
    pres.scatter_(-1, idx, True)  # [T, P, S, w + 1]
    return oob, lens_bad, cells_coll, pres[..., :w]


def corruption_flags(honest_c, attack, rand_v, v, use_fp: bool):
    """Per (packet, receiver) effective edits: ``(dropped, v2, clear_p,
    clear_l, forge_p)`` from the packet's sender honesty ``[T, P]``,
    draws ``[T, P, R]`` and carried order ``v`` ``[T, P]``.  ``forge_p``
    is all-False unless ``use_fp`` (strategy "split")."""
    biz = (honest_c == 0)[..., None]
    att = attack.to(torch.int32)
    dropped = biz & ((att & DROP_BIT) != 0)
    v2 = torch.where(biz & ((att & FORGE_BIT) != 0), rand_v.to(torch.int32),
                     v[..., None].to(torch.int32))
    clear_p = biz & ((att & CLEAR_P_BIT) != 0)
    clear_l = biz & ((att & CLEAR_L_BIT) != 0)
    if use_fp:
        forge_p = biz & ((att & FORGE_P_BIT) != 0)
    else:
        forge_p = torch.zeros_like(clear_p)
    return dropped, v2, clear_p, clear_l, forge_p


def effective_p(p: torch.Tensor, clear_p, forge_p) -> torch.Tensor:
    """The delivered presence mask ``[T, P, R, S]``: cleared by CLEAR_P,
    forced full by FORGE_P (forgery wins)."""
    return (p[..., None, :] & ~clear_p[..., None]) | forge_p[..., None]


def verdict(*, vals, lens, count, p, v, sent, sender, honest_c, attack,
            rand_v, late, li, round_idx: int, w: int, use_fp: bool,
            recv_off: int = 0):
    """Every (packet, receiver) acceptance flag of one round.

    Pool fields per trial: ``vals`` int ``[T, P, max_l, S]``, ``lens``
    ``[T, P, max_l]``, ``count``/``v``/``sender``/``honest_c`` ``[T, P]``,
    ``p``/``sent`` bool ``[T, P, S]``/``[T, P]``; draws ``[T, P, R]``
    (already selected by each packet's cell); ``li`` ``[T, R, S]``, the
    receivers being the lieutenants ``recv_off + r``.
    Returns ``(ok bool [T, P, R], v2 int32 [T, P, R])``.
    """
    max_l = vals.shape[-2]
    oob, lens_bad, cells_coll, pres = packet_facts(vals, lens, count, w)
    dropped, v2, clear_p, clear_l, forge_p = corruption_flags(
        honest_c, attack, rand_v, v, use_fp
    )
    n_rv = li.shape[-2]
    recv = recv_off + torch.arange(n_rv, device=vals.device)
    delivered = (
        ~dropped & (late == 0) & sent[..., None]
        & (sender[..., None] != recv)
    )
    count_eff = torch.where(clear_l, 0, count[..., None])

    p2 = effective_p(p, clear_p, forge_p)  # [T, P, R, S]
    li_b = li[:, None].to(torch.int32)  # [T, 1, R, S]
    own = torch.where(p2, li_b, SENTINEL)
    rows = torch.arange(max_l, device=vals.device)
    valid = rows < count[..., None]
    dup = torch.zeros_like(clear_l)
    for r in range(max_l):
        same = (vals[:, :, None, r, :] == own).all(-1)
        dup |= valid[..., r, None] & same
    dup &= ~clear_l
    own_len = p2.sum(-1)

    bad_own = (
        p2 & ((li_b == v2[..., None]) | (li_b > w) | (li_b < 0))
    ).any(-1)
    pres_any = pres.any(-2)  # [T, P, w]
    cont = torch.gather(pres_any, -1, v2.clamp(0, w - 1).long())
    cont &= (v2 >= 0) & (v2 < w)
    # pres[t, p, j, li[t, r, j]] for every receiver r: [T, P, R, S].
    t_, p_, s_, _ = pres.shape
    idx = li.clamp(0, w - 1).long().transpose(-1, -2)  # [T, S, R]
    at_li = torch.gather(
        pres.permute(0, 2, 1, 3)[:, :, None].expand(t_, s_, n_rv, p_, w),
        -1,
        idx[..., None, None].expand(t_, s_, n_rv, p_, 1),
    )[..., 0].permute(0, 3, 2, 1)
    at_li &= (li_b >= 0) & (li_b < w)
    own_coll = (p2 & at_li).any(-1)

    appended = ~dup & (count_eff < max_l)
    new_count = torch.where(appended, count_eff + 1, count_eff)
    len0 = lens[..., 0:1]
    cond1 = (clear_l | ~lens_bad[..., None]) & (
        ~appended | (count_eff == 0) | (own_len == len0)
    )
    cond2 = ~(
        (~clear_l & (cont | oob[..., None])) | (appended & bad_own)
    )
    cond3 = (clear_l | ~cells_coll[..., None]) & (
        ~appended | ~(~clear_l & own_coll)
    )
    ok = delivered & cond1 & cond2 & cond3 & (new_count == round_idx + 1)
    return ok, v2


def accept_first_per_value(ok: torch.Tensor, v2: torch.Tensor,
                           vi: torch.Tensor, w: int):
    """First-candidate-per-order dedup against ``vi`` (``v not in Vi``):
    among ok packets carrying the same value for a receiver, the lowest
    packet index wins; values already in ``vi`` are never accepted.

    ``ok``/``v2`` ``[T, P, R]``, ``vi`` bool ``[T, R, w]``.  Returns
    ``(acc bool [T, P, R], vi' bool [T, R, w])``.  One per-(receiver,
    value) ``amin`` over packet indices — no packet x packet matrix.
    """
    n_p = ok.shape[1]
    v_rp = v2.transpose(1, 2).clamp(0, w - 1).long()  # [T, R, P]
    in_vi = torch.gather(vi, -1, v_rp)  # [T, R, P]
    cand = ok.transpose(1, 2) & ~in_vi
    idx = torch.arange(n_p, device=ok.device).expand_as(v_rp)
    masked = torch.where(cand, idx, n_p)
    first = torch.full(vi.shape, n_p, dtype=torch.int64, device=ok.device)
    first = first.scatter_reduce(-1, v_rp, masked, reduce="amin")
    acc = cand & (torch.gather(first, -1, v_rp) == idx)
    slot = torch.where(acc, v_rp, w)
    hit = torch.zeros(vi.shape[:-1] + (w + 1,), dtype=torch.bool,
                      device=ok.device).scatter_(-1, slot, True)
    return acc.transpose(1, 2), vi | hit[..., :w]
