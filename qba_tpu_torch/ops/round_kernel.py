"""The voting round over the dense mailbox — counterpart of
:mod:`qba_tpu.ops.round_kernel` (``build_round_step``, the ``pallas``
round engine).

One call runs a full round for every trial: all ``n_pk = n_lieutenants *
slots`` mailbox cells, sent or not, against every receiver; first-accept
dedup into ``vi``; slot allocation per receiver with the overflow flag;
and the whole successor mailbox, in which receiver ``r``'s rebroadcast in
slot ``s`` sits at cell ``r * slots + s`` (no compaction, unlike the pool
engines of :mod:`qba_tpu_torch.ops.round_kernel_tiled`).

Packed mailbox layout (leading trial axis ``T``): ``vals`` ``[T, n_pk,
max_l, size_l]`` and ``p`` ``[T, n_pk, size_l]`` in the pool kernels'
narrow type (int8 while ``w <= 64``), ``lens`` int32 ``[T, n_pk,
max_l]``, ``meta`` int32 ``[T, n_pk, 4]`` with the pool's lanes
``(count, v, sent, cell)``; a cell's ``cell`` lane is its own index.
The JAX kernel keeps ``vals`` as ``[max_l, n_pk, size_l]`` to put
packets in TPU sublanes; here a cell's rows are contiguous.

:func:`round_step` launches ``csrc/round_step.cu`` for CUDA tensors and
runs :func:`round_step_reference` for CPU tensors; a CUDA tensor never
reaches the plain version.  With ``n_recv``, the party-sharded variant
(the JAX kernel's ``build_round_step(n_recv=...)``): each shard drains
its receivers against its copy of the gathered GLOBAL mailbox and writes
its LOCAL mailbox of ``n_recv * slots`` cells, whose ``cell`` lanes are
global, so the local mailboxes concatenated in shard order are again a
mailbox whose cells carry their own index.  The JAX kernel's compile
probes and VMEM pre-filter have no analog on this card.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.types import SENTINEL
from qba_tpu_torch.ops._launch import (
    check,
    check_kernel_shapes,
    dispatch,
    kernel_fn,
    no_clock,
    ptrs,
    timed_launch,
    write_out,
)
from qba_tpu_torch.ops.round_kernel_tiled import (
    META_COUNT,
    META_SENT,
    META_V,
    check_round_smem,
    honest_cells,
    launch_ints,
    pool_vals_dtype,
    rebuilt_entries,
    round_clock_ptr,
    shard_plan,
    shard_starts,
    stack_shards,
)
from qba_tpu_torch.ops.verdict_algebra import accept_first_per_value, verdict
from qba_tpu_torch.rounds.mailbox import Mailbox

# Per-cell sender honesty int32 [T, n_pk]: the pool kernels' table.
honest_packets = honest_cells


def empty_mailbox(cfg: QBAConfig, n_trials: int, device=None, *,
                  n_recv: int | None = None, start: int = 0):
    """An all-unsent packed mailbox ``(vals, lens, p, meta)``; with
    ``n_recv`` a shard's local mailbox of ``n_recv * slots`` cells, the
    receivers ``[start, start + n_recv)``'s, whose ``cell`` lanes are
    global."""
    n_rv = cfg.n_lieutenants if n_recv is None else n_recv
    n_pk, max_l, s = n_rv * cfg.slots, cfg.max_l, cfg.size_l
    vdt = pool_vals_dtype(cfg)
    meta = torch.zeros((n_trials, n_pk, 4), dtype=torch.int32, device=device)
    meta[..., 3] = start * cfg.slots + torch.arange(n_pk, dtype=torch.int32,
                                                    device=device)
    return (
        torch.full((n_trials, n_pk, max_l, s), SENTINEL, dtype=vdt,
                   device=device),
        torch.zeros((n_trials, n_pk, max_l), dtype=torch.int32,
                    device=device),
        torch.zeros((n_trials, n_pk, s), dtype=vdt, device=device),
        meta,
    )


def pack_mailbox(cfg: QBAConfig, mb: Mailbox):
    """A :class:`~qba_tpu_torch.rounds.mailbox.Mailbox` (fields ``[T,
    senders, slots, ...]``) in the packed layout."""
    n_trials = mb.sent.shape[0]
    n_pk = cfg.n_lieutenants * cfg.slots
    vdt = pool_vals_dtype(cfg)

    def flat(x, dt):
        return x.reshape((n_trials, n_pk) + x.shape[3:]).to(dt).contiguous()

    cells = torch.arange(n_pk, dtype=torch.int32, device=mb.sent.device)
    meta = torch.stack(
        [flat(mb.count, torch.int32), flat(mb.v, torch.int32),
         flat(mb.sent, torch.int32), cells.expand(n_trials, n_pk)], dim=-1)
    return (flat(mb.vals, vdt), flat(mb.lens, torch.int32),
            flat(mb.p_mask, vdt), meta.contiguous())


def mailbox_from_step3a(cfg: QBAConfig, out_cells, *, start: int = 0):
    """Step 3a's broadcasts (each lieutenant's slot 0, as
    :func:`qba_tpu_torch.rounds.engine.step3a_one` returns them) as a
    packed mailbox, the other slots unsent; built in place, without the
    int32 dense :class:`Mailbox` in between.  A shard passes its
    receivers' rows and ``start``, its first global receiver: the result
    is its local mailbox (global ``cell`` lanes)."""
    o_vals, o_lens, o_count, o_p, o_v, o_sent = out_cells
    n_trials, n_s = o_sent.shape
    slots = cfg.slots
    vals, lens, p, meta = empty_mailbox(cfg, n_trials, o_sent.device,
                                        n_recv=n_s, start=start)

    def slot0(x):  # [T, n_pk, ...] -> the view of every sender's slot 0
        return x.view((n_trials, n_s, slots) + x.shape[2:])[:, :, 0]

    slot0(vals).copy_(o_vals)
    slot0(lens).copy_(o_lens)
    slot0(p).copy_(o_p)
    m0 = slot0(meta)
    m0[..., META_COUNT] = o_count
    m0[..., META_V] = o_v
    m0[..., META_SENT] = o_sent
    return vals, lens, p, meta


def round_step_reference(cfg: QBAConfig, round_idx: int, mailbox, li, vi,
                         honest_pk, attack, rand_v, late, *, start: int = 0,
                         n_recv: int | None = None):
    """One voting round over the dense mailbox in plain PyTorch.

    ``mailbox`` is the packed ``(vals, lens, p, meta)``; ``li`` int32
    ``[T, n_rv, size_l]``, ``vi`` int32 0/1 ``[T, n_rv, w]``,
    ``honest_pk`` ``[T, n_pk]``, draws ``[T, n_pk, n_glob]``; the
    receivers are the global ``[start, start + n_rv)``.  Returns
    ``(mailbox', vi' int32, overflow bool [T])``, ``mailbox'`` their
    ``n_rv * slots`` cells.  Cells no trial sent take no part in the
    verdict, but every successor cell is written.

    With ``n_recv`` (the party-sharded variant) the mailbox, ``li``,
    ``vi`` and the results carry a leading shard axis: ``mailbox`` ``[n_sh,
    T, n_pk, ...]`` is each shard's gathered global mailbox, shard ``s``'s
    receivers the global ``[start + s * n_recv, start + (s + 1) *
    n_recv)``; honesty and draws are global.  Each shard's result is its
    local mailbox ``[n_sh, T, n_recv * slots, ...]``.
    """
    if n_recv is not None:
        return stack_shards([
            round_step_reference(cfg, round_idx,
                                 tuple(x[sh] for x in mailbox), li[sh],
                                 vi[sh], honest_pk, attack, rand_v, late,
                                 start=first)
            for sh, first in enumerate(shard_starts(li, start, n_recv))])
    vals, lens, p, meta = mailbox
    n_trials, n_pk, max_l, s = vals.shape
    n_rv, slots, w = li.shape[1], cfg.slots, cfg.w
    n_out = n_rv * slots
    attack, rand_v, late = (x[..., start:start + n_rv]
                            for x in (attack, rand_v, late))
    dev = vals.device
    out = empty_mailbox(cfg, n_trials, dev, n_recv=n_rv, start=start)
    no_overflow = torch.zeros(n_trials, dtype=torch.bool, device=dev)
    # qba-lint: sync-ok (plain version: CPU tensors only)
    cols = (meta[..., META_SENT] != 0).any(0).nonzero()[:, 0]
    if cols.numel() == 0:
        return out, vi.clone(), no_overflow
    vals_s = vals[:, cols].to(torch.int32)
    lens_s, meta_s, p_s = lens[:, cols], meta[:, cols], p[:, cols] != 0
    count, v = meta_s[..., META_COUNT], meta_s[..., META_V]
    cell = cols.expand(n_trials, -1)
    honest_s = honest_pk[:, cols]
    att_s, rv_s = attack[:, cols], rand_v[:, cols]
    ok, v2 = verdict(
        vals=vals_s, lens=lens_s, count=count, p=p_s, v=v,
        sent=meta_s[..., META_SENT] != 0, sender=cell // slots,
        honest_c=honest_s, attack=att_s, rand_v=rv_s, late=late[:, cols],
        li=li, round_idx=round_idx, w=w, use_fp=cfg.strategy == "split",
        recv_off=start,
    )
    acc, vi_new = accept_first_per_value(ok, v2, vi != 0, w)
    vi_new = vi_new.to(torch.int32)
    # qba-lint: sync-ok (plain version: CPU tensors only)
    if round_idx > cfg.n_dishonest or not bool(acc.any()):
        return out, vi_new, no_overflow

    # Slot allocation: per receiver, an exclusive prefix count of its
    # rebroadcasts in cell order; past `slots` is overflow.  Receiver r's
    # slot goes to (local) cell r * slots + slot.
    rb = acc.to(torch.int64)
    slot_r = torch.cumsum(rb, 1) - rb  # [T, P, R]
    write = acc & (slot_r < slots)
    overflow = (acc & ~write).flatten(1).any(-1)
    ridx = torch.arange(n_rv, device=dev)[None, None, :].expand_as(slot_r)
    pidx = torch.arange(cols.numel(), device=dev)[None, :, None].expand_as(
        slot_r)
    dst = torch.where(write, ridx * slots + slot_r, n_out)

    def to_dst(src_idx, fill=0):  # [T, P, R] -> per destination [T, n_out]
        buf = torch.full((n_trials, n_out + 1), fill, dtype=torch.int64,
                         device=dev)
        return buf.scatter_(1, dst.flatten(1), src_idx.flatten(1))[:, :n_out]

    src = to_dst(pidx)
    has = to_dst(torch.ones_like(pidx)) != 0
    r_d = (torch.arange(n_out, device=dev) // slots).expand(n_trials, n_out)
    o_vals, o_lens, o_p, new_cnt, v2_g = rebuilt_entries(
        cfg, vals_s, lens_s, p_s, count, v, honest_s, att_s, rv_s, li, src,
        r_d, has)
    o_meta = torch.stack(
        [new_cnt, v2_g, has.to(torch.int32), out[3][..., 3]], dim=-1)
    o_meta[..., :2] = torch.where(has[..., None], o_meta[..., :2], 0)
    vdt = pool_vals_dtype(cfg)
    out = (o_vals.to(vdt).contiguous(), o_lens.to(torch.int32),
           o_p.to(vdt), o_meta.to(torch.int32).contiguous())
    return out, vi_new, overflow


def _check_inputs(cfg: QBAConfig, mailbox, li, vi, honest_pk, draws,
                  lead=(), n_local=None):
    """Raise unless the round's inputs are what the kernel takes: exact
    dtypes, shapes, contiguous, on one CUDA device.  ``lead`` is the
    leading shard axis of the mailbox, ``li`` and ``vi`` (of ``n_local``
    receivers) in the party-sharded variant.  Returns the trial count."""
    vals, lens, p, meta = mailbox
    n_trials = vals.shape[len(lead)]
    n_rv, max_l, s, w = cfg.n_lieutenants, cfg.max_l, cfg.size_l, cfg.w
    n_loc = n_rv if n_local is None else n_local
    n_pk = n_rv * cfg.slots
    dev = vals.device
    lt = tuple(lead) + (n_trials,)
    shapes = {
        "vals": (vals, torch.int8, lt + (n_pk, max_l, s)),
        "lens": (lens, torch.int32, lt + (n_pk, max_l)),
        "p": (p, torch.int8, lt + (n_pk, s)),
        "meta": (meta, torch.int32, lt + (n_pk, 4)),
        "li": (li, torch.int32, lt + (n_loc, s)),
        "vi": (vi, torch.int32, lt + (n_loc, w)),
        "honest_pk": (honest_pk, torch.int32, (n_trials, n_pk)),
    }
    for name, x in draws.items():
        shapes[name] = (x, torch.uint8, (n_trials, n_pk, n_rv))
    for name, (x, dt, shp) in shapes.items():
        check(name, x, dt, shp, dev)
    return n_trials


def round_step(cfg: QBAConfig, round_idx: int, mailbox, li, vi, honest_pk,
               attack, rand_v, late, out=None, *, start: int = 0,
               n_recv: int | None = None, clock=None):
    """One voting round over the dense mailbox: ``(mailbox', vi',
    overflow bool [T])``.

    CPU tensors run :func:`round_step_reference` (its result written
    into ``out`` where one is given).  CUDA tensors launch the
    CUDA kernel, which takes exactly the dtypes ``int8`` (``vals``,
    ``p``), ``int32`` (``lens``, ``meta``, ``li``, ``vi``, ``honest_pk``)
    and ``uint8`` (the three draw tables), contiguous, on one device, and
    writes into ``out`` (a mailbox of the result's shapes that aliases
    none of the input: the other buffer of a ping-pong pair) or a new
    mailbox.  Any other input raises.

    With ``n_recv``, the party-sharded variant (see
    :func:`round_step_reference`): one launch for every shard of the
    leading shard axis, each writing its local mailbox ``[n_sh, T,
    n_recv * slots, ...]``; overflow is ``[n_sh, T]``.

    ``clock`` as in :func:`~qba_tpu_torch.ops.round_kernel_tiled.
    fused_round`.
    """
    if not dispatch("round_step", mailbox):
        no_clock(clock)
        new, vi_new, ovf = round_step_reference(
            cfg, round_idx, mailbox, li, vi, honest_pk, attack, rand_v, late,
            start=start, n_recv=n_recv)
        return write_out("round_step", new, out, mailbox), vi_new, ovf
    check_kernel_shapes(cfg, "dense-mailbox round")
    n_sh, n_local, lead = shard_plan(cfg, li, start, n_recv)
    check_round_smem(cfg, n_local, "dense-mailbox round")
    n_trials = _check_inputs(cfg, mailbox, li, vi, honest_pk,
                             dict(attack=attack, rand_v=rand_v, late=late),
                             lead, n_local)
    n_out, max_l, s = n_local * cfg.slots, cfg.max_l, cfg.size_l
    lt = lead + (n_trials, n_out)
    layout = (lt + (max_l, s), lt + (max_l,), lt + (s,), lt + (4,))
    if out is None:
        out = tuple(torch.empty(shp, dtype=x.dtype, device=x.device)
                    for shp, x in zip(layout, mailbox))
    for name, x, ref, shp in zip(("o_vals", "o_lens", "o_p", "o_meta"), out,
                                 mailbox, layout):
        check(name, x, ref.dtype, shp, ref.device)
        if x.data_ptr() == ref.data_ptr():
            raise ValueError(f"{name} aliases its input; pass the other "
                             "buffer of the ping-pong pair")
    vi_out = torch.empty_like(vi)
    ovf = torch.empty(lead + (n_trials,), dtype=torch.int32,
                      device=vi.device)
    fn = kernel_fn("round_step", "qba_round_step", 17, 12)
    args = ptrs(*mailbox, li, vi, honest_pk, attack, rand_v, late, *out,
                vi_out, ovf)
    args += [round_clock_ptr(clock, lead, n_trials, vi.device)]
    args += launch_ints(cfg, n_trials, n_sh, n_local, start)
    args += [cfg.n_dishonest, int(round_idx), int(cfg.strategy == "split")]
    timed_launch(round_step, fn, args, torch.cuda.current_stream(vi.device))
    return out, vi_out, ovf != 0


round_step.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
round_step.events = None
