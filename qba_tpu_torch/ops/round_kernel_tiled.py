"""The voting round over a compacted packet pool — counterpart of
:mod:`qba_tpu.ops.round_kernel_tiled`: the fused round kernel
(``build_fused_round_kernel``), the two-kernel tiled round
(``build_verdict_kernel`` + ``build_rebuild_kernel``) and their pool
helpers.

Pool layout (one per trial, leading trial axis ``T``; the JAX package's
layout with the trial axis in front): ``vals`` ``[T, max_l, n_pool,
size_l]``, ``lens`` int32 ``[T, n_pool, max_l]``, ``p`` ``[T, n_pool,
size_l]`` (0/1), ``meta`` int32 ``[T, n_pool, 4]`` with lanes
``META_*``.  ``n_pool = n_lieutenants * slots``.  The round's packets sit
compacted at the front in (sender, slot) order, each carrying its mailbox
cell id ``sender * slots + slot`` so the per-cell draws keep their
identity.  ``vals`` and ``p`` are int8: every stored value lies in
``[-1, w]`` with ``w <= 64``, so int8 is exact (the TPU stores bf16).

Three wrappers, each with its plain PyTorch version beside it:
:func:`fused_round` (:func:`fused_round_reference`, ``csrc/fused_round.cu``),
:func:`tiled_verdict` (:func:`verdict_reference`) and
:func:`tiled_rebuild` (:func:`rebuild_reference`, both in
``csrc/tiled_round.cu``).  The fused round's plain version is the
composition of the two tiled ones; the seam between them is the accepted
matrix as one receiver mask a packet, ``acc`` int64 ``[T, n_pool]``: bit
``r`` is set where receiver ``r`` accepted the packet (first accept per
value), 0 past the receivers and for unsent entries (:func:`pack_acc`,
:func:`unpack_acc`).  The word is 64 bits because every kernel keeps its
receivers as 64-bit masks (``KERNEL_MAX_W``: at most 64 lieutenants).  A
wrapper launches its
hand-written CUDA kernel for CUDA tensors and runs the plain version for
CPU tensors; a CUDA tensor never reaches the plain version.

The party-sharded ``n_recv`` variants of the three kernels (the TPU
kernels' ``n_recv`` builds) are the same wrappers with ``n_recv``: each
shard drains its receivers ``[start, start + n_recv)`` against the whole
assembled pool and the rebuilding kernels write its LOCAL successor
segment (capacity ``n_recv * slots``, locally compacted, global cell
ids).  Shard tensors carry a leading shard axis ``[n_shards, T, ...]``;
the round's honesty and draws stay global.  The verdict's ``acc`` is
then ``[n_shards, T, n_pool]``, bit ``r`` of a shard's word its local
receiver ``r`` (global ``start + shard * n_recv + r``;
:func:`join_acc_shards` gives the single-device words): the entries
between the segments of an assembled pool are unsent and their words
stay zero, so the rebuild reads the accepted packets in the global
(sender, slot) order.
:func:`sharded_mega_plan` admits the party-sharded trial megakernel.
"""

from __future__ import annotations

import typing

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.types import SENTINEL
from qba_tpu_torch.ops._launch import (
    KERNEL_MAX_W,
    KernelUnsupported,
    check,
    check_kernel_shapes,
    clock_breakdown,
    clock_ptr,
    dispatch,
    kernel_fn,
    no_clock,
    ptrs,
    timed_launch,
)
from qba_tpu_torch.ops.verdict_algebra import (
    accept_first_per_value,
    corruption_flags,
    verdict,
)

META_COUNT, META_V, META_SENT, META_CELL = 0, 1, 2, 3
# The per-round kernels' phase clock (``csrc/round_common.cuh``,
# ``RoundPhase``): the phases of the fused round's and the dense-mailbox
# round's blocks, in the order of the clock's int64 ``[..., T,
# len(ROUND_PHASES)]`` buffer.
ROUND_PHASES = ("setup", "list", "stage", "receivers", "verdict_wait",
                "dedup", "offsets", "rebuild", "fill")
# The per-round kernels' block: ROUND_WARPS warps (``kWarps``,
# ``csrc/round_common.cuh``).
ROUND_WARPS = 8
# The largest dynamic shared memory of a block on the H100 (``kSmemLimit``).
SMEM_LIMIT = 232448


def lane_group(n_rv: int) -> int:
    """Lanes a receiver in the kernels' verdicts (``lane_group``,
    ``csrc/round_common.cuh``): 32 / G receivers run across a warp's
    lanes at once, each over G lanes that split the packet's words."""
    return 4 if n_rv <= 8 else (2 if n_rv <= 16 else 1)


def _align16(x: int) -> int:
    return (x + 15) & ~15


def round_smem_bytes(cfg: QBAConfig, n_local: int | None = None,
                     verdict: bool = True, slots: bool = True) -> int:
    """Dynamic shared memory of a per-round kernel's block (``Smem``,
    ``csrc/round_common.cuh``) draining ``n_local`` receivers (default
    every lieutenant): the accepted sets, slots (with ``slots``: every
    kernel but the tiled verdict), counts, offsets and flags; with
    ``verdict`` (every kernel but the tiled rebuild) also each
    warp's lossy receivers, each cell's verdict and order, the cells' sent
    and honesty bits, the sent cells' list, the block's lists as int8
    words ``[sw][n_local + 1]`` with their out-of-range words, and
    ``ROUND_WARPS`` warps' packet buffers (lens, P and the rows as words;
    two a warp where they fit :data:`SMEM_LIMIT`, else one)."""
    n_rv = cfg.n_lieutenants if n_local is None else n_local
    n_pool = cfg.n_lieutenants * cfg.slots
    sw = -(-cfg.size_l // 4)
    lossy = _align16(8 * n_rv + (4 * n_rv * cfg.slots if slots else 0)
                     + 4 * n_rv + 4 * (n_rv + 1)) + 32
    if not verdict:
        return lossy
    ok = lossy + 8 * ROUND_WARPS
    cells = ok + 8 * n_pool + 4 * n_pool + 8 * -(-n_pool // 32) + 4 * n_pool
    stage = _align16(cells + 2 * 4 * sw * (n_rv + 1))
    buf = (_align16(4 * cfg.max_l) + _align16(4 * sw)
           + _align16(4 * sw * cfg.max_l))
    stages = 2 if stage + ROUND_WARPS * 2 * buf <= SMEM_LIMIT else 1
    return stage + ROUND_WARPS * stages * buf


def verdict_ranks(cfg: QBAConfig, n_local: int) -> int:
    """Thread blocks a (shard, trial) in the tiled verdict's launch (its
    cluster dimension, ``csrc/tiled_round.cu``): two where a block drains
    more than 16 receivers (33 parties single-device), which splits each
    trial's listed packets over two SMs, else one."""
    return 2 if n_local > 16 else 1


def check_round_smem(cfg: QBAConfig, n_local: int, kernel: str,
                     slots: bool = True) -> None:
    """Raise :class:`~qba_tpu_torch.ops._launch.KernelUnsupported` where a
    per-round kernel's block would need more shared memory than the card
    gives one block."""
    need = round_smem_bytes(cfg, n_local, slots=slots)
    if need > SMEM_LIMIT:
        raise KernelUnsupported(
            f"the {kernel} kernel needs {need} B of shared memory a block "
            f"at size_l={cfg.size_l}, more than the {SMEM_LIMIT} B the card "
            "gives one block")


def pool_vals_dtype(cfg: QBAConfig) -> torch.dtype:
    """Element type of the pool's ``vals`` and ``p``: int8 while every
    stored value (``[-1, w]``) fits, else int32."""
    return torch.int8 if cfg.w <= KERNEL_MAX_W else torch.int32


def empty_pool(cfg: QBAConfig, n_trials: int, device=None,
               n_recv: int | None = None):
    """An empty pool ``(vals, lens, p, meta)`` for ``n_trials`` trials;
    ``n_recv`` sizes a shard's local segment (capacity ``n_recv *
    slots``)."""
    n_rv = cfg.n_lieutenants if n_recv is None else n_recv
    n_pool, max_l, s = n_rv * cfg.slots, cfg.max_l, cfg.size_l
    vdt = pool_vals_dtype(cfg)
    return (
        torch.full((n_trials, max_l, n_pool, s), SENTINEL, dtype=vdt,
                   device=device),
        torch.zeros((n_trials, n_pool, max_l), dtype=torch.int32,
                    device=device),
        torch.zeros((n_trials, n_pool, s), dtype=vdt, device=device),
        torch.zeros((n_trials, n_pool, 4), dtype=torch.int32, device=device),
    )


def pool_from_step3a(cfg: QBAConfig, out_cells, *, start: int = 0,
                     n_recv: int | None = None):
    """Compact step 3a's broadcasts (each lieutenant's slot 0, as returned
    by :func:`qba_tpu_torch.rounds.engine.step3a_one`) into the pool.

    A shard passes its receivers' rows, ``start`` (its first global
    receiver) and ``n_recv``: the result is its LOCAL segment, locally
    compacted, with global cell ids."""
    o_vals, o_lens, o_count, o_p, o_v, o_sent = out_cells
    n_trials, n_rv = o_sent.shape
    if n_recv is not None and n_recv != n_rv:
        raise ValueError(f"n_recv={n_recv} but the cells hold {n_rv} "
                         "receivers")
    slots = cfg.slots
    cap = n_rv * slots
    dev = o_sent.device
    sent = o_sent.to(torch.int64)
    dst = torch.where(o_sent, torch.cumsum(sent, -1) - sent, cap)
    vdt = pool_vals_dtype(cfg)
    cells = (start + torch.arange(n_rv, dtype=torch.int32, device=dev)) * slots
    meta_rows = torch.stack(
        [o_count.to(torch.int32), o_v.to(torch.int32),
         torch.ones_like(o_count, dtype=torch.int32),
         cells.expand(n_trials, n_rv)],
        dim=-1,
    )

    def scat(src, fill, dt):  # rows of src [T, n_rv, ...] -> dst slots
        out = torch.full((n_trials, cap + 1) + src.shape[2:], fill,
                         dtype=dt, device=dev)
        index = dst.view(dst.shape + (1,) * (src.dim() - 2)).expand(src.shape)
        return out.scatter_(1, index, src.to(dt))[:, :cap]

    vals = scat(o_vals, SENTINEL, vdt).transpose(1, 2).contiguous()
    return (
        vals,
        scat(o_lens, 0, torch.int32).contiguous(),
        scat(o_p, 0, vdt).contiguous(),
        scat(meta_rows, 0, torch.int32).contiguous(),
    )


def shard_receivers(x: torch.Tensor, n_tp: int) -> torch.Tensor:
    """Receiver-indexed ``[T, n_rv, ...]`` -> ``[n_tp, T, n_rv / n_tp,
    ...]``: shard ``s`` holds the receivers ``[s * n_local, (s + 1) *
    n_local)``, contiguous."""
    t, n_rv = x.shape[:2]
    return (x.reshape((t, n_tp, n_rv // n_tp) + x.shape[2:])
            .movedim(1, 0).contiguous())


def unshard_receivers(x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`shard_receivers`."""
    n_tp, t, n_local = x.shape[:3]
    return x.movedim(0, 1).reshape((t, n_tp * n_local) + x.shape[3:])


# The capacity axis of each pool leaf, counted after the trial axis.
POOL_AXES = (1, 0, 0, 0)


def assemble_pool(segments):
    """The whole pool ``[T, ...]`` from the shards' local segments
    ``[n_tp, T, ...]``: the segments concatenated in tp order, each with
    its empty tail, as the tiled all-gather assembles them."""
    return tuple(torch.cat(list(x), dim=ax + 1)
                 for x, ax in zip(segments, POOL_AXES))


def honest_cells(honest: torch.Tensor, cfg: QBAConfig) -> torch.Tensor:
    """Per-cell sender honesty int32 ``[T, n_cells]`` from the rank-indexed
    mask (the cell's sender lieutenant is ``cell // slots``, rank + 2)."""
    n_cells = cfg.n_lieutenants * cfg.slots
    ranks = torch.arange(n_cells, device=honest.device) // cfg.slots + 2
    return honest[:, ranks].to(torch.int32).contiguous()


def _by_cell(table: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Rows of a cell-indexed table ``[T, n_cells, ...]`` at ``cell``
    ``[T, P]``."""
    idx = cell.clamp(0, table.shape[1] - 1).long()
    idx = idx.view(idx.shape + (1,) * (table.dim() - 2))
    return torch.gather(table, 1, idx.expand(idx.shape[:2] + table.shape[2:]))


def _receiver_draws(draws, start: int, n_rv: int):
    """The columns of receivers ``[start, start + n_rv)`` of global draw
    tables ``[T, n_cells, n_glob]``."""
    return tuple(x[..., start:start + n_rv] for x in draws)


def stack_shards(parts):
    """Per-shard outputs (tensors, or tuples of them) stacked on a leading
    shard axis."""
    if isinstance(parts[0], tuple):
        return tuple(stack_shards([p[i] for p in parts])
                     for i in range(len(parts[0])))
    return torch.stack(parts)


def shard_starts(li, start: int, n_recv: int):
    """Each shard's first global receiver, for shard tensors ``li``
    ``[n_sh, T, n_recv, ...]``."""
    if li.shape[2] != n_recv:
        raise ValueError(f"n_recv={n_recv} but li holds {li.shape[2]} "
                         "receivers a shard")
    return [start + s * n_recv for s in range(li.shape[0])]


def pack_acc(acc: torch.Tensor) -> torch.Tensor:
    """An accepted matrix 0/1 (any integer or bool dtype) ``[..., n_pool,
    n_local]`` -> one receiver mask a packet, int64 ``[..., n_pool]``:
    bit ``r`` is receiver ``r``'s entry (``n_local <= 64``)."""
    n_local = acc.shape[-1]
    if n_local > KERNEL_MAX_W:
        raise ValueError(f"{n_local} receivers do not fit a 64-bit mask")
    bits = torch.arange(n_local, dtype=torch.int64, device=acc.device)
    # Disjoint bits: the sum is their or, bit 63 included.
    return ((acc != 0).to(torch.int64) << bits).sum(-1)


def unpack_acc(acc: torch.Tensor, n_local: int) -> torch.Tensor:
    """One receiver mask a packet, int64 ``[..., n_pool]`` -> the accepted
    matrix int32 0/1 ``[..., n_pool, n_local]`` (the JAX verdict
    kernel's ``acc``)."""
    bits = torch.arange(n_local, dtype=torch.int64, device=acc.device)
    return ((acc[..., None] >> bits) & 1).to(torch.int32)


def join_acc_shards(acc: torch.Tensor, n_local: int) -> torch.Tensor:
    """The ``n_recv`` verdict's masks ``[n_sh, T, n_pool]`` (``n_local``
    receivers a shard) -> the single-device masks ``[T, n_pool]`` of the
    ``n_sh * n_local`` receivers in shard order."""
    rows = unpack_acc(acc, n_local)  # [n_sh, T, n_pool, n_local]
    return pack_acc(rows.permute(1, 2, 0, 3).flatten(2))


def verdict_reference(cfg: QBAConfig, round_idx: int, pool, li, vi,
                      honest_c, attack, rand_v, late, *, start: int = 0,
                      n_recv: int | None = None):
    """Phase 1 of a round in plain PyTorch: the verdict of every pool
    packet against every receiver and the first accept per value into
    ``vi``.

    ``li`` int32 ``[T, n_rv, size_l]``, ``vi`` int32 0/1 ``[T, n_rv, w]``,
    ``honest_c`` ``[T, n_cells]``, draws ``[T, n_cells, n_glob]``; the
    receivers are the global ``[start, start + n_rv)``.  Returns ``(acc
    int64 [T, n_pool], vi' int32)``: ``acc`` is the accepted matrix after
    first-accept dedup, one receiver mask a packet (:func:`pack_acc` of
    the JAX verdict kernel's int32 0/1 ``[T, n_pool, n_rv]``).

    With ``n_recv`` (the party-sharded variant) the pool, ``li`` and
    ``vi`` carry a leading shard axis, as in
    :func:`fused_round_reference`, and so do both results: ``acc``
    ``[n_sh, T, n_pool]``, bit ``r`` the shard's local receiver ``r``.
    """
    if n_recv is not None:
        return stack_shards([
            verdict_reference(cfg, round_idx, tuple(x[sh] for x in pool),
                              li[sh], vi[sh], honest_c, attack, rand_v,
                              late, start=first)
            for sh, first in enumerate(shard_starts(li, start, n_recv))])
    vals, lens, p, meta = pool
    n_trials, max_l, n_pool, s = vals.shape
    n_rv, slots, w = li.shape[1], cfg.slots, cfg.w
    attack, rand_v, late = _receiver_draws((attack, rand_v, late), start,
                                           n_rv)
    dev = vals.device
    acc = torch.zeros((n_trials, n_pool), dtype=torch.int64, device=dev)
    sent_any = (meta[..., META_SENT] != 0).any(0).nonzero()
    if sent_any.numel() == 0:
        return acc, vi.clone()
    # Packets past the last sent entry of every trial can be accepted by
    # no receiver: the verdict scans only up to it.
    n_scan = int(sent_any.max()) + 1
    vals_s = vals[:, :, :n_scan].to(torch.int32).transpose(1, 2)
    lens_s, meta_s = lens[:, :n_scan], meta[:, :n_scan]
    count, v = meta_s[..., META_COUNT], meta_s[..., META_V]
    cell = meta_s[..., META_CELL]
    honest_s = torch.gather(honest_c, 1,
                            cell.clamp(0, honest_c.shape[1] - 1).long())
    ok, v2 = verdict(
        vals=vals_s, lens=lens_s, count=count, p=p[:, :n_scan] != 0, v=v,
        sent=meta_s[..., META_SENT] != 0, sender=cell // slots,
        honest_c=honest_s, attack=_by_cell(attack, cell),
        rand_v=_by_cell(rand_v, cell), late=_by_cell(late, cell), li=li,
        round_idx=round_idx, w=w, use_fp=cfg.strategy == "split",
        recv_off=start,
    )
    acc_s, vi_new = accept_first_per_value(ok, v2, vi != 0, w)
    acc[:, :n_scan] = pack_acc(acc_s)
    return acc, vi_new.to(torch.int32)


def rebuilt_entries(cfg: QBAConfig, vals_s, lens_s, p_s, count, v,
                    honest_s, att_s, rv_s, li, src, r_d, has):
    """The rebroadcast packets of one round, shared by the pool rebuild
    and the dense-mailbox round: destination ``d`` of trial ``t`` is
    source packet ``src[t, d]`` as receiver ``r_d[t, d]`` accepted it
    (where ``has``; empty elsewhere).

    Per source packet: ``vals_s`` int32 ``[T, P, max_l, S]``, ``lens_s``
    ``[T, P, max_l]``, ``p_s`` bool ``[T, P, S]``, ``count``/``v``/
    ``honest_s`` ``[T, P]`` and its draws ``att_s``/``rv_s`` ``[T, P,
    R]``.  Returns ``(vals int32 [T, D, max_l, S], lens int32 [T, D,
    max_l], p bool [T, D, S], count int32 [T, D], v int32 [T, D])``; the
    first three are empty where ``~has``, the last two unmasked."""
    max_l, s = cfg.max_l, cfg.size_l
    dev = vals_s.device

    def gat(x):  # packet-indexed [T, P, ...] -> destinations
        idx = src.view(src.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(src.shape + x.shape[2:]))

    vals_g, lens_g = gat(vals_s), gat(lens_s)
    cnt_g, v_g = gat(count), gat(v)
    att_g = torch.gather(gat(att_s), 2, r_d[..., None])[..., 0]
    rvv_g = torch.gather(gat(rv_s), 2, r_d[..., None])[..., 0]
    _, v2_g, clear_p, clear_l, forge_p = corruption_flags(
        gat(honest_s), att_g[..., None], rvv_g[..., None], v_g,
        cfg.strategy == "split",
    )
    v2_g, clear_p, clear_l, forge_p = (
        x[..., 0] for x in (v2_g, clear_p, clear_l, forge_p)
    )
    p2 = (gat(p_s) & ~clear_p[..., None]) | forge_p[..., None]
    li_d = torch.gather(li, 1, r_d[..., None].expand(r_d.shape + (s,)))
    own = torch.where(p2, li_d.to(torch.int32), SENTINEL)
    own_len = p2.sum(-1).to(torch.int32)
    cnt_eff = torch.where(clear_l, 0, cnt_g)
    rows = torch.arange(max_l, device=dev)
    valid = rows < cnt_g[..., None]
    dup = (valid & (vals_g == own[..., None, :]).all(-1)).any(-1) & ~clear_l
    new_cnt = torch.where(dup, cnt_eff, torch.clamp(cnt_eff + 1, max=max_l))
    keep = rows < cnt_eff[..., None]
    new_row = ~dup[..., None] & (rows == cnt_eff[..., None])
    hm = has[..., None]
    o_lens = torch.where(
        hm & new_row, own_len[..., None],
        torch.where(hm & keep, lens_g, 0),
    )
    o_vals = torch.where(
        (hm & new_row)[..., None], own[..., None, :],
        torch.where((hm & keep)[..., None], vals_g, SENTINEL),
    )
    return (o_vals, o_lens.to(torch.int32), hm & p2,
            new_cnt.to(torch.int32), v2_g.to(torch.int32))


def rebuild_reference(cfg: QBAConfig, round_idx: int, pool, li, acc,
                      honest_c, attack, rand_v, *, start: int = 0,
                      n_recv: int | None = None):
    """Phase 2 of a round in plain PyTorch: slot allocation from the
    accepted matrix ``acc`` (int64 ``[T, n_pool]``, one receiver mask a
    packet, as :func:`verdict_reference` returns it), with overflow, and the
    successor pool of the receivers ``[start, start + n_rv)`` (capacity
    ``n_rv * slots``, global cell ids).  Returns ``(pool', overflow bool
    [T])``.

    With ``n_recv`` the pool, ``li``, ``acc`` and the results carry a
    leading shard axis, as in :func:`fused_round_reference`: each
    shard's local successor segment ``[n_sh, T, ...]``."""
    if n_recv is not None:
        return stack_shards([
            rebuild_reference(cfg, round_idx, tuple(x[sh] for x in pool),
                              li[sh], acc[sh], honest_c, attack, rand_v,
                              start=first)
            for sh, first in enumerate(shard_starts(li, start, n_recv))])
    vals, lens, p, meta = pool
    n_trials, max_l, n_pool, s = vals.shape
    n_rv, slots = li.shape[1], cfg.slots
    attack, rand_v = _receiver_draws((attack, rand_v), start, n_rv)
    dev = vals.device
    out = empty_pool(cfg, n_trials, dev, n_recv=n_rv)
    acc_rows = (acc != 0).any(0).nonzero()
    if acc_rows.numel() == 0 or round_idx > cfg.n_dishonest:
        return out, torch.zeros(n_trials, dtype=torch.bool, device=dev)
    # Rows past the last accepted packet of every trial write nothing.
    n_scan = int(acc_rows.max()) + 1
    vals_s = vals[:, :, :n_scan].to(torch.int32).transpose(1, 2)
    lens_s, meta_s = lens[:, :n_scan], meta[:, :n_scan]
    count, v = meta_s[..., META_COUNT], meta_s[..., META_V]
    cell = meta_s[..., META_CELL]

    # Slot allocation: per receiver, an exclusive prefix count of its
    # rebroadcasts in packet order; past `slots` is overflow.
    rebroadcast = unpack_acc(acc[:, :n_scan], n_rv) != 0
    rb = rebroadcast.to(torch.int64)
    slot_r = torch.cumsum(rb, 1) - rb  # [T, P, R]
    write = rebroadcast & (slot_r < slots)
    overflow = (rebroadcast & ~write).flatten(1).any(-1)
    k_r = write.sum(1)  # [T, R]
    offs = torch.cumsum(k_r, -1) - k_r
    n_out = n_rv * slots
    dst = torch.where(write, offs[:, None, :] + slot_r, n_out)
    pidx = torch.arange(n_scan, device=dev)[None, :, None].expand_as(dst)
    ridx = torch.arange(n_rv, device=dev)[None, None, :].expand_as(dst)

    def to_dst(src_idx):  # [T, P, R] -> per destination [T, n_out]
        buf = torch.zeros((n_trials, n_out + 1), dtype=torch.int64,
                          device=dev)
        return buf.scatter_(1, dst.flatten(1), src_idx.flatten(1))[:, :n_out]

    src, r_d, sl_d = to_dst(pidx), to_dst(ridx), to_dst(slot_r)
    has = torch.arange(n_out, device=dev) < k_r.sum(-1, keepdim=True)
    o_vals, o_lens, o_p, new_cnt, v2_g = rebuilt_entries(
        cfg, vals_s, lens_s, p[:, :n_scan] != 0, count, v,
        torch.gather(honest_c, 1, cell.clamp(0, honest_c.shape[1] - 1).long()),
        _by_cell(attack, cell), _by_cell(rand_v, cell), li, src, r_d, has)
    o_meta = torch.where(
        has[..., None],
        torch.stack(
            [new_cnt, v2_g, torch.ones_like(new_cnt),
             (start + r_d.to(torch.int32)) * slots + sl_d.to(torch.int32)],
            dim=-1,
        ).to(torch.int32),
        0,
    )
    vdt = pool_vals_dtype(cfg)
    out = (
        o_vals.transpose(1, 2).to(vdt).contiguous(),
        o_lens,
        o_p.to(vdt),
        o_meta,
    )
    return out, overflow


def fused_round_reference(cfg: QBAConfig, round_idx: int, pool, li, vi,
                          honest_c, attack, rand_v, late, *, start: int = 0,
                          n_recv: int | None = None):
    """One voting round in plain PyTorch: :func:`verdict_reference` then
    :func:`rebuild_reference` — the verdict of every pool packet against
    every receiver, first-accept dedup into ``vi``, slot allocation with
    overflow, and the successor pool.

    ``li`` int32 ``[T, n_rv, size_l]``, ``vi`` int32 0/1 ``[T, n_rv, w]``,
    ``honest_c`` ``[T, n_cells]``, draws ``[T, n_cells, n_rv]``.  Returns
    ``(pool', vi' int32, overflow bool [T])``.

    With ``n_recv`` (the party-sharded variant) the pool, ``li`` and
    ``vi`` carry a leading shard axis: ``pool`` ``[n_sh, T, ...]`` is each
    shard's assembled pool, ``li``/``vi`` ``[n_sh, T, n_recv, ...]`` its
    receivers, the global ``[start + s * n_recv, start + (s + 1) *
    n_recv)`` for shard ``s``; ``honest_c`` and the draws (``[T, n_cells,
    n_lieutenants]``) are global.  Returns each shard's local successor
    segment ``[n_sh, T, ...]`` (capacity ``n_recv * slots``), ``vi'`` and
    overflow ``[n_sh, T]``.
    """
    acc, vi_new = verdict_reference(cfg, round_idx, pool, li, vi, honest_c,
                                    attack, rand_v, late, start=start,
                                    n_recv=n_recv)
    out, overflow = rebuild_reference(cfg, round_idx, pool, li, acc,
                                      honest_c, attack, rand_v, start=start,
                                      n_recv=n_recv)
    return out, vi_new, overflow


def _check_round_inputs(cfg: QBAConfig, pool, li, honest_c, draws,
                        vi=None, acc=None, lead=(), n_local=None):
    """Raise unless the round's inputs are what the kernels take: exact
    dtypes, shapes, contiguous, on one CUDA device.  ``lead`` is the
    leading shard axis of the pool, ``li``, ``vi`` and ``acc`` (of
    ``n_local`` receivers) in the party-sharded variant.  Returns the
    trial count."""
    vals, lens, p, meta = pool
    n_trials = vals.shape[len(lead)]
    n_rv, max_l, s, w = cfg.n_lieutenants, cfg.max_l, cfg.size_l, cfg.w
    n_loc = n_rv if n_local is None else n_local
    n_pool = n_rv * cfg.slots
    dev = vals.device
    lt = tuple(lead) + (n_trials,)
    shapes = {
        "vals": (vals, torch.int8, lt + (max_l, n_pool, s)),
        "lens": (lens, torch.int32, lt + (n_pool, max_l)),
        "p": (p, torch.int8, lt + (n_pool, s)),
        "meta": (meta, torch.int32, lt + (n_pool, 4)),
        "li": (li, torch.int32, lt + (n_loc, s)),
        "honest_c": (honest_c, torch.int32, (n_trials, n_pool)),
    }
    if vi is not None:
        shapes["vi"] = (vi, torch.int32, lt + (n_loc, w))
    if acc is not None:
        shapes["acc"] = (acc, torch.int64, lt + (n_pool,))
    for name, x in draws.items():
        shapes[name] = (x, torch.uint8, (n_trials, n_pool, n_rv))
    for name, (x, dt, shp) in shapes.items():
        check(name, x, dt, shp, dev)
    return n_trials


def _check_out_pool(cfg: QBAConfig, pool, out, lead=(), n_local=None):
    """A successor pool for ``pool`` (``n_local`` receivers' segments
    under the leading shard axis ``lead``) that aliases none of it (a
    new one when ``out`` is None)."""
    n_trials = pool[0].shape[len(lead)]
    layout = empty_pool(cfg, n_trials, "meta", n_recv=n_local)
    if out is None:
        return tuple(torch.empty(tuple(lead) + tuple(x.shape), dtype=x.dtype,
                                 device=pool[0].device) for x in layout)
    for name, x, ref, want in zip(("o_vals", "o_lens", "o_p", "o_meta"),
                                  out, pool, layout):
        check(name, x, ref.dtype, tuple(lead) + tuple(want.shape),
              ref.device)
        if x.data_ptr() == ref.data_ptr():
            raise ValueError(f"{name} aliases its input; pass the other "
                             "buffer of the ping-pong pair")
    return out


def shard_plan(cfg: QBAConfig, li, start: int, n_recv: int | None):
    """``(n_shards, n_local, lead)`` of a round launch: one shard of every
    receiver, or with ``n_recv`` the shards of ``li``'s leading axis
    (``lead`` that axis), which must fit the lieutenants from ``start``
    on."""
    if n_recv is None:
        return 1, cfg.n_lieutenants, ()
    n_sh = li.shape[0]
    if not (n_recv >= 1 and 0 <= start
            and start + n_sh * n_recv <= cfg.n_lieutenants):
        raise ValueError(
            f"shards of {n_recv} receivers from {start} x {n_sh} do not "
            f"fit {cfg.n_lieutenants} lieutenants")
    return n_sh, n_recv, (n_sh,)


def launch_ints(cfg: QBAConfig, n_trials: int, n_sh: int, n_local: int,
                start: int):
    """The round kernels' leading int arguments: the launch's trials and
    shards, then the round's dims."""
    return [n_trials, n_sh, n_local, cfg.n_lieutenants, int(start),
            cfg.slots, cfg.max_l, cfg.size_l, cfg.w]


def round_phase_clock(n_trials: int, n_shards: int | None = None,
                      device=None):
    """A zeroed phase-clock buffer for a per-round kernel's ``clock``
    argument: int64 ``[n_trials, len(ROUND_PHASES)]``, with a leading
    shard axis for an ``n_recv`` launch of ``n_shards`` shards.  Each
    launch adds its blocks' cycles into it, so one buffer sums a batch's
    rounds."""
    lead = () if n_shards is None else (n_shards,)
    return torch.zeros(lead + (n_trials, len(ROUND_PHASES)),
                       dtype=torch.int64, device=device)


def round_phase_breakdown(clock) -> dict:
    """A filled per-round phase clock's breakdown
    (:func:`~qba_tpu_torch.ops._launch.clock_breakdown` over
    :data:`ROUND_PHASES`)."""
    return clock_breakdown(clock, ROUND_PHASES)


def round_clock_ptr(clock, lead, n_trials: int, device):
    """A per-round launch's clock address (None without a clock)."""
    return clock_ptr(clock, tuple(lead) + (n_trials, len(ROUND_PHASES)),
                     device)


def fused_round(cfg: QBAConfig, round_idx: int, pool, li, vi, honest_c,
                attack, rand_v, late, out=None, *, start: int = 0,
                n_recv: int | None = None, clock=None):
    """One voting round: ``(pool', vi', overflow bool [T])``.

    CPU tensors run :func:`fused_round_reference`.  CUDA tensors launch
    the CUDA kernel, which takes exactly the dtypes ``int8`` (``vals``,
    ``p``), ``int32`` (``lens``, ``meta``, ``li``, ``vi``, ``honest_c``)
    and ``uint8`` (the three draw tables), contiguous, on one device,
    and writes into ``out`` (a pool of the same shapes, e.g. the previous
    round's buffers) or a new pool.  Any other input raises.

    With ``n_recv``, the party-sharded variant (see
    :func:`fused_round_reference`): one launch for every shard of the
    leading shard axis, each writing its local segment ``[n_sh, T, ...]``
    of ``n_recv * slots`` entries into ``out`` or a new one; overflow is
    ``[n_sh, T]``.

    ``clock`` (:func:`round_phase_clock`) launches the phase clock's
    instantiation, which adds each block's cycles per phase into it; the
    plain version refuses it.
    """
    if not dispatch("fused_round", pool):
        no_clock(clock)
        return fused_round_reference(cfg, round_idx, pool, li, vi,
                                     honest_c, attack, rand_v, late,
                                     start=start, n_recv=n_recv)
    check_kernel_shapes(cfg, "fused round")
    n_sh, n_local, lead = shard_plan(cfg, li, start, n_recv)
    check_round_smem(cfg, n_local, "fused round")
    n_trials = _check_round_inputs(
        cfg, pool, li, honest_c,
        dict(attack=attack, rand_v=rand_v, late=late), vi=vi, lead=lead,
        n_local=n_local)
    dev = vi.device
    out = _check_out_pool(cfg, pool, out, lead, n_local)
    vi_out = torch.empty_like(vi)
    ovf = torch.empty(lead + (n_trials,), dtype=torch.int32, device=dev)
    fn = kernel_fn("fused_round", "qba_fused_round", 17, 12)
    args = ptrs(*pool, li, vi, honest_c, attack, rand_v, late, *out,
                vi_out, ovf)
    args += [round_clock_ptr(clock, lead, n_trials, dev)]
    args += launch_ints(cfg, n_trials, n_sh, n_local, start)
    args += [cfg.n_dishonest, int(round_idx), int(cfg.strategy == "split")]
    timed_launch(fused_round, fn, args, torch.cuda.current_stream(dev))
    return out, vi_out, ovf != 0


fused_round.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
fused_round.events = None


def tiled_verdict(cfg: QBAConfig, round_idx: int, pool, li, vi, honest_c,
                  attack, rand_v, late, *, start: int = 0,
                  n_recv: int | None = None, clock=None):
    """Phase 1 of the two-launch round: ``(acc int64 [T, n_pool], vi')``,
    ``acc`` one receiver mask a packet (:func:`verdict_reference`).

    CPU tensors run :func:`verdict_reference`; CUDA tensors launch the
    verdict kernel (``csrc/tiled_round.cu``) with the input rules of
    :func:`fused_round`.  Any other input raises.  With ``n_recv``, the
    party-sharded variant (see :func:`verdict_reference`): one launch for
    every shard of the leading shard axis; ``acc`` is ``[n_sh, T,
    n_pool]``.  ``clock`` as in :func:`fused_round`.
    """
    if not dispatch("tiled_verdict", pool):
        no_clock(clock)
        return verdict_reference(cfg, round_idx, pool, li, vi, honest_c,
                                 attack, rand_v, late, start=start,
                                 n_recv=n_recv)
    check_kernel_shapes(cfg, "tiled verdict")
    n_sh, n_local, lead = shard_plan(cfg, li, start, n_recv)
    check_round_smem(cfg, n_local, "tiled verdict", slots=False)
    n_trials = _check_round_inputs(
        cfg, pool, li, honest_c,
        dict(attack=attack, rand_v=rand_v, late=late), vi=vi, lead=lead,
        n_local=n_local)
    n_pool = cfg.n_lieutenants * cfg.slots
    acc = torch.empty(lead + (n_trials, n_pool), dtype=torch.int64,
                      device=vi.device)
    vi_out = torch.empty_like(vi)
    fn = kernel_fn("tiled_round", "qba_tiled_verdict", 13, 12)
    args = ptrs(*pool, li, vi, honest_c, attack, rand_v, late, acc, vi_out)
    args += [round_clock_ptr(clock, lead, n_trials, vi.device)]
    args += launch_ints(cfg, n_trials, n_sh, n_local, start)
    args += [int(round_idx), int(cfg.strategy == "split"),
             verdict_ranks(cfg, n_local)]
    timed_launch(tiled_verdict, fn, args,
                  torch.cuda.current_stream(vi.device))
    return acc, vi_out


tiled_verdict.launches = 0
tiled_verdict.events = None


def tiled_rebuild(cfg: QBAConfig, round_idx: int, pool, li, acc, honest_c,
                  attack, rand_v, out=None, *, start: int = 0,
                  n_recv: int | None = None, clock=None):
    """Phase 2 of the two-launch round: ``(pool', overflow bool [T])``
    from the accepted matrix ``acc`` (int64 ``[T, n_pool]``, one receiver
    mask a packet, as :func:`tiled_verdict` returns it).

    CPU tensors run :func:`rebuild_reference`; CUDA tensors launch the
    rebuild kernel (``csrc/tiled_round.cu``), writing into ``out`` (a
    pool of the same shapes) or a new pool, with the input rules of
    :func:`fused_round`.  Any other input raises.  With ``n_recv``, the
    party-sharded variant (see :func:`rebuild_reference`): one launch for
    every shard, each writing its local segment ``[n_sh, T, ...]`` of
    ``n_recv * slots`` entries; overflow is ``[n_sh, T]``.  ``clock`` as
    in :func:`fused_round`.
    """
    if not dispatch("tiled_rebuild", pool):
        no_clock(clock)
        return rebuild_reference(cfg, round_idx, pool, li, acc, honest_c,
                                 attack, rand_v, start=start, n_recv=n_recv)
    check_kernel_shapes(cfg, "tiled rebuild")
    n_sh, n_local, lead = shard_plan(cfg, li, start, n_recv)
    n_trials = _check_round_inputs(
        cfg, pool, li, honest_c, dict(attack=attack, rand_v=rand_v),
        acc=acc, lead=lead, n_local=n_local)
    out = _check_out_pool(cfg, pool, out, lead, n_local)
    ovf = torch.empty(lead + (n_trials,), dtype=torch.int32,
                      device=acc.device)
    fn = kernel_fn("tiled_round", "qba_tiled_rebuild", 15, 12)
    args = ptrs(*pool, li, acc, honest_c, attack, rand_v, *out, ovf)
    args += [round_clock_ptr(clock, lead, n_trials, acc.device)]
    args += launch_ints(cfg, n_trials, n_sh, n_local, start)
    args += [cfg.n_dishonest, int(round_idx), int(cfg.strategy == "split")]
    timed_launch(tiled_rebuild, fn, args,
                  torch.cuda.current_stream(acc.device))
    return out, ovf != 0


tiled_rebuild.launches = 0
tiled_rebuild.events = None


class ShardedMegaPlan(typing.NamedTuple):
    """An admitted launch shape of the party-sharded trial megakernel: a
    cluster of ``n_tp`` blocks a trial, ``n_local`` receivers a block,
    and on CUDA its shared memory and how many clusters the card holds
    at once (None off CUDA)."""

    n_tp: int
    n_local: int
    smem_bytes: int | None
    clusters: int | None


# Clusters of more blocks need the non-portable cluster-size opt-in.
MAX_PORTABLE_CLUSTER = 8


def sharded_mega_plan(cfg: QBAConfig, n_tp: int,
                      device=None) -> ShardedMegaPlan | None:
    """The party-sharded trial megakernel's plan at ``n_tp`` shards, or
    None to demote to the fused per-round engine — the Hopper
    counterpart of :func:`qba_tpu.ops.round_kernel_tiled.sharded_mega_plan`.

    Admitted: ``n_tp`` divides the lieutenants, a cluster of ``n_tp <=
    8`` blocks (the portable maximum), the kernels' 64-bit masks hold the
    values and receivers, and on a CUDA ``device`` the card holds at
    least one such cluster (``cudaOccupancyMaxActiveClusters``, which
    builds the kernel).  The TPU's block sizes have no counterpart."""
    n_rv = cfg.n_lieutenants
    if not 1 <= n_tp <= MAX_PORTABLE_CLUSTER or n_rv % n_tp:
        return None
    if cfg.w > KERNEL_MAX_W or n_rv > KERNEL_MAX_W:
        return None
    smem = clusters = None
    if device is not None and torch.device(device).type == "cuda":
        from qba_tpu_torch.ops.trial_megakernel import (
            sharded_megakernel_clusters,
        )

        smem, clusters = sharded_megakernel_clusters(cfg, n_tp, device)
        if clusters < 1:
            return None
    return ShardedMegaPlan(n_tp, n_rv // n_tp, smem, clusters)
