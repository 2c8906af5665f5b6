"""The fused voting round over a compacted packet pool — counterpart of
:func:`qba_tpu.ops.round_kernel_tiled.build_fused_round_kernel` and its
pool helpers.

Pool layout (one per trial, leading trial axis ``T``; the JAX package's
layout with the trial axis in front): ``vals`` ``[T, max_l, n_pool,
size_l]``, ``lens`` int32 ``[T, n_pool, max_l]``, ``p`` ``[T, n_pool,
size_l]`` (0/1), ``meta`` int32 ``[T, n_pool, 4]`` with lanes
``META_*``.  ``n_pool = n_lieutenants * slots``.  The round's packets sit
compacted at the front in (sender, slot) order, each carrying its mailbox
cell id ``sender * slots + slot`` so the per-cell draws keep their
identity.  ``vals`` and ``p`` are int8: every stored value lies in
``[-1, w]`` with ``w <= 64``, so int8 is exact (the TPU stores bf16).

:func:`fused_round` launches the hand-written CUDA kernel
(``csrc/fused_round.cu``) for CUDA tensors and runs
:func:`fused_round_reference`, the plain PyTorch version, for CPU
tensors.  A CUDA tensor never reaches the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.types import SENTINEL
from qba_tpu_torch.ops.verdict_algebra import (
    accept_first_per_value,
    corruption_flags,
    verdict,
)

META_COUNT, META_V, META_SENT, META_CELL = 0, 1, 2, 3

# The kernel keeps a receiver's accepted set and a packet's per-receiver
# verdicts as 64-bit masks.
KERNEL_MAX_W = 64


def pool_vals_dtype(cfg: QBAConfig) -> torch.dtype:
    """Element type of the pool's ``vals`` and ``p``: int8 while every
    stored value (``[-1, w]``) fits, else int32."""
    return torch.int8 if cfg.w <= KERNEL_MAX_W else torch.int32


def empty_pool(cfg: QBAConfig, n_trials: int, device=None):
    """An empty pool ``(vals, lens, p, meta)`` for ``n_trials`` trials."""
    n_pool, max_l, s = cfg.n_lieutenants * cfg.slots, cfg.max_l, cfg.size_l
    vdt = pool_vals_dtype(cfg)
    return (
        torch.full((n_trials, max_l, n_pool, s), SENTINEL, dtype=vdt,
                   device=device),
        torch.zeros((n_trials, n_pool, max_l), dtype=torch.int32,
                    device=device),
        torch.zeros((n_trials, n_pool, s), dtype=vdt, device=device),
        torch.zeros((n_trials, n_pool, 4), dtype=torch.int32, device=device),
    )


def pool_from_step3a(cfg: QBAConfig, out_cells):
    """Compact step 3a's broadcasts (each lieutenant's slot 0, as returned
    by :func:`qba_tpu_torch.rounds.engine.step3a_one`) into the pool."""
    o_vals, o_lens, o_count, o_p, o_v, o_sent = out_cells
    n_trials, n_rv = o_sent.shape
    slots = cfg.slots
    cap = n_rv * slots
    dev = o_sent.device
    sent = o_sent.to(torch.int64)
    dst = torch.where(o_sent, torch.cumsum(sent, -1) - sent, cap)
    vdt = pool_vals_dtype(cfg)
    cells = torch.arange(n_rv, dtype=torch.int32, device=dev) * slots
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


def fused_round_reference(cfg: QBAConfig, round_idx: int, pool, li, vi,
                          honest_c, attack, rand_v, late):
    """One voting round in plain PyTorch: the verdict of every pool packet
    against every receiver, first-accept dedup into ``vi``, slot
    allocation with overflow, and the successor pool.

    ``li`` int32 ``[T, n_rv, size_l]``, ``vi`` int32 0/1 ``[T, n_rv, w]``,
    ``honest_c`` ``[T, n_cells]``, draws ``[T, n_cells, n_rv]``.  Returns
    ``(pool', vi' int32, overflow bool [T])``.
    """
    vals, lens, p, meta = pool
    n_trials, max_l, n_pool, s = vals.shape
    n_rv, slots, w = cfg.n_lieutenants, cfg.slots, cfg.w
    dev = vals.device
    out = empty_pool(cfg, n_trials, dev)
    sent_any = (meta[..., META_SENT] != 0).any(0).nonzero()
    if sent_any.numel() == 0:
        no = torch.zeros(n_trials, dtype=torch.bool, device=dev)
        return out, vi.clone(), no
    # Packets past the last sent entry of every trial can be accepted by
    # no receiver: the verdict scans only up to it.
    n_scan = int(sent_any.max()) + 1
    vals_s = vals[:, :, :n_scan].to(torch.int32).transpose(1, 2)
    lens_s, meta_s = lens[:, :n_scan], meta[:, :n_scan]
    p_s = p[:, :n_scan] != 0
    count, v = meta_s[..., META_COUNT], meta_s[..., META_V]
    cell = meta_s[..., META_CELL]
    honest_s = torch.gather(honest_c, 1,
                            cell.clamp(0, honest_c.shape[1] - 1).long())
    att_s, rv_s = _by_cell(attack, cell), _by_cell(rand_v, cell)
    use_fp = cfg.strategy == "split"
    ok, v2 = verdict(
        vals=vals_s, lens=lens_s, count=count, p=p_s, v=v,
        sent=meta_s[..., META_SENT] != 0, sender=cell // slots,
        honest_c=honest_s, attack=att_s, rand_v=rv_s,
        late=_by_cell(late, cell), li=li, round_idx=round_idx, w=w,
        use_fp=use_fp,
    )
    acc, vi_new = accept_first_per_value(ok, v2, vi != 0, w)

    # Slot allocation: per receiver, an exclusive prefix count of its
    # rebroadcasts in packet order; past `slots` is overflow.
    rebroadcast = acc & (round_idx <= cfg.n_dishonest)
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

    def gat(x):  # packet-indexed [T, n_scan, ...] -> destinations
        idx = src.view(src.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(src.shape + x.shape[2:]))

    vals_g, lens_g = gat(vals_s), gat(lens_s)
    cnt_g, v_g, cell_g = gat(count), gat(v), gat(cell)
    att_g = torch.gather(_by_cell(attack, cell_g), 2, r_d[..., None])[..., 0]
    rvv_g = torch.gather(_by_cell(rand_v, cell_g), 2, r_d[..., None])[..., 0]
    hon_g = torch.gather(honest_c, 1, cell_g.long())
    _, v2_g, clear_p, clear_l, forge_p = corruption_flags(
        hon_g, att_g[..., None], rvv_g[..., None], v_g, use_fp
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
    o_meta = torch.where(
        hm,
        torch.stack(
            [new_cnt, v2_g, torch.ones_like(new_cnt),
             r_d.to(torch.int32) * slots + sl_d.to(torch.int32)],
            dim=-1,
        ).to(torch.int32),
        0,
    )
    vdt = pool_vals_dtype(cfg)
    out = (
        o_vals.transpose(1, 2).to(vdt).contiguous(),
        o_lens.to(torch.int32),
        (hm & p2).to(vdt),
        o_meta,
    )
    return out, vi_new.to(torch.int32), overflow


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_round(cfg: QBAConfig, round_idx: int, pool, li, vi, honest_c,
                attack, rand_v, late, out=None):
    """One voting round: ``(pool', vi', overflow bool [T])``.

    CPU tensors run :func:`fused_round_reference`.  CUDA tensors launch
    the CUDA kernel, which takes exactly the dtypes ``int8`` (``vals``,
    ``p``), ``int32`` (``lens``, ``meta``, ``li``, ``vi``, ``honest_c``)
    and ``uint8`` (the three draw tables), contiguous, on one device,
    and writes into ``out`` (a pool of the same shapes, e.g. the previous
    round's buffers) or a new pool.  Any other input raises.
    """
    dev = pool[0].device
    if dev.type == "cpu":
        return fused_round_reference(cfg, round_idx, pool, li, vi,
                                     honest_c, attack, rand_v, late)
    if dev.type != "cuda":
        raise ValueError(f"fused_round: unsupported device {dev}")
    return _launch(cfg, round_idx, pool, li, vi, honest_c, attack, rand_v,
                   late, out)


fused_round.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
fused_round.events = None


def _launch(cfg, round_idx, pool, li, vi, honest_c, attack, rand_v, late,
            out):
    if cfg.w > KERNEL_MAX_W:
        raise NotImplementedError(
            f"the fused round kernel keeps w <= {KERNEL_MAX_W} values as "
            f"64-bit masks; w={cfg.w} is not supported on CUDA"
        )
    vals, lens, p, meta = pool
    n_trials = vals.shape[0]
    n_rv, slots, max_l, s, w = (cfg.n_lieutenants, cfg.slots, cfg.max_l,
                                cfg.size_l, cfg.w)
    n_pool = n_rv * slots
    dev = vals.device
    shapes = {
        "vals": (vals, torch.int8, (n_trials, max_l, n_pool, s)),
        "lens": (lens, torch.int32, (n_trials, n_pool, max_l)),
        "p": (p, torch.int8, (n_trials, n_pool, s)),
        "meta": (meta, torch.int32, (n_trials, n_pool, 4)),
        "li": (li, torch.int32, (n_trials, n_rv, s)),
        "vi": (vi, torch.int32, (n_trials, n_rv, w)),
        "honest_c": (honest_c, torch.int32, (n_trials, n_pool)),
        "attack": (attack, torch.uint8, (n_trials, n_pool, n_rv)),
        "rand_v": (rand_v, torch.uint8, (n_trials, n_pool, n_rv)),
        "late": (late, torch.uint8, (n_trials, n_pool, n_rv)),
    }
    for name, (x, dt, shp) in shapes.items():
        _check(name, x, dt, shp, dev)
    if out is None:
        out = empty_pool(cfg, n_trials, dev)
    for name, x, ref in zip(("o_vals", "o_lens", "o_p", "o_meta"), out, pool):
        _check(name, x, ref.dtype, ref.shape, dev)
        if x.data_ptr() == ref.data_ptr():
            raise ValueError(f"{name} aliases its input; pass the other "
                             "buffer of the ping-pong pair")
    vi_out = torch.empty_like(vi)
    ovf = torch.empty(n_trials, dtype=torch.int32, device=dev)

    from qba_tpu_torch.ops._build import load_library

    lib = load_library("fused_round")
    fn = lib.qba_fused_round
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    ptrs = [x.data_ptr() for x in (vals, lens, p, meta, li, vi, honest_c,
                                   attack, rand_v, late, *out, vi_out, ovf)]
    stream = torch.cuda.current_stream(dev)
    events = fused_round.events
    if events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record(stream)
    rc = fn(*ptrs, n_trials, n_rv, slots, max_l, s, w, cfg.n_dishonest,
            int(round_idx), int(cfg.strategy == "split"), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_round kernel launch failed: CUDA error {rc}")
    fused_round.launches += 1
    if events is not None:
        end.record(stream)
        events.append((start, end))
    return out, vi_out, ovf != 0
