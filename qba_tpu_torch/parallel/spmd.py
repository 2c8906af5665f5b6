"""The party-sharded round engine (dp x tp) — counterpart of
:mod:`qba_tpu.parallel.spmd`.

The lieutenants shard over the mesh's ``tp`` axis: shard ``s`` owns the
receivers ``[s * n_local, (s + 1) * n_local)`` (their lists, accepted
sets and outgoing packets), and every round each shard assembles the
whole pool (or mailbox) from the shards' segments and drains its own
receivers against it.  Trials shard over ``dp``.

One process drives every shard, as ``shard_map`` does.  Where a ``tp``
row is one card, the shards of a tensor are one tensor with a leading
``[n_tp, ...]`` axis and each kernel runs once over all of them: every
round the ring kernel (:mod:`qba_tpu_torch.parallel.ring`) once a leaf
of the pool or mailbox, then the ``n_recv`` variant of the round's
kernels — the fused round (``pallas_fused``), the verdict and the
rebuild (``pallas_tiled``) or the dense-mailbox round (``pallas``) — or
the party-sharded trial megakernel once a batch, a thread-block cluster
a trial (``pallas_mega``).  A ``tp`` row across cards raises: that
transport is ROADMAP A12b.  Set-up is replicated per shard in JAX (same
key, same values); here it is computed once and sliced, which gives the
same values.

Results equal the single-device engine's for the same keys, trial for
trial: the round draws are the same global tables every engine reads,
each shard reading its receivers' columns (the per-round kernel engines
draw them with the draws kernel a round at a time, the ``xla`` engine
with the plain ``sample_attacks_round``; the sharded megakernel hashes
them where it reads them).  Unlike JAX's
``run_trials_spmd``, nothing falls back: a kernel that fails to build or
launch raises.  The recorded demotions are JAX's
(:func:`_resolve_spmd_engine`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import sample_attacks_round
from qba_tpu_torch.backends.torch_backend import (
    MonteCarloResult,
    aggregate,
    trial_keys,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.diagnostics import warn_demotion
from qba_tpu_torch.ops import round_kernel as rs
from qba_tpu_torch.ops._launch import masks_fit
from qba_tpu_torch.ops.round_kernel_tiled import (
    POOL_AXES,
    empty_pool,
    fused_round,
    honest_cells,
    pool_from_step3a,
    shard_receivers,
    sharded_mega_plan,
    tiled_rebuild,
    tiled_verdict,
    unshard_receivers,
)
from qba_tpu_torch.parallel.mesh import (
    Mesh,
    axis_sizes,
    dp_devices,
    require_divisible,
)
from qba_tpu_torch.parallel.montecarlo import cat_trials
from qba_tpu_torch.parallel.ring import all_gather, resolve_tp_comms, ring_gather
from qba_tpu_torch.rounds.engine import (
    ProtocolCounters,
    TrialResult,
    finish_trial,
    mega_result,
    receiver_round,
    round_draws,
    scan_rounds,
    setup_batch,
    step3a_one,
    warn_masks_demotion,
)
from qba_tpu_torch.rounds.mailbox import Mailbox, mailbox_from_step3a

def _make_gather_tp(n_tp: int, comms: str):
    """The per-round tp assembly: ``gather_tp(x, axis)`` gives every
    shard of ``x`` ``[n_tp, *shard]`` the tiled all-gather along shard
    axis ``axis``, bit-identically on both paths — only the traffic
    differs."""
    return ring_gather if comms == "ring" else all_gather


def _fields(mb: Mailbox):
    return [getattr(mb, f.name) for f in dataclasses.fields(mb)]


def _stacked(segs, layout, device):
    """The shards' step-3a segments (one tuple of leaves each, tp order)
    as stacked leaves ``[n_tp, ...]``, and a spare buffer of the same
    shapes for the other half of the ping-pong pair (``layout``: the
    leaves of one shard's empty segment)."""
    cur = tuple(torch.stack(x) for x in zip(*segs))
    spare = tuple(torch.empty((len(segs),) + x.shape, dtype=x.dtype,
                              device=device) for x in layout)
    return cur, spare


def _trial_party_sharded(cfg: QBAConfig, n_tp: int, keys: torch.Tensor,
                         engine: str, comms: str,
                         partitionable: bool) -> TrialResult:
    """Trials ``keys`` ``[T, 2]`` with the lieutenants in ``n_tp`` shards,
    on the engine ``xla``, ``pallas``, ``pallas_fused``, ``pallas_tiled``
    or ``pallas_mega``, in ``partitionable``'s threefry mode."""
    p = partitionable
    if engine == "pallas_mega":
        return _trial_sharded_mega(cfg, n_tp, keys, p)
    n_local = cfg.n_lieutenants // n_tp
    n_trials = keys.shape[0]
    s, ctx = setup_batch(cfg, keys, partitionable=p)
    honest, lieu_lists, p_rows, v_sent, v_comm, k_rounds = (
        s.honest, s.lieu_lists, s.p_rows, s.v_sent, s.v_comm, s.k_rounds)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, lieu_lists)
    # Each shard's receivers: step 3a is per lieutenant, so its rows are
    # what the shard computes for itself.
    vi_l = shard_receivers(vi, n_tp)
    cells_l = [shard_receivers(x, n_tp) for x in out_cells]
    gather_tp = _make_gather_tp(n_tp, comms)

    def draws_of(r):
        return sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx,
                                    partitionable=p)

    def shard_cells(s):
        return tuple(c[s] for c in cells_l)

    if engine in ("pallas", "pallas_fused", "pallas_tiled"):
        # Each shard keeps its local segment of the pool (or its local
        # mailbox), global cell ids; every round gathers the segments
        # into each shard's copy of the whole, and one launch of the
        # round's n_recv kernels drains every shard's receivers into the
        # other buffer of a ping-pong pair.
        li_l = shard_receivers(lieu_lists.to(torch.int32), n_tp)
        hc = honest_cells(honest, cfg)
        if engine == "pallas":
            # Every mailbox leaf is cell-major: gathered on the cell axis.
            axes = (1, 1, 1, 1)
            bufs = _stacked(
                [rs.mailbox_from_step3a(cfg, shard_cells(s),
                                        start=s * n_local)
                 for s in range(n_tp)],
                rs.empty_mailbox(cfg, n_trials, "meta", n_recv=n_local),
                keys.device)
        else:
            axes = tuple(ax + 1 for ax in POOL_AXES)
            bufs = _stacked(
                [pool_from_step3a(cfg, shard_cells(s), start=s * n_local)
                 for s in range(n_tp)],
                empty_pool(cfg, n_trials, "meta", n_recv=n_local),
                keys.device)

        def round_body(r, vi, bufs):
            cur, spare = bufs
            whole = tuple(gather_tp(x, axis=ax) for x, ax in zip(cur, axes))
            draws = round_draws(cfg, k_rounds, ctx, r, partitionable=p)
            if engine == "pallas_tiled":
                acc, vi = tiled_verdict(cfg, r, whole, li_l, vi, hc, *draws,
                                        n_recv=n_local)
                new, ovf = tiled_rebuild(cfg, r, whole, li_l, acc, hc,
                                         *draws[:2], out=spare,
                                         n_recv=n_local)
            else:
                step = rs.round_step if engine == "pallas" else fused_round
                new, vi, ovf = step(cfg, r, whole, li_l, vi, hc, *draws,
                                    out=spare, n_recv=n_local)
            return vi, (new, cur), ovf

        vi_l, overflows, cst = scan_rounds(cfg, round_body,
                                           vi_l.to(torch.int32), bufs)
        vi_l = vi_l != 0
    elif engine == "xla":
        li_l = shard_receivers(lieu_lists, n_tp)
        segs = [_fields(mailbox_from_step3a(cfg, shard_cells(s)))
                for s in range(n_tp)]
        mb_l = Mailbox(*(torch.stack(x) for x in zip(*segs)))

        def round_body(r, vi, mb):
            # The sender axis follows the trial axis in every field.
            full = [gather_tp(x, axis=1) for x in _fields(mb)]
            draws = draws_of(r)
            outs = []
            for s in range(n_tp):
                lo = s * n_local
                outs.append(receiver_round(
                    cfg, r, tuple(d[..., lo:lo + n_local] for d in draws),
                    vi[s], li_l[s], Mailbox(*(f[s] for f in full)), honest,
                    start=lo))
            vis, mbs, ovfs = zip(*outs)
            mb = Mailbox(*(torch.stack(x) for x in zip(*map(_fields, mbs))))
            return torch.stack(vis), mb, torch.stack(ovfs)

        vi_l, overflows, cst = scan_rounds(cfg, round_body, vi_l, mb_l)
    else:
        raise ValueError(f"no party-sharded engine {engine!r}")

    vi = unshard_receivers(vi_l)
    counters = _merge_counters_tp(cfg, n_tp, cst, vi) if cst else None
    return finish_trial(cfg, vi, v_comm, honest, overflows.any(0), counters)


def _trial_sharded_mega(cfg: QBAConfig, n_tp: int, keys: torch.Tensor,
                        partitionable: bool) -> TrialResult:
    """The party-sharded trial megakernel: set-up as for the single-device
    megakernel, then one launch for the batch, which hashes every round's
    draws where it reads them
    (:func:`~qba_tpu_torch.ops.trial_megakernel.sharded_trial_megakernel_keyed`).
    The lists are generated on the host whatever ``mega_gen`` says."""
    from qba_tpu_torch.ops.trial_megakernel import (
        sharded_trial_megakernel_keyed,
    )

    p = partitionable
    s, ctx = setup_batch(cfg, keys, partitionable=p)
    vi, dec, overflow = sharded_trial_megakernel_keyed(
        cfg, n_tp, s.p_rows.contiguous(),
        s.lieu_lists.to(torch.int32).contiguous(),
        s.v_sent.to(torch.int32).contiguous(), honest_cells(s.honest, cfg),
        s.k_rounds.contiguous(), ctx, partitionable=p)
    return mega_result(s.honest, s.v_comm, vi, dec, overflow)


def _merge_counters_tp(cfg: QBAConfig, n_tp: int, cst: ProtocolCounters,
                       vi: torch.Tensor) -> ProtocolCounters:
    """The shards' counters (leading axis ``[n_tp]``, each over its own
    receivers) merged into the whole grid's — the fields of JAX's
    ``_merge_counters_tp``: first-accept rounds by receiver, accept
    counts from the merged ``vi``, accepts per round summed, the slot
    high-water mark the largest, a round overflowing where any shard's
    did."""
    return ProtocolCounters(
        first_accept_round=unshard_receivers(cst.first_accept_round),
        accept_counts=vi.sum(-2, dtype=torch.int32),
        accepts_per_round=cst.accepts_per_round.sum(0, dtype=torch.int32),
        slot_high_water=cst.slot_high_water.amax(0),
        overflow_rounds=cst.overflow_rounds.any(0),
    )


def _resolve_spmd_engine(cfg: QBAConfig, n_local: int, device) -> str:
    """Engine for the party-sharded round loop on ``device``.

    ``xla``, ``pallas``, ``pallas_fused`` and ``pallas_tiled`` pass
    through, as in JAX.  ``auto`` is ``xla`` on the CPU; on CUDA it is
    ``pallas_mega`` where :func:`~qba_tpu_torch.ops.round_kernel_tiled
    .sharded_mega_plan` admits it and counters are off, else
    ``pallas_fused``, and ``xla`` past the kernels' 64-bit masks (with
    a :class:`~qba_tpu_torch.diagnostics.QBADemotionWarning`, as
    :func:`~qba_tpu_torch.rounds.engine.resolve_round_engine` records
    it).  A forced ``pallas_mega`` demotes to
    ``pallas_fused`` with the JAX package's two recorded reasons
    (counters need the host round scan; no sharded plan), and
    ``mega_gen='gf2'`` records that generation stays on the host (the
    sharded megakernel has no gen prologue, in JAX either).
    """
    n_tp = cfg.n_lieutenants // n_local
    engine = cfg.round_engine
    if engine in ("xla", "pallas", "pallas_fused", "pallas_tiled"):
        return engine
    if engine == "auto":
        if torch.device(device).type != "cuda":
            return "xla"
        if not masks_fit(cfg):
            warn_masks_demotion(cfg, stacklevel=3)
            return "xla"
        if cfg.collect_counters or sharded_mega_plan(cfg, n_tp,
                                                     device) is None:
            return "pallas_fused"
    elif cfg.collect_counters:
        warn_demotion(
            "trial megakernel has no host round scan for the counters "
            "wrapper to instrument; collect_counters demotes to the fused "
            "per-round engine under the tp mesh (bit-identical counters)",
            "counters_need_host_scan", stacklevel=3)
        return "pallas_fused"
    elif sharded_mega_plan(cfg, n_tp, device) is None:
        warn_demotion(
            "party-sharded trial megakernel unavailable at "
            f"(n_parties={cfg.n_parties}, size_l={cfg.size_l}, "
            f"slots={cfg.slots}, tp={n_tp}); demoting to the fused "
            "per-round engine under the tp mesh",
            "no_sharded_mega_plan", stacklevel=3)
        return "pallas_fused"
    if cfg.mega_gen == "gf2":
        warn_demotion(
            "mega_gen='gf2' has no party-sharded gen-fused prologue; "
            "step-1 generation stays on the host under the tp mesh (the "
            "sharded megakernel itself still runs)",
            "no_sharded_gen_fused", stacklevel=3)
    return "pallas_mega"


def _tp_row_devices(mesh: Mesh) -> list[torch.device]:
    """Each ``dp`` index's device; raises unless every ``tp`` row of the
    mesh is one device."""
    names = mesh.axis_names
    rows = np.moveaxis(mesh.devices, names.index("tp"), -1)
    for row in rows.reshape(-1, rows.shape[-1]):
        if len(set(row)) > 1:
            raise NotImplementedError(
                f"a tp row spans the devices {sorted(map(str, set(row)))}; "
                "the party-sharded engine runs a tp row on one card (its "
                "shards as thread-block clusters); the transport across "
                "cards is ROADMAP A12b")
    return dp_devices(mesh)


def run_trials_spmd(cfg: QBAConfig, mesh: Mesh,
                    keys: torch.Tensor | None = None, *,
                    partitionable: bool | None = None) -> MonteCarloResult:
    """Monte-Carlo batch with trials over ``dp`` and lieutenants over
    ``tp``, in ``partitionable``'s threefry mode (None: the current
    mode).

    Requires ``cfg.trials`` divisible by the ``dp`` size and
    ``cfg.n_lieutenants`` divisible by the ``tp`` size.  ``dp`` index
    ``i`` runs the ``i``-th contiguous chunk of the trials on its row's
    device; the results come back on the first row's.
    """
    axes = axis_sizes(mesh)
    if "tp" not in axes:
        raise ValueError(
            f"run_trials_spmd needs a 'tp' mesh axis; got axes {tuple(axes)}. "
            "For trial-only sharding use run_trials_sharded."
        )
    dp, tp = axes.get("dp", 1), axes["tp"]
    devices = dp_devices(mesh)
    p = jr.resolve_mode(partitionable)
    if keys is None:
        keys = trial_keys(cfg, devices[0], partitionable=p)
    require_divisible(keys.shape[0], dp, "trials", "dp")
    require_divisible(cfg.n_lieutenants, tp, "n_lieutenants", "tp")
    _tp_row_devices(mesh)
    engine = _resolve_spmd_engine(cfg, cfg.n_lieutenants // tp, devices[0])
    comms = resolve_tp_comms(cfg)
    parts = [_trial_party_sharded(cfg, tp, k.to(dev), engine, comms, p)
             for k, dev in zip(keys.chunk(dp), devices)]
    return aggregate(cat_trials(parts, devices[0]))
