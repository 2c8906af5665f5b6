"""End-to-end protocol engine on a batch of trials — counterpart of
:mod:`qba_tpu.rounds.engine`.

Every phase is a tensor op over an explicit trial axis (where the JAX
package vmaps a one-trial function): honesty assignment, list
generation, step 1b/2 orders and P-sets, step 3a, the synchronous voting
rounds ``1..n_dishonest+1`` and the decision + success oracle.  Packet
processing order within a round is (sender, slot) lexicographic.

Five round engines, trial-for-trial identical:

* ``xla`` (:func:`run_rounds_xla`): the port's eager oracle on the dense
  mailbox, built on the executable specification
  ``consistent_after_append``;
* ``pallas`` (:func:`run_rounds_pallas`): one launch of the dense-mailbox
  round kernel per round;
* ``pallas_fused`` (:func:`run_rounds_fused`): one launch of the fused
  round kernel per round over the compacted pool;
* ``pallas_tiled`` (:func:`run_rounds_tiled`): two launches per round,
  the verdict kernel and the rebuild kernel, meeting at the accepted
  matrix;
* ``pallas_mega`` (:func:`run_trial_mega`): the trial megakernel, one
  launch per batch for step 3a, every round and the decisions, which
  hashes each round's draws where it reads them (its keyed entries): no
  draw stack exists.  With ``qsim_path="stabilizer"`` the launch also
  generates the lists from the GF(2) operands (:func:`resolve_mega_gen`).

``auto`` picks ``pallas_mega`` for CUDA tensors and ``xla`` for CPU
tensors; past the kernels' 64-bit masks (65 parties and up) it picks
``xla`` on CUDA too, with a :class:`QBADemotionWarning`.  On CPU
tensors the kernel engines run their kernels' plain versions.  The
per-round kernel engines draw each round's attacks with the draws
kernel (:func:`~qba_tpu_torch.ops.attack_draws.attack_draws`, one launch
a round); the ``xla`` oracle keeps the plain
:func:`~qba_tpu_torch.adversary.model.sample_attacks_round`.

The per-round engines share one loop, :func:`scan_rounds`, which with
``cfg.collect_counters`` also folds each round's ``vi`` delta and
overflow flag into :class:`ProtocolCounters`.  The megakernel has no
per-round loop on the host: with counters on, ``auto`` on CUDA picks
``pallas_fused`` and an explicit ``pallas_mega`` demotes to it with a
:class:`QBADemotionWarning`.

Every function that draws takes JAX's threefry mode as
``partitionable`` (None: the current mode,
:func:`qba_tpu_torch.random.resolve_mode`), reads it once and passes the
bool down to the draws, the kernels' instantiations and the list
generation.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import (
    adversary_ctx,
    corrupt_at_delivery,
    sample_attacks_round,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core import (
    Evidence,
    Packet,
    append_own,
    consistent,
    consistent_after_append,
    decide_order,
    empty_evidence,
    success_oracle,
)
from qba_tpu_torch.core.types import SENTINEL
from qba_tpu_torch.diagnostics import QBADemotionWarning, warn_demotion  # noqa: F401
from qba_tpu_torch.ops._launch import KERNEL_MAX_W, masks_fit
from qba_tpu_torch.ops.attack_draws import attack_draws
from qba_tpu_torch.qsim import generate_lists_for
from qba_tpu_torch.rounds.mailbox import Mailbox, mailbox_from_step3a

ENGINES = ("xla", "pallas", "pallas_fused", "pallas_tiled", "pallas_mega")


@dataclasses.dataclass
class ProtocolCounters:
    """Per-trial protocol counters (``cfg.collect_counters``), leading
    axis = trials.  Every field comes from the accepted-set (``vi``)
    deltas and overflow flags the round loop already carries, so
    collecting them cannot change the primary outputs.  Rounds are
    1-based; 0 means accepted at step 3a, -1 never accepted."""

    first_accept_round: torch.Tensor  # int32[T, n_lieutenants, w]
    accept_counts: torch.Tensor  # int32[T, w]: receivers that accepted v
    accepts_per_round: torch.Tensor  # int32[T, n_rounds]
    slot_high_water: torch.Tensor  # int32[T]: most rebroadcasts queued by
    # one receiver in one round (against the cfg.slots bound)
    overflow_rounds: torch.Tensor  # bool[T, n_rounds]


@dataclasses.dataclass
class TrialResult:
    """Per-trial outputs, leading axis = trials."""

    success: torch.Tensor  # bool[T]
    decisions: torch.Tensor  # int32[T, n_parties], index 0 = commander
    honest: torch.Tensor  # bool[T, n_parties], same indexing
    v_comm: torch.Tensor  # int32[T]
    vi: torch.Tensor  # bool[T, n_lieutenants, w]
    overflow: torch.Tensor  # bool[T]
    counters: ProtocolCounters | None = None  # with cfg.collect_counters


def warn_masks_demotion(cfg: QBAConfig, stacklevel: int) -> None:
    """Record that ``auto`` on CUDA runs the ``xla`` engine because the
    kernels' 64-bit masks cannot hold ``cfg`` (JAX's ``auto`` falls
    through to ``xla`` where no kernel plan compiles)."""
    warn_demotion(
        f"the CUDA kernels keep values and receivers as 64-bit masks "
        f"(w <= {KERNEL_MAX_W}, n_lieutenants <= {KERNEL_MAX_W}); at "
        f"w={cfg.w}, n_lieutenants={cfg.n_lieutenants} auto demotes to the "
        "xla engine", "kernel_masks_64", stacklevel=stacklevel + 1)


def resolve_round_engine(cfg: QBAConfig, device: torch.device) -> str:
    """``auto`` -> ``pallas_mega`` on CUDA (``pallas_fused`` when
    counters are collected: they need the per-round loop), ``xla`` on
    the CPU, and ``xla`` on CUDA with a :class:`QBADemotionWarning` where
    the kernels' 64-bit masks cannot hold the config (:func:`masks_fit`).
    An explicit engine is kept (a kernel engine past the masks raises
    when it launches), except ``pallas_mega`` with counters, which
    demotes to ``pallas_fused`` with a :class:`QBADemotionWarning` (the
    counters are identical: every engine's per-round ``vi`` sequence
    is)."""
    if cfg.round_engine == "auto":
        if torch.device(device).type != "cuda":
            return "xla"
        if not masks_fit(cfg):
            warn_masks_demotion(cfg, stacklevel=2)
            return "xla"
        return "pallas_fused" if cfg.collect_counters else "pallas_mega"
    if cfg.round_engine == "pallas_mega" and cfg.collect_counters:
        warn_demotion(
            "the trial megakernel has no per-round loop on the host for "
            "the counters to ride; collect_counters demotes pallas_mega "
            "to the fused per-round engine (identical counters)",
            "counters_need_host_scan", stacklevel=3,
        )
        return "pallas_fused"
    return cfg.round_engine


def resolve_mega_gen(cfg: QBAConfig, device: torch.device) -> str:
    """Where the trial megakernel generates the lists: ``"gf2"`` (inside
    the launch, from :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_gen_operands`)
    when ``qsim_path="stabilizer"``, the engine is ``pallas_mega`` after
    :func:`resolve_round_engine` and ``mega_gen`` is not ``"host"``;
    else ``"host"`` (the lists arrive as inputs).  The JAX package's
    resolver can demote a forced ``"gf2"`` when the TPU's VMEM plan
    refuses it; Hopper has no such plan here, so a forced ``"gf2"``
    never demotes.  A config whose engine is not the megakernel (the
    counters demote it, and ``auto`` past the 64-bit masks is ``xla``)
    generates on the host."""
    if cfg.qsim_path != "stabilizer" or cfg.mega_gen == "host":
        return "host"
    mega = cfg.round_engine == "pallas_mega" or (
        cfg.round_engine == "auto" and torch.device(device).type == "cuda"
        and masks_fit(cfg))
    return "gf2" if mega and not cfg.collect_counters else "host"


def p_sets(lists: torch.Tensor, v_sent: torch.Tensor) -> torch.Tensor:
    """Each lieutenant's P-set bool ``[..., n_lieu, S]`` from the lists
    ``[..., n_parties + 1, S]`` and the orders ``[..., n_lieu]``: the
    Q-correlated positions (the QSD's copy differs from the commander's
    value) where the commander's value is the order sent."""
    is_qcorr = lists[..., 0, :] != lists[..., 1, :]
    return is_qcorr[..., None, :] & (lists[..., 1:2, :] == v_sent[..., None])


def setup_batch(cfg: QBAConfig, keys: torch.Tensor, *,
                partitionable: bool | None = None, full_lists: bool = False):
    """The protocol phases before the round loop for trial keys ``[T,
    2]`` and the adversary context: ``(TrialSetup, ctx)``
    (:class:`~qba_tpu_torch.ops.setup_kernel.TrialSetup`).

    The factorized path is one :func:`~qba_tpu_torch.ops.setup_kernel.
    setup_kernel` call (``"whole"``); the other list paths call its
    ``"orders"`` form for ``k_lists``, make the lists with
    :func:`~qba_tpu_torch.qsim.generate_lists_for` and hand them to its
    ``"given"`` form.  On CUDA keys each call is one launch of the
    set-up kernel, on CPU keys its plain version (the eager set-up).
    The context takes the set-up's collude target.  ``full_lists``: the
    result's ``lists`` holds every party's lists."""
    from qba_tpu_torch.ops.setup_kernel import setup_kernel

    p = jr.resolve_mode(partitionable)
    if cfg.qsim_path == "factorized":
        s = setup_kernel(cfg, keys, "whole", full_lists=full_lists,
                         partitionable=p)
    else:
        k_lists = setup_kernel(cfg, keys, "orders", partitionable=p).k_lists
        lists, _qcorr = generate_lists_for(cfg, k_lists, partitionable=p)
        s = setup_kernel(cfg, keys, "given", lists, partitionable=p)
        if full_lists:
            s = s._replace(lists=lists)
    ctx = adversary_ctx(cfg, s.k_rounds, s.v_sent, partitionable=p,
                        target=s.target)
    return s, ctx


def setup_trial(cfg: QBAConfig, keys: torch.Tensor, *,
                partitionable: bool | None = None):
    """Protocol phases before the round loop, for trial keys ``[T, 2]``:
    dishonesty assignment, particle lists, commander orders and each
    lieutenant's P-set (:func:`setup_batch` without the context).

    Returns ``(honest [T, n+1], lieu_lists [T, n_lieu, S], p_rows
    [T, n_lieu, S], v_sent [T, n_lieu], v_comm [T], k_rounds [T, 2])``.
    """
    s, _ctx = setup_batch(cfg, keys, partitionable=partitionable)
    return s.honest, s.lieu_lists, s.p_rows, s.v_sent, s.v_comm, s.k_rounds


def gen_setup_batch(cfg: QBAConfig, keys: torch.Tensor, *,
                    partitionable: bool | None = None):
    """:func:`setup_batch` for the megakernel's gen entry: the set-up
    kernel's ``"orders"`` form (the same key split, ``k_dis, k_lists,
    k_comm, k_rounds``), with ``k_lists`` feeding
    :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_gen_operands`
    instead of generating the lists.  Returns ``(TrialSetup, gen_ops,
    ctx)``."""
    from qba_tpu_torch.ops.setup_kernel import setup_kernel
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_operands

    p = jr.resolve_mode(partitionable)
    s = setup_kernel(cfg, keys, "orders", partitionable=p)
    gen_ops = stabilizer_gen_operands(cfg, s.k_lists, partitionable=p)
    ctx = adversary_ctx(cfg, s.k_rounds, s.v_sent, partitionable=p,
                        target=s.target)
    return s, gen_ops, ctx


def _mega_gen_setup(cfg: QBAConfig, keys: torch.Tensor,
                    partitionable: bool | None = None):
    """:func:`gen_setup_batch` as ``(honest, gen_ops, v_sent, v_comm,
    k_rounds)``."""
    s, gen_ops, _ctx = gen_setup_batch(cfg, keys, partitionable=partitionable)
    return s.honest, gen_ops, s.v_sent, s.v_comm, s.k_rounds


def step3a_one(cfg: QBAConfig, p_rows, v, li):
    """Step 3a for every lieutenant: receive the commander's packet,
    append the own sub-list, accept and rebroadcast if consistent.

    Returns ``(vi bool [..., w], out_cells)``; ``out_cells`` is each
    lieutenant's outgoing slot 0 ``(vals, lens, count, p, v, sent)``
    (every other slot of step 3a's mailbox row is empty).
    """
    ev = append_own(
        empty_evidence(cfg.max_l, cfg.size_l, v.shape, v.device), p_rows, li
    )
    ok = consistent(v, ev, cfg.w)
    values = torch.arange(cfg.w, device=v.device)
    vi = (values == v[..., None]) & ok[..., None]
    out = (
        torch.where(ok[..., None, None], ev.vals, SENTINEL),
        torch.where(ok[..., None], ev.lens, 0),
        torch.where(ok, ev.count, 0),
        p_rows & ok[..., None],
        torch.where(ok, v, 0).to(torch.int32),
        ok,
    )
    return vi, out


def receiver_round(cfg: QBAConfig, round_idx: int, draws, vi, li,
                   mb: Mailbox, honest, start: int = 0):
    """Every lieutenant's inbox drain for one voting round, every trial.

    Each (receiver, packet) delivery is corrupted by its draws and judged
    by the executable specification ``consistent_after_append``; then
    the first candidate per order value not already in ``vi`` is
    accepted, in (sender, slot) order, and accepted packets are
    rebroadcast into the receiver's row of the next mailbox.

    ``draws`` are ``[T, n_pk, n_rv]``; ``vi`` bool ``[T, n_rv, w]``; ``li``
    ``[T, n_rv, S]``.  The receivers are the lieutenants ``[start, start
    + n_rv)`` (a party-sharded block drains its own against the whole
    mailbox; the draws are its columns).  Returns ``(vi', the receivers'
    rows of the next mailbox, overflow [T])``.
    """
    n_s, slots, w = cfg.n_lieutenants, cfg.slots, cfg.w
    n_pk = n_s * slots
    n_rv = li.shape[1]
    dev = li.device

    def flat(x):  # [T, n_s, slots, ...] -> [T, 1, n_pk, ...]
        return x.reshape((x.shape[0], 1, n_pk) + x.shape[3:])

    attack, rand_v, late = (d.transpose(1, 2) for d in draws)  # [T, R, P]
    idx = torch.arange(n_pk, device=dev)
    senders = idx // slots
    recv = start + torch.arange(n_rv, device=dev)[:, None]
    packet = Packet(
        p_mask=flat(mb.p_mask),
        v=flat(mb.v),
        evidence=Evidence(vals=flat(mb.vals), lens=flat(mb.lens),
                          count=flat(mb.count)),
    )
    pk, delivered = corrupt_at_delivery(
        cfg, (attack, rand_v), packet, honest[:, None, senders + 2]
    )
    delivered = (
        delivered & flat(mb.sent) & (senders != recv) & ~late.to(torch.bool)
    )
    li_b = li[:, :, None, :]
    ok, new_count = consistent_after_append(
        pk.v, pk.evidence, pk.p_mask, li_b, w
    )
    ok = ok & delivered & (new_count == round_idx + 1)

    # First-occurrence-wins dedup against Vi, per (receiver, value).
    onehot = pk.v[..., None] == torch.arange(w, device=dev)  # [T, R, P, w]
    cand = ok & ~(onehot & vi[:, :, None, :]).any(-1)
    cand_idx = torch.where(cand, idx, n_pk)
    first = torch.where(onehot, cand_idx[..., None], n_pk).amin(-2)
    first_b = torch.where(onehot, first[:, :, None, :], n_pk).amin(-1)
    acc = cand & (first_b == idx)
    vi = vi | (acc[..., None] & onehot).any(-2)

    # Rebroadcast while round <= n_dishonest into the receiver's own
    # sender row; outgoing slot = exclusive prefix count.
    rebroadcast = acc & (round_idx <= cfg.n_dishonest)
    rb = rebroadcast.to(torch.int64)
    slot = torch.cumsum(rb, -1) - rb
    write = rebroadcast & (slot < slots)
    overflow = (rebroadcast & ~write).flatten(1).any(-1)
    hit = write[:, :, None, :] & (
        slot[:, :, None, :] == torch.arange(slots, device=dev)[:, None]
    )  # [T, R, slots, P]
    has = hit.any(-1)
    src = hit.to(torch.int8).argmax(-1)  # [T, R, slots]

    ev = append_own(pk.evidence, pk.p_mask, li_b)

    def pick(x):  # [T, R, P, ...] -> [T, R, slots, ...]
        x = x.expand((x.shape[0], n_rv) + x.shape[2:])
        i = src.view(src.shape + (1,) * (x.dim() - 3))
        return torch.gather(x, 2, i.expand(src.shape + x.shape[3:]))

    out = Mailbox(
        vals=torch.where(has[..., None, None], pick(ev.vals), SENTINEL),
        lens=torch.where(has[..., None], pick(ev.lens), 0),
        count=torch.where(has, pick(ev.count), 0),
        p_mask=pick(pk.p_mask) & has[..., None],
        v=torch.where(has, pick(pk.v), 0).to(torch.int32),
        sent=has,
    )
    return vi, out, overflow


def _vi_bool(vi):
    """Engines carry vi as bool (``xla``) or int32 (the kernel engines)."""
    return vi if vi.dtype == torch.bool else vi != 0


def counters_init(cfg: QBAConfig, vi0):
    """Counter state from step 3a's accepted sets bool ``[T, n_rv, w]``:
    first-accept rounds (0 = step 3a, -1 = pending) and the slot
    high-water mark."""
    first_accept = torch.where(vi0, 0, -1).to(torch.int32)
    high_water = torch.zeros(vi0.shape[:-2], dtype=torch.int32,
                             device=vi0.device)
    return first_accept, high_water


def counters_step(cfg: QBAConfig, state, vi_old, vi_new, round_idx: int):
    """Fold one round's acceptance delta into the counter state.  While
    ``round <= n_dishonest`` each acceptance queues a rebroadcast, so a
    receiver's newly accepted count is the number of outgoing slots it
    claimed.  Returns ``(state', accepts int32 [T])``."""
    first_accept, high_water = state
    newly = vi_new & ~vi_old
    first_accept = torch.where(newly, round_idx, first_accept).to(torch.int32)
    per_receiver = newly.sum(-1, dtype=torch.int32)
    if round_idx <= cfg.n_dishonest:
        high_water = torch.maximum(high_water, per_receiver.amax(-1))
    return (first_accept, high_water), per_receiver.sum(-1, dtype=torch.int32)


def counters_finish(cfg: QBAConfig, state, vi_final, accepts_per_round,
                    overflow_rounds) -> ProtocolCounters:
    first_accept, high_water = state
    return ProtocolCounters(
        first_accept_round=first_accept,
        accept_counts=vi_final.sum(-2, dtype=torch.int32),
        accepts_per_round=accepts_per_round,
        slot_high_water=high_water,
        overflow_rounds=overflow_rounds,
    )


def scan_rounds(cfg: QBAConfig, round_body, vi, state):
    """The round loop every per-round engine shares: ``round_body(r, vi,
    state) -> (vi', state', overflow bool [T])`` for rounds
    ``1..n_rounds``.  With ``cfg.collect_counters`` each round's ``vi``
    delta and overflow flag are folded into :class:`ProtocolCounters`;
    otherwise nothing more is computed.  Returns ``(vi, overflow [T],
    counters or None)``.  ``vi`` may carry leading axes before the
    trials' (the party-sharded engine's shards): the overflow flags and
    the counters then carry them too."""
    overflow = torch.zeros(vi.shape[:-2], dtype=torch.bool, device=vi.device)
    collect = cfg.collect_counters
    if collect:
        cstate = counters_init(cfg, _vi_bool(vi))
        accepts, overflows = [], []
    for r in range(1, cfg.n_rounds + 1):
        vi_new, state, ovf = round_body(r, vi, state)
        overflow |= ovf
        if collect:
            cstate, acc = counters_step(cfg, cstate, _vi_bool(vi),
                                        _vi_bool(vi_new), r)
            accepts.append(acc)
            overflows.append(ovf)
        vi = vi_new
    counters = None
    if collect:
        counters = counters_finish(cfg, cstate, _vi_bool(vi),
                                   torch.stack(accepts, -1),
                                   torch.stack(overflows, -1))
    return vi, overflow, counters


def run_rounds_xla(cfg: QBAConfig, vi, mb: Mailbox, lieu_lists, honest,
                   k_rounds, ctx=None, *, partitionable: bool | None = None):
    """Step 3b on the dense mailbox, one :func:`receiver_round` per
    round.  Returns ``(vi, overflow [T], counters)``."""
    p = jr.resolve_mode(partitionable)

    def round_body(r, vi, mb):
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx,
                                     partitionable=p)
        return receiver_round(cfg, r, draws, vi, lieu_lists, mb, honest)

    return scan_rounds(cfg, round_body, vi, mb)


def _run_rounds_kernel(cfg: QBAConfig, round_step, vi, state, spare,
                       lieu_lists, honest, k_rounds, ctx):
    """Step 3b on a per-round kernel: ``round_step(r, state, li, vi,
    honest_c, attack, rand_v, late, out) -> (state', vi', overflow)`` per
    round, the packet state (a pool or a packed mailbox) ping-ponging
    between two buffers allocated once per batch, each round's draws in
    the threefry mode its caller runs it in (read once).  Returns ``(vi,
    overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells

    partitionable = jr.partitionable_mode()
    hc = honest_cells(honest, cfg)
    li = lieu_lists.to(torch.int32).contiguous()

    def round_body(r, vi, bufs):
        cur, spare = bufs
        new, vi, ovf = round_step(r, cur, li, vi, hc,
                                  *round_draws(cfg, k_rounds, ctx, r,
                                               partitionable=partitionable),
                                  out=spare)
        return vi, (new, cur), ovf

    vi, overflow, counters = scan_rounds(
        cfg, round_body, vi.to(torch.int32), (state, spare))
    return vi != 0, overflow, counters


def run_rounds_pallas(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                      k_rounds, ctx=None, *,
                      partitionable: bool | None = None):
    """Step 3b on the dense-mailbox round kernel: one
    :func:`~qba_tpu_torch.ops.round_kernel.round_step` per round over
    the packed mailbox.  Returns ``(vi, overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel import (
        empty_mailbox,
        mailbox_from_step3a as packed_from_step3a,
        round_step,
    )

    with jr.threefry_partitionable(jr.resolve_mode(partitionable)):
        return _run_rounds_kernel(
            cfg, functools.partial(round_step, cfg), vi,
            packed_from_step3a(cfg, out_cells),
            empty_mailbox(cfg, vi.shape[0], vi.device), lieu_lists, honest,
            k_rounds, ctx,
        )


def _run_rounds_pool(cfg: QBAConfig, round_step, vi, out_cells, lieu_lists,
                     honest, k_rounds, ctx, partitionable):
    """Step 3b over the compacted pool (see :func:`_run_rounds_kernel`)."""
    from qba_tpu_torch.ops.round_kernel_tiled import (
        empty_pool,
        pool_from_step3a,
    )

    with jr.threefry_partitionable(jr.resolve_mode(partitionable)):
        return _run_rounds_kernel(
            cfg, round_step, vi, pool_from_step3a(cfg, out_cells),
            empty_pool(cfg, vi.shape[0], vi.device), lieu_lists, honest,
            k_rounds, ctx,
        )


def run_rounds_fused(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                     k_rounds, ctx=None, *,
                     partitionable: bool | None = None):
    """Step 3b on the fused round kernel: one
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round` per round
    over the compacted pool.  Returns ``(vi, overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel_tiled import fused_round

    return _run_rounds_pool(
        cfg, functools.partial(fused_round, cfg), vi, out_cells, lieu_lists,
        honest, k_rounds, ctx, partitionable,
    )


def run_rounds_tiled(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                     k_rounds, ctx=None, *,
                     partitionable: bool | None = None):
    """Step 3b on the two-kernel tiled round: per round one
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.tiled_verdict` (the
    accepted matrix and ``vi'``) and one
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.tiled_rebuild` (the
    successor pool).  Returns ``(vi, overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel_tiled import (
        tiled_rebuild,
        tiled_verdict,
    )

    def round_step(r, pool, li, vi, hc, attack, rand_v, late, out):
        acc, vi = tiled_verdict(cfg, r, pool, li, vi, hc, attack, rand_v,
                                late)
        new, ovf = tiled_rebuild(cfg, r, pool, li, acc, hc, attack, rand_v,
                                 out=out)
        return new, vi, ovf

    return _run_rounds_pool(cfg, round_step, vi, out_cells, lieu_lists,
                            honest, k_rounds, ctx, partitionable)


def round_draws(cfg: QBAConfig, k_rounds, ctx, r: int, *,
                partitionable: bool | None = None):
    """Round ``r``'s draw tables ``(attack, rand_v, late)``, each uint8
    ``[T, n_pool, n_rv]``: one launch of the draws kernel on CUDA
    (:func:`~qba_tpu_torch.ops.attack_draws.attack_draws`), its plain
    version on the CPU.  The per-round kernel engines draw a round at a
    time, so their peak memory holds one round's tables."""
    return tuple(x[:, 0] for x in attack_draws(
        cfg, k_rounds.contiguous(), ctx, r, 1, partitionable=partitionable))


def run_trial_mega(cfg: QBAConfig, keys: torch.Tensor, *,
                   partitionable: bool | None = None) -> TrialResult:
    """Full protocol executions on the trial megakernel
    (:func:`qba_tpu_torch.ops.trial_megakernel.trial_megakernel_keyed`):
    the same key tree as :func:`setup_trial`, then step 3a, the rounds
    and the decisions in one launch for the batch, which hashes every
    round's draws from the trials' rounds keys where it reads them.
    Where :func:`resolve_mega_gen` says ``"gf2"``, the launch is the gen
    entry
    (:func:`~qba_tpu_torch.ops.trial_megakernel.trial_megakernel_gen_keyed`),
    which also sweeps the tableaux and decodes the lists.

    ``trial_pack`` (folding ``k`` trials into one TPU launch) has no
    effect here: the CUDA grid already runs one block per trial, so a
    packed config gives results identical to an unpacked one."""
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.ops.trial_megakernel import (
        trial_megakernel_gen_keyed,
        trial_megakernel_keyed,
    )

    p = jr.resolve_mode(partitionable)
    gen = resolve_mega_gen(cfg, keys.device) == "gf2"
    if gen:
        s, gen_ops, ctx = gen_setup_batch(cfg, keys, partitionable=p)
    else:
        s, ctx = setup_batch(cfg, keys, partitionable=p)
    honest, v_comm = s.honest, s.v_comm
    v32, hc = s.v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg)
    k_rounds = s.k_rounds.contiguous()
    # The launch runs in the batch's mode (the wrappers read it once).
    with jr.threefry_partitionable(p):
        if gen:
            from qba_tpu_torch.qsim.protocol_circuits import (
                stabilizer_gen_tables,
            )

            vi, dec, overflow = trial_megakernel_gen_keyed(
                cfg, stabilizer_gen_tables(cfg, keys.device), gen_ops, v32,
                hc, k_rounds, ctx)
        else:
            vi, dec, overflow = trial_megakernel_keyed(
                cfg, s.p_rows.contiguous(),
                s.lieu_lists.to(torch.int32).contiguous(), v32, hc, k_rounds,
                ctx)
    return mega_result(honest, v_comm, vi, dec, overflow)


def mega_result(honest, v_comm, vi, dec, overflow) -> TrialResult:
    """A megakernel's outputs (``vi`` int32, the lieutenants' decisions
    and overflow) as the batch's :class:`TrialResult`."""
    decisions = torch.cat([v_comm[..., None].to(torch.int32), dec], dim=-1)
    return TrialResult(
        success=success_oracle(decisions, honest[..., 1:]),
        decisions=decisions,
        honest=honest[..., 1:],
        v_comm=v_comm,
        vi=vi != 0,
        overflow=overflow,
    )


def finish_trial(cfg: QBAConfig, vi, v_comm, honest, overflow,
                 counters=None) -> TrialResult:
    """Decisions (``min(Vi)``, the commander its own ``v``) and the
    success oracle."""
    is_comm = torch.zeros(vi.shape[:-1], dtype=torch.bool, device=vi.device)
    lieu = decide_order(vi, v_comm[..., None].expand(vi.shape[:-1]),
                        is_comm, cfg.w)
    decisions = torch.cat([v_comm[..., None].to(torch.int32), lieu], dim=-1)
    return TrialResult(
        success=success_oracle(decisions, honest[..., 1:]),
        decisions=decisions,
        honest=honest[..., 1:],
        v_comm=v_comm,
        vi=vi,
        overflow=overflow,
        counters=counters,
    )


def run_chunk_counts(cfg: QBAConfig, keys: torch.Tensor, *,
                     partitionable: bool | None = None):
    """One chunk's verdicts reduced on its device: ``(successes int32,
    overflow bool)`` 0-dim tensors from a :func:`run_trial` batch, the
    two numbers a stopping rule reads (counterpart of
    :func:`qba_tpu.rounds.engine.run_chunk_counts`)."""
    res = run_trial(cfg, keys, partitionable=partitionable)
    return res.success.sum(dtype=torch.int32), res.overflow.any()


def run_chunk_outcomes(cfg: QBAConfig, keys: torch.Tensor, *,
                       partitionable: bool | None = None):
    """Like :func:`run_chunk_counts` but keeps the per-trial success
    bits: ``(success bool [len(keys)], overflow bool 0-dim)``, for a
    caller that reports each trial's success."""
    res = run_trial(cfg, keys, partitionable=partitionable)
    return res.success, res.overflow.any()


def run_trial(cfg: QBAConfig, keys: torch.Tensor, *,
              partitionable: bool | None = None) -> TrialResult:
    """Full protocol executions for a batch of trial keys ``[T, 2]`` on
    their device, with the engine :func:`resolve_round_engine` picks, in
    ``partitionable``'s threefry mode (None: the current mode)."""
    p = jr.resolve_mode(partitionable)
    engine = resolve_round_engine(cfg, keys.device)
    if engine == "pallas_mega":
        # The megakernel absorbs step 3a and the decisions too.
        return run_trial_mega(cfg, keys, partitionable=p)
    s, ctx = setup_batch(cfg, keys, partitionable=p)
    honest, lieu_lists, p_rows, v_sent, v_comm, k_rounds = (
        s.honest, s.lieu_lists, s.p_rows, s.v_sent, s.v_comm, s.k_rounds)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, lieu_lists)
    if engine == "xla":
        vi, overflow, counters = run_rounds_xla(
            cfg, vi, mailbox_from_step3a(cfg, out_cells), lieu_lists,
            honest, k_rounds, ctx, partitionable=p,
        )
    else:
        rounds = {"pallas": run_rounds_pallas,
                  "pallas_fused": run_rounds_fused,
                  "pallas_tiled": run_rounds_tiled}[engine]
        vi, overflow, counters = rounds(
            cfg, vi, out_cells, lieu_lists, honest, k_rounds, ctx,
            partitionable=p,
        )
    return finish_trial(cfg, vi, v_comm, honest, overflow, counters)
