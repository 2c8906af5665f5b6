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
  launch per batch for step 3a, every round and the decisions, on draws
  stacked for all rounds beforehand (:func:`_stacked_draws`).  With
  ``qsim_path="stabilizer"`` the launch also generates the lists from
  the GF(2) operands (:func:`resolve_mega_gen`).

``auto`` picks ``pallas_mega`` for CUDA tensors and ``xla`` for CPU
tensors.  On CPU tensors the kernel engines run their kernels' plain
versions.

The per-round engines share one loop, :func:`scan_rounds`, which with
``cfg.collect_counters`` also folds each round's ``vi`` delta and
overflow flag into :class:`ProtocolCounters`.  The megakernel has no
per-round loop on the host: with counters on, ``auto`` on CUDA picks
``pallas_fused`` and an explicit ``pallas_mega`` demotes to it with a
:class:`QBADemotionWarning`.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import (
    adversary_ctx,
    assign_dishonest,
    commander_orders,
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
from qba_tpu_torch.diagnostics import QBADemotionWarning
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


def resolve_round_engine(cfg: QBAConfig, device: torch.device) -> str:
    """``auto`` -> ``pallas_mega`` on CUDA (``pallas_fused`` when
    counters are collected: they need the per-round loop), ``xla`` on
    the CPU.  An explicit engine is kept, except ``pallas_mega`` with
    counters, which demotes to ``pallas_fused`` with a
    :class:`QBADemotionWarning` (the counters are identical: every
    engine's per-round ``vi`` sequence is)."""
    if cfg.round_engine == "auto":
        if torch.device(device).type != "cuda":
            return "xla"
        return "pallas_fused" if cfg.collect_counters else "pallas_mega"
    if cfg.round_engine == "pallas_mega" and cfg.collect_counters:
        warnings.warn(
            "the trial megakernel has no per-round loop on the host for "
            "the counters to ride; collect_counters demotes pallas_mega "
            "to the fused per-round engine (identical counters)",
            QBADemotionWarning, stacklevel=3,
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
    counters demote it) generates on the host."""
    if cfg.qsim_path != "stabilizer" or cfg.mega_gen == "host":
        return "host"
    mega = cfg.round_engine == "pallas_mega" or (
        cfg.round_engine == "auto" and torch.device(device).type == "cuda")
    return "gf2" if mega and not cfg.collect_counters else "host"


def p_sets(lists: torch.Tensor, v_sent: torch.Tensor) -> torch.Tensor:
    """Each lieutenant's P-set bool ``[..., n_lieu, S]`` from the lists
    ``[..., n_parties + 1, S]`` and the orders ``[..., n_lieu]``: the
    Q-correlated positions (the QSD's copy differs from the commander's
    value) where the commander's value is the order sent."""
    is_qcorr = lists[..., 0, :] != lists[..., 1, :]
    return is_qcorr[..., None, :] & (lists[..., 1:2, :] == v_sent[..., None])


def setup_trial(cfg: QBAConfig, keys: torch.Tensor):
    """Protocol phases before the round loop, for trial keys ``[T, 2]``:
    dishonesty assignment, particle lists, commander orders and each
    lieutenant's P-set.

    Returns ``(honest [T, n+1], lieu_lists [T, n_lieu, S], p_rows
    [T, n_lieu, S], v_sent [T, n_lieu], v_comm [T], k_rounds [T, 2])``.
    """
    k = jr.split(keys, 4)
    honest = assign_dishonest(cfg, k[..., 0, :])
    lists, _qcorr = generate_lists_for(cfg, k[..., 1, :])
    v_sent, v_comm = commander_orders(cfg, k[..., 2, :], honest[..., 1])
    return (honest, lists[..., 2:, :], p_sets(lists, v_sent), v_sent, v_comm,
            k[..., 3, :])


def _mega_gen_setup(cfg: QBAConfig, keys: torch.Tensor):
    """:func:`setup_trial`'s phases for the megakernel's gen entry: the
    same key split (``k_dis, k_lists, k_comm, k_rounds``), with
    ``k_lists`` feeding
    :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_gen_operands`
    instead of generating the lists.  Returns ``(honest, gen_ops,
    v_sent, v_comm, k_rounds)``."""
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_operands

    k = jr.split(keys, 4)
    honest = assign_dishonest(cfg, k[..., 0, :])
    gen_ops = stabilizer_gen_operands(cfg, k[..., 1, :])
    v_sent, v_comm = commander_orders(cfg, k[..., 2, :], honest[..., 1])
    return honest, gen_ops, v_sent, v_comm, k[..., 3, :]


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
                   mb: Mailbox, honest):
    """Every lieutenant's inbox drain for one voting round, every trial.

    Each (receiver, packet) delivery is corrupted by its draws and judged
    by the executable specification ``consistent_after_append``; then
    the first candidate per order value not already in ``vi`` is
    accepted, in (sender, slot) order, and accepted packets are
    rebroadcast into the receiver's row of the next mailbox.

    ``draws`` are ``[T, n_pk, n_rv]``; ``vi`` bool ``[T, n_rv, w]``; ``li``
    ``[T, n_rv, S]``.  Returns ``(vi', next mailbox, overflow [T])``.
    """
    n_s, slots, w = cfg.n_lieutenants, cfg.slots, cfg.w
    n_pk = n_s * slots
    dev = li.device

    def flat(x):  # [T, n_s, slots, ...] -> [T, 1, n_pk, ...]
        return x.reshape((x.shape[0], 1, n_pk) + x.shape[3:])

    attack, rand_v, late = (d.transpose(1, 2) for d in draws)  # [T, R, P]
    idx = torch.arange(n_pk, device=dev)
    senders = idx // slots
    recv = torch.arange(n_s, device=dev)[:, None]
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
        x = x.expand((x.shape[0], n_s) + x.shape[2:])
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
    counters or None)``."""
    overflow = torch.zeros(vi.shape[0], dtype=torch.bool, device=vi.device)
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
                   k_rounds, ctx=None):
    """Step 3b on the dense mailbox, one :func:`receiver_round` per
    round.  Returns ``(vi, overflow [T], counters)``."""

    def round_body(r, vi, mb):
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        return receiver_round(cfg, r, draws, vi, lieu_lists, mb, honest)

    return scan_rounds(cfg, round_body, vi, mb)


def _run_rounds_kernel(cfg: QBAConfig, round_step, vi, state, spare,
                       lieu_lists, honest, k_rounds, ctx):
    """Step 3b on a per-round kernel: ``round_step(r, state, li, vi,
    honest_c, attack, rand_v, late, out) -> (state', vi', overflow)`` per
    round, the packet state (a pool or a packed mailbox) ping-ponging
    between two buffers allocated once per batch.  Returns ``(vi,
    overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells

    hc = honest_cells(honest, cfg)
    li = lieu_lists.to(torch.int32).contiguous()

    def round_body(r, vi, bufs):
        cur, spare = bufs
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        new, vi, ovf = round_step(
            r, cur, li, vi, hc, *(x.to(torch.uint8) for x in draws),
            out=spare,
        )
        return vi, (new, cur), ovf

    vi, overflow, counters = scan_rounds(
        cfg, round_body, vi.to(torch.int32), (state, spare))
    return vi != 0, overflow, counters


def run_rounds_pallas(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                      k_rounds, ctx=None):
    """Step 3b on the dense-mailbox round kernel: one
    :func:`~qba_tpu_torch.ops.round_kernel.round_step` per round over
    the packed mailbox.  Returns ``(vi, overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel import (
        empty_mailbox,
        mailbox_from_step3a as packed_from_step3a,
        round_step,
    )

    return _run_rounds_kernel(
        cfg, functools.partial(round_step, cfg), vi,
        packed_from_step3a(cfg, out_cells),
        empty_mailbox(cfg, vi.shape[0], vi.device), lieu_lists, honest,
        k_rounds, ctx,
    )


def _run_rounds_pool(cfg: QBAConfig, round_step, vi, out_cells, lieu_lists,
                     honest, k_rounds, ctx):
    """Step 3b over the compacted pool (see :func:`_run_rounds_kernel`)."""
    from qba_tpu_torch.ops.round_kernel_tiled import (
        empty_pool,
        pool_from_step3a,
    )

    return _run_rounds_kernel(
        cfg, round_step, vi, pool_from_step3a(cfg, out_cells),
        empty_pool(cfg, vi.shape[0], vi.device), lieu_lists, honest,
        k_rounds, ctx,
    )


def run_rounds_fused(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                     k_rounds, ctx=None):
    """Step 3b on the fused round kernel: one
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round` per round
    over the compacted pool.  Returns ``(vi, overflow [T], counters)``."""
    from qba_tpu_torch.ops.round_kernel_tiled import fused_round

    return _run_rounds_pool(
        cfg, functools.partial(fused_round, cfg), vi, out_cells, lieu_lists,
        honest, k_rounds, ctx,
    )


def run_rounds_tiled(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                     k_rounds, ctx=None):
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
                            honest, k_rounds, ctx)


def _stacked_draws(cfg: QBAConfig, k_rounds, ctx):
    """Every round's draws ``(attack, rand_v, late)``, each uint8
    ``[T, n_rounds, n_pool, n_rv]`` trial-major, for the megakernel.

    Round ``r``'s slab is ``sample_attacks_round(cfg, fold_in(k_rounds,
    r), r, ctx)``, the per-round draws of the other engines, written
    into one preallocated tensor a round at a time (at 33 parties x 1000
    trials the three uint8 stacks are already 2.16 GB).  Every value fits
    uint8: attack bits < 32, forged values < w <= 64, late 0/1."""
    n_trials = k_rounds.shape[0]
    n_pool = cfg.n_lieutenants * cfg.slots
    shape = (n_trials, cfg.n_rounds, n_pool, cfg.n_lieutenants)
    out = tuple(torch.empty(shape, dtype=torch.uint8, device=k_rounds.device)
                for _ in range(3))
    for r in range(1, cfg.n_rounds + 1):
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        for dst, x in zip(out, draws):
            dst[:, r - 1] = x
    return out


def run_trial_mega(cfg: QBAConfig, keys: torch.Tensor) -> TrialResult:
    """Full protocol executions on the trial megakernel
    (:func:`qba_tpu_torch.ops.trial_megakernel.trial_megakernel`): the
    same key tree as :func:`setup_trial`, every round's draws stacked
    beforehand, then step 3a, the rounds and the decisions in one launch
    for the batch.  Where :func:`resolve_mega_gen` says ``"gf2"``, the
    launch is the gen entry
    (:func:`~qba_tpu_torch.ops.trial_megakernel.trial_megakernel_gen`),
    which also sweeps the tableaux and decodes the lists.

    ``trial_pack`` (folding ``k`` trials into one TPU launch) has no
    effect here: the CUDA grid already runs one block per trial, so a
    packed config gives results identical to an unpacked one."""
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.ops.trial_megakernel import (
        trial_megakernel,
        trial_megakernel_gen,
    )

    gen = resolve_mega_gen(cfg, keys.device) == "gf2"
    if gen:
        honest, gen_ops, v_sent, v_comm, k_rounds = _mega_gen_setup(cfg,
                                                                    keys)
    else:
        honest, lieu_lists, p_rows, v_sent, v_comm, k_rounds = setup_trial(
            cfg, keys)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    draws = _stacked_draws(cfg, k_rounds, ctx)
    v32, hc = v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg)
    if gen:
        from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_tables

        vi, dec, overflow = trial_megakernel_gen(
            cfg, stabilizer_gen_tables(cfg, keys.device), gen_ops, v32, hc,
            *draws)
    else:
        vi, dec, overflow = trial_megakernel(
            cfg, p_rows.contiguous(), lieu_lists.to(torch.int32).contiguous(),
            v32, hc, *draws)
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


def run_trial(cfg: QBAConfig, keys: torch.Tensor) -> TrialResult:
    """Full protocol executions for a batch of trial keys ``[T, 2]`` on
    their device, with the engine :func:`resolve_round_engine` picks."""
    engine = resolve_round_engine(cfg, keys.device)
    if engine == "pallas_mega":
        # The megakernel absorbs step 3a and the decisions too.
        return run_trial_mega(cfg, keys)
    honest, lieu_lists, p_rows, v_sent, v_comm, k_rounds = setup_trial(
        cfg, keys
    )
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, lieu_lists)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    if engine == "xla":
        vi, overflow, counters = run_rounds_xla(
            cfg, vi, mailbox_from_step3a(cfg, out_cells), lieu_lists,
            honest, k_rounds, ctx,
        )
    else:
        rounds = {"pallas": run_rounds_pallas,
                  "pallas_fused": run_rounds_fused,
                  "pallas_tiled": run_rounds_tiled}[engine]
        vi, overflow, counters = rounds(
            cfg, vi, out_cells, lieu_lists, honest, k_rounds, ctx
        )
    return finish_trial(cfg, vi, v_comm, honest, overflow, counters)
