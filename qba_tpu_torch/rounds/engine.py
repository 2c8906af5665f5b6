"""End-to-end protocol engine on a batch of trials — counterpart of
:mod:`qba_tpu.rounds.engine`.

Every phase is a tensor op over an explicit trial axis (where the JAX
package vmaps a one-trial function): honesty assignment, list
generation, step 1b/2 orders and P-sets, step 3a, the synchronous voting
rounds ``1..n_dishonest+1`` and the decision + success oracle.  Packet
processing order within a round is (sender, slot) lexicographic.

Four round engines, trial-for-trial identical:

* ``xla`` (:func:`run_rounds_xla`): the port's eager oracle on the dense
  mailbox, built on the executable specification
  ``consistent_after_append``;
* ``pallas_fused`` (:func:`run_rounds_fused`): one launch of the fused
  round kernel per round over the compacted pool;
* ``pallas_tiled`` (:func:`run_rounds_tiled`): two launches per round,
  the verdict kernel and the rebuild kernel, meeting at the accepted
  matrix;
* ``pallas_mega`` (:func:`run_trial_mega`): the trial megakernel, one
  launch per batch for step 3a, every round and the decisions, on draws
  stacked for all rounds beforehand (:func:`_stacked_draws`).

``auto`` picks ``pallas_mega`` for CUDA tensors and ``xla`` for CPU
tensors.  On CPU tensors the kernel engines run their kernels' plain
versions.
"""

from __future__ import annotations

import dataclasses
import functools

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
from qba_tpu_torch.qsim import generate_lists_for
from qba_tpu_torch.rounds.mailbox import Mailbox, mailbox_from_step3a

ENGINES = ("xla", "pallas_fused", "pallas_tiled", "pallas_mega")


@dataclasses.dataclass
class TrialResult:
    """Per-trial outputs, leading axis = trials."""

    success: torch.Tensor  # bool[T]
    decisions: torch.Tensor  # int32[T, n_parties], index 0 = commander
    honest: torch.Tensor  # bool[T, n_parties], same indexing
    v_comm: torch.Tensor  # int32[T]
    vi: torch.Tensor  # bool[T, n_lieutenants, w]
    overflow: torch.Tensor  # bool[T]


def check_supported(cfg: QBAConfig) -> None:
    """Raise ``NotImplementedError`` for config values the port accepts
    but does not run yet, naming the ROADMAP item — never a silent
    demotion."""
    if cfg.round_engine not in ("auto",) + ENGINES:
        raise NotImplementedError(
            f"round_engine={cfg.round_engine!r} is not ported yet "
            "(ROADMAP A6 and queue B row 1: the dense-mailbox round "
            "kernel); use 'auto', " + ", ".join(repr(e) for e in ENGINES)
        )
    if cfg.qsim_path != "factorized":
        raise NotImplementedError(
            f"qsim_path={cfg.qsim_path!r} is not ported yet (ROADMAP "
            "A7/A8); use qsim_path='factorized'"
        )
    if cfg.collect_counters:
        raise NotImplementedError(
            "collect_counters is not ported yet (ROADMAP A4: protocol "
            "counters)"
        )


def resolve_round_engine(cfg: QBAConfig, device: torch.device) -> str:
    """``auto`` -> ``pallas_mega`` on CUDA, ``xla`` on the CPU; an
    explicit engine is kept."""
    check_supported(cfg)
    if cfg.round_engine != "auto":
        return cfg.round_engine
    return "pallas_mega" if torch.device(device).type == "cuda" else "xla"


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
    is_qcorr = lists[..., 0, :] != lists[..., 1, :]
    v_sent, v_comm = commander_orders(cfg, k[..., 2, :], honest[..., 1])
    p_rows = is_qcorr[..., None, :] & (lists[..., 1:2, :] == v_sent[..., None])
    return honest, lists[..., 2:, :], p_rows, v_sent, v_comm, k[..., 3, :]


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


def run_rounds_xla(cfg: QBAConfig, vi, mb: Mailbox, lieu_lists, honest,
                   k_rounds, ctx=None):
    """Step 3b on the dense mailbox, one :func:`receiver_round` per
    round.  Returns ``(vi, overflow [T])``."""
    overflow = torch.zeros(vi.shape[0], dtype=torch.bool, device=vi.device)
    for r in range(1, cfg.n_rounds + 1):
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        vi, mb, ovf = receiver_round(cfg, r, draws, vi, lieu_lists, mb,
                                     honest)
        overflow |= ovf
    return vi, overflow


def _run_rounds_pool(cfg: QBAConfig, round_step, vi, out_cells, lieu_lists,
                     honest, k_rounds, ctx):
    """Step 3b over the compacted pool: ``round_step(r, pool, li, vi,
    honest_c, attack, rand_v, late, out) -> (pool', vi', overflow)`` per
    round, the pool ping-ponging between two buffers allocated once per
    batch.  Returns ``(vi, overflow [T])``."""
    from qba_tpu_torch.ops.round_kernel_tiled import (
        empty_pool,
        honest_cells,
        pool_from_step3a,
    )

    pool = pool_from_step3a(cfg, out_cells)
    spare = empty_pool(cfg, vi.shape[0], vi.device)
    hc = honest_cells(honest, cfg)
    li = lieu_lists.to(torch.int32).contiguous()
    vi_i = vi.to(torch.int32)
    overflow = torch.zeros(vi.shape[0], dtype=torch.bool, device=vi.device)
    for r in range(1, cfg.n_rounds + 1):
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        new, vi_i, ovf = round_step(
            r, pool, li, vi_i, hc, *(x.to(torch.uint8) for x in draws),
            out=spare,
        )
        pool, spare = new, pool
        overflow |= ovf
    return vi_i != 0, overflow


def run_rounds_fused(cfg: QBAConfig, vi, out_cells, lieu_lists, honest,
                     k_rounds, ctx=None):
    """Step 3b on the fused round kernel: one
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round` per round
    over the compacted pool.  Returns ``(vi, overflow [T])``."""
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
    successor pool).  Returns ``(vi, overflow [T])``."""
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
    for the batch.

    ``trial_pack`` (folding ``k`` trials into one TPU launch) has no
    effect here: the CUDA grid already runs one block per trial, so a
    packed config gives results identical to an unpacked one."""
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.ops.trial_megakernel import trial_megakernel

    honest, lieu_lists, p_rows, v_sent, v_comm, k_rounds = setup_trial(
        cfg, keys
    )
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    attack, rand_v, late = _stacked_draws(cfg, k_rounds, ctx)
    vi, dec, overflow = trial_megakernel(
        cfg, p_rows.contiguous(), lieu_lists.to(torch.int32).contiguous(),
        v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg),
        attack, rand_v, late,
    )
    decisions = torch.cat([v_comm[..., None].to(torch.int32), dec], dim=-1)
    return TrialResult(
        success=success_oracle(decisions, honest[..., 1:]),
        decisions=decisions,
        honest=honest[..., 1:],
        v_comm=v_comm,
        vi=vi != 0,
        overflow=overflow,
    )


def finish_trial(cfg: QBAConfig, vi, v_comm, honest, overflow) -> TrialResult:
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
    if engine in ("pallas_fused", "pallas_tiled"):
        rounds = (run_rounds_fused if engine == "pallas_fused"
                  else run_rounds_tiled)
        vi, overflow = rounds(
            cfg, vi, out_cells, lieu_lists, honest, k_rounds, ctx
        )
    else:
        vi, overflow = run_rounds_xla(
            cfg, vi, mailbox_from_step3a(cfg, out_cells), lieu_lists,
            honest, k_rounds, ctx,
        )
    return finish_trial(cfg, vi, v_comm, honest, overflow)
