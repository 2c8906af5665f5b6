"""Adversary model — counterpart of :mod:`qba_tpu.adversary.model`.

Honesty assignment, commander equivocation, and the strategy zoo's
per-round effective-edit arrays ``(attack, rand_v, late)``, drawn from the
same key tree with the same fold_in tags, so every draw equals the JAX
package's bit for bit.  All functions take a batch of trial keys
``[..., 2]`` and return the leading batch axes in front, and JAX's
threefry mode as ``partitionable`` (None: the current mode).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core.types import SENTINEL, Evidence, Packet

# fold_in tags of the JAX package (qba_tpu/adversary/model.py).
ATTACK_TAG = 0x0AC7
LATE_TAG = 0x17A7E
COLLUDE_TAG = 0xC011
ADAPT_TAG = 0xADA7

# Effective-edit bitmask: the attacks a receiver observes on one delivery.
DROP_BIT = 1
FORGE_BIT = 2
CLEAR_P_BIT = 4
CLEAR_L_BIT = 8
FORGE_P_BIT = 16  # strategy="split": fabricate a MAXIMAL presence mask

STRATEGIES = ("reference", "collude", "adaptive", "split")

# Exclusive upper bound of each strategy's forged-order values.
STRATEGY_FORGE_BOUND = {
    "reference": lambda cfg: cfg.n_parties + 1,
    "collude": lambda cfg: cfg.n_parties + 1,
    "adaptive": lambda cfg: cfg.w,
    "split": lambda cfg: cfg.n_parties + 1,
}


# The trail's names of the attack edits (tfg.py:272-284), shared by every
# backend that renders protocol events; mp_party keeps a torch-free copy.
EFFECT_NAMES = (
    (DROP_BIT, "drop"),
    (FORGE_BIT, "corrupt-v"),
    (CLEAR_P_BIT, "clear-P"),
    (CLEAR_L_BIT, "clear-L"),
    (FORGE_P_BIT, "forge-P"),
)


def effect_names(bits: int) -> str:
    """Human-readable rendering of an attack bitmask for the event trail."""
    names = [n for b, n in EFFECT_NAMES if bits & b]
    return "+".join(names) if names else "none"


def assign_dishonest(cfg: QBAConfig, keys: torch.Tensor, *,
                     partitionable: bool | None = None) -> torch.Tensor:
    """bool ``[..., n_parties + 1]`` honesty mask by rank (rank 0, the
    QSD, is always honest): ``n_dishonest`` distinct ranks of
    ``1..n_parties``, the head of a key-derived permutation."""
    ranks1 = torch.arange(1, cfg.n_parties + 1, device=keys.device)
    perm = jr.permutation(keys, ranks1, partitionable=partitionable)
    dishonest = perm[..., : cfg.n_dishonest]
    ranks = torch.arange(cfg.n_parties + 1, device=keys.device)
    hit = (ranks[:, None] == dishonest[..., None, :]).any(-1)
    return ~hit


def commander_orders(cfg: QBAConfig, keys: torch.Tensor,
                     commander_honest: torch.Tensor, *,
                     partitionable: bool | None = None):
    """``(v_sent int32 [..., n_lieutenants], v_comm int32 [...])``: an
    honest commander sends its ``v`` to everyone; a dishonest one sends
    ``v1 != v2`` split at the midpoint rank (by rank parity under
    ``strategy="split"``) and still decides ``v``."""
    w, p = cfg.w, jr.resolve_mode(partitionable)
    k = jr.split(keys, 3, partitionable=p)
    v = jr.randint(k[..., 0, :], (), 0, w, partitionable=p)
    v1 = jr.randint(k[..., 1, :], (), 0, w, partitionable=p)
    v2 = (v1 + 1 + jr.randint(k[..., 2, :], (), 0, w - 1,
                              partitionable=p)) % w
    ranks = torch.arange(2, cfg.n_parties + 1, dtype=torch.int32,
                         device=keys.device)
    if cfg.strategy == "split":
        first = ranks % 2 == 0
    else:
        first = ranks <= (cfg.n_parties + 1) // 2
    equivocated = torch.where(first, v1[..., None], v2[..., None])
    v_sent = torch.where(commander_honest[..., None], v[..., None],
                         equivocated).to(torch.int32)
    return v_sent, v


def raw_attack_draws(cfg: QBAConfig, k_round: torch.Tensor, *,
                     partitionable: bool | None = None):
    """The round's raw per-(cell, receiver) draws ``(action, coin,
    rand_v)``, int32 ``[..., n_cells, n_lieutenants]``: bit fields of one
    uint32 stream (bits 0-1, bit 2, and bits 3-26 mod ``n_parties+1``)."""
    shape = (cfg.n_lieutenants * cfg.slots, cfg.n_lieutenants)
    if cfg.n_parties + 1 > cfg.w:
        raise ValueError(
            f"forge range [0, {cfg.n_parties + 1}) exceeds the value "
            f"domain [0, {cfg.w}) the round engines are exact on"
        )
    b = jr.bits(jr.fold_in(k_round, ATTACK_TAG), shape,
                partitionable=partitionable)
    action = (b & 3).to(torch.int32)
    coin = ((b >> 2) & 1).to(torch.int32)
    rand_v = (((b >> 3) & 0xFFFFFF) % (cfg.n_parties + 1)).to(torch.int32)
    return action, coin, rand_v


class AdversaryCtx(NamedTuple):
    """Per-trial adversary state: the collude target ``[...]`` and the
    order each lieutenant received ``[..., n_lieutenants]``."""

    collude_target: torch.Tensor
    v_sent: torch.Tensor


def needs_target(cfg: QBAConfig) -> bool:
    """Whether ``cfg``'s strategy draws a per-trial context ("collude"
    and "adaptive"; "reference" and "split" are stateless)."""
    return cfg.strategy in ("collude", "adaptive")


def collude_target(cfg: QBAConfig, k_rounds: torch.Tensor, *,
                   partitionable: bool | None = None) -> torch.Tensor:
    """The collude target int32 ``[...]``: ``randint(fold_in(k_rounds,
    COLLUDE_TAG), (), 0, n_parties + 1)``."""
    return jr.randint(jr.fold_in(k_rounds, COLLUDE_TAG), (), 0,
                      cfg.n_parties + 1, partitionable=partitionable)


def adversary_ctx(cfg: QBAConfig, k_rounds: torch.Tensor,
                  v_sent: torch.Tensor, *,
                  partitionable: bool | None = None,
                  target: torch.Tensor | None = None) -> AdversaryCtx | None:
    """The per-trial context for strategies that need one (None for the
    stateless "reference" and "split").  ``target``: the collude target
    the set-up kernel drew (``TrialSetup.target``); without it the
    target is drawn here (:func:`collude_target`)."""
    if not needs_target(cfg):
        return None
    if target is None:
        target = collude_target(cfg, k_rounds, partitionable=partitionable)
    return AdversaryCtx(collude_target=target, v_sent=v_sent)


def sample_attacks_round(cfg: QBAConfig, k_round: torch.Tensor,
                         round_idx: int | None = None,
                         ctx: AdversaryCtx | None = None, *,
                         partitionable: bool | None = None):
    """One round's ``(attack int32, rand_v int32, late bool)``, each
    ``[..., n_cells, n_lieutenants]`` indexed by ``(sender * slots +
    slot, receiver)``, under ``cfg.strategy`` and ``cfg.attack_scope``
    (see the JAX function for each law)."""
    n_cells, n_rv = cfg.n_lieutenants * cfg.slots, cfg.n_lieutenants
    shape = (n_cells, n_rv)
    dev = k_round.device
    bound = STRATEGY_FORGE_BOUND[cfg.strategy](cfg)
    if bound > cfg.w:
        raise ValueError(
            f"strategy {cfg.strategy!r} forges orders in [0, {bound}), "
            f"outside the value domain [0, {cfg.w}) the round engines "
            "are exact on"
        )
    p = jr.resolve_mode(partitionable)
    action, coin, rand_v = raw_attack_draws(cfg, k_round, partitionable=p)
    forge_p = None
    if cfg.strategy in ("reference", "collude"):
        drop = (action == 0) & (coin == 0)
        forge = action == 1
        clear_p = action == 2
        clear_l = action == 3
        if cfg.strategy == "collude":
            if ctx is None:
                raise ValueError(
                    "strategy='collude' requires ctx=adversary_ctx(...)"
                )
            rand_v = ctx.collude_target.to(torch.int32)[..., None, None]
            rand_v = rand_v.expand(action.shape).contiguous()
    elif cfg.strategy == "adaptive":
        if round_idx is None or ctx is None:
            raise ValueError(
                "strategy='adaptive' requires round_idx and "
                "ctx=adversary_ctx(...)"
            )
        u3 = action * 2 + coin
        if 2 * int(round_idx) > cfg.n_rounds:
            drop, forge, clear_p, clear_l = u3 == 4, u3 < 4, u3 == 5, u3 == 6
        else:
            drop, forge, clear_p, clear_l = u3 < 4, u3 == 6, u3 == 4, u3 == 5
        b2 = jr.bits(jr.fold_in(k_round, ADAPT_TAG), shape, partitionable=p)
        offset = ((b2 & 0xFFFFFF) % max(cfg.w - 1, 1)).to(torch.int32) + 1
        senders = torch.arange(n_cells, device=dev) // cfg.slots
        v_recv = ctx.v_sent.to(torch.int32)[..., senders][..., None]
        rand_v = (v_recv + offset) % cfg.w
    elif cfg.strategy == "split":
        forge_p = (action == 0) | (action == 1)
        forge = action == 1
        clear_l = action == 2
        drop = (action == 3) & (coin == 0)
        clear_p = torch.zeros_like(forge)
    else:  # pragma: no cover — config validation owns membership
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.attack_scope == "broadcast":
        senders = (torch.arange(n_cells, device=dev) // cfg.slots)[:, None]
        recv = torch.arange(n_rv, device=dev)[None, :]
        not_self = senders != recv
        last_forge = torch.cummax(
            torch.where(forge & not_self, recv, -1), dim=-1
        ).values
        forge = last_forge >= 0
        rand_v = torch.gather(rand_v, -1, last_forge.clamp(min=0))
        clear_p = torch.cummax((clear_p & not_self).to(torch.int32),
                               dim=-1).values > 0
        clear_l = torch.cummax((clear_l & not_self).to(torch.int32),
                               dim=-1).values > 0
    attack = (
        drop.to(torch.int32) * DROP_BIT
        + forge.to(torch.int32) * FORGE_BIT
        + clear_p.to(torch.int32) * CLEAR_P_BIT
        + clear_l.to(torch.int32) * CLEAR_L_BIT
    )
    if forge_p is not None:
        attack = attack + forge_p.to(torch.int32) * FORGE_P_BIT
    if cfg.delivery == "racy":
        late = jr.bernoulli(jr.fold_in(k_round, LATE_TAG), cfg.p_late, shape,
                            partitionable=p)
    else:
        late = torch.zeros(action.shape, dtype=torch.bool, device=dev)
    return attack, rand_v.to(torch.int32), late


def corrupt_at_delivery(cfg: QBAConfig, draws, packet: Packet,
                        sender_honest: torch.Tensor):
    """Apply the effective edits ``draws = (attack, rand_v)`` to delivered
    packets (all operands broadcast together): returns ``(packet',
    delivered)``; a no-op, always delivered, when the sender is honest."""
    attack, rand_v = draws
    biz = ~sender_honest
    delivered = ~(biz & ((attack & DROP_BIT) != 0))
    v = torch.where(biz & ((attack & FORGE_BIT) != 0), rand_v, packet.v)
    p_mask = packet.p_mask & ~(biz & ((attack & CLEAR_P_BIT) != 0))[..., None]
    p_mask = p_mask | (biz & ((attack & FORGE_P_BIT) != 0))[..., None]
    clear_l = biz & ((attack & CLEAR_L_BIT) != 0)
    ev = packet.evidence
    evidence = Evidence(
        vals=torch.where(clear_l[..., None, None], SENTINEL, ev.vals),
        lens=torch.where(clear_l[..., None], 0, ev.lens),
        count=torch.where(clear_l, 0, ev.count),
    )
    return Packet(p_mask=p_mask, v=v, evidence=evidence), delivered
