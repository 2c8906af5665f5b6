"""Message-level pure-Python backend (``backend="local"``) — counterpart of
:mod:`qba_tpu.backends.local_backend`.

An independent re-implementation of the protocol with the reference's
data model — Python sets of int positions, sets of tuples, per-party
mailboxes, explicit per-packet receive loops (``tfg.py:87-98,185-300,
337-348``) — instead of the masked tensors of :mod:`qba_tpu_torch.rounds`.

Its randomness is the batched runner's own key tree.  :func:`presample_batch`
draws a batch's dishonesty, lists, commander orders and every round's
attack draws on the keys' device in one batch — on CUDA the draws are one
launch of the draws kernel over every round and trial
(:func:`~qba_tpu_torch.ops.attack_draws.attack_draws`) — and copies them
to the host in one copy.  The message passing then runs on the host, as
the reference's QSD hands out its resources before the parties talk.  So
for any config and trial key the decisions and verdict equal the batched
runner's (``tests/test_torch_backends.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import TYPE_CHECKING

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import (
    CLEAR_L_BIT,
    CLEAR_P_BIT,
    DROP_BIT,
    FORGE_BIT,
    FORGE_P_BIT,
    effect_names,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops.attack_draws import attack_draws
from qba_tpu_torch.rounds.engine import setup_batch

if TYPE_CHECKING:  # pragma: no cover - typing only
    from qba_tpu_torch.obs import EventLog

# The presample is uint8 end to end (the draws kernel's tables, and the
# lists and orders packed beside them for the one host copy): values < w.
MAX_W = 256


def _consistent(v: int, L: set, w: int) -> bool:
    """The reference predicate over sets of tuples (``tfg.py:87-98``)."""
    if not L:
        return True
    lens = {len(t) for t in L}
    if len(lens) != 1:
        return False
    if not all(0 <= x <= w and x != v for t in L for x in t):
        return False
    n = next(iter(lens))
    return all(
        all(a[k] != b[k] for k in range(n))
        for a, b in itertools.combinations(L, 2)
    )


@dataclasses.dataclass(frozen=True)
class Presample:
    """A batch's presampled randomness on the host, trial-major:

    * ``honest`` bool ``[T, n_parties + 1]``, by rank (rank 0 the QSD);
    * ``lists`` uint8 ``[T, n_parties + 1, size_l]``;
    * ``v_sent`` uint8 ``[T, n_lieutenants]`` (equivocation applied) and
      ``v_comm`` uint8 ``[T]``;
    * ``attack``, ``rand_v``, ``late`` uint8 ``[T, n_rounds, n_pool,
      n_lieutenants]``: the draws kernel's packet-major tables, entry
      ``[t, round - 1, sender * slots + slot, receiver]``.
    """

    honest: np.ndarray
    lists: np.ndarray
    v_sent: np.ndarray
    v_comm: np.ndarray
    attack: np.ndarray
    rand_v: np.ndarray
    late: np.ndarray

    def __len__(self) -> int:
        return self.honest.shape[0]

    def trial(self, i: int):
        """Trial ``i``'s ``(honest, lists, v_sent list, v_comm int)``."""
        return (self.honest[i], self.lists[i],
                [int(x) for x in self.v_sent[i]], int(self.v_comm[i]))


def _fence(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def presample_batch(cfg: QBAConfig, keys: torch.Tensor,
                    timings: dict | None = None, *,
                    partitionable: bool | None = None) -> Presample:
    """Every message-level backend's randomness for trial keys ``[T, 2]``,
    drawn on their device with the batched runner's key tree: ``split(key,
    4)`` into dishonesty, lists, orders and rounds and the adversary
    context (:func:`~qba_tpu_torch.rounds.engine.setup_batch`: the set-up
    kernel on CUDA, a launch a form, its plain version on the CPU);
    every round's draws in one :func:`attack_draws` call (one kernel launch
    on CUDA, its plain version on the CPU); then one copy to the host.

    ``timings``, when a dict, receives the phases' seconds on the host
    clock, each fenced: ``setup_s`` (up to the draws), ``draws_s`` and
    ``copy_s``.  Raises past ``w = 256``: the presample is uint8.
    ``partitionable``: JAX's threefry mode (None: the current mode)."""
    if cfg.w > MAX_W:
        raise ValueError(
            f"the message-level backends presample uint8 draws and lists "
            f"(w <= {MAX_W}); got w={cfg.w} (n_parties={cfg.n_parties})")
    dev, p = keys.device, jr.resolve_mode(partitionable)
    t0 = time.perf_counter()
    s, ctx = setup_batch(cfg, keys, partitionable=p, full_lists=True)
    honest, lists, v_sent, v_comm = s.honest, s.lists, s.v_sent, s.v_comm
    k_rounds = s.k_rounds.contiguous()
    if timings is not None:
        _fence(dev)
        t1 = time.perf_counter()
        timings["setup_s"] = t1 - t0
    draws = attack_draws(cfg, k_rounds, ctx, partitionable=p)
    if timings is not None:
        _fence(dev)
        t2 = time.perf_counter()
        timings["draws_s"] = t2 - t1
    parts = (honest, lists, v_sent, v_comm, *draws)
    flat = torch.cat([p.to(torch.uint8).reshape(-1) for p in parts])
    host = flat.cpu().numpy()
    if timings is not None:
        timings["copy_s"] = time.perf_counter() - t2
    out, off = [], 0
    for p in parts:
        out.append(host[off:off + p.numel()].reshape(tuple(p.shape)))
        off += p.numel()
    return Presample(out[0].astype(bool), *out[1:])


def emit_host_phases(cfg: QBAConfig, log, trial, honest, lists, v_comm,
                     v_sent) -> None:
    """The host-side (rank-0-visible) trail phases shared by the
    message-level backends: per-party dishonesty (``tfg.py:124``),
    particle lists (``tfg.py:159-162``), commander state and
    equivocation (``tfg.py:328-330,169-181``)."""
    for rank in range(1, cfg.n_parties + 1):
        log.debug("dishonesty", "party role", trial=trial, rank=rank,
                  honest=bool(honest[rank]))
    for rank in range(cfg.n_parties + 1):
        row = [int(x) for x in lists[rank][:16]]
        log.debug("particles", "list received", trial=trial, rank=rank,
                  head=row, size_l=cfg.size_l)
    n_qcorr = int(np.sum(lists[0] != lists[1]))
    log.info("step2", "commander order", trial=trial, v=v_comm,
             n_qcorr=n_qcorr, commander_honest=bool(honest[1]))
    if len(set(v_sent)) > 1:
        log.info("step2", "commander equivocates", trial=trial,
                 orders=sorted(set(v_sent)))


def emit_verdict(log, trial, decisions, honest_parties, success) -> None:
    """The rank-0 verdict triple (``tfg.py:360-363``), the shared trail
    tail of the message-level backends."""
    log.info(
        "decision", "verdict", trial=trial, decisions=decisions,
        dishonest=[i + 1 for i, h in enumerate(honest_parties) if not h],
        success=success,
    )


def run_trial_local(
    cfg: QBAConfig,
    key: torch.Tensor,
    log: "EventLog | None" = None,
    trial: int = 0,
    *,
    partitionable: bool | None = None,
) -> dict:
    """One protocol execution over Python sets for trial key ``[2]``;
    returns the rank-0 summary (``tfg.py:351-363``) plus diagnostics
    mirroring ``TrialResult``: ``success``, ``decisions``, ``honest``,
    ``v_comm``, ``vi`` (sets) and ``overflow``.

    With ``log`` the full protocol event trail is emitted, the structured
    equivalent of every ``mpi_print`` site of the reference: phase
    summaries at INFO, per-packet events at DEBUG.  ``partitionable``:
    JAX's threefry mode (None: the current mode)."""
    return local_trial(cfg, presample_batch(cfg, key[None],
                                            partitionable=partitionable),
                       0, log, trial)


def run_trials_local(cfg: QBAConfig, keys: torch.Tensor, log=None,
                     first_trial: int = 0,
                     log_limit: int | None = None, *,
                     partitionable: bool | None = None) -> list[dict]:
    """A batch of :func:`run_trial_local` executions over one presample.
    ``log_limit`` bounds the trail to the first trials (the CLI's
    ``--max-verdicts``)."""
    pre = presample_batch(cfg, keys, partitionable=partitionable)
    return [local_trial(cfg, pre, i,
                        log if log_limit is None or i < log_limit else None,
                        first_trial + i)
            for i in range(len(pre))]


def local_trial(cfg: QBAConfig, pre: Presample, i: int, log=None,
                trial: int = 0) -> dict:
    """Trial ``i`` of a presample over Python sets (the body of
    :func:`run_trial_local`)."""
    honest, lists, v_sent, v_comm = pre.trial(i)

    n_lieu, w, slots = cfg.n_lieutenants, cfg.w, cfg.slots
    li = [[int(x) for x in lists[r + 2]] for r in range(n_lieu)]
    vi: list[set] = [set() for _ in range(n_lieu)]
    overflow = False

    if log:
        emit_host_phases(cfg, log, trial, honest, lists, v_comm, v_sent)

    # Step 1b: the commander's recovered Q-correlated positions
    # (tfg.py:325-328).
    isq = {k for k in range(cfg.size_l) if lists[0][k] != lists[1][k]}

    # Step 2 + 3a (tfg.py:166-196): per-sender packet lists; the list
    # index is the mailbox slot (the pool's numbering).
    mailbox: list[list] = [[] for _ in range(n_lieu)]
    for r in range(n_lieu):
        p = {k for k in isq if int(lists[1][k]) == v_sent[r]}
        v = v_sent[r]
        if log:
            # tfg.py:203: the commander's send to lieutenant rank r+2.
            log.debug("step2", "send", trial=trial, sender=1, dest=r + 2,
                      v=v, p_size=len(p), l_size=0)
        ell = {tuple(li[r][j] for j in sorted(p))}
        ok = _consistent(v, ell, w)
        if ok:
            vi[r].add(v)
            mailbox[r].append((p, v, ell))
        if log:
            # tfg.py:190: step 3a receive and accept/reject.
            log.debug("step3a", "receive", trial=trial, rank=r + 2, v=v,
                      accepted=ok, reason="accepted" if ok else "inconsistent")

    # Step 3b (tfg.py:337-348): synchronous rounds, each delivery's draws
    # read from the presampled tables at [cell, receiver].
    #
    # Under racy_mode="defer" a late packet is delivered at the start of
    # the NEXT round's drain, where the len(L) == round+1 check
    # (tfg.py:294) necessarily rejects it; it is corrupted at deferral
    # time with the ORIGINAL round's draws (the reference corrupts at
    # send time, before the race).
    deferred: list[list] = [[] for _ in range(n_lieu)]
    for rnd in range(1, cfg.n_rounds + 1):
        a_att = pre.attack[i, rnd - 1].tolist()
        a_rv = pre.rand_v[i, rnd - 1].tolist()
        a_late = pre.late[i, rnd - 1].tolist()
        out: list[list] = [[] for _ in range(n_lieu)]
        next_deferred: list[list] = [[] for _ in range(n_lieu)]

        def lieu_receive(recv, sender_rank, p2, v2, ell2, was_deferred=False):
            """tfg.py:289-300 for one delivered packet."""
            nonlocal overflow
            ell2 = set(ell2)
            ell2.add(tuple(li[recv][j] for j in sorted(p2)))
            if not _consistent(v2, ell2, w):
                reason = "inconsistent"
            elif v2 in vi[recv]:
                reason = "duplicate-v"
            elif len(ell2) != rnd + 1:
                reason = "wrong-evidence-len"
            else:
                reason = "accepted"
            if log:
                fields = dict(
                    trial=trial, round=rnd, sender=sender_rank,
                    recv=recv + 2, v=v2,
                    accepted=reason == "accepted", reason=reason,
                )
                if was_deferred:
                    fields["deferred"] = True
                log.debug("round", "receive", **fields)
            if reason == "accepted":
                vi[recv].add(v2)
                if rnd <= cfg.n_dishonest:
                    if len(out[recv]) < slots:
                        out[recv].append((p2, v2, ell2))
                        if log:
                            # tfg.py:229: the accepted packet is
                            # rebroadcast to every peer.
                            log.debug(
                                "round", "send", trial=trial,
                                round=rnd, sender=recv + 2, v=v2,
                                p_size=len(p2), l_size=len(ell2),
                                broadcast=True,
                            )
                    else:
                        overflow = True

        # Deferred arrivals from the previous round drain first, in
        # (sender, slot) order.
        for recv in range(n_lieu):
            for sender_rank, p2, v2, ell2 in deferred[recv]:
                lieu_receive(recv, sender_rank, p2, v2, ell2,
                             was_deferred=True)

        for recv in range(n_lieu):
            for sender in range(n_lieu):
                for slot in range(min(slots, len(mailbox[sender]))):
                    if sender == recv:
                        continue
                    p, v, ell = mailbox[sender][slot]
                    cell = sender * slots + slot
                    bits, rand_v = a_att[cell][recv], a_rv[cell][recv]
                    late = bool(a_late[cell][recv])
                    if late and cfg.racy_mode == "loss":
                        if log:
                            log.debug("round", "late loss", trial=trial,
                                      round=rnd, sender=sender + 2,
                                      recv=recv + 2)
                        continue
                    p2, v2, ell2 = set(p), v, set(ell)
                    if not honest[sender + 2]:  # tfg.py:271-284
                        if log:
                            # tfg.py:275-284 "The action for general N".
                            log.debug("round", "attack", trial=trial,
                                      round=rnd, sender=sender + 2,
                                      recv=recv + 2,
                                      action=effect_names(bits))
                        if bits & DROP_BIT:
                            continue
                        if bits & FORGE_BIT:
                            v2 = rand_v
                        if bits & CLEAR_P_BIT:
                            p2 = set()
                        if bits & CLEAR_L_BIT:
                            ell2 = set()
                        if bits & FORGE_P_BIT:
                            # Worst-case P-set forgery: the fabricated
                            # all-positions mask wins over clear.
                            p2 = set(range(cfg.size_l))
                    if late:  # racy_mode == "defer"
                        if log:
                            log.debug("round", "late defer", trial=trial,
                                      round=rnd, sender=sender + 2,
                                      recv=recv + 2)
                        next_deferred[recv].append((sender + 2, p2, v2, ell2))
                        continue
                    lieu_receive(recv, sender + 2, p2, v2, ell2)
        if log:
            for r in range(n_lieu):
                log.debug("round", "vi", trial=trial, round=rnd, rank=r + 2,
                          vi=sorted(vi[r]))
        mailbox = out
        deferred = next_deferred

    # Decision and verdict (tfg.py:303-306,351-363; the empty-Vi sentinel
    # is w).
    decisions = [v_comm] + [
        min(vi[r]) if vi[r] else cfg.no_decision for r in range(n_lieu)
    ]
    honest_parties = [bool(h) for h in honest[1:]]
    filtered = {d for d, h in zip(decisions, honest_parties) if h}
    if log:
        emit_verdict(log, trial, decisions, honest_parties,
                     len(filtered) == 1)
    return {
        "success": len(filtered) == 1,
        "decisions": decisions,
        "honest": honest_parties,
        "v_comm": v_comm,
        "vi": [set(s) for s in vi],
        "overflow": overflow,
    }
