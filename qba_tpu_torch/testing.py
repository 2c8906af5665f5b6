"""Seeded random inputs for holding the port's kernels against their
plain versions.

The protocol hands a kernel only protocol-shaped state: counts that match
the round, lens that agree, rows that never collide, lieutenants whose
own rows are consistent.  These inputs also reach the branches that guard
against the rest: the verdict's rejections of out-of-range values,
colliding rows, disagreeing lens and rows equal to the receiver's own,
accepted matrices denser than the protocol makes, and step 3a's rejection
of inconsistent lieutenants.  The tests compare the plain versions with
the JAX package on :func:`random_state`; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` compare each kernel with its plain version on
:func:`random_round_inputs`, :func:`dense_acc`,
:func:`random_trial_inputs`, :func:`random_mailbox_inputs` (the same
packets at their own cells of a dense mailbox) and
:func:`random_circuit` (complex gates, multi-control ops and ``XPOW``),
and the party-sharded round kernels with their plain versions on
:func:`random_shard_inputs` (assembled pools with an empty segment, a
full one and stale entries between the segments) and
:func:`random_shard_mailbox_inputs` (gathered mailboxes whose unsent
cells hold stale packets);
and the GF(2) sweep with its plain version on :func:`random_sweep_inputs`
(the tableaux of :func:`random_clifford` circuits, random phases, coins
and readout flips).  Everything is made with numpy from a seed.

:data:`GOLD_PINS` are the repo's fixed, recorded outputs, which the tests
and ``chip_smoke.py`` hold the port to in JAX's legacy threefry mode.
"""

from __future__ import annotations

import numpy as np
import torch

# The repo's golden pins, copied from tests/test_strategies.py:63-76
# (GOLD_5P and GOLD_11P: the reference strategy without noise, recorded
# in JAX's legacy threefry mode, jax_threefry_partitionable=False): the
# config's fields, then each trial's success and decisions (commander
# first) of run_trials(cfg, trial_keys(cfg)).
GOLD_PINS = (
    ("GOLD_5P",
     dict(n_parties=5, size_l=16, n_dishonest=2, trials=6, seed=2026),
     [False, True, True, False, True, False],
     [[5, 0, 5, 0, 5], [6, 6, 6, 6, 6], [4, 4, 4, 4, 4],
      [7, 3, 2, 2, 2], [1, 0, 0, 0, 0], [4, 2, 4, 2, 2]]),
    ("GOLD_11P",
     dict(n_parties=11, size_l=8, n_dishonest=3, trials=4, seed=77),
     [True, False, True, False],
     [[2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2],
      [7, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0],
      [9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9],
      [6, 15, 15, 15, 15, 15, 2, 2, 2, 2, 2]]),
)

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.convert import (
    draws_from_numpy,
    mailbox_from_numpy,
    pool_from_numpy,
)
from qba_tpu_torch.ops.round_kernel_tiled import pack_acc


def random_draws(rng, cfg: QBAConfig, shape):
    """Attack bits, forged values and late flags of ``shape`` (numpy
    int32): half the attacks empty, the forge-P bit only under the
    ``split`` strategy, one delivery in ten late."""
    top = 32 if cfg.strategy == "split" else 16
    att = rng.integers(0, top, shape).astype(np.int32)
    att[rng.random(shape) < 0.5] = 0
    rv = rng.integers(0, cfg.n_parties + 1, shape).astype(np.int32)
    late = (rng.random(shape) < 0.1).astype(np.int32)
    return att, rv, late


def random_state(rng, cfg: QBAConfig, round_idx: int):
    """One trial's numpy round inputs in the JAX kernel's layout: a
    compacted pool of protocol-shaped packets (rows over one P, values
    mostly distinct per position, counts around the round's evidence
    length, some rows equal to a receiver's own row), random li/vi,
    honesty and draws."""
    n_rv, slots, s, w = cfg.n_lieutenants, cfg.slots, cfg.size_l, cfg.w
    n_pool = n_rv * slots
    li = rng.integers(0, w, (n_rv, s)).astype(np.int32)
    n_live = int(rng.integers(1, n_pool + 1))
    cells = np.sort(rng.choice(n_pool, n_live, replace=False))
    vals, lens, p, meta = random_packets(rng, cfg, round_idx, cells, li,
                                         n_pool)
    vi = (rng.random((n_rv, w)) < 0.05).astype(np.int32)
    sender_honest = rng.random(n_rv) < 0.6
    hc = np.repeat(sender_honest, slots).astype(np.int32)[:, None]
    att, rv, late = random_draws(rng, cfg, (n_pool, n_rv))
    return (vals, lens, p, meta), li, vi, hc, att, rv, late


def random_packets(rng, cfg: QBAConfig, round_idx: int, cells, li, cap):
    """A compacted pool of capacity ``cap`` (numpy, the JAX layout)
    holding one protocol-shaped packet per cell of ``cells``, in order,
    and empty entries after them (see :func:`random_state`)."""
    n_rv, max_l, s, w = cfg.n_lieutenants, cfg.max_l, cfg.size_l, cfg.w
    vals = np.full((max_l, cap, s), -1, np.int32)
    lens = np.zeros((cap, max_l), np.int32)
    p = np.zeros((cap, s), np.int32)
    meta = np.zeros((cap, 4), np.int32)
    for i, cell in enumerate(cells):
        pm = rng.random(s) < 0.4
        count = int(rng.choice([round_idx, round_idx + 1,
                                rng.integers(0, max_l + 1)]))
        for r in range(count):
            vals[r, i, pm] = rng.integers(0, w, pm.sum())
        if rng.random() < 0.7:
            for j in np.flatnonzero(pm):
                vals[:count, i, j] = rng.permutation(w)[:count]
        if count and rng.random() < 0.2:  # a receiver's own row already in L
            vals[count - 1, i] = np.where(pm, li[rng.integers(n_rv)], -1)
        lens[i, :count] = pm.sum() if rng.random() < 0.9 else rng.integers(s)
        p[i] = pm
        meta[i] = (count, rng.integers(w), 1, cell)
    return vals, lens, p, meta


def random_shard_inputs(cfg: QBAConfig, n_tp: int, round_idx: int,
                        n_trials: int, seed: int, device=None):
    """One round's inputs to the party-sharded pool rounds
    (``fused_round``, ``tiled_verdict`` and ``tiled_rebuild`` with
    ``n_recv=n_lieutenants // n_tp``): ``(pool, li,
    vi, honest_c, attack, rand_v, late)`` with ``pool`` ``[n_tp, T, ...]``
    (every shard's copy of the assembled pool), ``li``/``vi`` ``[n_tp, T,
    n_local, ...]`` and the honesty and draws global.

    Each assembled pool is the shards' segments in tp order, each
    segment its shard's senders' packets (:func:`random_packets`)
    compacted at its front.  Shard 0's segment is empty in trial 0 and
    the last shard's full (every cell of its senders) in trial 1; the
    entries past a segment's packets are unsent but hold stale packets
    (random rows, counts, values and cells), which no kernel may read.
    A small ``slots`` makes receivers overflow."""
    rng = np.random.default_rng(seed)
    n_rv, slots, w = cfg.n_lieutenants, cfg.slots, cfg.w
    n_local, n_pool = n_rv // n_tp, n_rv * slots
    seg = n_local * slots
    pools, lis, vis, hcs, draws = [], [], [], [], []
    for t in range(n_trials):
        li = rng.integers(0, w, (n_rv, cfg.size_l)).astype(np.int32)
        parts = []
        for sh in range(n_tp):
            own = np.arange(sh * seg, (sh + 1) * seg)
            if t == 0 and sh == 0:
                cells = own[:0]
            elif t == 1 and sh == n_tp - 1:
                cells = own
            else:
                cells = np.sort(rng.choice(own, int(rng.integers(seg + 1)),
                                           replace=False))
            part = random_packets(rng, cfg, round_idx, cells, li, seg)
            stale = random_packets(rng, cfg, round_idx,
                                   rng.integers(0, n_pool, seg), li, seg)
            dead = slice(len(cells), seg)
            part[0][:, dead] = stale[0][:, dead]
            for a, b in zip(part[1:], stale[1:]):
                a[dead] = b[dead]
            part[3][dead, 2] = 0  # unsent
            parts.append(part)
        pools.append([np.concatenate([q[i] for q in parts], axis=1 if i == 0
                                     else 0) for i in range(4)])
        lis.append(li)
        vis.append((rng.random((n_rv, w)) < 0.05).astype(np.int32))
        hcs.append(np.repeat(rng.random(n_rv) < 0.6, slots).astype(np.int32))
        draws.append(random_draws(rng, cfg, (n_pool, n_rv)))
    pool = pool_from_numpy(*(np.stack([q[i] for q in pools])
                             for i in range(4)), device=device)
    pool = tuple(x.expand((n_tp,) + x.shape).contiguous() for x in pool)

    def shards(xs):
        x = torch.from_numpy(np.ascontiguousarray(np.stack(xs))).to(
            device, torch.int32)
        return x.reshape((n_trials, n_tp, n_local) + x.shape[2:]) \
            .movedim(1, 0).contiguous()

    hc = torch.from_numpy(np.stack(hcs)).to(device, torch.int32)
    return (pool, shards(lis), shards(vis), hc,
            *draws_from_numpy(*(np.stack(d) for d in zip(*draws)),
                              device=device))


def random_shard_mailbox_state(rng, cfg: QBAConfig, n_tp: int,
                               round_idx: int, trial: int):
    """One trial's inputs to the party-sharded dense-mailbox round, in
    the JAX round kernel's packed layout (see
    :func:`random_mailbox_state`): the gathered GLOBAL mailbox, then li,
    vi, honesty and draws for every receiver.

    Each shard's senders send a random subset of their cells (none of
    shard 0's in trial 0, all of the last shard's in trial 1), each a
    protocol-shaped packet (:func:`random_packets`) at its own cell; every
    unsent cell holds a stale packet (random rows, lens, count and
    value), which no kernel may read."""
    n_rv, slots, w = cfg.n_lieutenants, cfg.slots, cfg.w
    n_pk, seg = n_rv * slots, n_rv // n_tp * slots
    li = rng.integers(0, w, (n_rv, cfg.size_l)).astype(np.int32)
    sent = np.zeros(n_pk, bool)
    for sh in range(n_tp):
        own = np.arange(sh * seg, (sh + 1) * seg)
        k = (0 if (trial, sh) == (0, 0) else seg if (trial, sh) == (1, n_tp - 1)
             else int(rng.integers(seg + 1)))
        sent[rng.choice(own, k, replace=False)] = True
    cells = np.flatnonzero(sent)
    vals, lens, p, meta = random_packets(rng, cfg, round_idx, cells, li, n_pk)
    s_vals, s_lens, s_p, s_meta = random_packets(
        rng, cfg, round_idx, np.arange(n_pk), li, n_pk)
    live = slice(0, len(cells))
    s_vals[:, cells], s_lens[cells], s_p[cells] = (
        vals[:, live], lens[live], p[live])
    s_meta[cells] = meta[live]
    s_meta[~sent, 2] = 0
    packed = (s_vals, s_lens, s_meta[:, 0:1], s_p, s_meta[:, 1:2],
              s_meta[:, 2:3])
    vi = (rng.random((n_rv, w)) < 0.05).astype(np.int32)
    hc = np.repeat(rng.random(n_rv) < 0.6, slots).astype(np.int32)
    return (packed, li, vi, hc, *random_draws(rng, cfg, (n_pk, n_rv)))


def random_shard_mailbox_inputs(cfg: QBAConfig, n_tp: int, round_idx: int,
                                n_trials: int, seed: int, device=None):
    """``n_trials`` trials of :func:`random_shard_mailbox_state` as one
    round's inputs to ``round_step(..., n_recv=n_lieutenants // n_tp)``:
    ``(mailbox, li, vi, honest_pk, attack, rand_v, late)`` with the
    mailbox ``[n_tp, T, ...]`` (every shard's copy of the gathered one),
    ``li``/``vi`` ``[n_tp, T, n_local, ...]`` and honesty and draws
    global."""
    rng = np.random.default_rng(seed)
    states = [random_shard_mailbox_state(rng, cfg, n_tp, round_idx, t)
              for t in range(n_trials)]
    packed, lis, vis, hcs, atts, rvs, lates = zip(*states)
    mailbox = mailbox_from_numpy(*(np.stack([m[i] for m in packed])
                                   for i in range(6)), device=device)
    mailbox = tuple(x.expand((n_tp,) + x.shape).contiguous()
                    for x in mailbox)
    n_local = cfg.n_lieutenants // n_tp

    def shards(xs):
        x = torch.from_numpy(np.ascontiguousarray(np.stack(xs))).to(
            device, torch.int32)
        return x.reshape((n_trials, n_tp, n_local) + x.shape[2:]) \
            .movedim(1, 0).contiguous()

    hc = torch.from_numpy(np.stack(hcs)).to(device, torch.int32)
    return (mailbox, shards(lis), shards(vis), hc,
            *draws_from_numpy(np.stack(atts), np.stack(rvs), np.stack(lates),
                              device=device))


def random_mailbox_state(rng, cfg: QBAConfig, round_idx: int):
    """:func:`random_state` with its pool's packets at their own cells of
    a dense mailbox, in the JAX round kernel's packed layout: ``(vals
    [max_l, n_pk, S], lens, count [n_pk, 1], p, v [n_pk, 1], sent [n_pk,
    1])``, then li, vi, honesty and draws as :func:`random_state`."""
    (vals, lens, p, meta), *rest = random_state(rng, cfg, round_idx)
    live = meta[:, 2] != 0
    cells = meta[live, 3]
    d_vals, d_lens, d_p = np.full_like(vals, -1), np.zeros_like(lens), \
        np.zeros_like(p)
    d_meta = np.zeros((meta.shape[0], 3), np.int32)
    d_vals[:, cells] = vals[:, live]
    d_lens[cells], d_p[cells] = lens[live], p[live]
    d_meta[cells] = meta[live, :3]
    packed = (d_vals, d_lens, d_meta[:, 0:1], d_p, d_meta[:, 1:2],
              d_meta[:, 2:3])
    return (packed, *rest)


def random_mailbox_inputs(cfg: QBAConfig, round_idx: int, n_trials: int,
                          seed: int, device=None):
    """``n_trials`` trials of :func:`random_mailbox_state` as one round's
    inputs to ``round_step``: ``(mailbox, li, vi, honest_pk, attack,
    rand_v, late)`` in the kernel's dtypes."""
    rng = np.random.default_rng(seed)
    states = [random_mailbox_state(rng, cfg, round_idx)
              for _ in range(n_trials)]
    packed, lis, vis, hcs, atts, rvs, lates = zip(*states)
    mailbox = mailbox_from_numpy(*(np.stack([m[i] for m in packed])
                                   for i in range(6)), device=device)

    def i32(xs):
        return torch.from_numpy(np.ascontiguousarray(np.stack(xs))).to(
            device, torch.int32)

    return (mailbox, i32(lis), i32(vis), i32([h[:, 0] for h in hcs]),
            *draws_from_numpy(np.stack(atts), np.stack(rvs), np.stack(lates),
                              device=device))


def random_round_inputs(cfg: QBAConfig, round_idx: int, n_trials: int,
                        seed: int, device=None):
    """``n_trials`` trials of :func:`random_state` as one round's inputs to
    the round wrappers: ``(pool, li, vi, honest_c, attack, rand_v,
    late)`` in the kernels' dtypes."""
    rng = np.random.default_rng(seed)
    states = [random_state(rng, cfg, round_idx) for _ in range(n_trials)]
    pools, lis, vis, hcs, atts, rvs, lates = zip(*states)
    pool = pool_from_numpy(*(np.stack([p[i] for p in pools])
                             for i in range(4)), device=device)

    def i32(xs):
        return torch.from_numpy(np.ascontiguousarray(np.stack(xs))).to(
            device, torch.int32)

    return (pool, i32(lis), i32(vis), i32([h[:, 0] for h in hcs]),
            *draws_from_numpy(np.stack(atts), np.stack(rvs), np.stack(lates),
                              device=device))


def dense_acc(cfg: QBAConfig, pool, seed: int, rate: float = 0.5,
              n_local: int | None = None):
    """An accepted matrix for ``pool`` as the verdict returns it (one
    receiver mask a packet, int64 ``[T, n_pool]``), far denser than the
    protocol makes: each sent (packet, receiver) pair with probability
    ``rate`` (many slots per receiver, overflow wherever the slot bound
    is small).  ``n_local`` keeps the first ``n_local`` receivers' bits
    (a shard's)."""
    rng = np.random.default_rng(seed)
    meta = pool[3].cpu().numpy()
    acc = ((rng.random(meta.shape[:2] + (cfg.n_lieutenants,)) < rate)
           & (meta[..., 2:3] != 0))
    return pack_acc(torch.from_numpy(acc[..., :n_local])).to(pool[3].device)


def random_trial_inputs(cfg: QBAConfig, n_trials: int, seed: int,
                        device=None):
    """Whole trials' inputs to the megakernel wrapper: ``(p_rows bool,
    li int32, v_sent int32, honest_c int32, attack, rand_v, late)``, the
    draws stacked ``[T, n_rounds, n_pool, n_rv]`` uint8.

    Each lieutenant's P avoids its order ``v`` (a consistent packet);
    then in some rows a P position is set to ``v``, to a value above
    ``w``, to a negative value or to the SENTINEL -1 (which the rule
    ignores), so step 3a rejects some lieutenants and keeps others.
    """
    rng = np.random.default_rng(seed)
    n_rv, s, w, slots = cfg.n_lieutenants, cfg.size_l, cfg.w, cfg.slots
    n_pool = n_rv * slots
    li = rng.integers(0, w, (n_trials, n_rv, s)).astype(np.int32)
    v_sent = rng.integers(0, w, (n_trials, n_rv)).astype(np.int32)
    p_rows = (rng.random((n_trials, n_rv, s)) < 0.4) & (li != v_sent[..., None])
    for t in range(n_trials):
        for r in range(n_rv):
            j = int(rng.integers(s))
            u = rng.random()
            if u < 0.15:
                li[t, r, j] = v_sent[t, r]
            elif u < 0.2:
                li[t, r, j] = w + 1
            elif u < 0.25:
                li[t, r, j] = -2
            elif u < 0.35:
                li[t, r, j] = -1
            else:
                continue
            p_rows[t, r, j] = True
    honest = rng.random((n_trials, n_rv)) < 0.6
    hc = np.repeat(honest, slots, axis=1).astype(np.int32)
    draws = random_draws(rng, cfg, (n_trials, cfg.n_rounds, n_pool, n_rv))

    def t_(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return (t_(p_rows, torch.bool), t_(li, torch.int32),
            t_(v_sent, torch.int32), t_(hc, torch.int32),
            *(x.contiguous() for x in draws_from_numpy(*draws,
                                                       device=device)))


def random_circuit(n_qubits: int, n_ops: int, seed: int, n_params: int = 3,
                   real: bool = False):
    """A seeded random op list for the circuit engines, as plain tuples
    ``(kind, target, controls, param, angle)``
    (:func:`qba_tpu_torch.convert.circuit_ops_from_tuples`): the fixed
    gates, the rotation families with random angles, ``XPOW`` on
    ``n_params`` runtime bits, and up to three controls per op; with
    ``real`` only the real gates (H, X, Z, RY, ``XPOW``).  Starts with an
    H on every qubit so that every amplitude is live."""
    rng = np.random.default_rng(seed)
    kinds = (("H", "X", "Z", "RY", "XPOW") if real else
             ("H", "X", "Y", "Z", "S", "T", "RX", "RY", "RZ", "P", "XPOW"))
    ops = [("H", q, (), None, None) for q in range(n_qubits)]
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(len(kinds)))]
        target = int(rng.integers(n_qubits))
        others = [q for q in range(n_qubits) if q != target]
        n_ctrl = int(rng.choice([0, 0, 1, 2, 3]))
        controls = tuple(int(c) for c in rng.choice(
            others, size=min(n_ctrl, len(others)), replace=False))
        param = int(rng.integers(n_params)) if kind == "XPOW" else None
        angle = (float(rng.uniform(-np.pi, np.pi))
                 if kind in ("RX", "RY", "RZ", "P") else None)
        ops.append((kind, target, controls, param, angle))
    return ops


def random_clifford(n_qubits: int, n_ops: int, seed: int, n_params: int = 3):
    """A seeded random Clifford op list for the stabilizer engines, as
    plain tuples ``(kind, target, controls, param, angle)``: H, X, Y, Z,
    CNOT, CZ and ``XPOW`` on ``n_params`` runtime bits.  Half the qubits
    start with an H, so that measurements are random and deterministic,
    and the CNOTs and CZs entangle them, so that pivots fall past the
    first stabilizer row."""
    rng = np.random.default_rng(seed)
    ops = [("H", q, (), None, None) for q in range(0, n_qubits, 2)]
    for _ in range(n_ops):
        kind = ("H", "X", "Y", "Z", "CNOT", "CNOT", "CZ", "XPOW")[
            int(rng.integers(8))]
        target = int(rng.integers(n_qubits))
        if kind in ("CNOT", "CZ"):
            c = int(rng.choice([q for q in range(n_qubits) if q != target]))
            ops.append(("X" if kind == "CNOT" else "Z", target, (c,), None,
                        None))
        elif kind == "XPOW":
            ops.append(("XPOW", target, (), int(rng.integers(n_params)),
                        None))
        else:
            ops.append((kind, target, (), None, None))
    return ops


def random_sweep_inputs(n_qubits: int, n_shots: int, seed: int,
                        device=None):
    """Inputs to :func:`~qba_tpu_torch.ops.gf2_sweep.gf2_sweep`: the
    tableaux of two :func:`random_clifford` circuits as families
    (``xw``, ``zw`` int32 ``[2, 2n, W]``), then per shot uint8 random
    phases ``[B, 2n]``, coins ``[B, n]``, a family ``[B]`` and readout
    flips ``[B, n]`` (one bit in ten)."""
    from qba_tpu_torch.convert import circuit_ops_from_tuples
    from qba_tpu_torch.gf2 import compile_symplectic, pack_bits

    rng = np.random.default_rng(seed)
    progs = [compile_symplectic(
        n_qubits, circuit_ops_from_tuples(random_clifford(
            n_qubits, 4 * n_qubits, seed + i)), 3) for i in range(2)]
    xw = torch.stack([pack_bits(torch.from_numpy(p.x)) for p in progs])
    zw = torch.stack([pack_bits(torch.from_numpy(p.z)) for p in progs])

    def u8(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.uint8)).to(
            device)

    r = rng.integers(0, 2, (n_shots, 2 * n_qubits))
    coins = rng.integers(0, 2, (n_shots, n_qubits))
    family = rng.integers(0, 2, n_shots)
    mflip = rng.random((n_shots, n_qubits)) < 0.1
    return (xw.to(device), zw.to(device), u8(r), u8(coins), u8(family),
            u8(mflip))
