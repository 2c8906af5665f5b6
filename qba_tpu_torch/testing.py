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
:func:`random_circuit` (complex gates, multi-control ops and ``XPOW``);
and the GF(2) sweep with its plain version on :func:`random_sweep_inputs`
(the tableaux of :func:`random_clifford` circuits, random phases, coins
and readout flips).  Everything is made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.convert import (
    draws_from_numpy,
    mailbox_from_numpy,
    pool_from_numpy,
)


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
    n_rv, slots, max_l, s, w = (cfg.n_lieutenants, cfg.slots, cfg.max_l,
                                cfg.size_l, cfg.w)
    n_pool = n_rv * slots
    vals = np.full((max_l, n_pool, s), -1, np.int32)
    lens = np.zeros((n_pool, max_l), np.int32)
    p = np.zeros((n_pool, s), np.int32)
    meta = np.zeros((n_pool, 4), np.int32)
    li = rng.integers(0, w, (n_rv, s)).astype(np.int32)
    n_live = int(rng.integers(1, n_pool + 1))
    cells = np.sort(rng.choice(n_pool, n_live, replace=False))
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
    vi = (rng.random((n_rv, w)) < 0.05).astype(np.int32)
    sender_honest = rng.random(n_rv) < 0.6
    hc = np.repeat(sender_honest, slots).astype(np.int32)[:, None]
    att, rv, late = random_draws(rng, cfg, (n_pool, n_rv))
    return (vals, lens, p, meta), li, vi, hc, att, rv, late


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


def dense_acc(cfg: QBAConfig, pool, seed: int, rate: float = 0.5):
    """An accepted matrix int32 0/1 ``[T, n_pool, n_rv]`` for ``pool``, far
    denser than the protocol makes: each sent (packet, receiver) pair
    with probability ``rate`` (many slots per receiver, overflow wherever
    the slot bound is small)."""
    rng = np.random.default_rng(seed)
    meta = pool[3].cpu().numpy()
    acc = ((rng.random(meta.shape[:2] + (cfg.n_lieutenants,)) < rate)
           & (meta[..., 2:3] != 0)).astype(np.int32)
    return torch.from_numpy(acc).to(pool[3].device)


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


def random_circuit(n_qubits: int, n_ops: int, seed: int, n_params: int = 3):
    """A seeded random op list for the circuit engines, as plain tuples
    ``(kind, target, controls, param, angle)``
    (:func:`qba_tpu_torch.convert.circuit_ops_from_tuples`): the fixed
    gates, the rotation families with random angles, ``XPOW`` on
    ``n_params`` runtime bits, and up to three controls per op.  Starts
    with an H on every qubit so that every amplitude is live."""
    rng = np.random.default_rng(seed)
    kinds = ("H", "X", "Y", "Z", "S", "T", "RX", "RY", "RZ", "P", "XPOW")
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
