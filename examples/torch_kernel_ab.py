#!/usr/bin/env python3
"""Time the port's round kernels of one checkout on a CUDA card, to
compare two checkouts (a parent and a change) on one card.

    python3 examples/torch_kernel_ab.py ROOT [--config 33p|11p] [--reps N]
        [--kernels all|mega|round|gen|setup|batch] [--phases]
        [--circuit-cluster BYTES:MAX] [--circuit-pass-bits K]

imports ``qba_tpu_torch`` from the checkout at ``ROOT`` (built there on
first use), replays every round of a 1000-trial batch of the config with
the fused round kernel, and times on each round's inputs the
single-device fused round, tiled verdict, tiled rebuild and dense-mailbox
round kernels, and the ``n_recv`` variant of each at the config's ``tp``
(4 at 33p, 2 at 11p; each shard on its copy of the round's pool or
mailbox), where the checkout has it (CUDA events over ``--reps``
launches queued behind a sleep kernel, so that the host's launch rate
does not enter the times); then on the whole batch the trial megakernel
on the draws kernel's stacks, its keyed entry (which hashes its own
draws), the party-sharded keyed entry at the config's ``tp``, the keyed
gen entry on ``qsim_path="stabilizer"``, both keyed entries on the
first 64 trials (``*_x64``), and the draws kernel over every round (a
checkout needs ``qba_tpu_torch.ops.attack_draws``).  ``--kernels
mega`` skips the round kernels, ``--kernels round`` the megakernels and
the draws kernel.  ``--kernels gen`` times the list-generation kernels
instead (``gen_kernels``): the fused circuit kernel on the 5-party
Q-correlated circuit (18 qubits, real) at 64 runs (the dense path's
launch) and 132, the not-Q-correlated one at one run, and seeded
circuits of 17 qubits (complex) and 19 and 20 (real); the sweep kernel
over a 1000-trial batch of list positions at 11, 33 and 65 parties (as
``qsim_path="stabilizer"`` sweeps them); the keyed gen entry of the
megakernel at 11 and 33 parties.  ``--kernels setup`` times the trial
set-up kernel (``setup_kernels``): its whole form over the 11p and 33p
batches of 1000 trials in both threefry modes (the same keys for every
checkout: ``random.py``'s eager split), with ``--phases`` its phase
clock's breakdown where the checkout has one
(``setup_kernel.setup_phase_clock``), and the key entry
(``setup_kernel.keys_kernel``: the batch's keys from the seed, and a
chunk's from a root key and a fold in device memory) where it has one.
``--kernels batch`` times no kernel alone but the warm batch a user
calls, ``run_trials(cfg)`` on the default engine with its keys made from
the seed, at 11p and 33p x 1000 (``batch_walls``: host clock, fenced by
``torch.cuda.synchronize()``, the median of ``--reps`` after two
warm-ups, beside every rep).
``--circuit-cluster`` sets the
circuit kernel's cluster route (``fused_circuit.CLUSTER_BLOCK_BYTES``
and ``CLUSTER_MAX``) and ``--circuit-pass-bits`` its passes' bits
(``fused_circuit.PASS_BITS``) for the run, where the checkout has them:
options to time side by side.  ``--phases``, where the checkout has
the megakernel's phase clock (``trial_megakernel.phase_clock``), also
runs each keyed entry once with it and adds each one's breakdown (warp
0's mean cycles per block and share, per phase) under ``phases``; where
it has the per-round kernels' clock (``round_kernel_tiled.
round_phase_clock``), it also runs the fused round and the dense-mailbox
round, single-device and ``n_recv``, once a round with it (one buffer
summing the batch's rounds) and adds their breakdowns there too, and
the tiled verdict and rebuild likewise where their wrappers take a
``clock``.
Prints one JSON line: the card, the checkout and each kernel's mean ms
per launch over the rounds (null for an ``n_recv`` variant the checkout
lacks).  Run it for the two checkouts in turns (parent, change, change,
parent, ...) back to back: a card's clocks drift, so only times taken
side by side compare.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys

CONFIGS = {"33p": dict(n_parties=33, size_l=64, n_dishonest=10),
           "11p": dict(n_parties=11, size_l=64, n_dishonest=3)}
TP = {"33p": 4, "11p": 2}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--config", default="33p", choices=sorted(CONFIGS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default="all",
                    choices=("all", "mega", "round", "gen", "setup",
                             "batch"))
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--circuit-cluster")
    ap.add_argument("--circuit-pass-bits", type=int)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import torch

    if args.circuit_cluster:
        from qba_tpu_torch.ops import fused_circuit as fc

        size, most = args.circuit_cluster.split(":")
        fc.CLUSTER_BLOCK_BYTES, fc.CLUSTER_MAX = int(size), int(most)
    if args.circuit_pass_bits:
        from qba_tpu_torch.ops import fused_circuit as fc

        fc.PASS_BITS = args.circuit_pass_bits

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops.attack_draws import attack_draws
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    dev = torch.device("cuda", 0)
    cfg = QBAConfig(trials=1000, **CONFIGS[args.config])

    def ms(fn, *a, timed=None, **kw):
        """``fn``'s ms per launch; ``timed`` is the wrapper whose
        launches are timed where ``fn`` calls it (default ``fn``)."""
        timed = fn if timed is None else timed
        fn(*a, **kw)
        timed.events = []
        # A head start on the card: the launches queue behind the sleep,
        # so their events time the kernels, not the host's launch rate.
        torch.cuda._sleep(20_000_000)
        for _ in range(args.reps):
            fn(*a, **kw)
        torch.cuda.synchronize()
        out = sum(s.elapsed_time(e) for s, e in timed.events) / len(
            timed.events)
        timed.events = None
        return out

    if args.kernels == "gen":
        return report(args, None, gen_kernels(dev, ms))
    if args.kernels == "setup":
        return report(args, None, setup_kernels(dev, ms, args.phases))
    if args.kernels == "batch":
        return report(args, None, batch_walls(dev, args.reps))

    keys = trial_keys(cfg, dev)
    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    vi, cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    hc = rk.honest_cells(honest, cfg)
    li = li.to(torch.int32).contiguous()
    vi = vi.to(torch.int32)
    pool = rk.pool_from_step3a(cfg, cells)
    spare = rk.empty_pool(cfg, cfg.trials, dev)
    mbox = rs.mailbox_from_step3a(cfg, cells)
    mbox_spare = rs.empty_mailbox(cfg, cfg.trials, dev)
    tp = TP[args.config]
    n_local = cfg.n_lieutenants // tp
    kernels = ("fused_round", "tiled_verdict", "tiled_rebuild", "round_step")
    times = {k + sfx: [] for k in kernels for sfx in ("", "_n_recv")}
    sharded = {k: "n_recv" in inspect.signature(fn).parameters
               for k, fn in (("fused_round", rk.fused_round),
                             ("tiled_verdict", rk.tiled_verdict),
                             ("tiled_rebuild", rk.tiled_rebuild),
                             ("round_step", rs.round_step))}
    tiled_spare = rk.empty_pool(cfg, cfg.trials, dev)
    # The per-round kernels' phase clocks, one buffer a kernel summing
    # the rounds (where the checkout has the clock).
    clocks = {}
    clocked = [k for k, fn in (("fused_round", rk.fused_round),
                               ("round_step", rs.round_step),
                               ("tiled_verdict", rk.tiled_verdict),
                               ("tiled_rebuild", rk.tiled_rebuild))
               if "clock" in inspect.signature(fn).parameters]
    if args.phases and args.kernels != "mega" and hasattr(
            rk, "round_phase_clock"):
        clocks = {k + sfx: rk.round_phase_clock(
                      cfg.trials, tp if sfx else None, dev)
                  for k in clocked for sfx in ("", "_n_recv")}

    def shards(x):
        return x.expand((tp,) + x.shape).contiguous()

    rounds = cfg.n_rounds if args.kernels != "mega" else 0
    for r in range(1, rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        times["fused_round"].append(ms(rk.fused_round, cfg, r, pool, li, vi,
                                       hc, *draws, out=spare))
        times["tiled_verdict"].append(ms(rk.tiled_verdict, cfg, r, pool, li,
                                         vi, hc, *draws))
        acc = rk.tiled_verdict(cfg, r, pool, li, vi, hc, *draws)[0]
        times["tiled_rebuild"].append(ms(rk.tiled_rebuild, cfg, r, pool, li,
                                         acc, hc, *draws[:2],
                                         out=tiled_spare))
        times["round_step"].append(ms(rs.round_step, cfg, r, mbox, li, vi,
                                      hc, *draws, out=mbox_spare))
        # The n_recv variants, each shard on its copy of the round's pool
        # (or mailbox).
        if any(sharded.values()):
            spool, smbox = tuple(map(shards, pool)), tuple(map(shards, mbox))
            sli = rk.shard_receivers(li, tp)
            svi = rk.shard_receivers(vi, tp)
        kw = dict(n_recv=n_local)
        if sharded["fused_round"]:
            times["fused_round_n_recv"].append(ms(
                rk.fused_round, cfg, r, spool, sli, svi, hc, *draws, **kw))
        if sharded["tiled_verdict"]:
            times["tiled_verdict_n_recv"].append(ms(
                rk.tiled_verdict, cfg, r, spool, sli, svi, hc, *draws, **kw))
            sacc = rk.tiled_verdict(cfg, r, spool, sli, svi, hc, *draws,
                                    **kw)[0]
            times["tiled_rebuild_n_recv"].append(ms(
                rk.tiled_rebuild, cfg, r, spool, sli, sacc, hc, *draws[:2],
                **kw))
            del sacc
        if sharded["round_step"]:
            times["round_step_n_recv"].append(ms(
                rs.round_step, cfg, r, smbox, sli, svi, hc, *draws, **kw))
        if clocks:
            rk.fused_round(cfg, r, pool, li, vi, hc, *draws, out=spare,
                           clock=clocks["fused_round"])
            rk.fused_round(cfg, r, spool, sli, svi, hc, *draws, **kw,
                           clock=clocks["fused_round_n_recv"])
            rs.round_step(cfg, r, mbox, li, vi, hc, *draws, out=mbox_spare,
                          clock=clocks["round_step"])
            rs.round_step(cfg, r, smbox, sli, svi, hc, *draws, **kw,
                          clock=clocks["round_step_n_recv"])
            if "tiled_verdict" in clocked:
                for sfx, a, skw in (("", (pool, li, vi, hc), {}),
                                    ("_n_recv", (spool, sli, svi, hc), kw)):
                    cacc = rk.tiled_verdict(
                        cfg, r, *a, *draws, **skw,
                        clock=clocks["tiled_verdict" + sfx])[0]
                    rk.tiled_rebuild(cfg, r, *a[:2], cacc, hc, *draws[:2],
                                     **skw,
                                     clock=clocks["tiled_rebuild" + sfx])
                del cacc
        if any(sharded.values()):
            del spool, smbox
        # The next round's inputs: both engines advance from the same vi.
        new_mbox = rs.round_step(cfg, r, mbox, li, vi, hc, *draws,
                                 out=mbox_spare)[0]
        new, vi, _ovf = rk.fused_round(cfg, r, pool, li, vi, hc, *draws,
                                       out=spare)
        pool, spare = new, pool
        mbox, mbox_spare = new_mbox, mbox
    body = (p_rows.contiguous(), li, v_sent.to(torch.int32).contiguous(), hc)
    k_rounds = k_rounds.contiguous()
    mega = {}
    if args.kernels != "round":
        mega = megakernels(cfg, tp, body, k_rounds, ctx, ms, args.phases)
        mega["attack_draws"] = ms(attack_draws, cfg, k_rounds, ctx)
    if clocks:
        torch.cuda.synchronize()
        mega.setdefault("phases", {}).update(
            {k: rk.round_phase_breakdown(c) for k, c in clocks.items()})
    return report(args, tp, {k: sum(v) / len(v) if v else None
                             for k, v in times.items()} | mega)


def report(args, tp, times):
    """Print the JSON line: the card, the checkout and ``times``."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "root": args.root, "config": args.config,
                      "trials": 1000, "reps": args.reps, "tp": tp, **times}))
    return 0


def circuit_ops(n, seed, real, n_ops=40):
    """A seeded circuit of ``n`` qubits as op tuples: H on every qubit,
    then ``n_ops`` random gates with up to two controls, real ones only
    (H, X, Z, RY, ``XPOW``) where ``real``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds = ("H", "X", "Z", "RY", "XPOW") + (() if real else ("S", "T", "RX"))
    ops = [("H", q, (), None, None) for q in range(n)]
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(len(kinds)))]
        target = int(rng.integers(n))
        others = [q for q in range(n) if q != target]
        controls = tuple(int(c) for c in rng.choice(
            others, size=int(rng.integers(3)), replace=False))
        ops.append((kind, target, controls,
                    int(rng.integers(3)) if kind == "XPOW" else None,
                    float(rng.uniform(-3, 3)) if kind in ("RX", "RY")
                    else None))
    return ops


def cluster_occupancy():
    """How many circuit clusters the card runs at once, per (blocks, KB
    of state a block), where the checkout's kernel has the query."""
    import ctypes

    from qba_tpu_torch.ops._build import load_library

    lib = load_library("fused_circuit")
    if not hasattr(lib, "qba_fused_circuit_clusters"):
        return None
    out = {}
    for blocks, kb in ((8, 128), (16, 64), (16, 128)):
        n = ctypes.c_int(0)
        rc = lib.qba_fused_circuit_clusters(blocks, kb * 1024,
                                            ctypes.byref(n))
        out[f"{blocks}x{kb}KB"] = n.value if rc == 0 else f"error {rc}"
    return out


def setup_kernels(dev, ms, phases):
    """The set-up kernel's and the key entry's ms per launch (``--kernels
    setup``), with the set-up kernel's phase clock under ``phases``."""
    import torch

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.ops import setup_kernel as sk

    out, clocks = {}, {}
    for name, kw in CONFIGS.items():
        cfg = QBAConfig(trials=1000, **kw)
        for p in (True, False):
            mode = "partitionable" if p else "legacy"
            keys = jr.split(jr.key(cfg.seed, dev), cfg.trials,
                            partitionable=p)
            out[f"setup_trial_{name}_{mode}"] = ms(
                sk.setup_kernel, cfg, keys, "whole", partitionable=p)
            if hasattr(sk, "keys_kernel"):
                out[f"trial_keys_{name}_{mode}"] = ms(
                    sk.keys_kernel, cfg.seed, cfg.trials, device=dev,
                    partitionable=p)
                out[f"trial_keys_fold_{name}_{mode}"] = ms(
                    sk.keys_kernel, jr.key(cfg.seed, dev), cfg.trials,
                    torch.tensor(3, dtype=torch.int32, device=dev),
                    partitionable=p)
            if phases and p and hasattr(sk, "setup_phase_clock"):
                clock = sk.setup_phase_clock(cfg.trials, dev)
                sk.setup_kernel(cfg, keys, "whole", partitionable=True,
                                clock=clock)
                torch.cuda.synchronize()
                clocks[f"setup_trial_{name}"] = sk.setup_phase_breakdown(
                    clock)
    if phases:
        out["phases"] = clocks
    return out


def batch_walls(dev, reps):
    """A warm ``run_trials(cfg)``'s fenced wall in ms (``--kernels
    batch``) at each config of ``CONFIGS``: the median of ``reps`` after
    two warm-ups, and every rep."""
    import statistics
    import time

    import torch

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.torch_backend import run_trials

    out = {}
    for name, kw in CONFIGS.items():
        cfg = QBAConfig(trials=1000, **kw)
        for _ in range(2):
            run_trials(cfg, device=dev)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_trials(cfg, device=dev)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"run_trials_{name}_ms"] = statistics.median(walls)
        out[f"run_trials_{name}_reps"] = walls
    return out


def gen_kernels(dev, ms):
    """The list-generation kernels' ms per launch (``--kernels gen``)."""
    import torch

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.convert import circuit_ops_from_tuples
    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import trial_megakernel as tm
    from qba_tpu_torch.qsim import protocol_circuits as pc
    from qba_tpu_torch.rounds.engine import _mega_gen_setup

    out = {}
    q5, nq5 = pc.gen_q_corr_circuit(5, 3), pc.gen_nq_corr_circuit(5, 3)
    circuits = {"circuit_q5_x64": (18, q5.ops, q5.n_params, 64),
                "circuit_q5_x132": (18, q5.ops, q5.n_params, 132),
                "circuit_nq5_x1": (18, nq5.ops, 0, 1)}
    for n, real, runs in ((17, False, 8), (19, True, 4), (20, True, 2)):
        circuits[f"circuit_{'r' if real else 'c'}{n}_x{runs}"] = (
            n, circuit_ops_from_tuples(circuit_ops(n, n, real)), 3, runs)
    for name, (n, ops, n_params, runs) in circuits.items():
        tables = fc.circuit_tables(n, ops, n_params).to(dev)
        if hasattr(tables, "route"):
            out[name + "_route"] = list(tables.route)
        gen = torch.Generator().manual_seed(runs)
        params = torch.randint(0, 2, (runs, tables.n_params), generator=gen,
                               dtype=torch.int32).to(dev)
        out[name] = ms(fc.fused_circuit, tables, params)
    out["circuit_clusters"] = cluster_occupancy()
    for n in (11, 33, 65):
        cfg = QBAConfig(n_parties=n, size_l=64, trials=1000)
        ops = pc.stabilizer_gen_operands(
            cfg, jr.split(jr.key(n, device=dev), cfg.trials))
        tables = pc.stabilizer_gen_tables(cfg, dev)
        out[f"gf2_sweep_{n}p"] = ms(pc.stabilizer_bits, cfg, tables, ops,
                                    timed=gs.gf2_sweep)
        del ops
    for name, kw in CONFIGS.items():
        cfg = QBAConfig(trials=1000, qsim_path="stabilizer", **kw)
        keys = trial_keys(cfg, dev)
        honest, gen_ops, v_sent, _vc, k_rounds = _mega_gen_setup(cfg, keys)
        k_rounds = k_rounds.contiguous()
        ctx = adversary_ctx(cfg, k_rounds, v_sent)
        out[f"trial_megakernel_gen_keyed_{name}"] = ms(
            tm.trial_megakernel_gen_keyed, cfg,
            pc.stabilizer_gen_tables(cfg, dev), gen_ops,
            v_sent.to(torch.int32).contiguous(), rk.honest_cells(honest, cfg),
            k_rounds, ctx)
    return out


def megakernels(cfg, tp, body, k_rounds, ctx, ms, phases):
    """The megakernels' ms per launch on the batch: the stacked and keyed
    single-device entries, the keyed sharded entry at ``tp``, the keyed
    gen entry, and both keyed entries on the first 64 trials; with
    ``phases`` each keyed entry's phase breakdown too."""
    import dataclasses

    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import trial_megakernel as tm
    from qba_tpu_torch.ops.attack_draws import attack_draws
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_tables
    from qba_tpu_torch.rounds.engine import _mega_gen_setup

    stacks = attack_draws(cfg, k_rounds, ctx)
    out = {"trial_megakernel": ms(tm.trial_megakernel, cfg, *body, *stacks)}
    del stacks
    scfg = dataclasses.replace(cfg, qsim_path="stabilizer")
    keys = trial_keys(scfg, body[0].device)
    honest, gen_ops, v_sent, _vc, gk_rounds = _mega_gen_setup(scfg, keys)
    gk_rounds = gk_rounds.contiguous()
    gctx = adversary_ctx(scfg, gk_rounds, v_sent)
    gen = [stabilizer_gen_tables(scfg, keys.device), gen_ops,
           v_sent.to(torch.int32).contiguous(), rk.honest_cells(honest, scfg)]
    small = 64
    scfg64 = dataclasses.replace(cfg, trials=small)
    sl = slice(0, small)
    sbody = [x[sl].contiguous() for x in body]
    sctx = None if ctx is None else type(ctx)(*(x[sl] for x in ctx))
    runs = {
        "trial_megakernel_keyed": (tm.trial_megakernel_keyed, (cfg,),
                                   (*body, k_rounds, ctx), cfg.trials, 1),
        "sharded_trial_megakernel_keyed": (
            tm.sharded_trial_megakernel_keyed, (cfg, tp),
            (*body, k_rounds, ctx), cfg.trials, tp),
        "trial_megakernel_gen_keyed": (tm.trial_megakernel_gen_keyed,
                                       (scfg,), (*gen, gk_rounds, gctx),
                                       cfg.trials, 1),
        "trial_megakernel_keyed_x64": (
            tm.trial_megakernel_keyed, (scfg64,),
            (*sbody, k_rounds[sl].contiguous(), sctx), small, 1),
        "sharded_trial_megakernel_keyed_x64": (
            tm.sharded_trial_megakernel_keyed, (scfg64, tp),
            (*sbody, k_rounds[sl].contiguous(), sctx), small, tp),
    }
    breakdown = {}
    for name, (fn, pre, a, n, n_tp) in runs.items():
        out[name] = ms(fn, *pre, *a)
        if phases and hasattr(tm, "phase_clock"):
            clock = tm.phase_clock(n, n_tp, body[0].device)
            fn(*pre, *a, clock=clock)
            torch.cuda.synchronize()
            breakdown[name] = tm.phase_breakdown(clock)
    if breakdown:
        out["phases"] = breakdown
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
