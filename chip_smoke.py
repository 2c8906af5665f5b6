#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes

Phases, each reported on its own line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``qba_tpu_torch/ops/csrc``, one ``nvcc``
   per source, all started together (build time, registers, spills);
3. ``kernel_vs_plain``: the fused round kernel, the tiled verdict and
   rebuild kernels and the dense-mailbox round kernel against their
   plain PyTorch versions, bit-exact on every output, round by round, on
   protocol state of real trials at 5p/L16/d2, 11p/L64/d3 (strategy
   "split"), an overflowing ``max_accepts_per_round=1`` case, 5p/L16/d1
   racy delivery and 33p/L64/d10;
4. ``mega_vs_plain``: the trial megakernel against its plain version on
   the same configs, bit-exact on vi, decisions and overflow;
   ``random_vs_plain``: the five round kernels against their plain
   versions on seeded random inputs (``qba_tpu_torch.testing``) that
   reach the guards the protocol's own state never trips;
   ``circuit_vs_plain``: the fused circuit kernel against its plain
   version at ``atol=1e-6`` on amplitudes (same float32 arithmetic, but
   the compiler may fuse a multiply and an add): both protocol circuits
   at 3, 4 and 5 parties (8, 15, 18 qubits) with random params, and
   seeded random circuits at 10 and 16 qubits with complex gates,
   multi-control ops and ``XPOW``;
5. ``engines_agree``: ``run_trials`` with the ``xla``, ``pallas``,
   ``pallas_fused``, ``pallas_tiled`` and ``pallas_mega`` engines trial
   for trial at 5p/L16/d2 x 64, and the protocol counters of the four
   per-round engines field by field;
6. ``main_path``, at full width, 11p/L64/d3 and 33p/L64/d10 x 1000 trials
   each: ``run_trials(QBAConfig(...))`` with ``auto`` (asserted to
   resolve to the megakernel, one launch per batch), then the
   ``pallas_fused`` (one launch per round), ``pallas_tiled`` (two per
   round) and ``pallas`` (one per round) engines, each with its launch
   counts reset just before and asserted just after; wall time after a
   warm-up, rounds/s (trials x n_rounds / s), kernel time per launch
   from CUDA events, set-up and draw times, success rate and peak
   memory.  The four engines must agree trial for trial.  Then
   ``full_width_vs_plain``: the same batches replayed round by round
   with the fused, verdict, rebuild and dense-mailbox kernels held
   against their plain versions (bit-exact, with times and bounds), and
   the megakernel held against its plain version on the batch's own
   inputs.  Then ``collect_counters=True`` on ``auto`` at 11p/L64/d3 x
   1000 (asserted to run the fused per-round engine), and the dense
   circuit path at the widest circuit it admits,
   ``qsim_path="dense_pallas"`` at 5p/L64/d2 x 64 (18 qubits), with the
   circuit kernel's launches asserted and its lists and results equal to
   the same run on ``qsim_path="dense"`` (the plain per-gate engine on
   the card).

Any failure exits non-zero.  The line before the last is the kernel
table as JSON, the one before it the card; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor
# float32 rate, the closest listed rate for the kernels' integer compares.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
REPORT = os.path.join("build", "chip_smoke_report.json")
SOURCES = {
    "fused_round": ("qba_tpu_torch/ops/csrc/fused_round.cu",
                    "qba_tpu/ops/round_kernel_tiled.py:1270"),
    "trial_megakernel": ("qba_tpu_torch/ops/csrc/trial_megakernel.cu",
                         "qba_tpu/ops/trial_megakernel.py:102"),
    "tiled_verdict": ("qba_tpu_torch/ops/csrc/tiled_round.cu",
                      "qba_tpu/ops/round_kernel_tiled.py:357"),
    "tiled_rebuild": ("qba_tpu_torch/ops/csrc/tiled_round.cu",
                      "qba_tpu/ops/round_kernel_tiled.py:874"),
    "round_step": ("qba_tpu_torch/ops/csrc/round_step.cu",
                   "qba_tpu/ops/round_kernel.py:162"),
    "fused_circuit": ("qba_tpu_torch/ops/csrc/fused_circuit.cu",
                      "qba_tpu/ops/fused_circuit.py:93"),
}


T0 = time.perf_counter()


def log(phase, **kw):
    """One phase's line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T0, **kw}),
          flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(a, b):
    """Largest absolute difference of two integer tensors, on their
    device; 0 when they are equal."""
    import torch

    if a.dtype == b.dtype and torch.equal(a, b):
        return 0
    return int((a.long() - b.long()).abs().max())


def pool_stats(cfg, pool):
    """``(live entries, valid evidence rows)`` of a pool, over trials."""
    import torch

    meta = pool[3]
    sent = meta[..., 2] != 0
    cnt = torch.where(sent, meta[..., 0].clamp(0, cfg.max_l), 0)
    return int(sent.sum()), int(cnt.sum())


def bound(bytes_moved, ops):
    """Least time in ms for this many bytes and compares: ``(ms, "bytes"
    | "operations")``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def verdict_cost(cfg, live, rows, n_trials):
    """Bytes and compares of one round's verdict: in, the live packets'
    valid rows (vals and lens), P, meta and their cells' three draws per
    receiver, every packet's meta (the scan), li and vi; out, acc and
    vi."""
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    b_in = (rows * (s + 4) + live * (s + 3 * n_rv + 4)
            + n_trials * (n_pool * 16 + n_rv * s * 4 + n_rv * w * 4))
    b_out = n_trials * (n_pool * n_rv * 4 + n_rv * w * 4)
    return b_in + b_out, (rows + 3 * live) * s * n_rv


def pool_bytes(cfg, n_trials):
    """Bytes of a whole pool: int8 vals and P, int32 lens and meta."""
    n_pool = cfg.n_lieutenants * cfg.slots
    return n_trials * n_pool * (cfg.max_l * cfg.size_l + cfg.max_l * 4
                                + cfg.size_l + 16)


def rebuild_cost(cfg, dst, dst_rows, n_trials):
    """Bytes and compares of one round's rebuild: in, acc, each
    destination's source rows (vals and lens), P and meta, its two draws,
    honesty and the receiver's li row; out, the whole successor pool and
    the overflow flag."""
    n_rv, s = cfg.n_lieutenants, cfg.size_l
    n_pool = n_rv * cfg.slots
    b_in = (n_trials * n_pool * n_rv * 4 + dst_rows * (s + 4)
            + dst * (s + 16 + 2 + 4 + s * 4))
    b_out = pool_bytes(cfg, n_trials) + n_trials * 4
    return b_in + b_out, (dst_rows + dst) * s


def fused_cost(cfg, live, rows, dst, dst_rows, n_trials):
    """Bytes and compares of one fused round: the verdict's inputs and vi
    out, the rebuild's source reads and the whole successor pool out
    (acc stays on chip)."""
    n_rv = cfg.n_lieutenants
    n_pool = n_rv * cfg.slots
    acc = n_trials * n_pool * n_rv * 4
    vb, vo = verdict_cost(cfg, live, rows, n_trials)
    rb, ro = rebuild_cost(cfg, dst, dst_rows, n_trials)
    return vb + rb - 2 * acc, vo + ro


def circuit_cost(tables, params):
    """Bytes and float operations of one fused-circuit launch: the op
    table and the params in, the final state out (4 B per amplitude and
    plane); per op the pairs its controls select, at 4 operations for H,
    none for a swap (``X``, and ``XPOW`` only in the runs whose bit is
    set), 6 for a real coefficient form and 28 for a complex one."""
    n_runs, size = params.shape[0], 1 << tables.n_qubits
    planes = 1 if tables.is_real else 2
    b = (tables.ops_i.numel() * 4 + tables.ops_f.numel() * 4
         + params.numel() * 4 + n_runs * planes * size * 4)
    ops = 0
    for kind, _bit, ctrl, _pi in tables.ops_i.tolist():
        pairs = (size // 2) >> bin(ctrl).count("1")
        per_pair = {0: 4 * planes, 1: 0, 2: 0}.get(kind,
                                                  6 if planes == 1 else 28)
        ops += n_runs * pairs * per_pair
    return b, ops


def mega_cost(cfg, rounds, n_trials):
    """Bytes and compares of a whole trial batch in one launch: li, P,
    the orders and honesty once in; vi, the decisions and overflow out;
    per round its live pool entries (valid rows of vals and lens, P,
    meta) written once and read back once, the three draws of each live
    packet per receiver (the verdict) and the two of each rebuilt entry
    (the rebuild).  A round reads no draw of a cell without a live
    packet, so the draw stacks are not counted whole.  ``rounds`` holds
    each round's ``(live, rows, dst)``."""
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    b = n_trials * (n_rv * s * 4 + n_rv * s + n_rv * 4 + n_pool * 4
                    + n_rv * w * 4 + n_rv * 4 + 4)
    ops = 0
    for live, rows, dst in rounds:
        b += (2 * (rows * (s + 4) + live * (s + 16)) + live * 3 * n_rv
              + dst * 2)
        ops += (rows + 3 * live) * s * n_rv
    return b, ops


def tree_err(got, want):
    """``max_err`` over two equal-shaped tuples (nested) of tensors."""
    if isinstance(got, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError("outputs differ in length")
        return max(tree_err(a, b) for a, b in zip(got, want))
    return max_err(got, want)


def event_ms(events):
    return sum(a.elapsed_time(b) for a, b in events) / max(len(events), 1)


def replay(cfg, keys, *, chunk, reps=0):
    """Run ``cfg``'s round loop on ``keys`` step by step with the fused,
    verdict, rebuild and dense-mailbox kernels, holding every round's
    outputs against the plain versions on the same inputs (bit-exact).  With ``reps`` > 0
    also times each kernel (CUDA events over ``reps`` launches) and each
    plain version (host clock, in chunks of ``chunk`` trials).  Returns
    the set-up time and final accepted sets, then per-round stats with
    each round's draw time and bounds; host-clock times are fenced by
    ``torch.cuda.synchronize()``."""
    import torch

    from qba_tpu_torch import random as jr
    from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    n = keys.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    pool = rk.pool_from_step3a(cfg, out_cells)
    spare = rk.empty_pool(cfg, n, keys.device)
    hc = rk.honest_cells(honest, cfg)
    li = li.to(torch.int32).contiguous()
    vi_i = vi.to(torch.int32)
    torch.cuda.synchronize()
    stats = [dict(setup_ms=(time.perf_counter() - t0) * 1e3)]
    mbox = rs.mailbox_from_step3a(cfg, out_cells)
    mbox_spare = rs.empty_mailbox(cfg, n, keys.device)

    def timed(fn, *args, **kw):
        if not reps:
            return None
        fn.events = []
        for _ in range(reps):
            fn(*args, **kw)
        torch.cuda.synchronize()
        ms, fn.events = event_ms(fn.events), None
        return ms

    def plain(fn, *args):
        """``fn`` over chunks of trials -> (outputs, ms)."""
        parts = []
        t0 = time.perf_counter()
        for a in range(0, n, chunk):
            sl = slice(a, a + chunk)
            parts.append(fn(*(tuple(x[sl] for x in y) if isinstance(y, tuple)
                              else y[sl] for y in args)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3

        def cat(items):
            if isinstance(items[0], tuple):
                return tuple(cat([it[i] for it in items])
                             for i in range(len(items[0])))
            return torch.cat(items)

        return cat(parts), ms

    for r in range(1, cfg.n_rounds + 1):
        t0 = time.perf_counter()
        att, rv, late = (x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        torch.cuda.synchronize()
        draws_ms = (time.perf_counter() - t0) * 1e3
        live, rows = pool_stats(cfg, pool)
        new, vi_k, ovf_k = rk.fused_round(cfg, r, pool, li, vi_i, hc, att,
                                          rv, late, out=spare)
        acc_k, vi_t = rk.tiled_verdict(cfg, r, pool, li, vi_i, hc, att, rv,
                                       late)
        tiled_pool, ovf_t = rk.tiled_rebuild(cfg, r, pool, li, acc_k, hc,
                                             att, rv)
        new_mbox, vi_m, ovf_m = rs.round_step(cfg, r, mbox, li, vi_i, hc, att,
                                              rv, late, out=mbox_spare)
        torch.cuda.synchronize()
        fused_ms = timed(rk.fused_round, cfg, r, pool, li, vi_i, hc, att, rv,
                         late, out=spare)
        verdict_ms = timed(rk.tiled_verdict, cfg, r, pool, li, vi_i, hc, att,
                           rv, late)
        rebuild_ms = timed(rk.tiled_rebuild, cfg, r, pool, li, acc_k, hc,
                           att, rv, out=tiled_pool)
        step_ms = timed(rs.round_step, cfg, r, mbox, li, vi_i, hc, att, rv,
                        late, out=mbox_spare)
        sub = lambda f: (lambda *a: f(cfg, r, *a))  # noqa: E731
        (ref_pool, ref_vi, ref_ovf), fused_plain_ms = plain(
            sub(rk.fused_round_reference), pool, li, vi_i, hc, att, rv, late)
        (ref_acc, ref_vi_t), verdict_plain_ms = plain(
            sub(rk.verdict_reference), pool, li, vi_i, hc, att, rv, late)
        (ref_tpool, ref_ovf_t), rebuild_plain_ms = plain(
            sub(rk.rebuild_reference), pool, li, acc_k, hc, att, rv)
        (ref_mbox, ref_vi_m, ref_ovf_m), step_plain_ms = plain(
            sub(rs.round_step_reference), mbox, li, vi_i, hc, att, rv, late)
        errs = {
            "round_step": max(
                [max_err(a, b) for a, b in zip(new_mbox, ref_mbox)]
                + [max_err(vi_m, ref_vi_m), max_err(ovf_m, ref_ovf_m)]),
            "fused_round": max(
                [max_err(a, b) for a, b in zip(new, ref_pool)]
                + [max_err(vi_k, ref_vi), max_err(ovf_k, ref_ovf)]),
            "tiled_verdict": max(max_err(acc_k, ref_acc),
                                 max_err(vi_t, ref_vi_t)),
            "tiled_rebuild": max(
                [max_err(a, b) for a, b in zip(tiled_pool, ref_tpool)]
                + [max_err(ovf_t, ref_ovf_t)]),
        }
        if any(errs.values()):
            raise AssertionError(
                f"kernel != plain version at {cfg} round {r}: {errs}")
        # What the rebuild must read: each destination's source packet.
        rb = (acc_k != 0) & (r <= cfg.n_dishonest)
        slot = torch.cumsum(rb.long(), 1) - rb.long()
        write = rb & (slot < cfg.slots)
        src_cnt = torch.where(pool[3][..., 2] != 0,
                              pool[3][..., 0].clamp(0, cfg.max_l), 0)
        dst = int(write.sum())
        dst_rows = int((write.long() * src_cnt[..., None].long()).sum())
        stats.append(dict(
            round=r, live=live, rows=rows, dst=dst, max_abs_err=errs,
            overflow=int(ovf_k.sum()), draws_ms=draws_ms,
            ms=dict(fused_round=fused_ms, tiled_verdict=verdict_ms,
                    tiled_rebuild=rebuild_ms, round_step=step_ms),
            plain_ms=dict(round_step=step_plain_ms if reps else None,
                          fused_round=fused_plain_ms if reps else None,
                          tiled_verdict=verdict_plain_ms if reps else None,
                          tiled_rebuild=rebuild_plain_ms if reps else None),
            bound=dict(
                # The dense mailbox holds the pool's packets at their own
                # cells and is as large as the pool: the same bytes.
                round_step=bound(*fused_cost(cfg, live, rows, dst,
                                             dst_rows, n)),
                fused_round=bound(*fused_cost(cfg, live, rows, dst,
                                              dst_rows, n)),
                tiled_verdict=bound(*verdict_cost(cfg, live, rows, n)),
                tiled_rebuild=bound(*rebuild_cost(cfg, dst, dst_rows, n)),
            )))
        if not (torch.equal(vi_k, vi_t) and torch.equal(ovf_k, ovf_t)
                and all(torch.equal(a, b) for a, b in zip(new, tiled_pool))):
            raise AssertionError(f"fused != tiled at {cfg} round {r}")
        if not (torch.equal(vi_k, vi_m) and torch.equal(ovf_k, ovf_m)
                and int(new_mbox[3][..., 2].sum()) == dst):
            raise AssertionError(f"fused != dense mailbox at {cfg} round {r}")
        pool, spare, vi_i = new, pool, vi_k
        mbox, mbox_spare = new_mbox, mbox
    stats[0]["vi"] = vi_i != 0
    return stats


def mega_inputs(cfg, keys):
    """The megakernel's inputs for ``keys``, staged as ``run_trial_mega``
    builds them, with the set-up and draw times (host clock, fenced)."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.rounds.engine import _stacked_draws, setup_trial

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    args = [p_rows.contiguous(), li.to(torch.int32).contiguous(),
            v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    args += list(_stacked_draws(cfg, k_rounds, ctx))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return args, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def mega_vs_plain(cfg, keys, *, chunk, reps=0):
    """The megakernel against its plain version on ``keys``' inputs
    (bit-exact).  With ``reps`` > 0 also times both."""
    import torch

    from qba_tpu_torch.ops.trial_megakernel import (
        trial_megakernel,
        trial_megakernel_reference,
    )

    args, setup_ms, draws_ms = mega_inputs(cfg, keys)
    got = trial_megakernel(cfg, *args)
    torch.cuda.synchronize()
    ms = None
    if reps:
        trial_megakernel.events = []
        for _ in range(reps):
            trial_megakernel(cfg, *args)
        torch.cuda.synchronize()
        ms, trial_megakernel.events = event_ms(trial_megakernel.events), None
    n = keys.shape[0]
    t0 = time.perf_counter()
    parts = [trial_megakernel_reference(cfg, *(x[a:a + chunk] for x in args))
             for a in range(0, n, chunk)]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = [torch.cat([p[i] for p in parts]) for i in range(3)]
    err = max(max_err(a, b) for a, b in zip(got, want))
    if err:
        raise AssertionError(f"trial_megakernel != plain version at {cfg}: "
                             f"max abs err {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms if reps else None,
                setup_ms=setup_ms, draws_ms=draws_ms,
                overflow=int(got[2].sum()), vi=got[0] != 0)


ENGINE_OF = {"fused_round": "pallas_fused", "tiled_verdict": "pallas_tiled",
             "tiled_rebuild": "pallas_tiled", "trial_megakernel": "auto",
             "round_step": "pallas"}
COUNTED = ("fused_round", "tiled_verdict", "tiled_rebuild",
           "trial_megakernel", "round_step", "fused_circuit")
ROUND_KERNELS = COUNTED[:5]

# Seeded random inputs (qba_tpu_torch.testing): round inputs as
# (config, round) and whole-trial inputs as configs.
RANDOM_ROUNDS = [
    ("5p/L16/d2 r1", dict(n_parties=5, size_l=16, n_dishonest=2), 1),
    ("5p/L16/d2 r2", dict(n_parties=5, size_l=16, n_dishonest=2), 2),
    ("5p/L16/d2 split r1", dict(n_parties=5, size_l=16, n_dishonest=2,
                                strategy="split"), 1),
    ("5p/L16/d2 slots=1 r1", dict(n_parties=5, size_l=16, n_dishonest=2,
                                  max_accepts_per_round=1), 1),
    ("7p/L8/d3 r3", dict(n_parties=7, size_l=8, n_dishonest=3), 3),
    ("7p/L8/d3 r4", dict(n_parties=7, size_l=8, n_dishonest=3), 4),
    ("11p/L64/d3 r1", dict(n_parties=11, size_l=64, n_dishonest=3), 1),
]
RANDOM_TRIALS = [
    ("5p/L16/d2 split", dict(n_parties=5, size_l=16, n_dishonest=2,
                             strategy="split")),
    ("5p/L16/d2 slots=1", dict(n_parties=5, size_l=16, n_dishonest=2,
                               max_accepts_per_round=1)),
    ("11p/L64/d3", dict(n_parties=11, size_l=64, n_dishonest=3)),
]


def random_vs_plain(dev, n_trials=64):
    """Every kernel against its plain version on seeded random inputs,
    bit-exact: the verdict's guards (out-of-range values, colliding rows,
    disagreeing lens, own rows already in L), accepted matrices far
    denser than the protocol makes, and step 3a's rejection of
    inconsistent lieutenants.  Returns the per-kernel max abs error and
    the cases' facts."""
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import trial_megakernel as tm
    from qba_tpu_torch.rounds.engine import step3a_one
    from qba_tpu_torch.testing import (
        dense_acc,
        random_mailbox_inputs,
        random_round_inputs,
        random_trial_inputs,
    )

    errs = dict.fromkeys(ROUND_KERNELS, 0)
    facts = []
    for i, (name, kw, r) in enumerate(RANDOM_ROUNDS):
        cfg = QBAConfig(**kw)
        args = random_round_inputs(cfg, r, n_trials, seed=100 + i, device=dev)
        pool, li, vi, hc, att, rv, late = args
        errs["fused_round"] = max(errs["fused_round"], tree_err(
            rk.fused_round(cfg, r, *args),
            rk.fused_round_reference(cfg, r, *args)))
        acc, vi2 = rk.tiled_verdict(cfg, r, *args)
        errs["tiled_verdict"] = max(errs["tiled_verdict"], tree_err(
            (acc, vi2), rk.verdict_reference(cfg, r, *args)))
        dense = dense_acc(cfg, pool, seed=i)
        for a in (acc, dense):
            errs["tiled_rebuild"] = max(errs["tiled_rebuild"], tree_err(
                rk.tiled_rebuild(cfg, r, pool, li, a, hc, att, rv),
                rk.rebuild_reference(cfg, r, pool, li, a, hc, att, rv)))
        margs = random_mailbox_inputs(cfg, r, n_trials, seed=100 + i,
                                      device=dev)
        mgot = rs.round_step(cfg, r, *margs)
        errs["round_step"] = max(errs["round_step"], tree_err(
            mgot, rs.round_step_reference(cfg, r, *margs)))
        facts.append(dict(case=name, accepted=int(acc.sum()),
                          dense_accepted=int(dense.sum()),
                          mailbox_accepted=int(mgot[1].sum() - margs[2].sum())))
    for i, (name, kw) in enumerate(RANDOM_TRIALS):
        cfg = QBAConfig(**kw)
        args = random_trial_inputs(cfg, n_trials, seed=200 + i, device=dev)
        errs["trial_megakernel"] = max(errs["trial_megakernel"], tree_err(
            tm.trial_megakernel(cfg, *args),
            tm.trial_megakernel_reference(cfg, *args)))
        ok = step3a_one(cfg, args[0], args[2], args[1])[0].any(-1)
        facts.append(dict(case=name, step3a_ok=int(ok.sum()),
                          step3a_rejected=int((~ok).sum())))
    if any(errs.values()):
        raise AssertionError(f"kernel != plain version on random inputs: "
                             f"{errs}")
    if not all(f.get("accepted", 1) and f.get("step3a_rejected", 1)
               and f.get("step3a_ok", 1) and f.get("mailbox_accepted", 1)
               for f in facts):
        raise AssertionError(f"a random case reached no branch: {facts}")
    return errs, facts


CIRCUIT_ATOL = 1e-6


def circuit_vs_plain(dev, reps=5):
    """The fused circuit kernel against its plain version, amplitudes at
    ``atol=1e-6``: both protocol circuits at 3, 4 and 5 parties with
    seeded random params, and seeded random complex circuits at 10 and 16
    qubits.  The 5-party Q-correlated circuit, at the 64 runs per launch
    the dense path gives it, is also timed against its plain version and
    its bound.  Returns the cases' facts and that timing."""
    import torch

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.convert import circuit_ops_from_tuples
    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.qsim import protocol_circuits as pc
    from qba_tpu_torch.qsim.statevector import SAMPLE_CHUNK_ELEMS
    from qba_tpu_torch.testing import random_circuit

    cases = []
    for n in (3, 4, 5):
        nq = QBAConfig(n_parties=n, size_l=1).n_qubits
        q_circ = pc.gen_q_corr_circuit(n, nq)
        nq_circ = pc.gen_nq_corr_circuit(n, nq)
        cases.append((f"q-corr {n}p", q_circ.n_qubits, q_circ.ops,
                      q_circ.n_params, 8))
        cases.append((f"nq-corr {n}p", nq_circ.n_qubits, nq_circ.ops, 0, 1))
    for n, seed in ((10, 1), (16, 2)):
        ops = circuit_ops_from_tuples(random_circuit(n, 40, seed))
        cases.append((f"random {n}q", n, ops, 3, 4))
    # The main path's launch shape: 5p Q-correlated, one chunk of runs.
    big = pc.gen_q_corr_circuit(5, 3)
    runs = max(1, SAMPLE_CHUNK_ELEMS >> big.n_qubits)
    cases.append(("q-corr 5p, main-path chunk", big.n_qubits, big.ops,
                  big.n_params, runs))
    facts, timing = [], None
    for i, (name, n, ops, n_params, n_runs) in enumerate(cases):
        tables = fc.circuit_tables(n, ops, n_params).to(dev)
        gen = torch.Generator().manual_seed(i)
        params = torch.randint(0, 2, (n_runs, tables.n_params), generator=gen,
                               dtype=torch.int32).to(dev)
        got = fc.fused_circuit(tables, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fc.fused_circuit_reference(tables, params)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"fused_circuit {name}: {got.dtype} "
                                 f"{tuple(got.shape)} != plain version's")
        err = float((got - want).abs().max())
        norm = float(((got.abs() ** 2).sum(-1) - 1).abs().max())
        if not (err <= CIRCUIT_ATOL and norm <= 1e-4):
            raise AssertionError(f"fused_circuit != plain version at {name}: "
                                 f"max abs err {err}, norm off by {norm}")
        facts.append(dict(case=name, qubits=n, ops=len(ops), runs=n_runs,
                          real=tables.is_real, max_abs_err=err))
        if name.endswith("main-path chunk"):
            fc.fused_circuit.events = []
            for _ in range(reps):
                fc.fused_circuit(tables, params)
            torch.cuda.synchronize()
            ms, fc.fused_circuit.events = event_ms(
                fc.fused_circuit.events), None
            b_ms, b_by = bound(*circuit_cost(tables, params))
            timing = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, runs=n_runs,
                          qubits=n, ops=len(ops))
    return facts, timing


def wrappers():
    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import trial_megakernel as tm

    return {"fused_round": rk.fused_round, "tiled_verdict": rk.tiled_verdict,
            "tiled_rebuild": rk.tiled_rebuild,
            "trial_megakernel": tm.trial_megakernel,
            "round_step": rs.round_step, "fused_circuit": fc.fused_circuit}


def drive(cfg, engine):
    """One main-path batch, ``run_trials(cfg)``, after a warm-up, with
    every kernel's launch count set to 0 just before and read just
    after, and each launch's CUDA events kept."""
    import dataclasses

    import torch

    import qba_tpu_torch
    from qba_tpu_torch.backends.torch_backend import fence

    if engine != "auto":
        cfg = dataclasses.replace(cfg, round_engine=engine)
    fence(qba_tpu_torch.run_trials(cfg))  # warm-up
    fns = wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches, fn.events = 0, []
    t0 = time.perf_counter()
    out = fence(qba_tpu_torch.run_trials(cfg))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    events = {k: fn.events for k, fn in fns.items()}
    for fn in fns.values():
        fn.events = None
    return out, wall, launches, events, torch.cuda.max_memory_allocated()


def main(argv):
    quick = "--quick" in argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    import qba_tpu_torch
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.ops import _build
    from qba_tpu_torch.rounds.engine import resolve_round_engine

    report = {}
    dev = torch.device("cuda", 0)
    card = smi()
    log("device", smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        kind=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for text in logs.values()
             for ln in text.splitlines() if "registers" in ln or "spill" in ln]
    log("build", seconds=build_s, kernels=list(logs), ptxas=ptxas)

    small = [
        ("5p/L16/d2", QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                trials=8, seed=11)),
        ("11p/L64/d3 split", QBAConfig(n_parties=11, size_l=64,
                                       n_dishonest=3, trials=8, seed=12,
                                       strategy="split")),
        ("5p/L16/d2 slots=1", QBAConfig(n_parties=5, size_l=16,
                                        n_dishonest=2, trials=16, seed=2,
                                        max_accepts_per_round=1)),
        ("5p/L16/d1 racy", QBAConfig(n_parties=5, size_l=16, n_dishonest=1,
                                     trials=16, seed=5, delivery="racy",
                                     p_late=0.25)),
        ("33p/L64/d10", QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=4, seed=13)),
    ]
    checks, mega_checks = [], []
    for name, cfg in small:
        keys = trial_keys(cfg, dev)
        stats = replay(cfg, keys, chunk=cfg.trials)
        final_vi = stats[0]["vi"]
        stats = stats[1:]
        errs = {k: max(s["max_abs_err"][k] for s in stats)
                for k in stats[0]["max_abs_err"]}
        checks.append(dict(config=name, rounds=len(stats),
                           live=[s["live"] for s in stats],
                           overflow=[s["overflow"] for s in stats]))
        log("kernel_vs_plain", config=name, rounds=len(stats), tolerance=0,
            max_abs_err=errs, live=[s["live"] for s in stats],
            overflow=[s["overflow"] for s in stats])
        mega = mega_vs_plain(cfg, keys, chunk=cfg.trials)
        if not torch.equal(mega.pop("vi"), final_vi):
            raise AssertionError(f"{name}: megakernel != round-by-round vi")
        mega_checks.append(dict(config=name, **mega))
        log("mega_vs_plain", config=name, tolerance=0,
            max_abs_err=mega["max_abs_err"], overflow=mega["overflow"])
    if not any(sum(c["overflow"]) for c in checks):
        raise AssertionError("no overflowing round among the kernel checks")
    if not any(c["overflow"] for c in mega_checks):
        raise AssertionError("no overflowing trial among the mega checks")
    report["kernel_vs_plain"] = checks
    report["mega_vs_plain"] = mega_checks
    random_errs, facts = random_vs_plain(dev)
    report["random_vs_plain"] = dict(max_abs_err=random_errs, cases=facts)
    log("random_vs_plain", tolerance=0, max_abs_err=random_errs, cases=facts)
    circuit_cases, circuit_timing = circuit_vs_plain(dev)
    report["circuit_vs_plain"] = dict(cases=circuit_cases,
                                      timing=circuit_timing)
    log("circuit_vs_plain", tolerance=CIRCUIT_ATOL, cases=circuit_cases,
        **circuit_timing)
    if quick:
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    fields = ("decisions", "success", "vi", "overflow")
    engines = ("xla", "pallas", "pallas_fused", "pallas_tiled", "pallas_mega")
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2, trials=64, seed=5)
    res = {e: qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine=e)).trials for e in engines}
    for e in engines[1:]:
        for f in fields:
            if not torch.equal(getattr(res["xla"], f), getattr(res[e], f)):
                raise AssertionError(f"engines xla and {e} disagree on {f}")
    # The counters ride the per-round loop: the four per-round engines.
    counted = {e: qba_tpu_torch.run_trials(dataclasses.replace(
        cfg, round_engine=e, collect_counters=True)).trials
        for e in engines[:4]}
    for e, r in counted.items():
        for f in dataclasses.fields(r.counters):
            if not torch.equal(getattr(counted["xla"].counters, f.name),
                               getattr(r.counters, f.name)):
                raise AssertionError(
                    f"counters of xla and {e} disagree on {f.name}")
        if not torch.equal(r.vi, res["xla"].vi):
            raise AssertionError(f"{e}: counters changed the accepted sets")
    log("engines_agree", config="5p/L16/d2", trials=64, engines=engines,
        counters=engines[:4],
        accepts_per_round=counted["xla"].counters.accepts_per_round.sum(0)
        .tolist(),
        success_rate=float(res["xla"].success.float().mean()))

    main_cfgs = [
        ("11p/L64/d3", QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                 trials=1000)),
        ("33p/L64/d10", QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=1000)),
    ]
    expect = {"auto": {"trial_megakernel": 1},
              "pallas_fused": {"fused_round": 1},
              "pallas_tiled": {"tiled_verdict": 1, "tiled_rebuild": 1},
              "pallas": {"round_step": 1}}
    launches = dict.fromkeys(COUNTED, 0)
    runs = []
    for name, cfg in main_cfgs:
        if resolve_round_engine(cfg, dev) != "pallas_mega":
            raise AssertionError("auto does not resolve to pallas_mega")
        per_engine, results = {}, {}
        for engine, per_batch in expect.items():
            out, wall, counts, events, peak = drive(cfg, engine)
            want = {k: per_batch.get(k, 0)
                    * (1 if k == "trial_megakernel" else cfg.n_rounds)
                    for k in COUNTED}
            if counts != want:
                raise AssertionError(
                    f"{name} {engine}: launches {counts}, expected {want}")
            for k, n in counts.items():
                launches[k] += n
            rate = float(out.success_rate)
            if not (out.trials.decisions.shape == (cfg.trials, cfg.n_parties)
                    and 0.0 <= rate <= 1.0):
                raise AssertionError(f"{name} {engine}: malformed result")
            results[engine] = out.trials
            per_engine[engine] = dict(
                launches={k: n for k, n in counts.items() if n},
                wall_s=wall, rounds_per_s=cfg.trials * cfg.n_rounds / wall,
                kernel_ms_per_launch={k: event_ms(ev)
                                      for k, ev in events.items() if ev},
                success_rate=rate, peak_mem_bytes=peak)
        for e in ("pallas_fused", "pallas_tiled", "pallas"):
            for f in fields:
                if not torch.equal(getattr(results["auto"], f),
                                   getattr(results[e], f)):
                    raise AssertionError(
                        f"{name}: pallas_mega and {e} disagree on {f}")
        log("engines_agree", config=name, trials=cfg.trials,
            engines=["pallas_mega", "pallas_fused", "pallas_tiled", "pallas"])

        keys = trial_keys(cfg, dev)
        setup, *stats = replay(cfg, keys, chunk=32, reps=5)
        if not torch.equal(setup.pop("vi"), results["auto"].vi):
            raise AssertionError(f"{name}: main path != round-by-round replay")
        mega = mega_vs_plain(cfg, keys, chunk=32, reps=3)
        if not torch.equal(mega.pop("vi"), results["auto"].vi):
            raise AssertionError(f"{name}: main path != staged megakernel")
        mega_bound = bound(*mega_cost(
            cfg, [(s["live"], s["rows"], s["dst"]) for s in stats],
            cfg.trials))
        draws_ms = sum(s["draws_ms"] for s in stats)
        per_engine["auto"].update(
            engine="pallas_mega", setup_ms=mega["setup_ms"],
            draws_ms=mega["draws_ms"],
            bound_ms={"trial_megakernel": mega_bound[0]},
            bound_by={"trial_megakernel": mega_bound[1]})
        for engine, ks in (("pallas_fused", ("fused_round",)),
                           ("pallas_tiled", ("tiled_verdict",
                                             "tiled_rebuild")),
                           ("pallas", ("round_step",))):
            per_engine[engine].update(
                engine=engine, setup_ms=setup["setup_ms"],
                draws_ms=draws_ms,
                bound_ms={k: sum(s["bound"][k][0] for s in stats)
                          / len(stats) for k in ks},
                bound_by={k: max(stats, key=lambda s: s["bound"][k][0])
                          ["bound"][k][1] for k in ks})
        kern = {}
        for k in ("fused_round", "tiled_verdict", "tiled_rebuild",
                  "round_step"):
            kern[k] = dict(
                max_abs_err=max(s["max_abs_err"][k] for s in stats),
                ms=sum(s["ms"][k] for s in stats) / len(stats),
                plain_ms=sum(s["plain_ms"][k] for s in stats) / len(stats),
                bound_ms=per_engine[ENGINE_OF[k]]["bound_ms"][k])
        kern["trial_megakernel"] = dict(
            max_abs_err=mega["max_abs_err"], ms=mega["ms"],
            plain_ms=mega["plain_ms"], bound_ms=mega_bound[0])
        run = dict(config=name, trials=cfg.trials, rounds=cfg.n_rounds,
                   vi=results["auto"].vi,
                   engines=per_engine, full_width_vs_plain=kern,
                   pool_bytes_per_trial=pool_bytes(cfg, 1),
                   replay=stats)
        for engine, e in per_engine.items():
            log("main_path", config=name, trials=cfg.trials,
                rounds=cfg.n_rounds, **e)
        log("full_width_vs_plain", config=name, tolerance=0, **kern)
        runs.append(run)
    report["main_path"] = runs

    # The protocol counters on the default engine: they need the
    # per-round loop, so `auto` runs the fused per-round engine.
    name, cfg = main_cfgs[0]
    ccfg = dataclasses.replace(cfg, collect_counters=True)
    if resolve_round_engine(ccfg, dev) != "pallas_fused":
        raise AssertionError("auto with counters is not pallas_fused")
    out, wall, counts, _events, peak = drive(ccfg, "auto")
    want = {k: cfg.n_rounds if k == "fused_round" else 0 for k in COUNTED}
    if counts != want:
        raise AssertionError(
            f"{name} counters: launches {counts}, expected {want}")
    launches["fused_round"] += counts["fused_round"]
    c = out.trials.counters
    base = runs[0]["engines"]["pallas_fused"]
    if not (torch.equal(out.trials.vi, runs[0]["vi"])
            and c.accepts_per_round.shape == (cfg.trials, cfg.n_rounds)
            and torch.equal(c.accept_counts,
                            out.trials.vi.sum(-2, dtype=torch.int32))
            and torch.equal(c.overflow_rounds.any(-1), out.trials.overflow)):
        raise AssertionError(f"{name}: counters disagree with the results")
    counters_run = dict(
        config=name, trials=cfg.trials, engine="pallas_fused",
        launches={"fused_round": counts["fused_round"]}, wall_s=wall,
        rounds_per_s=cfg.trials * cfg.n_rounds / wall,
        rounds_per_s_without=base["rounds_per_s"], peak_mem_bytes=peak,
        accepts_per_round=c.accepts_per_round.sum(0).tolist(),
        slot_high_water=int(c.slot_high_water.max()),
        overflow_rounds=c.overflow_rounds.sum(0).tolist())
    report["counters"] = counters_run
    log("main_path", collect_counters=True, **counters_run)
    for r in runs:
        del r["vi"]

    # The dense circuit path at the widest circuit it admits: 5 parties,
    # 18 qubits, every list position a joint statevector.
    from qba_tpu_torch.rounds.engine import setup_trial

    dcfg = QBAConfig(n_parties=5, size_l=64, n_dishonest=2,
                     qsim_path="dense_pallas", trials=64)
    out, wall, counts, events, peak = drive(dcfg, "auto")
    want = {k: int(k == "trial_megakernel") for k in ROUND_KERNELS}
    if ({k: counts[k] for k in ROUND_KERNELS} != want
            or counts["fused_circuit"] < 1):
        raise AssertionError(f"dense_pallas: launches {counts}")
    for k, n in counts.items():
        launches[k] += n
    pcfg = dataclasses.replace(dcfg, qsim_path="dense")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_out = qba_tpu_torch.run_trials(pcfg)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    for f in fields + ("honest", "v_comm"):
        if not torch.equal(getattr(out.trials, f),
                           getattr(plain_out.trials, f)):
            raise AssertionError(f"dense_pallas and dense disagree on {f}")
    keys = trial_keys(dcfg, dev)
    t0 = time.perf_counter()
    fast_setup = setup_trial(dcfg, keys)
    torch.cuda.synchronize()
    lists_s = time.perf_counter() - t0
    for a, b in zip(fast_setup, setup_trial(pcfg, keys)):
        if not torch.equal(a, b):
            raise AssertionError("dense_pallas and dense lists disagree")
    li = fast_setup[1]
    if not (li.shape == (dcfg.trials, dcfg.n_lieutenants, dcfg.size_l)
            and int(li.min()) >= 0 and int(li.max()) < dcfg.w):
        raise AssertionError("dense_pallas: malformed lists")
    dense_run = dict(
        config="5p/L64/d2 dense_pallas", trials=dcfg.trials,
        qubits=dcfg.total_qubits, engine="pallas_mega",
        launches={k: n for k, n in counts.items() if n}, wall_s=wall,
        rounds_per_s=dcfg.trials * dcfg.n_rounds / wall,
        plain_engine_wall_s=plain_wall, setup_with_lists_s=lists_s,
        circuit_ms_per_launch=event_ms(events["fused_circuit"]),
        success_rate=float(out.success_rate), peak_mem_bytes=peak)
    report["dense_path"] = dense_run
    log("main_path", qsim_path="dense_pallas", **dense_run)

    big = runs[-1]
    kernels = []
    for k in ("fused_round", "trial_megakernel", "tiled_verdict",
              "tiled_rebuild", "round_step"):
        e = big["engines"][ENGINE_OF[k]]
        source, replaces = SOURCES[k]
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max([r["full_width_vs_plain"][k]["max_abs_err"]
                                for r in runs] + [random_errs[k]]),
            "ms": e["kernel_ms_per_launch"][k],
            "plain_ms": big["full_width_vs_plain"][k]["plain_ms"],
            "bound_ms": e["bound_ms"][k],
            "bound_by": e["bound_by"][k],
            "library_ms": None,
            "config": f"{big['config']} x{big['trials']} trials",
        })
    source, replaces = SOURCES["fused_circuit"]
    kernels.append({
        "name": "fused_circuit", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["fused_circuit"],
        "max_abs_err": max(c["max_abs_err"] for c in circuit_cases),
        "ms": circuit_timing["ms"], "plain_ms": circuit_timing["plain_ms"],
        "bound_ms": circuit_timing["bound_ms"],
        "bound_by": circuit_timing["bound_by"], "library_ms": None,
        "config": (f"5p Q-correlated circuit, {circuit_timing['qubits']} "
                   f"qubits x{circuit_timing['runs']} runs per launch"),
    })
    report["kernels"] = kernels
    report["device"] = card
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
