#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes

Phases, each reported on its own line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``qba_tpu_torch/ops/csrc`` (build time);
3. the fused round kernel against its plain PyTorch version, bit-exact on
   every output, round by round, on protocol state of real trials at
   5p/L16/d2, 11p/L64/d3 (strategy "split"), 33p/L64/d10 and an
   overflowing ``max_accepts_per_round`` case;
4. ``run_trials`` with ``round_engine="pallas_fused"`` equals
   ``round_engine="xla"`` trial for trial at 5p/L16/d2;
5. the main path at full width: ``run_trials(QBAConfig(...))`` with 1000
   trials at 11p/L64/d3 and 33p/L64/d10, launch counts asserted
   (``n_rounds`` per batch), wall time after a warm-up, rounds/s
   (trials x n_rounds / s), kernel time per launch from CUDA events,
   success rate and peak memory; then the same batches replayed round by
   round with the kernel held against the plain version (bit-exact),
   the plain version's time per round, and the kernel's bound.

Any failure exits non-zero.  The second-to-last line is the kernel
table as JSON, the last ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke_report.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor
# float32 rate, the closest listed rate for the kernel's integer compares.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
REPORT = os.path.join("build", "chip_smoke_report.json")


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_err(a, b):
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max())


def round_bound(cfg, pool, n_trials):
    """Least time for one round on these inputs: the larger of the bytes
    the round must move over HBM bandwidth (live packets' valid rows,
    lens, P, meta and draws, every packet's meta, li and vi in; the whole
    successor pool and vi out) and its element compares over the core
    rate.  Returns ``(ms, "bytes" | "operations")``."""
    import torch

    n_rv, slots, max_l, s, w = (cfg.n_lieutenants, cfg.slots, cfg.max_l,
                                cfg.size_l, cfg.w)
    n_pool = n_rv * slots
    meta = pool[3]
    sent = meta[..., 2] != 0
    cnt = torch.where(sent, meta[..., 0].clamp(0, max_l), 0).long()
    live = int(sent.sum())
    rows = int(cnt.sum())
    bytes_in = (rows * (s + 4) + live * (s + 3 * n_rv + 4)
                + n_trials * (n_pool * 16 + n_rv * s * 4 + n_rv * w * 4))
    bytes_out = n_trials * (max_l * n_pool * s + n_pool * max_l * 4
                            + n_pool * s + n_pool * 16 + n_rv * w * 4 + 4)
    ops = (rows + 3 * live) * s * n_rv
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def replay(cfg, keys, *, chunk, reps=0):
    """Run ``cfg``'s round loop on ``keys`` step by step with the kernel,
    holding every round's outputs against the plain version on the same
    inputs.  With ``reps`` > 0 also times both.  Returns the set-up time
    (setup, step 3a, pool) and final accepted sets, then per-round stats
    with each round's draw time; host-clock times are fenced by
    ``torch.cuda.synchronize()``."""
    import torch

    from qba_tpu_torch import random as jr
    from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
    from qba_tpu_torch.ops.round_kernel_tiled import (
        empty_pool,
        fused_round,
        fused_round_reference,
        honest_cells,
        pool_from_step3a,
    )
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    n = keys.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    pool = pool_from_step3a(cfg, out_cells)
    spare = empty_pool(cfg, n, keys.device)
    hc = honest_cells(honest, cfg)
    li = li.to(torch.int32).contiguous()
    vi_i = vi.to(torch.int32)
    torch.cuda.synchronize()
    stats = [dict(setup_ms=(time.perf_counter() - t0) * 1e3)]
    for r in range(1, cfg.n_rounds + 1):
        t0 = time.perf_counter()
        att, rv, late = (x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        torch.cuda.synchronize()
        draws_ms = (time.perf_counter() - t0) * 1e3
        bound_ms, bound_by = round_bound(cfg, pool, n)
        live = int((pool[3][..., 2] != 0).sum())
        new, vi_k, ovf_k = fused_round(cfg, r, pool, li, vi_i, hc, att, rv,
                                       late, out=spare)
        torch.cuda.synchronize()
        ms = None
        if reps:
            fused_round.events = []
            for _ in range(reps):
                fused_round(cfg, r, pool, li, vi_i, hc, att, rv, late,
                            out=spare)
            torch.cuda.synchronize()
            ms = sum(a.elapsed_time(b) for a, b in fused_round.events) / reps
            fused_round.events = None
        parts = []
        t0 = time.perf_counter()
        for a in range(0, n, chunk):
            sl = slice(a, a + chunk)
            parts.append(fused_round_reference(
                cfg, r, tuple(x[sl] for x in pool), li[sl], vi_i[sl],
                hc[sl], att[sl], rv[sl], late[sl]))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ref_pool = [torch.cat([p[0][i] for p in parts]) for i in range(4)]
        ref_vi = torch.cat([p[1] for p in parts])
        ref_ovf = torch.cat([p[2] for p in parts])
        err = max(
            [max_err(a, b) for a, b in zip(new, ref_pool)]
            + [max_err(vi_k, ref_vi), max_err(ovf_k, ref_ovf)]
        )
        stats.append(dict(round=r, live=live, max_abs_err=err, ms=ms,
                          draws_ms=draws_ms,
                          plain_ms=plain_ms if reps else None,
                          bound_ms=bound_ms, bound_by=bound_by,
                          overflow=int(ovf_k.sum())))
        if err:
            raise AssertionError(
                f"fused_round kernel != plain version at {cfg} round {r}: "
                f"max abs err {err}")
        pool, spare, vi_i = new, pool, vi_k
    stats[0]["vi"] = vi_i != 0
    return stats


def main(argv):
    quick = "--quick" in argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    import qba_tpu_torch
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.torch_backend import fence, trial_keys
    from qba_tpu_torch.ops import _build
    from qba_tpu_torch.ops.round_kernel_tiled import empty_pool, fused_round

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
    log("build", seconds=build_s, ptxas=ptxas)

    small = [
        ("5p/L16/d2", QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                trials=8, seed=11)),
        ("11p/L64/d3 split", QBAConfig(n_parties=11, size_l=64,
                                       n_dishonest=3, trials=8, seed=12,
                                       strategy="split")),
        ("5p/L16/d2 slots=1", QBAConfig(n_parties=5, size_l=16,
                                        n_dishonest=2, trials=16, seed=2,
                                        max_accepts_per_round=1)),
        ("33p/L64/d10", QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=4, seed=13)),
    ]
    checks = []
    for name, cfg in small:
        stats = replay(cfg, trial_keys(cfg, dev), chunk=cfg.trials)[1:]
        checks.append(dict(config=name, rounds=len(stats),
                           live=[s["live"] for s in stats],
                           overflow=[s["overflow"] for s in stats]))
        log("kernel_vs_plain", config=name, rounds=len(stats),
            tolerance=0, max_abs_err=max(s["max_abs_err"] for s in stats),
            live=[s["live"] for s in stats],
            overflow=[s["overflow"] for s in stats])
    if not any(sum(c["overflow"]) for c in checks):
        raise AssertionError("no overflowing round among the kernel checks")
    report["kernel_vs_plain"] = checks
    if quick:
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2, trials=64, seed=5)
    res = {e: qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine=e)).trials
        for e in ("xla", "pallas_fused")}
    for f in ("decisions", "success", "vi", "overflow"):
        if not torch.equal(getattr(res["xla"], f),
                           getattr(res["pallas_fused"], f)):
            raise AssertionError(f"engines disagree on {f}")
    log("engines_agree", config="5p/L16/d2", trials=64,
        success_rate=float(res["xla"].success.float().mean()))

    main_cfgs = [
        ("11p/L64/d3", QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                 trials=1000)),
        ("33p/L64/d10", QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=1000)),
    ]
    main_runs, launches = [], 0
    for name, cfg in main_cfgs:
        fence(qba_tpu_torch.run_trials(cfg))  # warm-up
        torch.cuda.reset_peak_memory_stats()
        fused_round.launches = 0
        fused_round.events = []
        t0 = time.perf_counter()
        out = fence(qba_tpu_torch.run_trials(cfg))
        wall = time.perf_counter() - t0
        n_launch = fused_round.launches
        events, fused_round.events = fused_round.events, None
        if n_launch != cfg.n_rounds:
            raise AssertionError(
                f"{name}: {n_launch} kernel launches, expected "
                f"{cfg.n_rounds} (one per round)")
        launches += n_launch
        kernel_ms = sum(a.elapsed_time(b) for a, b in events) / n_launch
        rate = float(out.success_rate)
        if not (out.trials.decisions.shape == (cfg.trials, cfg.n_parties)
                and 0.0 <= rate <= 1.0):
            raise AssertionError(f"{name}: malformed result")
        run = dict(config=name, trials=cfg.trials, rounds=cfg.n_rounds,
                   launches=n_launch, wall_s=wall,
                   rounds_per_s=cfg.trials * cfg.n_rounds / wall,
                   kernel_ms_per_launch=kernel_ms, success_rate=rate,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   pool_bytes_per_trial=sum(
                       x.nbytes for x in empty_pool(cfg, 1, dev)),
                   draw_cells_per_round=(cfg.trials * cfg.n_lieutenants
                                         * cfg.slots * cfg.n_lieutenants))
        setup, *stats = replay(cfg, trial_keys(cfg, dev), chunk=32, reps=5)
        if not torch.equal(setup.pop("vi"), out.trials.vi):
            raise AssertionError(f"{name}: main path != round-by-round replay")
        run["replay"] = stats
        run["setup_ms"] = setup["setup_ms"]
        run["draws_ms_per_round"] = (
            sum(s["draws_ms"] for s in stats) / len(stats))
        run["replay_kernel_ms"] = sum(s["ms"] for s in stats) / len(stats)
        run["plain_ms_per_round"] = (
            sum(s["plain_ms"] for s in stats) / len(stats))
        run["bound_ms_per_round"] = (
            sum(s["bound_ms"] for s in stats) / len(stats))
        run["bound_by"] = max(stats, key=lambda s: s["bound_ms"])["bound_by"]
        run["max_abs_err"] = max(s["max_abs_err"] for s in stats)
        run["tolerance"] = 0
        log("main_path", **{k: v for k, v in run.items() if k != "replay"})
        main_runs.append(run)
    report["main_path"] = main_runs

    big = main_runs[-1]
    kernels = [{
        "name": "fused_round",
        "route": "cuda",
        "source": "qba_tpu_torch/ops/csrc/fused_round.cu",
        "replaces": "qba_tpu/ops/round_kernel_tiled.py:1270",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_runs),
        "ms": big["kernel_ms_per_launch"],
        "plain_ms": big["plain_ms_per_round"],
        "bound_ms": big["bound_ms_per_round"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "config": big["config"] + " x1000 trials",
    }]
    report["kernels"] = kernels
    report["device"] = card
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
