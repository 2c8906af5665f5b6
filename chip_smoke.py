#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qba_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel checks at small shapes

Phases, each reported on its own line:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``qba_tpu_torch/ops/csrc``, one ``nvcc``
   per source, all started together (build time, registers, spills);
   the CUDA driver's and runtime's versions (the device surface's SWITCH
   node needs a 12.8 driver);
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
   the compiler may fuse a multiply and an add) on each of its routes
   (one block's shared memory, a cluster's, global memory): both
   protocol circuits at 3, 4 and 5 parties (8, 15, 18 qubits) with
   random params, seeded random circuits at 10, 16 and 17 qubits with
   complex gates, multi-control ops and ``XPOW``, and real ones at 19
   and 20 qubits;
   ``sweep_vs_plain``: the GF(2) sweep kernel (each family's affine map)
   against its plain version (the serial sweep), bit-exact, on the
   protocol's stabilizer tableaux at 5, 11, 33 and 65 parties (some with
   noise; the kernel keeps the maps in shared memory up to 33 parties
   and reads them where they lie at 65) and on seeded random Clifford
   tableaux of 13 to 400 qubits, on both sides of that rule, whose steps
   take both branches and pivots past the first stabilizer row;
   ``sweep_65p``: the sweep kernel over a 1000-trial batch at 65 parties
   (462 qubits), timed, with its bound;
   ``gen_vs_plain``: the trial megakernel's gen entry against its plain
   version at 11p/L64/d3 (strategy "split", noise) and 33p/L64/d10 on
   32 trials, and against the host-gen megakernel on the same lists;
   the party-sharded kernels: the ``n_recv`` variants of the fused
   round, the tiled verdict and rebuild and the dense-mailbox round in
   ``kernel_vs_plain`` (each shard against the round's pool or mailbox,
   its accepted sets, verdicts and overflow the single-device round's,
   the tiled pair's segments the fused round's, the local mailboxes in
   shard order the single-device successor) and ``random_vs_plain``
   (assembled pools with empty and full segments and stale entries
   between them, a far denser accepted matrix for the rebuild, gathered
   mailboxes whose unsent cells hold stale packets; each variant accepts
   and overflows somewhere); ``ring_vs_plain``, the ring gather at
   ``tp`` 2, 4 and 8 on int8, int32, bool, uint8 and int64 segments of
   ragged tile counts (bit-exact); ``sharded_mega_vs_plain``, the party-sharded trial
   megakernel on the ``small`` list at every ``tp <= 8`` dividing the
   lieutenants, against its plain version and the single-device
   megakernel trial for trial (some trial overflows);
   ``draws_vs_plain``: the draws kernel against its plain version,
   bit-exact, on every round of 32 trials at 11p/L64/d3 and 33p/L64/d10
   in every strategy (``reference``, ``collude``, ``adaptive``,
   ``split``) under the delivery scope and ``reference`` under the
   broadcast scope, each under ``sync`` and ``racy`` delivery;
   ``keyed_vs_plain``: the megakernels' keyed entries (which hash their
   own draws, the ones the engines launch) in the same combinations, at
   11p (32 trials) and 33p (16), and at 11p with one slot a round (some
   trial overflows): single-device, party-sharded at ``tp`` 2 and 4 and
   the gen entry on ``qsim_path="stabilizer"``, each against its plain
   version and its stacked form, trial for trial;
   ``sweep_stop_vs_plain``: the sweep loop's stop kernel against its
   plain version, bit-exact on the carry, at every index of a four-chunk
   budget and past it, on seeded random chunks of 1 to 5000 trials;
   ``surface_vs_plain``: the device surface's ``surface_pick`` and
   ``surface_fold`` against their plain versions on the card's tensors,
   on seeded random carries of 1, 4, 33 and 256 cells (up to 32 chunks of
   1000 trials a cell, a quarter done) under two thresholds and a width
   target: the chosen cell and its tier exact, the endpoints within
   ``PICK_ATOL`` (equal expected), the fold bit-exact;
5. ``engines_agree``: ``run_trials`` with the ``xla``, ``pallas``,
   ``pallas_fused``, ``pallas_tiled`` and ``pallas_mega`` engines trial
   for trial at 5p/L16/d2 x 64, and the protocol counters of the four
   per-round engines field by field;
6. ``main_path``, at full width, 11p/L64/d3 and 33p/L64/d10 x 1000 trials
   each: ``run_trials(QBAConfig(...))`` with ``auto`` (asserted to
   resolve to the keyed megakernel, one launch per batch and no draws
   launch), then the ``pallas_fused`` (one launch per round),
   ``pallas_tiled`` (two per round) and ``pallas`` (one per round)
   engines, each also one draws launch per round, each with its launch
   counts reset just before and asserted just after; wall time after a
   warm-up, rounds/s (trials x n_rounds / s), kernel time per launch
   from CUDA events, set-up and draw times, success rate and peak
   memory.  The four engines must agree trial for trial.  Then
   ``full_width_vs_plain``: the same batches replayed round by round
   with the fused, verdict, rebuild and dense-mailbox kernels held
   against their plain versions (bit-exact, with times and bounds), each
   round's draws (the draws kernel a round a launch, as the per-round
   engines launch it) held against the plain draws, and
   the keyed megakernel held against its plain version and its stacked
   form on the batch's own inputs; ``draws_timing``, the draws kernel
   over all the batch's rounds in one launch, held bit for bit against
   its plain version on the whole batch, with its bound; ``keyed_timing``, the keyed megakernel beside the
   stacked one under the broadcast scope, racy delivery and the
   adaptive strategy.  Then ``collect_counters=True`` on ``auto`` at 11p/L64/d3 x
   1000 (asserted to run the fused per-round engine), and the dense
   circuit path at the widest circuit it admits,
   ``qsim_path="dense_pallas"`` at 5p/L64/d2 x 32 (18 qubits), with the
   circuit kernel's launches asserted and its lists and results equal to
   the same run on ``qsim_path="dense"`` (the plain per-gate engine on
   the card);
7. the stabilizer path at full width, ``qsim_path="stabilizer"`` at
   11p/L64/d3 and 33p/L64/d10 x 1000: ``auto`` (asserted to be one launch
   of the megakernel's gen entry and none of the sweep kernel),
   ``mega_gen="host"`` (one sweep launch, one host-gen megakernel launch)
   and ``pallas_fused`` (one sweep launch, one fused round per round),
   equal trial for trial, each with rounds/s, kernel ms per launch,
   set-up, draws and peak memory; then the gen entry timed (with its
   shared memory and resident blocks per SM) against the host-gen
   megakernel on the same lists (the sweep's share), the sweep kernel
   over the batch against its plain version (timed behind a sleep), and
   the bounds of both (the sweep as its affine map, the serial sweep's
   operation count from the run's own pivots beside it);
8. ``mesh_path``, the party-sharded (``tp``) path on one card:
   ``run_trials_spmd`` on ``make_mesh({"dp": 1, "tp": tp},
   devices=[cuda:0] * tp)`` at 33p/L64/d10 x 1000 (``tp = 4``) and
   11p/L64/d3 x 1000 (``tp = 2``): ``auto`` (asserted the sharded
   megakernel, one launch), then ``pallas_fused``, ``pallas_tiled`` and
   ``pallas``, each with the ring (per round 4 ring launches, one per
   pool or mailbox leaf, and the engine's ``n_recv`` kernels: one fused
   round, a verdict and a rebuild, or one dense-mailbox round) and with
   ``all_gather`` (no ring launch), each equal trial for trial to the
   single-device ``run_trials`` of phase 6, with rounds/s, kernel ms per
   launch and peak memory; then the ring timed on the batch's step-3a
   segments against its plain version and one PyTorch broadcast copy,
   the sharded megakernel against its plain version at full width, the
   ``n_recv`` verdict, rebuild and dense-mailbox round replayed round by
   round on the batch against their plain versions and the
   single-device round (timed, with bounds), and 33p x 64 trials on the
   sharded megakernel (``tp = 4``) beside the single-device one;
9. ``mega_phases``: the keyed megakernel's phase clock (its ``kClock``
   instantiation, launched here and by ``examples/torch_kernel_ab.py``
   only) on the 11p and 33p batches, 33p x 64 and the sharded entry at
   ``tp = 4``: per phase, warp 0's SM cycles per block and its share,
   and the blocks' mean and largest sums, on a line of its own;
   ``round_phases``: the same for the fused round, the dense-mailbox
   round and the tiled verdict and rebuild (their clocked
   instantiations, each round's result equal to the unclocked launch's)
   over every round of the 11p and 33p batches and, as ``n_recv``
   variants, of the 33p batch at ``tp = 4``.
10. ``sweep_path``: the precision-targeted sweep, ``run_sweep(cfg,
   12, 1000, target=...)`` at 33p/L64/d10 and 11p/L64/d3 (seed 3), a
   decide target at each width that stops inside the budget and one at
   33p that spends it, and at 33p on ``qsim_path="stabilizer"`` (the gen
   entry; budget 4): the host loop (one chunk a dispatch, one readback
   a chunk) and the graph loop (``dispatch="device"``: one launch of a
   CUDA graph whose WHILE node runs the captured chunk, keys to
   ``sweep_stop``, and one readback), equal chunk for chunk and in their
   stop decision to each other and to the fixed-budget run's prefix,
   with launch counts asserted (the graph loop launches each kernel once
   eagerly as its warm-up and once into the capture; the graph then
   runs them once a chunk), readbacks, wall, rounds/s and ms a chunk
   over the executed chunks, the graph's warm-up, capture and
   instantiate ms and its body's node types; then ``sweep_stop`` on a
   33p chunk against its plain version, timed, with its bound.
11. ``surface_path``: the device surface at 33p/L64/d10, chunks of 1000
   trials, seed 3, over strategies ``reference`` and ``split`` x noise
   0 and 0.01 x ``sizeL`` 64 (four cells).  Run A: the first target of
   ``SURFACE_TARGETS`` under which the host surface resolves every cell
   inside a shared budget of 48 chunks, then ``run_surface(...,
   dispatch="device")``: one launch of a CUDA graph whose WHILE node runs
   ``surface_pick``, a SWITCH node into the chosen cell's captured chunk
   and ``surface_fold``, and one readback, equal to the host surface cell
   by cell (chunks, stop, spent chunks) and each cell to its own targeted
   ``run_sweep``.  Run B: budget 6, where the budget runs out: the
   device's schedule and tiers beside the host allocator's, equal but at
   near-ties (printed), a pass out of capture order (the captures share
   one memory pool).  Launch counts asserted (each kernel once eagerly
   and once captured, the megakernel once each a cell), ms a pass of the
   graph against the host surface's ms a chunk, warm-up, capture (a cell)
   and instantiate ms, node counts a branch and in all, peak memory; the
   two kernels timed at run A's totals (CUDA events and queued behind a
   sleep) with their plain versions' ms and bounds; and ``python -m
   qba_tpu_torch sweep ... --dispatch device`` at 11p/L64/d3 x 1000 in a
   process of its own, stopping below 0.3 after 7 chunks.
12. ``serve_path``: the serving worker (``qba_tpu_torch.serve``).  The
   host path: a ``QBAServer(chunk_trials=64, depth=2)`` fed through
   ``serve_jsonl`` in process with four 1000-trial requests, 33p/L64/d10
   targeted (``decide vs 0.58 +-0.02``) and untargeted, 11p/L64/d3 with
   ``return_decisions`` and 33p on ``qsim_path="stabilizer"``, after one
   warm-up pass of the same stream; one keyed megakernel (or gen entry)
   launch a chunk, asserted; every result equal to a direct
   ``run_trials`` of its config and keys, trial for trial (decisions
   where returned); per request its latency, chunks, rounds/s, the
   medians of ``serve.dispatch`` and ``serve.readback`` and the
   megakernel's CUDA-event ms a chunk; peak memory; the same stream's
   wall at depth 1; a probe of whether a dispatch reads the card (one
   dispatch under ``torch.cuda.set_sync_debug_mode("error")``, the key
   upload timed behind a sleep kernel, which it must not wait out, and
   a whole dispatch behind a sleep beside the time to enqueue 256 to
   4096 tiny kernels behind one: the launch queue's depth).  The device
   path: the
   targeted request on a ``dispatch="device"`` server, one graph launch
   and one readback (the loop's chunk gathers the request's key rows by
   the carry's index, and ``sweep_stop`` stores the success bits), equal
   to its host-path twin in stop, trials, success and interval, with the
   graph's warm-up, capture, instantiate and loop ms and node types.
   ``sweep_stop`` storing the bits of a 64-trial chunk against its plain
   version, timed.  Then ``python -m qba_tpu_torch serve --transport
   file-queue`` in a process of its own answers one 11p x 1000 request
   dropped in its inbox (equal to a direct run): its wall and engine.
13. ``fleet_path``: the fleet (``qba_tpu_torch.serve.fleet``).  First the
   admission's byte model (``analysis.memory.batch_bytes``) held at or
   above ``torch.cuda.max_memory_allocated`` (above what was held
   before) for a 64-trial chunk and a 1000-trial batch at 11p/L64/d3,
   33p/L64/d10 and 33p ``stabilizer``, a 1000-trial ``pallas_fused``
   batch and a 64-trial ``xla`` batch at 11p.  Then ``python -m qba_tpu_torch fleet --replicas 2
   --supervise --chunk-trials 64 --depth 2`` in a process group of its
   own (queue, cache and telemetry under a temporary directory), both
   workers on card 0: ``serve_path``'s four requests over one socket and
   one 11p request by HTTP POST, every result equal to a direct
   ``run_trials`` of its config and keys on the keyed megakernel (or its
   gen entry); one busy worker SIGKILLed after the first result, the
   supervisor's respawn, every request answered once; ``GET /metrics``
   and ``/status``; ``fleet_summary.json``; ``python -m qba_tpu_torch
   trace`` (one closed trace per request, no orphan span); the card's
   compute processes (``nvidia-smi``) and each process's open
   ``/dev/nvidia*`` files (the workers', not the fleet process's); each
   request's latency and queue wait, each worker's boot (spawn to its
   ``boot`` note with its first ``idle`` beat) and the respawn (kill to
   the replacement's); the same mix on a 1-replica and a clean 2-replica
   fleet, for the wall.  The workers' launches come from their exit
   summaries.
14. ``atlas_path``: ``python -m qba_tpu_torch atlas`` over 11p and 33p x
   dishonest 0 and 1/3 x ``reference`` and ``split`` x noise 0:0 and
   0.05:0.02 at ``sizeL`` 64 (16 cells, chunks of 64, budget 1024, one
   escalation) through a supervised 2-replica fleet with one worker
   SIGKILLed after the first result, and with ``--executor local``: no
   cell open and the two stores' digests equal.
15. ``run_path``: the reference's own runtime, the message-level
   backends (``qba_tpu_torch.backends``), their randomness presampled on
   the card (one ``attack_draws`` launch over every round and trial, one
   host copy).  At 11p/L64/d3 and 33p/L64/d10 x 1000 (seed 0): ``native``
   over the whole batch, ``local`` over its first 200 (11p) or 20 (33p)
   trials and ``mp`` (one party process a party over a Unix-socket mesh,
   started once a batch from a forkserver) over its first 100 or 10, each
   equal to the batched runner's ``auto`` batch trial for trial
   (decisions, success, honest, vi, overflow); the same on ``small``'s
   ``11p/L64/d3 split``, ``5p/L16/d2 slots=1`` and ``5p/L16/d1 racy``
   (``racy_mode="defer"``), and ``native`` at 33p on
   ``qsim_path="stabilizer"`` (a sweep launch in the presample) and at
   5p/L64/d2 x 32 on ``dense_pallas`` (circuit kernel launches).  Each
   presample's launches counted, its draws equal to the plain draws bit
   for bit in the layouts the backends read; no party holds a
   ``/dev/nvidia*`` file, every party exits 0.  Per backend: wall,
   trials/s, the presample's set-up, draws (the kernel's CUDA-event ms)
   and host copy, the message loop, the mesh's start.  Then a warm 33p
   ``run_trials`` batch under ``profile_trace`` (its one megakernel
   launch counted; device busy ms, top kernels, idle share of the
   window), a ``fork`` of this process
   (the ``/dev/nvidia*`` files a forked party would inherit), and
   ``python -m qba_tpu_torch run``: every backend at 11p x 100 (exit 0,
   the same verdict blocks and success rate), at 11p x 4 with ``-v
   --jsonl`` (the same trail), and ``--backend torch`` and ``native`` at
   33p x 1000 with ``--profile-dir`` (each trace's device account).
16. ``lint_path``: the invariant checker (``qba_tpu_torch.analysis``).
   ``python -m qba_tpu_torch lint --effects --protocol --obs`` over the
   built-in matrix in a process of its own exits 0 with the JAX
   package's findings-JSON keys (its launches, from the JSON's stats,
   count in the kernel line).  In process, at 11p/L64/d3 and 33p/L64/d10
   x 64 trials: the launch pin of ``xla``, ``pallas``, ``pallas_tiled``,
   ``pallas_fused``, ``pallas_mega`` and ``auto``, of 33p ``stabilizer``
   ``auto`` and of the 33p ``tp = 4`` mesh (``auto`` and the three
   per-round engines), each batch's launches counted by the wrappers, at
   the seams and by ``torch.profiler``'s kernel records, all equal to the
   engine's model; the sync probe (the graph loop's chunk on each engine,
   on the fused round with counters and on 3p ``dense`` and
   ``dense_pallas``, warmed up, under
   ``torch.cuda.set_sync_debug_mode("error")``: none may raise); the
   per-round engines' ping-pong carry; the exact-dot records of a 33p
   ``stabilizer`` and a 5p/L64/d2 x 32 ``dense_pallas`` batch.  Per check
   its wall and findings; any finding fails.
17. ``graph_path``: the graph loop on every engine and list path.  Sweeps
   (``GRAPH_SWEEPS``, seed 3, chunks of 1000): 33p/L64/d10 on
   ``pallas_fused``, ``pallas``, ``pallas_tiled`` and ``auto`` with
   ``collect_counters=True``, 11p/L64/d3 on ``xla``, and 5p/L64/d2 x 32
   on ``dense_pallas`` and ``dense``; each case's graph loop, host loop
   and fixed-budget run equal chunk for chunk and stop for stop, launch
   counts asserted against the launch model (the graph's warm-up and
   capture once each), with ms a chunk by graph and by host, the graph's
   warm-up, capture and instantiate ms, body nodes by type and peak
   memory.  The worker's device path (``GRAPH_SERVE``): a targeted 33p
   request on ``pallas_fused`` and a 5p ``dense_pallas`` request, equal
   to the host path and a direct ``run_trials``.  The device surface: 4
   cells at 33p on ``pallas_fused`` and 16 cells at 33p on ``auto`` (4
   strategies x 2 noise points x 2 sizeL; budgets of one and two passes
   a cell, for a first and a repeat pass's ms), each against the host
   surface, with instantiate, upload, nodes a branch and peak memory.

Any failure exits non-zero.  The line before the last is the kernel
table as JSON, the one before it the card; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke_report.json``.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor
# float32 rate (an FMA counted as two operations), which bounds the
# circuit kernel's float arithmetic.  The other kernels' work is 32-bit
# integer adds, shifts, compares and bitwise operations, which issue at
# 64 a clock an SM on compute capability 9.0 against 128 float32 FMAs
# (CUDA C++ Programming Guide, the throughput table of arithmetic
# instructions): their rate is int_ops_per_s().
HBM_BYTES_PER_S = 3.35e12
FLOAT_OPS_PER_S = 67e12
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
    # The counterpart of the JAX host sweep, not of a pallas_call site.
    "gf2_sweep": ("qba_tpu_torch/ops/csrc/gf2_sweep.cu",
                  "qba_tpu/gf2/symplectic.py:121"),
    "trial_megakernel_gen": ("qba_tpu_torch/ops/csrc/trial_megakernel.cu",
                             "qba_tpu/ops/trial_megakernel.py:102"),
    "sharded_trial_megakernel": ("qba_tpu_torch/ops/csrc/trial_megakernel.cu",
                                 "qba_tpu/ops/trial_megakernel.py:983"),
    "ring_gather": ("qba_tpu_torch/ops/csrc/ring_shuffle.cu",
                    "qba_tpu/ops/ring_shuffle.py:97"),
    # The counterpart of the XLA-compiled threefry and adversary draws,
    # not of a pallas_call site.
    "attack_draws": ("qba_tpu_torch/ops/csrc/attack_draws.cu",
                     "qba_tpu/adversary/model.py:250"),
    # The counterpart of the condition and per-chunk reduce of the sweep's
    # lax.while_loop, not of a pallas_call site.
    "sweep_stop": ("qba_tpu_torch/ops/csrc/sweep_loop.cu",
                   "qba_tpu/sweep.py:317"),
    # The counterparts of the device surface's loop body (its scoring over
    # qba_tpu/stats/device.py:144, and its fold and condition), not of a
    # pallas_call site.
    "surface_pick": ("qba_tpu_torch/ops/csrc/surface_loop.cu",
                     "qba_tpu/sweep.py:705"),
    "surface_fold": ("qba_tpu_torch/ops/csrc/surface_loop.cu",
                     "qba_tpu/sweep.py:732"),
}
# 32-bit operations of one threefry2x32 (csrc/draws.cuh): 20 rounds of an
# add, a rotate and a xor, and the key injections.
HASH_OPS = 80


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


@functools.cache
def int_ops_per_s():
    """The card's 32-bit integer rate: 64 operations a clock on each SM
    at the largest SM clock ``nvidia-smi --query-gpu=clocks.max.sm``
    prints (132 SMs at 1980 MHz on the H100 SXM: 16.7e12)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 64 * sms * mhz * 1e6


def bound(bytes_moved, ops, float_ops=False):
    """Least time in ms for this many bytes and operations, 32-bit
    integer ones or (``float_ops``) float32 ones: ``(ms, "bytes" |
    "operations")``."""
    rate = FLOAT_OPS_PER_S if float_ops else int_ops_per_s()
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def acc_bytes(cfg, n_trials, n_tp=1):
    """Bytes of one round's accepted matrix over ``n_tp`` shards: one bit
    a (packet, receiver), each shard's ``n_local`` receivers' bits of a
    packet in whole bytes (``ceil(n_local / 8)``), whatever layout a
    kernel writes or reads them in (the kernels hold a 64-bit word a
    packet a shard)."""
    n_local = cfg.n_lieutenants // n_tp
    return (n_tp * n_trials * cfg.n_lieutenants * cfg.slots
            * -(-n_local // 8))


def verdict_cost(cfg, live, rows, n_trials):
    """Bytes and compares of one round's verdict: in, the live packets'
    valid rows (vals and lens), P, meta and their cells' three draws per
    receiver, every packet's meta (the scan), li and vi; out, acc (one
    bit a packet and receiver, ``acc_bytes``) and vi."""
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    b_in = (rows * (s + 4) + live * (s + 3 * n_rv + 4)
            + n_trials * (n_pool * 16 + n_rv * s * 4 + n_rv * w * 4))
    b_out = acc_bytes(cfg, n_trials) + n_trials * n_rv * w * 4
    return b_in + b_out, (rows + 3 * live) * s * n_rv


def pool_bytes(cfg, n_trials):
    """Bytes of a whole pool: int8 vals and P, int32 lens and meta."""
    n_pool = cfg.n_lieutenants * cfg.slots
    return n_trials * n_pool * (cfg.max_l * cfg.size_l + cfg.max_l * 4
                                + cfg.size_l + 16)


def rebuild_cost(cfg, dst, dst_rows, n_trials):
    """Bytes and compares of one round's rebuild: in, acc (``acc_bytes``),
    each destination's source rows (vals and lens), P and meta, its two
    draws, honesty and the receiver's li row; out, the whole successor
    pool and the overflow flag."""
    s = cfg.size_l
    b_in = (acc_bytes(cfg, n_trials) + dst_rows * (s + 4)
            + dst * (s + 16 + 2 + 4 + s * 4))
    b_out = pool_bytes(cfg, n_trials) + n_trials * 4
    return b_in + b_out, (dst_rows + dst) * s


def fused_cost(cfg, live, rows, dst, dst_rows, n_trials):
    """Bytes and compares of one fused round: the verdict's inputs and vi
    out, the rebuild's source reads and the whole successor pool out
    (acc stays on chip)."""
    vb, vo = verdict_cost(cfg, live, rows, n_trials)
    rb, ro = rebuild_cost(cfg, dst, dst_rows, n_trials)
    return vb + rb - 2 * acc_bytes(cfg, n_trials), vo + ro


def n_recv_cost(cfg, live, rows, dst, dst_rows, n_trials, n_tp):
    """Bytes and compares of one party-sharded fused round over ``n_tp``
    shards: every shard reads the live packets and scans the meta of its
    own copy of the assembled pool; the draws, li, vi and the rebuilt
    sources are read once over all shards, and the segments written are
    one pool."""
    b, ops = fused_cost(cfg, live, rows, dst, dst_rows, n_trials)
    return b + n_recv_extra(cfg, live, rows, n_trials, n_tp), ops


def n_recv_extra(cfg, live, rows, n_trials, n_tp):
    """Bytes the ``n_tp - 1`` shards past the first add to a round
    kernel's: each scans the meta of its own copy of the assembled pool
    (or mailbox) and reads its live packets' valid rows, lens, P and
    meta."""
    n_pool = cfg.n_lieutenants * cfg.slots
    return (n_tp - 1) * (rows * (cfg.size_l + 4) + live * (cfg.size_l + 4)
                         + n_trials * n_pool * 16)


def n_recv_costs(cfg, live, rows, dst, dst_rows, n_trials, n_tp):
    """Bytes and compares of one round's ``n_recv`` verdict, rebuild and
    dense-mailbox round over ``n_tp`` shards: the verdict's and the
    dense-mailbox round's as the single-device kernels' plus
    ``n_recv_extra``, and the shards' masks in place of the single
    device's (``acc_bytes`` over ``n_tp`` shards) written by the verdict
    and read by the rebuild; the rebuild reads the rebuilt sources once
    over all shards and writes the segments, one pool."""
    extra = n_recv_extra(cfg, live, rows, n_trials, n_tp)
    masks = acc_bytes(cfg, n_trials, n_tp) - acc_bytes(cfg, n_trials)
    vb, vo = verdict_cost(cfg, live, rows, n_trials)
    rb, ro = rebuild_cost(cfg, dst, dst_rows, n_trials)
    return dict(
        tiled_verdict=(vb + extra + masks, vo),
        tiled_rebuild=(rb + masks, ro),
        round_step=n_recv_cost(cfg, live, rows, dst, dst_rows, n_trials,
                               n_tp))


def ring_cost(x):
    """Bytes and operations of one ring gather of ``x`` ``[n_tp, ...]``:
    ``x`` read once and ``n_tp`` copies of it written."""
    return x.numel() * x.element_size() * (1 + x.shape[0]), 0


def shard_tps(n_rv):
    """Every ``tp`` of 2..8 that divides ``n_rv`` lieutenants."""
    return [t for t in range(2, 9) if n_rv % t == 0]


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


def streams(cfg):
    """The draw streams a round hashes: attack, late under racy delivery,
    adapt under the adaptive strategy."""
    return 1 + (cfg.delivery == "racy") + (cfg.strategy == "adaptive")


def mega_cost(cfg, rounds, n_trials, keyed=False):
    """Bytes and compares of a whole trial batch in one launch: li, P,
    the orders and honesty once in; vi, the decisions and overflow out;
    per round its live pool entries (valid rows of vals and lens, P,
    meta) written once and read back once, and for the stacked entries
    the three draws of each live packet per receiver (the verdict) and
    the two of each rebuilt entry (the rebuild): a round reads no draw of
    a cell without a live packet, so the stacks are not counted whole.
    The keyed entries read the rounds keys instead and hash what a
    trial's rounds read, once each: per trial and round the round's keys
    (the round key and one a stream), the attack word of each receiver of
    a live packet of a dishonest sender, under the adaptive strategy the
    adapt word of each such entry that forges, and under racy delivery
    every live packet's late word per receiver.  The kernel's dedup and
    rebuild hash some of those entries again (``rehashes``): that is the
    design's own work, not the function's, and the bound leaves it out.
    ``rounds`` holds each round's ``round_facts``."""
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    b = n_trials * (n_rv * s * 4 + n_rv * s + n_rv * 4 + n_pool * 4
                    + n_rv * w * 4 + n_rv * 4 + 4 + (16 if keyed else 0))
    ops = hashes = 0
    racy = cfg.delivery == "racy"
    for f in rounds:
        live, rows, dst = f["live"], f["rows"], f["dst"]
        b += 2 * (rows * (s + 4) + live * (s + 16))
        ops += (rows + 3 * live) * s * n_rv
        if keyed:
            hashes += (n_trials * (1 + streams(cfg)) + f["live_biz"] * n_rv
                       + (f["forge_biz"] if cfg.strategy == "adaptive"
                          else 0)
                       + (live * n_rv if racy else 0))
        else:
            b += live * 3 * n_rv + dst * 2
    return b, ops + HASH_OPS * hashes


def rehashes(rounds):
    """The keyed megakernels' reads of a dishonest sender's draw beyond
    the verdict's row, over ``rounds``' ``round_facts``: one for each
    accepted pair (the dedup) and one for each rebuilt entry (the
    rebuild), each a hash of an entry the verdict hashed already (a walk
    of up to ``n_rv`` hashes under the broadcast scope)."""
    return sum(f["acc_biz"] + f["dst_biz"] for f in rounds)


def draws_cost(cfg, n_trials, n_r):
    """Bytes and operations of one draws launch over ``n_r`` rounds: the
    rounds keys (and the collude targets or adaptive's orders) in, the
    three uint8 tables out; per trial and round the round key and one a
    stream, per entry one hash a stream (a broadcast cell's walk hashes
    each of its entries once)."""
    n_rv = cfg.n_lieutenants
    entries = n_trials * n_r * n_rv * cfg.slots * n_rv
    ctx = {"collude": 4, "adaptive": 4 * n_rv}.get(cfg.strategy, 0)
    b = n_trials * (16 + ctx) + 3 * entries
    k = streams(cfg)
    return b, HASH_OPS * (entries * k + n_trials * n_r * (1 + k))


def round_facts(cfg, r, pool, hc, acc, att):
    """One round's work on ``pool``: its live packets and their valid
    rows, the rebuilt entries and the rows they copy, and the live
    packets, accepted pairs and rebuilt entries whose sender is dishonest
    (the keyed megakernels hash only those) and the entries of such
    packets that forge, from the round's accepted matrix ``acc`` and
    attack table ``att``."""
    import torch

    from qba_tpu_torch.ops.round_kernel_tiled import unpack_acc

    live, rows = pool_stats(cfg, pool)
    meta = pool[3]
    sent = meta[..., 2] != 0
    cell = meta[..., 3].clamp(0, hc.shape[1] - 1).long()
    biz = sent & (torch.gather(hc, 1, cell) == 0)
    accepted = unpack_acc(acc, cfg.n_lieutenants) != 0
    rb = accepted & (r <= cfg.n_dishonest)
    slot = torch.cumsum(rb.long(), 1) - rb.long()
    write = rb & (slot < cfg.slots)
    src_cnt = torch.where(sent, meta[..., 0].clamp(0, cfg.max_l), 0)
    return dict(live=live, rows=rows, dst=int(write.sum()),
                dst_rows=int((write.long() * src_cnt[..., None].long())
                             .sum()),
                live_biz=int(biz.sum()),
                forge_biz=int(((att.long() & 2) != 0)
                              .logical_and(biz[..., None]).sum()),
                acc_biz=int((accepted & biz[..., None]).sum()),
                dst_biz=int((write & biz[..., None]).sum()))


def ctx_part(ctx, sl):
    """Trials ``sl`` of an adversary context (None stays None)."""
    return None if ctx is None else type(ctx)(*(x[sl] for x in ctx))


def tree_err(got, want):
    """``max_err`` over two equal-shaped tuples (nested) of tensors."""
    if isinstance(got, (tuple, list)):
        if len(got) != len(want):
            raise AssertionError("outputs differ in length")
        return max(tree_err(a, b) for a, b in zip(got, want))
    return max_err(got, want)


def checked_draws(cfg, k_rounds, ctx, r):
    """Round ``r``'s draw tables as the per-round engines launch the draws
    kernel (``round_draws``: one round a launch, ``r0 = r``), held bit
    for bit against the plain version on the same trials.  Returns the
    tables and the kernel's host ms (fenced)."""
    import torch

    from qba_tpu_torch.ops.attack_draws import attack_draws_reference
    from qba_tpu_torch.rounds.engine import round_draws

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draws = round_draws(cfg, k_rounds, ctx, r)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = attack_draws_reference(cfg, k_rounds, ctx, r, 1)
    err = tree_err(draws, tuple(x[:, 0] for x in want))
    if err:
        raise AssertionError(f"attack_draws != plain version at {cfg} round "
                             f"{r} (r0={r}, n_r=1): max abs err {err}")
    return draws, ms


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

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    n = keys.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
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
        (att, rv, late), draws_ms = checked_draws(cfg, k_rounds, ctx, r)
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
        if not reps:
            # The n_recv variants: each shard of the round's pool (or
            # mailbox) drains its receivers; their accepted sets are the
            # single-device round's.
            nr_errs = dict.fromkeys(N_RECV_KERNELS, 0)
            for tp in shard_tps(cfg.n_lieutenants):
                got = n_recv_round(cfg, r, tp, pool, mbox, li, vi_i, hc,
                                   (att, rv, late), nr_errs)
                single = dict(fused_round=(new, vi_k, ovf_k),
                              tiled_verdict=(acc_k, vi_t),
                              round_step=(new_mbox, vi_m, ovf_m))
                n_recv_agrees(cfg, r, tp, got, single)
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
        if not reps:
            errs.update(nr_errs)
        if any(errs.values()):
            raise AssertionError(
                f"kernel != plain version at {cfg} round {r}: {errs}")
        facts = round_facts(cfg, r, pool, hc, acc_k, att)
        live, rows = facts["live"], facts["rows"]
        dst, dst_rows = facts["dst"], facts["dst_rows"]
        stats.append(dict(
            round=r, **facts,
            max_abs_err=errs,
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


N_RECV_KERNELS = ("fused_round_n_recv", "tiled_verdict_n_recv",
                  "tiled_rebuild_n_recv", "round_step_n_recv")


def shard_args(tp, whole, li, vi):
    """Each of ``tp`` shards' copy of a pool or mailbox ``whole``, and
    their receivers' rows of ``li`` and ``vi``."""
    from qba_tpu_torch.ops.round_kernel_tiled import shard_receivers

    return (tuple(x.expand((tp,) + x.shape).contiguous() for x in whole),
            shard_receivers(li, tp), shard_receivers(vi, tp))


def n_recv_round(cfg, r, tp, pool, mbox, li, vi, hc, draws, errs):
    """One round's four ``n_recv`` kernels at ``tp`` shards, each shard on
    its copy of the round's pool (or mailbox), held against their plain
    versions (the largest error per kernel into ``errs``).  Returns each
    kernel's outputs."""
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk

    n_local = cfg.n_lieutenants // tp
    kw = dict(n_recv=n_local)
    spool, sli, svi = shard_args(tp, pool, li, vi)
    smbox = shard_args(tp, mbox, li, vi)[0]
    got = dict(
        fused_round=rk.fused_round(cfg, r, spool, sli, svi, hc, *draws, **kw),
        tiled_verdict=rk.tiled_verdict(cfg, r, spool, sli, svi, hc, *draws,
                                       **kw),
        round_step=rs.round_step(cfg, r, smbox, sli, svi, hc, *draws, **kw))
    acc = got["tiled_verdict"][0]
    got["tiled_rebuild"] = rk.tiled_rebuild(cfg, r, spool, sli, acc, hc,
                                            *draws[:2], **kw)
    want = dict(
        fused_round=rk.fused_round_reference(cfg, r, spool, sli, svi, hc,
                                             *draws, **kw),
        tiled_verdict=rk.verdict_reference(cfg, r, spool, sli, svi, hc,
                                           *draws, **kw),
        tiled_rebuild=rk.rebuild_reference(cfg, r, spool, sli, acc, hc,
                                           *draws[:2], **kw),
        round_step=rs.round_step_reference(cfg, r, smbox, sli, svi, hc,
                                           *draws, **kw))
    for k, g in got.items():
        errs[k + "_n_recv"] = max(errs[k + "_n_recv"], tree_err(g, want[k]))
    return got


def n_recv_agrees(cfg, r, tp, got, single):
    """Raise unless the ``n_recv`` kernels' outputs at ``tp`` shards
    (``n_recv_round``) are the single-device round's: each shard's
    accepted sets, verdicts and overflow its receivers' part, the tiled
    pair's segments the fused round's, and the local mailboxes in shard
    order the single-device successor mailbox."""
    import torch

    from qba_tpu_torch.ops.round_kernel_tiled import (
        join_acc_shards,
        unshard_receivers,
    )

    new, vi, ovf = single["fused_round"]
    acc, _vi = single["tiled_verdict"]
    mbox = single["round_step"][0]
    fused, (s_acc, s_vi), tiled = (got["fused_round"], got["tiled_verdict"],
                                   got["tiled_rebuild"])
    step = got["round_step"]
    ok = (all(torch.equal(unshard_receivers(x), vi)
              for x in (fused[1], s_vi, step[1]))
          and all(torch.equal(x.any(0), ovf)
                  for x in (fused[2], tiled[1], step[2]))
          and torch.equal(join_acc_shards(s_acc, cfg.n_lieutenants // tp),
                          acc)
          and all(torch.equal(a, b) for a, b in zip(tiled[0], fused[0]))
          and all(torch.equal(torch.cat(list(a), dim=1), b)
                  for a, b in zip(step[0], mbox)))
    if not ok:
        raise AssertionError(f"n_recv kernels != single-device round at "
                             f"{cfg} round {r}, tp {tp}")


def n_recv_replay(cfg, keys, tp, *, chunk, reps=3):
    """The ``n_recv`` verdict, rebuild and dense-mailbox round at full
    width: every round of ``keys``' trials, advanced by the single-device
    fused round and dense-mailbox round kernels (which ``replay`` holds
    against their plain versions), runs the three variants at ``tp``
    shards, each shard on its copy of the round's pool or mailbox; each
    is held against its plain version (bit-exact) and, with the fused
    round's ``n_recv`` variant, against the single-device round
    (``n_recv_agrees``), timed (CUDA events over ``reps`` launches; the
    plain versions by host clock in chunks of ``chunk`` trials), and
    bounded from the round's own inputs (``n_recv_costs``).  Returns the
    per-round stats."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    n = keys.shape[0]
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    pool = rk.pool_from_step3a(cfg, out_cells)
    mbox = rs.mailbox_from_step3a(cfg, out_cells)
    hc = rk.honest_cells(honest, cfg)
    li, vi = li.to(torch.int32).contiguous(), vi.to(torch.int32)
    kw = dict(n_recv=cfg.n_lieutenants // tp)

    def timed(fn, *args):
        fn.events = []
        for _ in range(reps):
            fn(cfg, *args, **kw)
        torch.cuda.synchronize()
        ms, fn.events = event_ms(fn.events), None
        return ms

    def plain(fn, n_sharded, *args):
        """``fn`` over chunks of trials: the first ``n_sharded`` args are
        shard tensors (trial axis 1), the rest per trial (axis 0)."""
        def part(x, ax, sl):
            if isinstance(x, tuple):
                return tuple(part(y, ax, sl) for y in x)
            return x[:, sl] if ax else x[sl]

        def cat(items):
            if isinstance(items[0], tuple):
                return tuple(cat([it[i] for it in items])
                             for i in range(len(items[0])))
            return torch.cat(items, dim=1)

        t0 = time.perf_counter()
        parts = [fn(cfg, r, *(part(x, i < n_sharded, slice(a, a + chunk))
                              for i, x in enumerate(args)), **kw)
                 for a in range(0, n, chunk)]
        torch.cuda.synchronize()
        return cat(parts), (time.perf_counter() - t0) * 1e3

    stats = []
    for r in range(1, cfg.n_rounds + 1):
        draws = checked_draws(cfg, k_rounds, ctx, r)[0]
        live, rows = pool_stats(cfg, pool)
        spool, sli, svi = shard_args(tp, pool, li, vi)
        smbox = shard_args(tp, mbox, li, vi)[0]
        got = dict(
            fused_round=rk.fused_round(cfg, r, spool, sli, svi, hc, *draws,
                                       **kw),
            tiled_verdict=rk.tiled_verdict(cfg, r, spool, sli, svi, hc,
                                           *draws, **kw),
            round_step=rs.round_step(cfg, r, smbox, sli, svi, hc, *draws,
                                     **kw))
        acc = got["tiled_verdict"][0]
        got["tiled_rebuild"] = rk.tiled_rebuild(cfg, r, spool, sli, acc, hc,
                                                *draws[:2], **kw)
        new, vi_k, ovf_k = rk.fused_round(cfg, r, pool, li, vi, hc, *draws)
        new_mbox, vi_m, ovf_m = rs.round_step(cfg, r, mbox, li, vi, hc,
                                              *draws)
        single_acc = rk.join_acc_shards(acc, kw["n_recv"])
        n_recv_agrees(cfg, r, tp, got, dict(
            fused_round=(new, vi_k, ovf_k), tiled_verdict=(single_acc, vi_k),
            round_step=(new_mbox, vi_m, ovf_m)))
        ms = dict(tiled_verdict=timed(rk.tiled_verdict, r, spool, sli, svi,
                                      hc, *draws),
                  tiled_rebuild=timed(rk.tiled_rebuild, r, spool, sli, acc,
                                      hc, *draws[:2]),
                  round_step=timed(rs.round_step, r, smbox, sli, svi, hc,
                                   *draws))
        want, plain_ms = {}, {}
        want["tiled_verdict"], plain_ms["tiled_verdict"] = plain(
            rk.verdict_reference, 3, spool, sli, svi, hc, *draws)
        want["tiled_rebuild"], plain_ms["tiled_rebuild"] = plain(
            rk.rebuild_reference, 3, spool, sli, acc, hc, *draws[:2])
        want["round_step"], plain_ms["round_step"] = plain(
            rs.round_step_reference, 3, smbox, sli, svi, hc, *draws)
        errs = {k: tree_err(got[k], w) for k, w in want.items()}
        if any(errs.values()):
            raise AssertionError(f"n_recv kernel != plain version at {cfg} "
                                 f"round {r}, tp {tp}: {errs}")
        # What the rebuild must read: each destination's source packet.
        rb = ((rk.unpack_acc(single_acc, cfg.n_lieutenants) != 0)
              & (r <= cfg.n_dishonest))
        slot = torch.cumsum(rb.long(), 1) - rb.long()
        write = rb & (slot < cfg.slots)
        src_cnt = torch.where(pool[3][..., 2] != 0,
                              pool[3][..., 0].clamp(0, cfg.max_l), 0)
        dst = int(write.sum())
        dst_rows = int((write.long() * src_cnt[..., None].long()).sum())
        stats.append(dict(
            round=r, live=live, rows=rows, dst=dst, max_abs_err=errs, ms=ms,
            plain_ms=plain_ms,
            bound={k: bound(*c) for k, c in n_recv_costs(
                cfg, live, rows, dst, dst_rows, n, tp).items()}))
        del spool, smbox, got, acc
        pool, vi, mbox = new, vi_k, new_mbox
    return stats


def kernel_ms(fn, reps, *args):
    """``fn(*args)``'s kernel ms per launch: CUDA events over ``reps``
    launches."""
    import torch

    fn.events = []
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    ms, fn.events = event_ms(fn.events), None
    return ms


def mega_inputs(cfg, keys):
    """The megakernel's inputs for ``keys``, staged as ``run_trial_mega``
    builds them: the body's inputs, the rounds keys and the adversary
    context (the keyed entries'), and the draws kernel's stacks (the
    stacked entries'), with the set-up and stack times (host clock,
    fenced)."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops.attack_draws import attack_draws
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.rounds.engine import setup_trial

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    body = [p_rows.contiguous(), li.to(torch.int32).contiguous(),
            v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stacks = attack_draws(cfg, k_rounds, ctx)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return body, k_rounds, ctx, stacks, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def keyed_plain(fn, cfg, pre, body, k_rounds, ctx, chunk):
    """A keyed entry's plain version ``fn(cfg, *pre, *body, k_rounds,
    ctx)`` over chunks of ``chunk`` trials -> (outputs, host ms)."""
    import torch

    n = k_rounds.shape[0]
    t0 = time.perf_counter()
    parts = []
    for a in range(0, n, chunk):
        sl = slice(a, a + chunk)
        parts.append(fn(cfg, *pre, *(x[sl] for x in body), k_rounds[sl],
                        ctx_part(ctx, sl)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3)), ms


def mega_vs_plain(cfg, keys, *, chunk, reps=0):
    """The keyed megakernel (the main path's) against its plain version
    (the draws' plain version, then the megakernel's, in chunks of
    ``chunk`` trials) and against the stacked entry on the draws kernel's
    stacks, bit-exact.  With ``reps`` > 0 also times both entries (CUDA
    events) and the plain version (host clock)."""
    from qba_tpu_torch.ops import trial_megakernel as tm

    body, k_rounds, ctx, stacks, setup_ms, draws_ms = mega_inputs(cfg, keys)
    got = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    stacked = tm.trial_megakernel(cfg, *body, *stacks)
    want, plain_ms = keyed_plain(tm.trial_megakernel_keyed_reference, cfg,
                                 (), body, k_rounds, ctx, chunk)
    err = tree_err(got, want)
    if err or tree_err(stacked, got):
        raise AssertionError(f"keyed megakernel != plain version or stacked "
                             f"entry at {cfg}: max abs err {err}")
    out = dict(max_abs_err=err, ms=None, stacked_ms=None, plain_ms=None,
               setup_ms=setup_ms, draws_ms=draws_ms,
               overflow=int(got[2].sum()), vi=got[0] != 0)
    if reps:
        out.update(
            ms=kernel_ms(tm.trial_megakernel_keyed, reps, cfg, *body,
                         k_rounds, ctx),
            stacked_ms=kernel_ms(tm.trial_megakernel, reps, cfg, *body,
                                 *stacks),
            plain_ms=plain_ms)
    return out


def keyed_timing(cfg, keys, reps=3):
    """The keyed megakernel beside the stacked entry on the draws kernel's
    stacks, on ``keys``' whole batch: equal trial for trial, each timed
    (CUDA events over ``reps`` launches)."""
    from qba_tpu_torch.ops import trial_megakernel as tm

    body, k_rounds, ctx, stacks, _setup_ms, draws_ms = mega_inputs(cfg, keys)
    if tree_err(tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx),
                tm.trial_megakernel(cfg, *body, *stacks)):
        raise AssertionError(f"keyed != stacked megakernel at {cfg}")
    return dict(ms=kernel_ms(tm.trial_megakernel_keyed, reps, cfg, *body,
                             k_rounds, ctx),
                stacked_ms=kernel_ms(tm.trial_megakernel, reps, cfg, *body,
                                     *stacks),
                stacked_draws_ms=draws_ms)


def sharded_mega_vs_plain(cfg, keys, tp, *, chunk, reps=0):
    """The party-sharded keyed megakernel at ``tp`` against its plain
    version, the single-device keyed megakernel and the sharded stacked
    entry on ``keys``' inputs (bit-exact, trial for trial).  With ``reps``
    > 0 also times the keyed and stacked entries (CUDA events) and the
    plain version (host clock, ``chunk`` trials at a time)."""
    from qba_tpu_torch.ops import trial_megakernel as tm

    body, k_rounds, ctx, stacks, _setup_ms, _draws_ms = mega_inputs(cfg,
                                                                    keys)
    got = tm.sharded_trial_megakernel_keyed(cfg, tp, *body, k_rounds, ctx)
    single = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    stacked = tm.sharded_trial_megakernel(cfg, tp, *body, *stacks)
    want, plain_ms = keyed_plain(tm.sharded_trial_megakernel_keyed_reference,
                                 cfg, (tp,), body, k_rounds, ctx, chunk)
    err = tree_err(got, want)
    if err or tree_err(got, single) or tree_err(got, stacked):
        raise AssertionError(f"sharded keyed megakernel at tp={tp} != plain "
                             f"version, single-device or stacked entry at "
                             f"{cfg}")
    out = dict(tp=tp, max_abs_err=err, ms=None, stacked_ms=None,
               plain_ms=None, overflow=int(got[2].sum()))
    if reps:
        out.update(
            ms=kernel_ms(tm.sharded_trial_megakernel_keyed, reps, cfg, tp,
                         *body, k_rounds, ctx),
            stacked_ms=kernel_ms(tm.sharded_trial_megakernel, reps, cfg, tp,
                                 *body, *stacks),
            plain_ms=plain_ms)
    return out


def mega_phases(cfg, keys, tp=None):
    """The keyed megakernel's phase clock (``phase_clock``; the sharded
    entry at ``tp``) on ``keys``' staged inputs: per phase, warp 0's mean
    cycles per block and its share, and the blocks' mean and largest
    sums.  The clocked launch is its own instantiation, off the main
    path."""
    import torch

    from qba_tpu_torch.ops import trial_megakernel as tm

    body, k_rounds, ctx, _st, _s, _d = mega_inputs(cfg, keys)
    clock = tm.phase_clock(cfg.trials, tp or 1, keys.device)
    if tp is None:
        tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx, clock=clock)
    else:
        tm.sharded_trial_megakernel_keyed(cfg, tp, *body, k_rounds, ctx,
                                          clock=clock)
    torch.cuda.synchronize()
    return tm.phase_breakdown(clock)


def round_phases(cfg, keys, tp=None):
    """The per-round kernels' phase clocks (``round_phase_clock``) over
    every round of ``keys``' batch: the fused round and the tiled verdict
    and rebuild on the round's pool and the dense-mailbox round on its
    mailbox, single-device or, at ``tp``, their ``n_recv`` variants on
    ``tp`` copies; each clocked round is held equal to the unclocked
    launch.  Per kernel, the breakdown of one clock
    summing the rounds.  The clocked launches are their own
    instantiations, off the main path."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.rounds.engine import (
        round_draws,
        setup_trial,
        step3a_one,
    )

    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    vi, cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    hc = rk.honest_cells(honest, cfg)
    li = li.to(torch.int32).contiguous()
    vi = vi.to(torch.int32)
    pool = rk.pool_from_step3a(cfg, cells)
    mbox = rs.mailbox_from_step3a(cfg, cells)
    kw = {} if tp is None else dict(n_recv=cfg.n_lieutenants // tp)
    clocks = {k: rk.round_phase_clock(keys.shape[0], tp, keys.device)
              for k in ("fused_round", "round_step", "tiled_verdict",
                        "tiled_rebuild")}
    for r in range(1, cfg.n_rounds + 1):
        draws = round_draws(cfg, k_rounds, ctx, r)
        if tp is None:
            args = dict(fused_round=(pool, li, vi, hc),
                        round_step=(mbox, li, vi, hc))
        else:
            spool, sli, svi = shard_args(tp, pool, li, vi)
            smbox = shard_args(tp, mbox, li, vi)[0]
            args = dict(fused_round=(spool, sli, svi, hc),
                        round_step=(smbox, sli, svi, hc))
        for name, fn in (("fused_round", rk.fused_round),
                         ("round_step", rs.round_step)):
            got = fn(cfg, r, *args[name], *draws, **kw, clock=clocks[name])
            if tree_err(got, fn(cfg, r, *args[name], *draws, **kw)):
                raise AssertionError(f"{name} with its phase clock != "
                                     f"without at {cfg} round {r}")
        a = args["fused_round"]
        acc = rk.tiled_verdict(cfg, r, *a, *draws, **kw,
                               clock=clocks["tiled_verdict"])
        got = rk.tiled_rebuild(cfg, r, *a[:2], acc[0], hc, *draws[:2], **kw,
                               clock=clocks["tiled_rebuild"])
        if tree_err((acc, got), (rk.tiled_verdict(cfg, r, *a, *draws, **kw),
                                 rk.tiled_rebuild(cfg, r, *a[:2], acc[0], hc,
                                                  *draws[:2], **kw))):
            raise AssertionError(f"the tiled pair with its phase clocks != "
                                 f"without at {cfg} round {r}")
        del args, a, acc, got
        mbox = rs.round_step(cfg, r, mbox, li, vi, hc, *draws)[0]
        pool, vi, _ovf = rk.fused_round(cfg, r, pool, li, vi, hc, *draws)
    torch.cuda.synchronize()
    return {k: rk.round_phase_breakdown(c) for k, c in clocks.items()}


ENGINE_OF = {"fused_round": "pallas_fused", "tiled_verdict": "pallas_tiled",
             "tiled_rebuild": "pallas_tiled", "trial_megakernel": "auto",
             "round_step": "pallas"}
COUNTED = ("fused_round", "tiled_verdict", "tiled_rebuild",
           "trial_megakernel", "round_step", "fused_circuit", "gf2_sweep",
           "trial_megakernel_gen", "sharded_trial_megakernel", "ring_gather",
           "attack_draws", "trial_megakernel_keyed",
           "trial_megakernel_gen_keyed", "sharded_trial_megakernel_keyed",
           "sweep_stop", "surface_pick", "surface_fold")
ROUND_KERNELS = COUNTED[:5]
# The megakernel rows of the kernel table time the keyed entries, the ones
# the engines launch.
KEYED = {"trial_megakernel": "trial_megakernel_keyed",
         "trial_megakernel_gen": "trial_megakernel_gen_keyed",
         "sharded_trial_megakernel": "sharded_trial_megakernel_keyed"}

# The draws' every strategy, attack scope and delivery, at both widths.
RACY = dict(delivery="racy", p_late=0.25)
DRAW_COMBOS = [(f"{law}-{delivery}", dict(kw, **(RACY if delivery == "racy"
                                                  else {})))
               for law, kw in (("reference", {}),
                               ("collude", dict(strategy="collude")),
                               ("adaptive", dict(strategy="adaptive")),
                               ("split", dict(strategy="split")),
                               ("broadcast", dict(attack_scope="broadcast")))
               for delivery in ("sync", "racy")]
DRAW_SIZES = [("11p/L64/d3", dict(n_parties=11, size_l=64, n_dishonest=3)),
              ("33p/L64/d10", dict(n_parties=33, size_l=64, n_dishonest=10))]
# Past 32 receivers the broadcast scan carries from one warp-wide step to
# the next: 41p (40 lieutenants) and 65p (64; draws only, past the round
# kernels' 64-bit masks).
WIDE_SIZES = [("41p/L64/d13", dict(n_parties=41, size_l=64, n_dishonest=13)),
              ("65p/L64/d21", dict(n_parties=65, size_l=64, n_dishonest=21))]
WIDE_COMBOS = [(c, kw) for c, kw in DRAW_COMBOS if c.startswith("broadcast")]


def keyed_ctx(cfg, keys):
    """The rounds keys (contiguous) and adversary context of ``keys``."""
    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.rounds.engine import setup_trial

    _h, _li, _p, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    return k_rounds, adversary_ctx(cfg, k_rounds, v_sent)


def draws_vs_plain(dev, trials=32):
    """The draws kernel against its plain version, bit-exact, on every
    round of ``trials`` trials in every combination of ``DRAW_COMBOS`` at
    both ``DRAW_SIZES``, and under the broadcast scope at ``WIDE_SIZES``.
    Returns the largest error and per case the share of entries with an
    edit and of late ones."""
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.ops.attack_draws import (
        attack_draws,
        attack_draws_reference,
    )

    err, facts = 0, []
    cases = [(size, base, combo, kw) for size, base in DRAW_SIZES
             for combo, kw in DRAW_COMBOS]
    cases += [(size, base, combo, kw) for size, base in WIDE_SIZES
              for combo, kw in WIDE_COMBOS]
    for size, base, combo, kw in cases:
        cfg = QBAConfig(**base, **kw, trials=trials, seed=17)
        k_rounds, ctx = keyed_ctx(cfg, trial_keys(cfg, dev))
        got = attack_draws(cfg, k_rounds, ctx)
        e = tree_err(got, attack_draws_reference(cfg, k_rounds, ctx))
        err = max(err, e)
        facts.append(dict(case=f"{size} {combo}", max_abs_err=e,
                          edited=float((got[0] != 0).float().mean()),
                          late=float(got[2].float().mean())))
    if err:
        raise AssertionError(f"attack_draws != plain version: {facts}")
    return err, facts


def draws_timing(cfg, keys, reps=3):
    """The draws kernel over every round of ``keys``' batch in one launch,
    held bit for bit against its plain version on the whole batch: ms
    (CUDA events over ``reps`` launches), the plain version's ms (host
    clock, once), the error and the bound."""
    import torch

    from qba_tpu_torch.ops.attack_draws import (
        attack_draws,
        attack_draws_reference,
    )

    k_rounds, ctx = keyed_ctx(cfg, keys)
    got = attack_draws(cfg, k_rounds, ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = attack_draws_reference(cfg, k_rounds, ctx)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = tree_err(got, want)
    if err:
        raise AssertionError(f"attack_draws != plain version over every "
                             f"round at {cfg}: max abs err {err}")
    del got, want
    ms = kernel_ms(attack_draws, reps, cfg, k_rounds, ctx)
    b_ms, b_by = bound(*draws_cost(cfg, keys.shape[0], cfg.n_rounds))
    return dict(rounds=cfg.n_rounds, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def keyed_vs_plain(dev):
    """The keyed megakernels in every combination of ``DRAW_COMBOS``, at
    11p (32 trials) and 33p (16), at 11p with one slot a round (whose
    trials overflow) and under the broadcast scope at 41p: single-device (``mega_vs_plain``), party-sharded at
    ``tp`` 2 and, at 33p and 41p, 4 (``sharded_mega_vs_plain``), and the gen entry
    on ``qsim_path="stabilizer"`` (``gen_vs_plain``), each against its
    plain version and its stacked form, trial for trial.  Returns the
    largest error per entry and per case the overflowing trials."""
    import dataclasses

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.torch_backend import trial_keys

    errs = dict.fromkeys(KEYED, 0)
    facts = []
    cases = [(size, base, combo, kw) for size, base in DRAW_SIZES
             for combo, kw in DRAW_COMBOS]
    cases.append((*DRAW_SIZES[0], "reference-sync slots=1",
                  dict(max_accepts_per_round=1)))
    cases += [(*WIDE_SIZES[0], c, kw) for c, kw in WIDE_COMBOS]
    for size, base, combo, kw in cases:
        trials = 32 if size.startswith("11p") else 16
        cfg = QBAConfig(**base, **kw, trials=trials, seed=19)
        keys = trial_keys(cfg, dev)
        mega = mega_vs_plain(cfg, keys, chunk=trials)
        errs["trial_megakernel"] = max(errs["trial_megakernel"],
                                       mega["max_abs_err"])
        tps = [t for t in (2, 4) if cfg.n_lieutenants % t == 0]
        for tp in tps:
            sh = sharded_mega_vs_plain(cfg, keys, tp, chunk=trials)
            errs["sharded_trial_megakernel"] = max(
                errs["sharded_trial_megakernel"], sh["max_abs_err"])
        scfg = dataclasses.replace(cfg, qsim_path="stabilizer")
        gen, _vi = gen_vs_plain(scfg, trial_keys(scfg, dev), chunk=trials)
        errs["trial_megakernel_gen"] = max(errs["trial_megakernel_gen"],
                                           gen["max_abs_err"])
        facts.append(dict(case=f"{size} {combo}", trials=trials, tp=tps,
                          overflow=mega["overflow"],
                          gen_overflow=gen["overflow"]))
    return errs, facts

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
    # 33 receivers: the tiled verdict's cluster of two blocks, and mask
    # bit 32 in the word's high half (tp = 3: 11 receivers a shard).
    ("34p/L16/d11 r1", dict(n_parties=34, size_l=16, n_dishonest=11), 1),
]
RANDOM_TRIALS = [
    ("5p/L16/d2 split", dict(n_parties=5, size_l=16, n_dishonest=2,
                             strategy="split")),
    ("5p/L16/d2 slots=1", dict(n_parties=5, size_l=16, n_dishonest=2,
                               max_accepts_per_round=1)),
    ("11p/L64/d3", dict(n_parties=11, size_l=64, n_dishonest=3)),
]


def accepted_pairs(acc, n_local):
    """The (packet, receiver) pairs an accepted matrix (one mask of
    ``n_local`` receivers a packet) holds."""
    from qba_tpu_torch.ops.round_kernel_tiled import unpack_acc

    return int(unpack_acc(acc, n_local).sum())


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
        random_shard_inputs,
        random_trial_inputs,
    )

    errs = dict.fromkeys(ROUND_KERNELS + N_RECV_KERNELS
                         + ("sharded_trial_megakernel",), 0)
    facts = []
    for i, (name, kw, r) in enumerate(RANDOM_ROUNDS):
        cfg = QBAConfig(**kw)
        for tp in shard_tps(cfg.n_lieutenants):
            facts.append(dict(case=f"{name} tp={tp}", n_recv=True,
                              **random_n_recv(cfg, r, tp, n_trials, 311 + i,
                                              dev, errs)))
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
        if cfg.n_lieutenants > 32 and not bool((acc >> 32).any()):
            raise AssertionError(f"{name}: no mask bit past 31 accepted")
        facts.append(dict(case=name,
                          accepted=accepted_pairs(acc, cfg.n_lieutenants),
                          dense_accepted=accepted_pairs(dense,
                                                        cfg.n_lieutenants),
                          mailbox_accepted=int(mgot[1].sum() - margs[2].sum())))
    for i, (name, kw) in enumerate(RANDOM_TRIALS):
        cfg = QBAConfig(**kw)
        args = random_trial_inputs(cfg, n_trials, seed=200 + i, device=dev)
        single = tm.trial_megakernel(cfg, *args)
        errs["trial_megakernel"] = max(errs["trial_megakernel"], tree_err(
            single, tm.trial_megakernel_reference(cfg, *args)))
        for tp in shard_tps(cfg.n_lieutenants):
            got = tm.sharded_trial_megakernel(cfg, tp, *args)
            errs["sharded_trial_megakernel"] = max(
                errs["sharded_trial_megakernel"], tree_err(
                    got, tm.sharded_trial_megakernel_reference(cfg, tp,
                                                               *args)),
                tree_err(got, single))
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
    shard_facts = [f for f in facts if f.get("n_recv")]
    for k in ("fused", "tiled", "dense_acc", "mailbox"):
        if not any(f[k + "_overflow"] for f in shard_facts):
            raise AssertionError(f"the n_recv random cases ({k}) overflowed "
                                 f"nowhere: {shard_facts}")
    for k in ("fused", "tiled", "mailbox"):
        if not any(f[k + "_accepted"] for f in shard_facts):
            raise AssertionError(f"the n_recv random cases ({k}) accepted "
                                 f"nothing: {shard_facts}")
    return errs, facts


def random_n_recv(cfg, r, tp, n_trials, seed, dev, errs):
    """The four ``n_recv`` kernels at ``tp`` shards against their plain
    versions on seeded random shard inputs: assembled pools with an empty
    segment, a full one and stale unsent entries between the segments
    (the fused round, the verdict, the rebuild on the verdict's accepted
    matrix and on a far denser one), and gathered mailboxes whose unsent
    cells hold stale packets (the dense-mailbox round).  The largest
    error per kernel goes into ``errs``; returns what each accepted and
    how many shard-trials overflowed."""
    import torch

    from qba_tpu_torch.ops import round_kernel as rs
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.testing import (
        dense_acc,
        random_shard_inputs,
        random_shard_mailbox_inputs,
    )

    kw = dict(n_recv=cfg.n_lieutenants // tp)
    args = random_shard_inputs(cfg, tp, r, n_trials, seed=seed, device=dev)
    pool, li, vi, hc, att, rv, late = args
    # The plain fused round is the plain verdict, then the plain rebuild
    # on its accepted matrix: each plain version runs once.
    want_acc, want_vi = rk.verdict_reference(cfg, r, *args, **kw)
    want_pool, want_ovf = rk.rebuild_reference(cfg, r, pool, li, want_acc,
                                               hc, att, rv, **kw)
    fused = rk.fused_round(cfg, r, *args, **kw)
    errs["fused_round_n_recv"] = max(errs["fused_round_n_recv"], tree_err(
        fused, (want_pool, want_vi, want_ovf)))
    acc, vi2 = rk.tiled_verdict(cfg, r, *args, **kw)
    errs["tiled_verdict_n_recv"] = max(errs["tiled_verdict_n_recv"],
                                       tree_err((acc, vi2), (want_acc,
                                                             want_vi)))
    dense = torch.stack([dense_acc(cfg, tuple(x[s] for x in pool), seed=s,
                                   n_local=kw["n_recv"]) for s in range(tp)])
    ovf = {}
    for key, a, want in (
            ("tiled", acc, (want_pool, want_ovf)),
            ("dense_acc", dense, rk.rebuild_reference(
                cfg, r, pool, li, dense, hc, att, rv, **kw))):
        got = rk.tiled_rebuild(cfg, r, pool, li, a, hc, att, rv, **kw)
        errs["tiled_rebuild_n_recv"] = max(errs["tiled_rebuild_n_recv"],
                                           tree_err(got, want))
        ovf[key] = int(got[1].sum())
    margs = random_shard_mailbox_inputs(cfg, tp, r, n_trials, seed=seed,
                                        device=dev)
    step = rs.round_step(cfg, r, *margs, **kw)
    errs["round_step_n_recv"] = max(errs["round_step_n_recv"], tree_err(
        step, rs.round_step_reference(cfg, r, *margs, **kw)))
    return dict(fused_accepted=int((fused[1] - vi).sum()),
                fused_overflow=int(fused[2].sum()),
                tiled_accepted=accepted_pairs(acc, kw["n_recv"]),
                tiled_overflow=ovf["tiled"],
                dense_acc_overflow=ovf["dense_acc"],
                mailbox_accepted=int((step[1] - margs[2]).sum()),
                mailbox_overflow=int(step[2].sum()))


CIRCUIT_ATOL = 1e-6


def circuit_vs_plain(dev, reps=10):
    """The fused circuit kernel against its plain version, amplitudes at
    ``atol=1e-6``, on every route (``fused_circuit.circuit_route``): both
    protocol circuits at 3, 4 and 5 parties with seeded random params,
    seeded random complex circuits at 10, 16 and 17 qubits and real ones
    at 19 and 20.  The 5-party Q-correlated circuit, at the 64 runs per
    launch the dense path gives it, is also timed against its plain
    version and its bound.  Returns the cases' facts and that timing."""
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
    for n, seed, real, runs in ((10, 1, False, 4), (16, 2, False, 4),
                                (17, 3, False, 3), (19, 4, True, 2),
                                (20, 5, True, 2)):
        ops = circuit_ops_from_tuples(random_circuit(n, 40, seed, real=real))
        cases.append((f"random {n}q {'real' if real else 'complex'}", n, ops,
                      3, runs))
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
                          real=tables.is_real, route=list(tables.route),
                          max_abs_err=err))
        if name.endswith("main-path chunk"):
            fc.fused_circuit.events = []
            # Queued behind a sleep: the host's pace stays out of the times.
            torch.cuda._sleep(20_000_000)
            for _ in range(reps):
                fc.fused_circuit(tables, params)
            torch.cuda.synchronize()
            ms, fc.fused_circuit.events = event_ms(
                fc.fused_circuit.events), None
            b_ms, b_by = bound(*circuit_cost(tables, params), float_ops=True)
            timing = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, runs=n_runs,
                          qubits=n, ops=len(ops), route=list(tables.route))
    routes = {f["route"][0] for f in facts}
    if routes != {"block", "cluster", "global"}:
        raise AssertionError(f"circuit_vs_plain reached the routes {routes}")
    return facts, timing


def sweep_cost(total, n_shots, n_fam=2):
    """Bytes and word operations of one sweep over ``n_shots`` shots of
    ``total`` qubits, as the affine map it computes: in, the families'
    maps (once), each shot's phases, coins, readout flips and family;
    out, the bits (int32).  Per shot and qubit an AND and an XOR a word
    of its row (``wt`` words: the phases', the coins' and the
    constant's) and a parity."""
    wt = -(-2 * total // 32) + -(-total // 32) + 1
    n_pad = 32 * -(-total // 32)
    b = n_fam * wt * n_pad * 4 + n_shots * (2 * total + total + total + 1
                                            + 4 * total)
    return b, n_shots * total * (2 * wt + 1)


def sweep_step_ops(total, work):
    """The serial sweep's word operations on the run's own steps (``work``
    of the plain sweep on the same inputs), the count the bound took
    before the sweep became a map: a random step tests the ``2 total``
    rows' ``x_a`` and the surgery writes ``4 W`` words; each row that
    absorbs the pivot costs ``5 W`` (cross AND and fold, x and z XOR); a
    deterministic step tests ``2 total`` rows and each selected
    stabilizer costs ``3 W`` (AND, fold, prefix XOR)."""
    w = -(-total // 32)
    return (work["random_steps"] * (2 * total + 4 * w)
            + work["rows_updated"] * 5 * w
            + work["det_steps"] * 2 * total + work["rows_selected"] * 3 * w)


def gen_cost(cfg, rounds, n_trials, sweep_ops, keyed=False):
    """Bytes and operations of the megakernel's gen entry: the host-gen
    megakernel's (``mega_cost``) less its li and P inputs, plus the
    generation operands in (per shot qcorr, the coins, the readout flips
    and the phases of the one family ``qcorr`` picks, ``r_q`` or
    ``r_nq``; the two families' maps once) and the sweep's
    operations."""
    n_rv, s, total = cfg.n_lieutenants, cfg.size_l, cfg.total_qubits
    b, ops = mega_cost(cfg, rounds, n_trials, keyed)
    b -= n_trials * (n_rv * s * 4 + n_rv * s)
    b += sweep_cost(total, 0)[0] + n_trials * s * (1 + 4 * total)
    return b, ops + sweep_ops


# The GF(2) sweep on the protocol's tableaux: (name, parties, trials,
# noise); 65 parties (462 qubits) only generate on the card.  The kernel
# keeps the families' maps in shared memory up to 33 parties and reads
# them where they lie at 65 (``gf2_sweep.tables_in_shared``); the random
# tableaux reach both placements, and 400 qubits and 65 parties take two
# passes of the kernel's 256 outputs a lane.
SWEEP_CASES = [
    ("5p noisy", 5, 8, True),
    ("11p", 11, 8, False),
    ("11p noisy", 11, 8, True),
    ("33p noisy", 33, 4, True),
    ("33p", 33, 4, False),
    ("65p noisy", 65, 2, True),
]
RANDOM_SWEEPS = [13, 40, 70, 100, 150, 400]


def sweep_vs_plain(dev):
    """``gf2_sweep`` against its plain version, bit-exact: the protocol's
    tableaux at 5, 11, 33 and 65 parties (some with noise; the maps in
    shared memory and where they lie), and seeded random Clifford
    tableaux (``qba_tpu_torch.testing.random_sweep_inputs``) whose steps
    take both branches and pivots past the first stabilizer row."""
    import torch

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.qsim import protocol_circuits as pc
    from qba_tpu_torch.testing import random_sweep_inputs

    err, facts = 0, []
    for name, n, trials, noisy in SWEEP_CASES:
        cfg = QBAConfig(n_parties=n, size_l=64, p_depolarize=0.05 * noisy,
                        p_measure_flip=0.02 * noisy)
        ops = pc.stabilizer_gen_operands(
            cfg, jr.split(jr.key(n, device=dev), trials))
        tables = pc.stabilizer_gen_tables(cfg, dev)
        # The host's symbolic sweeps of both families, once per config.
        t0 = time.perf_counter()
        maps = gs.sweep_tables(cfg.total_qubits, *(
            torch.stack([tables[i + 2], tables[i]]) for i in (0, 1)))
        map_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(maps, pc.stabilizer_sweep_tables(cfg)):
            raise AssertionError(f"{name}: the cached maps differ")
        got = pc.stabilizer_bits(cfg, tables, ops)
        work = {}
        want = pc.stabilizer_bits(cfg, tables, ops, sweep=lambda *a: (
            gs.gf2_sweep_reference(*a, work=work)))
        err = max(err, max_err(got, want))
        facts.append(dict(case=name, qubits=cfg.total_qubits,
                          shots=trials * 64, tables=placement(maps),
                          map_host_ms=map_ms, **work))
    for n in RANDOM_SWEEPS:
        args = random_sweep_inputs(n, 128, seed=n, device=dev)
        work = {}
        want = gs.gf2_sweep_reference(n, *args, work=work)
        err = max(err, max_err(gs.gf2_sweep(n, *args), want))
        if not (work["random_steps"] and work["det_steps"]
                and work["late_pivots"]):
            raise AssertionError(f"random sweep at {n} qubits reached "
                                 f"too little: {work}")
        facts.append(dict(case=f"random {n}q", qubits=n, shots=128,
                          tables=placement(gs.sweep_tables(n, *args[:2])),
                          **work))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"gf2_sweep != plain version: max abs err {err}")
    if {f["tables"] for f in facts} != {"shared", "global"}:
        raise AssertionError("sweep_vs_plain missed a table placement")
    return err, facts


def placement(tables):
    """Where the sweep kernel keeps ``tables``."""
    from qba_tpu_torch.ops.gf2_sweep import tables_in_shared

    return "shared" if tables_in_shared(tables) else "global"


GEN_CASES = [
    ("11p/L64/d3 split noisy", dict(n_parties=11, size_l=64, n_dishonest=3,
                                    strategy="split", p_depolarize=0.02,
                                    p_measure_flip=0.01)),
    ("33p/L64/d10", dict(n_parties=33, size_l=64, n_dishonest=10)),
]


def gen_inputs(cfg, keys):
    """The gen entry's inputs for ``keys``, staged as ``run_trial_mega``
    builds them: the tables, operands, orders and cell honesty, the
    rounds keys and adversary context, and the draws kernel's stacks,
    with the set-up (generation operands) and stack times."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops.attack_draws import attack_draws
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_tables
    from qba_tpu_torch.rounds.engine import _mega_gen_setup

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    honest, gen_ops, v_sent, _v_comm, k_rounds = _mega_gen_setup(cfg, keys)
    k_rounds = k_rounds.contiguous()
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    args = [stabilizer_gen_tables(cfg, keys.device), gen_ops,
            v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stacks = attack_draws(cfg, k_rounds, ctx)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return args, k_rounds, ctx, stacks, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def chunked(fn, args, n, chunk):
    """``fn`` over chunks of ``chunk`` trials of ``args`` (the first, the
    tables, shared whole) -> (outputs concatenated, host ms)."""
    import torch

    def part(x, sl):
        if isinstance(x, (tuple, list)):
            return type(x)(part(y, sl) for y in x)
        return x[sl]

    t0 = time.perf_counter()
    parts = [fn(args[0], *(part(x, slice(a, a + chunk)) for x in args[1:]))
             for a in range(0, n, chunk)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3)), ms


def gen_vs_plain(cfg, keys, *, chunk=32, reps=0, plain_sweep=None):
    """The keyed gen entry (the main path's) against its plain version,
    bit-exact, and against the stacked gen entry and the keyed host-gen
    megakernel on the same lists.  The plain version is the plain draws,
    the plain sweep, then the decode and ``trial_megakernel_reference`` on
    its bits, in chunks of ``chunk`` trials.  ``plain_sweep``, the plain
    sweep's bits of these trials and its ms (``sweep_batch``), stands in
    for the sweep, which then does not run again.  With ``reps`` > 0 also
    times the keyed and stacked gen entries and the keyed host-gen
    megakernel (CUDA events) and the plain version (host clock).  Returns
    the facts and the final accepted sets."""
    import torch

    from qba_tpu_torch.ops import _build
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.ops import trial_megakernel as tm
    from qba_tpu_torch.ops.attack_draws import attack_draws_reference
    from qba_tpu_torch.qsim.protocol_circuits import (
        lists_from_bits,
        stabilizer_bits,
    )
    from qba_tpu_torch.rounds.engine import p_sets

    args, k_rounds, ctx, stacks, setup_ms, draws_ms = gen_inputs(cfg, keys)
    n = keys.shape[0]
    if plain_sweep is None:
        t0 = time.perf_counter()
        bits = stabilizer_bits(cfg, args[0], args[1],
                               sweep=gs.gf2_sweep_reference)
        torch.cuda.synchronize()
        plain_sweep = bits, (time.perf_counter() - t0) * 1e3
    bits, sweep_ms = plain_sweep

    def host_lists(bits, v_sent):
        lists = lists_from_bits(cfg, bits)
        return (p_sets(lists, v_sent).contiguous(),
                lists[:, 2:].to(torch.int32).contiguous())

    def rest(_tables, bits, _ops, v_sent, *a):
        return tm.trial_megakernel_reference(
            cfg, *host_lists(bits, v_sent), v_sent, *a)

    t0 = time.perf_counter()
    plain_stacks = attack_draws_reference(cfg, k_rounds, ctx)
    torch.cuda.synchronize()
    draws_plain_ms = (time.perf_counter() - t0) * 1e3
    want, rest_ms = chunked(rest, [args[0], bits, *args[1:], *plain_stacks],
                            n, chunk)
    gen_args = (cfg, *args, k_rounds, ctx)
    got = tm.trial_megakernel_gen_keyed(*gen_args)
    err = tree_err(got, want)
    if err or tree_err(tm.trial_megakernel_gen(cfg, *args, *stacks), want):
        raise AssertionError(f"keyed or stacked gen entry != plain version "
                             f"at {cfg}: max abs err {err}")
    # The keyed host-gen megakernel on the lists the gen entry decodes.
    host_args = (cfg, *host_lists(bits, args[2]), *args[2:], k_rounds, ctx)
    if tree_err(tm.trial_megakernel_keyed(*host_args), want):
        raise AssertionError(f"host-gen megakernel != gen entry at {cfg}")
    occupancy = _build.load_library("trial_megakernel") \
        .qba_trial_megakernel_occupancy
    out = dict(setup_ms=setup_ms, draws_ms=draws_ms,
               plain_ms=sweep_ms + draws_plain_ms + rest_ms if reps else None)
    for key, fn, mode, fargs in (
            ("gen", tm.trial_megakernel_gen_keyed, 3, gen_args),
            ("host_gen", tm.trial_megakernel_keyed, 2, host_args),
            ("gen_stacked", tm.trial_megakernel_gen, 1,
             (cfg, *args, *stacks))):
        smem, blocks = ctypes_ints(occupancy, mode, cfg.n_lieutenants,
                                   cfg.slots, cfg.max_l, cfg.size_l, cfg.w)
        out[key] = dict(smem=smem, blocks_per_sm=blocks)
        if reps:
            out[key]["ms"] = kernel_ms(fn, reps, *fargs)
    out["max_abs_err"] = err
    out["overflow"] = int(want[2].sum())
    return out, want[0] != 0


def pool_rounds(cfg, keys):
    """Each round's ``round_facts`` of ``keys``' trials, advanced by the
    fused round kernel (which ``replay`` holds against its plain
    version), with the tiled verdict's accepted matrix: what ``mega_cost``
    counts.  Returns them and the final accepted sets."""
    import torch

    from qba_tpu_torch.adversary import adversary_ctx
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    pool = rk.pool_from_step3a(cfg, out_cells)
    hc = rk.honest_cells(honest, cfg)
    li, vi = li.to(torch.int32).contiguous(), vi.to(torch.int32)
    rounds = []
    for r in range(1, cfg.n_rounds + 1):
        draws = checked_draws(cfg, k_rounds, ctx, r)[0]
        acc = rk.tiled_verdict(cfg, r, pool, li, vi, hc, *draws)[0]
        rounds.append(round_facts(cfg, r, pool, hc, acc, draws[0]))
        pool, vi, _ovf = rk.fused_round(cfg, r, pool, li, vi, hc, *draws)
    return rounds, vi != 0

def ctypes_ints(fn, *ints):
    """Call a C query taking ints and two int out-pointers."""
    import ctypes

    a, b = ctypes.c_int(), ctypes.c_int()
    rc = fn(*[ctypes.c_int(i) for i in ints], ctypes.byref(a),
            ctypes.byref(b))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {rc}")
    return a.value, b.value


def sweep_ms(cfg, tables, ops, reps=10):
    """The sweep kernel's ms per launch (CUDA events, the launches queued
    behind a sleep so that the host's pace stays out of them) over
    ``ops``' whole batch, and its bits."""
    import torch

    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.qsim import protocol_circuits as pc

    got = pc.stabilizer_bits(cfg, tables, ops)
    gs.gf2_sweep.events = []
    torch.cuda._sleep(20_000_000)
    for _ in range(reps):
        pc.stabilizer_bits(cfg, tables, ops)
    torch.cuda.synchronize()
    ms, gs.gf2_sweep.events = event_ms(gs.gf2_sweep.events), None
    return got, ms


def sweep_batch(cfg, keys, *, chunk=32):
    """The host path's sweep over ``keys``' whole batch (the shots
    ``setup_trial`` sweeps): the kernel against its plain version
    (bit-exact; plain in chunks of ``chunk`` trials, with its work
    counted), kernel ms, the bound and the serial sweep's operation
    count beside it."""
    import torch

    from qba_tpu_torch import random as jr
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.qsim import protocol_circuits as pc

    k_lists = jr.split(keys, 4)[..., 1, :]
    ops = pc.stabilizer_gen_operands(cfg, k_lists)
    tables = pc.stabilizer_gen_tables(cfg, keys.device)
    got, ms = sweep_ms(cfg, tables, ops)
    work = {}
    n = keys.shape[0]
    t0 = time.perf_counter()
    want = torch.cat([pc.stabilizer_bits(
        cfg, tables, tuple(x[a:a + chunk] for x in ops),
        sweep=lambda *a: gs.gf2_sweep_reference(*a, work=work))
        for a in range(0, n, chunk)])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(got, want)
    if err:
        raise AssertionError(f"gf2_sweep != plain version on the batch at "
                             f"{cfg}: max abs err {err}")
    shots = n * cfg.size_l
    b_ms, b_by = bound(*sweep_cost(cfg.total_qubits, shots))
    return dict(max_abs_err=err, ms=ms,
                tables=placement(pc.stabilizer_sweep_tables(cfg)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, shots=shots,
                step_ops=sweep_step_ops(cfg.total_qubits, work),
                work=work), want


def sweep_65p(dev, trials=1000):
    """The sweep kernel over a whole 1000-trial batch at 65 parties (462
    qubits; only generation runs there on the card): ms per launch and
    the bound.  ``sweep_vs_plain`` holds it against the plain version at
    this width on a few trials."""
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.qsim import protocol_circuits as pc

    cfg = QBAConfig(n_parties=65, size_l=64, trials=trials)
    ops = pc.stabilizer_gen_operands(
        cfg, jr.split(jr.key(65, device=dev), trials))
    _bits, ms = sweep_ms(cfg, pc.stabilizer_gen_tables(cfg, dev), ops)
    b_ms, b_by = bound(*sweep_cost(cfg.total_qubits, trials * 64))
    return dict(config="65p/L64", trials=trials, shots=trials * 64,
                qubits=cfg.total_qubits,
                tables=placement(pc.stabilizer_sweep_tables(cfg)), ms=ms,
                bound_ms=b_ms, bound_by=b_by)


RING_CASES = [((3, 5, 7), 1), ((2, 9000), 1), ((3, 4100, 5), 1),
              ((2, 3, 16, 64), 2), ((6,), 0)]


def ring_vs_plain(dev):
    """The ring gather against its plain version, bit-exact, at ``tp`` 2,
    4 and 8 on int8, int32, bool, uint8 and int64 shards: segments of 35 B (byte
    moves), of 20,500 B (4-byte moves, two 16 KB tiles, the second
    ragged), of 36,000 B (16-byte moves, three tiles), of one tile, and
    a gather along the leading axis.  Returns the max abs error and the
    number of cases."""
    import torch

    from qba_tpu_torch.ops.ring_shuffle import (
        ring_gather,
        ring_gather_reference,
    )

    gen = torch.Generator().manual_seed(7)
    err, n = 0, 0
    for tp in (2, 4, 8):
        for dtype in (torch.int8, torch.int32, torch.bool, torch.uint8,
                      torch.int64):
            for shard, axis in RING_CASES:
                x = torch.randint(-100, 100, (tp,) + shard, generator=gen)
                x = ((x > 0) if dtype == torch.bool else x.to(dtype)).to(dev)
                err = max(err, max_err(ring_gather(x, axis),
                                       ring_gather_reference(x, axis)))
                n += 1
    if err:
        raise AssertionError(f"ring_gather != plain version: {err}")
    return err, n


def ring_timing(leaves, reps=5):
    """The ring kernel on each shard-stacked pool leaf (``[tp, T, ...]``,
    gathered along its capacity axis, as the party-sharded fused engine
    gathers it), against its plain version and one PyTorch broadcast copy
    of the concatenated shards (the yardstick): each checked equal, and
    timed per launch (CUDA events over ``reps``; the plain version by
    host clock), averaged over the leaves, with the bound per launch."""
    import torch

    from qba_tpu_torch.ops.ring_shuffle import (
        ring_gather,
        ring_gather_reference,
    )
    from qba_tpu_torch.ops.round_kernel_tiled import POOL_AXES

    def events_ms(fn):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0)
    for x, ax in zip(leaves, POOL_AXES):
        axis = ax + 1
        tp = x.shape[0]
        got = ring_gather(x, axis)
        lib = torch.empty_like(got)
        # lib [tp, *pre, tp * chunk, *post] as [tp, *pre, tp, chunk, *post]
        view = lib.view(tp, *x.shape[1:axis + 1], tp, *x.shape[axis + 1:])
        src = x.movedim(0, axis)
        src = src.unsqueeze(0).expand(tp, *src.shape)

        def library():
            view.copy_(src)

        library()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ring_gather_reference(x, axis)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_err(got, want), max_err(lib, want))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        ring_gather.events = []
        for _ in range(reps):
            ring_gather(x, axis)
        torch.cuda.synchronize()
        out["ms"] += event_ms(ring_gather.events) / len(leaves)
        ring_gather.events = None
        out["library_ms"] += events_ms(library) / len(leaves)
        out["plain_ms"] += plain_ms / len(leaves)
        out["bound_ms"] += bound(*ring_cost(x))[0] / len(leaves)
    if out["max_abs_err"]:
        raise AssertionError(f"ring_gather != plain version on the pool "
                             f"leaves: {out['max_abs_err']}")
    return out


# The sweep path: (config, target, budget chunks, outcome, config
# changes) at chunk_trials=1000, seed 3.  The two decide targets stop
# inside the budget (11p below 0.3 at chunk 7, 33p below 0.56 at chunk 6,
# on these keys); the third runs the whole budget without deciding.  The
# fourth holds the graph loop on the stabilizer path (the gen entry), its
# outcome not pinned: its lists differ from the factorized path's.
TARGETED_TRIALS = 1000
TARGETED_SEED = 3
TARGETED_CASES = [("33p/L64/d10", "decide vs 0.56 +-0.01", 12, "decided",
                   {}),
                  ("11p/L64/d3", "decide vs 0.3 +-0.005", 12, "decided", {}),
                  ("33p/L64/d10", "decide vs 0.55 +-0.01", 12,
                   "budget_exhausted", {}),
                  ("33p/L64/d10", "decide vs 0.56 +-0.01", 4, None,
                   dict(qsim_path="stabilizer"))]


def sweep_stop_cost(n_trials, bits=False):
    """``sweep_stop``'s bytes (the chunk's success and overflow bytes, two
    table words, the carry's two words read and four written, and with
    ``bits`` the chunk's success bits stored) and operations (an add and
    an or a trial)."""
    return 2 * n_trials + 8 + 8 + 16 + (n_trials if bits else 0), \
        2 * n_trials


def sweep_stop_vs_plain(dev, inputs=None):
    """The ``sweep_stop`` kernel against its plain version, bit-exact on
    the carry (counts, flags, index, total and the loop's flag, which the
    graph loop's handle takes) and, with ``succ_out``, on the stored
    success bits (rows of earlier chunks left as they were), at every
    index of a four-chunk budget and past it: on seeded random chunks of
    1, 37, 64, 1000 and 5000 trials, or on ``inputs`` (a chunk's
    ``(success, overflow)``).  Returns the largest difference."""
    import torch

    from qba_tpu_torch.ops import sweep_loop as sl

    g = torch.Generator().manual_seed(0)
    if inputs is None:
        cases = [(torch.rand(t, generator=g) < 0.4,
                  torch.rand(t, generator=g) < 2.0 / t)
                 for t in (1, 37, 64, 1000, 5000)]
    else:
        cases = [tuple(x.cpu() for x in inputs)]
    err = 0
    for success, overflow in cases:
        t = success.shape[0]
        lo = torch.tensor([-1, 0, t // 3, t // 2, t], dtype=torch.int32)
        hi = lo + torch.tensor([2, t, t, t, t], dtype=torch.int32)
        for start in range(5):
            carry = sl.new_carry(4, start, (t // 4) * start, "cpu")
            want = sl.sweep_stop_reference(success, overflow, lo, hi,
                                           carry.clone())
            got = sl.sweep_stop(success.to(dev), overflow.to(dev),
                                lo.to(dev), hi.to(dev), carry.to(dev))
            err = max(err, max_err(got.cpu(), want))
            bits = torch.rand(4 * t, generator=g) < 0.5
            want_bits = bits.clone()
            want = sl.sweep_stop_reference(success, overflow, lo, hi,
                                           carry.clone(), want_bits)
            got_bits = bits.to(dev)
            got = sl.sweep_stop(success.to(dev), overflow.to(dev),
                                lo.to(dev), hi.to(dev), carry.to(dev),
                                succ_out=got_bits)
            err = max(err, max_err(got.cpu(), want),
                      max_err(got_bits.cpu(), want_bits))
    if err:
        raise AssertionError(f"sweep_stop != plain version: {err}")
    return err


def sweep_stop_timing(cfg, dev, reps=100, bits=False):
    """``sweep_stop`` on one full chunk of ``cfg`` (its keys' success and
    overflow flags; with ``bits`` also storing them, as the serving
    worker's loop does) against its plain version: bit-exact on the
    carry, ms per launch (CUDA events around each of ``reps`` launches,
    each a real step of a long budget; and ``queued_ms``, ``reps``
    launches queued behind a sleep between one pair of events, which
    leaves out the host's launch rate), the plain version's ms (host
    clock, fenced), its bound and a library call's ms (none computes this
    step)."""
    import torch

    from qba_tpu_torch.ops import sweep_loop as sl
    from qba_tpu_torch.rounds.engine import run_trial
    from qba_tpu_torch.sweep import chunk_keys

    res = run_trial(cfg, chunk_keys(cfg, 0, cfg.trials, dev))
    success, overflow = res.success.contiguous(), res.overflow.contiguous()
    err = sweep_stop_vs_plain(dev, (success, overflow))
    n = 2 * reps + 1
    lo = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    hi = torch.full((n + 1,), cfg.trials * n + 1, dtype=torch.int32,
                    device=dev)
    carry = sl.new_carry(n, 0, 0, dev)
    succ = (torch.zeros(n * cfg.trials, dtype=torch.bool, device=dev)
            if bits else None)
    args = (success, overflow, lo, hi, carry, 0, succ)
    sl.sweep_stop(*args)  # warm-up
    ms = kernel_ms(sl.sweep_stop, reps, *args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        sl.sweep_stop(*args)
    end.record()
    torch.cuda.synchronize()
    queued_ms = start.elapsed_time(end) / reps
    if sl.read_carry(carry)[0] != n:
        raise AssertionError("sweep_stop timing: the steps did not advance")
    if bits and not torch.equal(succ.view(n, -1), success.expand(n, -1)):
        raise AssertionError("sweep_stop timing: the stored bits differ")
    plain = sl.new_carry(n, 0, 0, dev)
    plain_succ = None if succ is None else torch.zeros_like(succ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sl.sweep_stop_reference(success, overflow, lo, hi, plain, plain_succ)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / 10 * 1e3
    b = bound(*sweep_stop_cost(cfg.trials, bits))
    return dict(max_abs_err=err, ms=ms, queued_ms=queued_ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=None, trials=cfg.trials, bits=bits)


def sweep_run(cfg, n_chunks, target, dispatch):
    """One targeted ``run_sweep`` on the card, every kernel's launch
    count set to 0 just before and read just after (no CUDA events: the
    graph loop captures the launches).  Returns the result, the wall
    seconds, the counts and the run's timers."""
    import torch

    from qba_tpu_torch.obs.timers import PhaseTimers
    from qba_tpu_torch.sweep import run_sweep

    fns = wrappers()
    for fn in fns.values():
        fn.launches, fn.events = 0, None
    timers = PhaseTimers()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(cfg, n_chunks, cfg.trials, target=target,
                    dispatch=dispatch, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {k: fn.launches for k, fn in fns.items()}, timers


def sweep_path(configs):
    """The targeted sweep on the card (``TARGETED_CASES``): the host loop
    (one chunk a dispatch, one readback a chunk), the graph loop (one
    launch of a CUDA graph whose WHILE node runs the captured chunk, one
    readback) and the fixed-budget run, chunk for chunk and stop for
    stop, with launch counts asserted, readbacks, wall and rounds/s over
    the executed chunks, and the graph's warm-up, capture and instantiate
    ms.  Returns ``(runs, launches)``."""
    import dataclasses

    from qba_tpu_torch.sweep import run_sweep

    runs, launches = [], dict.fromkeys(COUNTED, 0)
    for name, spec, budget, outcome, kw in TARGETED_CASES:
        cfg = dataclasses.replace(configs[name], trials=TARGETED_TRIALS,
                                  seed=TARGETED_SEED, **kw)
        mega = ("trial_megakernel_gen_keyed" if cfg.qsim_path == "stabilizer"
                else "trial_megakernel_keyed")
        name = " ".join([name, *kw.values()])
        t0 = time.perf_counter()
        fixed = run_sweep(cfg, budget, cfg.trials)
        fixed_s = time.perf_counter() - t0
        out = dict(config=name, target=spec, budget_chunks=budget,
                   chunk_trials=cfg.trials, rounds=cfg.n_rounds,
                   fixed_budget=dict(wall_s=fixed_s, rounds_per_s=(
                       budget * cfg.trials * cfg.n_rounds / fixed_s)))
        res = {}
        for dispatch in ("host", "device"):
            r, wall, counts, timers = sweep_run(cfg, budget, spec, dispatch)
            for k, n in counts.items():
                launches[k] += n
            done = len(r.chunks)
            rounds = done * cfg.trials * cfg.n_rounds
            if dispatch == "host":
                want = {mega: done}
                rec = dict(readbacks=timers.count("readback"), wall_s=wall,
                           rounds_per_s=rounds / wall,
                           ms_per_chunk=wall / done * 1e3)
            else:
                # Eager warm-up and capture: one launch of each kernel;
                # the graph then runs them once a chunk.
                want = {mega: 2, "sweep_stop": 2}
                (span,) = [sp for sp in timers.spans.spans
                           if sp.name == "device_loop"]
                info = span.args
                if info["dispatch"] != "graph" or info["readbacks"] != 1:
                    raise AssertionError(f"sweep {name}: not one graph "
                                         f"launch: {info}")
                rec = dict(readbacks=info["readbacks"], wall_s=wall,
                           rounds_per_s=rounds / wall,
                           loop_s=info["loop_s"],
                           loop_rounds_per_s=rounds / info["loop_s"],
                           ms_per_chunk=info["loop_s"] / done * 1e3,
                           warmup_ms=info["warmup_s"] * 1e3,
                           capture_ms=info["capture_s"] * 1e3,
                           instantiate_ms=info["instantiate_s"] * 1e3,
                           body_nodes=info["body_nodes"])
            want = {k: want.get(k, 0) for k in COUNTED}
            if counts != want:
                raise AssertionError(f"sweep {name} {dispatch}: launches "
                                     f"{counts}, expected {want}")
            rec.update(chunks=done, stop_chunk=done - 1,
                       stop=r.stop.reason, successes=r.successes,
                       launches={k: n for k, n in counts.items() if n})
            res[dispatch] = r
            out[dispatch] = rec
        host, dev = res["host"], res["device"]
        if not (host.chunks == dev.chunks == fixed.chunks[:len(host.chunks)]
                and host.stop.to_json() == dev.stop.to_json()):
            raise AssertionError(f"sweep {name} {spec}: host loop, graph "
                                 "loop and fixed-budget prefix disagree")
        if outcome is not None and not (
                host.stop.reason.startswith(outcome)
                and (len(host.chunks) < budget) == (outcome == "decided")):
            raise AssertionError(f"sweep {name} {spec}: stopped with "
                                 f"{host.stop.reason} after "
                                 f"{len(host.chunks)} chunks")
        out["counts"] = [c.successes for c in host.chunks]
        out["graph_over_host"] = (out["host"]["ms_per_chunk"]
                                  / out["device"]["ms_per_chunk"])
        log("sweep_path", **out)
        runs.append(out)
    return runs, launches


# The device surface: the (strategy x noise x sizeL) grid of a targeted
# run as one CUDA graph, at 33p/L64/d10, chunks of 1000 trials, seed 3.
# Run A spends a shared budget of 48 chunks on the first target of
# SURFACE_TARGETS under which the host surface resolves every cell; run B
# cuts the budget to 6, where it runs out first.
SURFACE_GRID = (("reference", "split"), [(0.0, 0.0), (0.01, 0.01)], [64])
SURFACE_BUDGET = 48
SURFACE_SHORT_BUDGET = 6
SURFACE_TARGETS = ["decide vs 0.56 +-0.01", "decide vs 0.6 +-0.02",
                   "decide vs 0.5 +-0.02"]
# Two best scores of a step closer than this are a near-tie: float32
# widths may order the two cells either way.
SURFACE_NEAR_TIE = 1e-4
# surface_pick's endpoints against its plain version on the card: both
# take each float32 operation rounded on its own (the kernel is built with
# -fmad=false) and the card's lgammaf, logf and log1pf, so they are
# expected equal; the chosen cell and its tier are held exact.
PICK_ATOL = 1e-6
PICK_CELLS = (1, 4, 33, 256)
# float32 operations of one bisection step of surface_pick (midpoint,
# clip, log, log1p and the mixture's products and sums, the compare) and
# of a cell's fixed work (three lgamma, the MLE, the edge tests, the
# score).
PICK_STEP_OPS = 14
PICK_CELL_OPS = 30
CLI_SWEEP = ["sweep", "--n-parties", "11", "--size-l", "64",
             "--n-dishonest", "3", "--trials", "1000", "--seed", "3",
             "--n-chunks", "12", "--target", "decide vs 0.3 +-0.005",
             "--dispatch", "device"]


def pick_cost(ci):
    """``surface_pick``'s bytes (each cell's three carry words read and
    its two endpoints written, the head and a tier word) and float
    operations, counting the bisections this carry needs: a side whose
    endpoint is not the interval's edge took 60 steps."""
    n = ci.shape[1]
    lo, hi = ci[0].cpu(), ci[1].cpu()
    sides = int((lo != 0).sum()) + int((hi != 1).sum())
    return n * 20 + 24, n * PICK_CELL_OPS + sides * 60 * PICK_STEP_OPS


def fold_cost(n_trials, n_cells):
    """``surface_fold``'s bytes (the slot's two bytes a trial, two table
    words, each cell's done word, the head, and seven words stored) and
    operations (an add and an or a trial, a test a cell)."""
    return 2 * n_trials + 8 + 4 * n_cells + 20 + 28, 2 * n_trials + n_cells


def random_surface(g, n, budget, steps, dev):
    """A random carry of ``n`` cells: chunks up to ``budget - 1`` of 1000
    trials, successes up to all of them, a quarter of the cells done."""
    import torch

    from qba_tpu_torch.ops import surface_loop as su

    layout = su.SurfaceLayout(n, budget, steps)
    i = torch.randint(0, budget, (n,), generator=g)
    k = (torch.rand(n, generator=g) * i * 1000).long()
    done = torch.rand(n, generator=g) < 0.25
    return layout, su.new_surface_carry(layout, k, i, done, dev)


def surface_vs_plain(dev):
    """``surface_pick`` and ``surface_fold`` against their plain versions
    on the card's tensors: random carries of 1, 4, 33 and 256 cells with
    up to 32 chunks of 1000 trials a cell, a quarter done, under a decide
    threshold of 0.3 and 0.55 and a width target (no threshold), the
    chosen cell, its chunk index and tier exact, the endpoints within
    ``PICK_ATOL``; the fold bit-exact on the carry from a random chosen
    cell's chunk, and past the steps (nothing stored).  Returns the
    largest endpoint and carry differences."""
    import numpy as np
    import torch

    from qba_tpu_torch.ops import surface_loop as su

    g = torch.Generator().manual_seed(0)
    pick_err, fold_err = 0.0, 0
    for n in PICK_CELLS:
        for rep in range(3):
            layout, carry = random_surface(g, n, 33, 4, dev)
            carry[su.STEP] = rep
            for thr in (0.3, 0.55, None):
                cis = [torch.zeros((2, n), device=dev) for _ in "ab"]
                want = su.surface_pick_reference(carry.clone(), cis[0],
                                                 layout, 1000, 0.95, thr)
                got = su.surface_pick(carry.clone(), cis[1], layout, 1000,
                                      0.95, thr)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"surface_pick != plain version at {n} cells, "
                        f"threshold {thr}: chosen "
                        f"{int(got[su.CHOSEN])} vs {int(want[su.CHOSEN])}")
                pick_err = max(pick_err,
                               float((cis[0] - cis[1]).abs().max()))
            lo = (torch.arange(34) * 1000 * 0.3).int().to(dev)
            hi = (torch.arange(34) * 1000 * 0.7).int().to(dev)
            hi[0] = 1
            open_ = np.flatnonzero(~su.read_surface_carry(layout,
                                                          carry)["done"])
            for step in (rep, 4):
                c = int(open_[0]) if len(open_) else 0
                carry[su.CHOSEN] = c
                carry[su.I_CUR] = int(carry[layout.section("i")][c])
                carry[su.STEP] = step
                success = (torch.rand(1000, generator=g) < 0.5).to(dev)
                overflow = (torch.rand(1000, generator=g) < 0.002).to(dev)
                want = su.surface_fold_reference(success, overflow, lo, hi,
                                                 carry.clone(), layout)
                got = su.surface_fold(success, overflow, lo, hi,
                                      carry.clone(), layout)
                fold_err = max(fold_err, max_err(got, want))
    torch.cuda.synchronize()
    if pick_err > PICK_ATOL or fold_err:
        raise AssertionError(f"surface kernels != plain versions: endpoints "
                             f"{pick_err}, fold {fold_err}")
    return pick_err, fold_err


def queued_ms(fn, reps, *args):
    """``fn(*args)``'s ms a launch with ``reps`` launches queued behind a
    sleep kernel between one pair of events (the host's launch rate left
    out)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms(fn, reps, *args):
    """The plain version's ms a call on the card's tensors (host clock,
    fenced)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def surface_timing(k, i, done, target, dev, reps=100):
    """``surface_pick`` and ``surface_fold`` at the main path's shapes (the
    grid's four cells at totals ``k`` of ``i`` chunks, budget 48, chunks
    of 1000 trials): ms a launch from CUDA events, queued behind a sleep,
    the plain version's ms, the bound and a library call's ms (none: no
    PyTorch call sets a graph's handle)."""
    import torch

    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.stats import parse_target

    tgt = parse_target(target)
    layout = su.SurfaceLayout(len(k), SURFACE_BUDGET, 2 * reps + 1)
    carry = su.new_surface_carry(layout, k, i, done, dev)
    ci = torch.zeros((2, len(k)), device=dev)
    args = (carry, ci, layout, 1000, tgt.confidence, tgt.threshold)
    su.surface_pick(*args)
    rows = {}
    b = bound(*pick_cost(ci), float_ops=True)
    rows["surface_pick"] = dict(
        ms=kernel_ms(su.surface_pick, reps, *args),
        queued_ms=queued_ms(su.surface_pick, reps, *args),
        plain_ms=plain_ms(su.surface_pick_reference, 10, carry.clone(),
                          ci.clone(), *args[2:]),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    g = torch.Generator().manual_seed(1)
    success = (torch.rand(1000, generator=g) < 0.5).to(dev)
    overflow = torch.zeros(1000, dtype=torch.bool, device=dev)
    lo = torch.full((SURFACE_BUDGET + 1,), -1, dtype=torch.int32, device=dev)
    hi = torch.full((SURFACE_BUDGET + 1,), 10 ** 9, dtype=torch.int32,
                    device=dev)
    args = (success, overflow, lo, hi, carry, layout)
    su.surface_fold(*args)
    b = bound(*fold_cost(1000, len(k)))
    rows["surface_fold"] = dict(
        ms=kernel_ms(su.surface_fold, reps, *args),
        queued_ms=queued_ms(su.surface_fold, reps, *args),
        plain_ms=plain_ms(su.surface_fold_reference, 10, *args[:4],
                          carry.clone(), layout),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    if su.read_surface_carry(layout, carry)["step"] != 2 * reps + 1:
        raise AssertionError("surface_fold timing: the steps did not advance")
    return rows


def step_scores(trace, cells, threshold, confidence):
    """The device's float32 score of every cell at each step of ``trace``
    (a host allocator's), from the chunks each cell had run by then."""
    import torch

    from qba_tpu_torch.ops.surface_loop import surface_scores

    counts = [[c.successes for c in cell.result.chunks] for cell in cells]
    done_at = [len(cell.result.chunks)
               if cell.result.stop.reason.startswith("decided") else None
               for cell in cells]
    ran = [0] * len(cells)
    out = []
    for step in trace:
        out.append(surface_scores(
            torch.tensor([sum(c[:r]) for c, r in zip(counts, ran)]),
            torch.tensor(ran),
            torch.tensor([d is not None and r >= d
                          for d, r in zip(done_at, ran)]),
            1000, confidence, threshold)[0].tolist())
        ran[step["cell"]] += 1
    return out


def near_tie(scores):
    """Whether the two best scores of a step (neither a bootstrap's, which
    go in index order on both sides, nor a done cell's) lie within
    ``SURFACE_NEAR_TIE``."""
    a, b = sorted(scores)[:2]
    return 2.0 <= a and b < 1e9 and b - a <= SURFACE_NEAR_TIE


def surface_run(cfg, target, budget, dispatch, grid=SURFACE_GRID):
    """One targeted ``run_surface`` over ``grid`` on the card,
    every kernel's launch count set to 0 just before and read just after.
    Returns the cells, the wall seconds, the counts, the device loop's
    record (None on the host) and the peak memory."""
    import torch

    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.sweep import run_surface

    records = []
    loop = su.device_surface_loop

    def recorded(*args, **kw):
        out, info = loop(*args, **kw)
        records.append(info)
        return out, info

    fns = wrappers()
    for fn in fns.values():
        fn.launches, fn.events = 0, None
    su.device_surface_loop = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        cells = run_surface(cfg, *grid, chunk_trials=cfg.trials,
                            target=target, budget_chunks=budget,
                            dispatch=dispatch)
    finally:
        su.device_surface_loop = loop
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (cells, wall, {k: fn.launches for k, fn in fns.items()},
            records[0] if records else None,
            torch.cuda.max_memory_allocated())


def surface_alloc(cells):
    return cells[0].manifest["stats"]["allocator"]


def surface_path(configs, dev):
    """The device surface at full width (``SURFACE_GRID``): run A, where
    every cell resolves inside ``SURFACE_BUDGET`` (the target picked with
    the host surface first), the graph surface (one launch, one readback)
    equal to the host surface and each cell to its own ``run_sweep``; run
    B, budget 6, its schedule beside the host allocator's, equal but at
    near-ties, with a pass out of capture order; launch counts asserted;
    the graph's ms a pass against the host's ms a chunk, its warm-up,
    capture and instantiate ms, node counts and peak memory; the two
    kernels timed; the CLI's ``sweep --dispatch device`` at 11p.  Returns
    ``(record, launches)``."""
    import dataclasses

    from qba_tpu_torch.sweep import run_sweep

    cfg = dataclasses.replace(configs["33p/L64/d10"], trials=1000,
                              seed=TARGETED_SEED)
    n_cells = len(SURFACE_GRID[0]) * len(SURFACE_GRID[1])
    launches = dict.fromkeys(COUNTED, 0)
    # A warm-up: the four cells' first chunks on the host.
    _cells, _wall, counts, _info, _peak = surface_run(
        cfg, SURFACE_TARGETS[0], n_cells, "host")
    for k, n in counts.items():
        launches[k] += n
    tried = []
    for target in SURFACE_TARGETS:
        host, host_wall, counts, _, host_peak = surface_run(
            cfg, target, SURFACE_BUDGET, "host")
        for k, n in counts.items():
            launches[k] += n
        spent = surface_alloc(host)["spent_chunks"]
        if counts != {k: (spent if k == "trial_megakernel_keyed" else 0)
                      for k in COUNTED}:
            raise AssertionError(f"host surface: launches {counts}, "
                                 f"expected {spent} megakernel launches")
        outcome = [(len(c.result.chunks), c.result.stop.reason,
                    c.result.success_rate) for c in host]
        tried.append(dict(target=target, cells=outcome))
        if all(c.result.stop.reason.startswith("decided") for c in host):
            break
    else:
        raise AssertionError(f"no target resolves every cell in "
                             f"{SURFACE_BUDGET} chunks: {tried}")
    log("surface_path", run="target", tried=tried, target=target)

    runs = {}
    for label, budget in (("A", SURFACE_BUDGET), ("B", SURFACE_SHORT_BUDGET)):
        if label == "B":
            host, host_wall, counts, _, host_peak = surface_run(
                cfg, target, budget, "host")
            for k, n in counts.items():
                launches[k] += n
        dev_cells, wall, counts, info, peak = surface_run(
            cfg, target, budget, "device")
        for k, n in counts.items():
            launches[k] += n
        # Eager warm-up and capture: one launch of each kernel (of the
        # megakernel, one a cell); the graph then runs them once a pass.
        want = {k: 0 for k in COUNTED}
        want.update(trial_megakernel_keyed=2 * n_cells, surface_pick=2,
                    surface_fold=2)
        if counts != want:
            raise AssertionError(f"surface {label}: launches {counts}, "
                                 f"expected {want}")
        if info["dispatch"] != "graph" or info["readbacks"] != 1:
            raise AssertionError(f"surface {label}: not one graph launch: "
                                 f"{info}")
        h_alloc, d_alloc = surface_alloc(host), surface_alloc(dev_cells)
        h_sched = [t["cell"] for t in h_alloc["trace"]]
        d_sched = [t["cell"] for t in d_alloc["trace"]]
        scores = step_scores(h_alloc["trace"], host, parse_threshold(target),
                             0.95)
        near = [dict(step=s, scores=sc) for s, sc in enumerate(scores)
                if near_tie(sc)]
        same = h_sched == d_sched and [t["reason"] for t in h_alloc["trace"]] \
            == [t["reason"] for t in d_alloc["trace"]]
        first = next((s for s, (a, b) in enumerate(zip(h_sched, d_sched))
                      if a != b), None)
        if not same and not any(x["step"] == first for x in near):
            raise AssertionError(f"surface {label}: device schedule "
                                 f"{d_sched} != host {h_sched}")
        if label == "A" or same:
            for h, d in zip(host, dev_cells):
                if not (h.result.chunks == d.result.chunks
                        and h.result.stop.to_json() == d.result.stop.to_json()):
                    raise AssertionError(f"surface {label}: cell "
                                         f"{h.strategy}/{h.p_depolarize} "
                                         "differs from the host surface")
            if h_alloc["spent_chunks"] != d_alloc["spent_chunks"]:
                raise AssertionError(f"surface {label}: spent chunks differ")
        passes = info["passes"]
        rec = dict(
            budget_chunks=budget, target=target, same_schedule=same,
            near_ties=near, host_schedule=h_sched,
            host_reasons=[t["reason"] for t in h_alloc["trace"]],
            device_sched=d_sched,
            device_tiers=[t["reason"] for t in d_alloc["trace"]],
            out_of_capture_order=[s for s in range(1, len(d_sched))
                                  if d_sched[s] < d_sched[s - 1]],
            cells=[dict(cell=f"{c.strategy}_p{c.p_depolarize}",
                        chunks=len(c.result.chunks),
                        stop=c.result.stop.reason,
                        success_rate=c.result.success_rate)
                   for c in dev_cells],
            spent_chunks=d_alloc["spent_chunks"], passes=passes,
            design=info["design"], readbacks=info["readbacks"],
            launches={k: n for k, n in counts.items() if n},
            wall_s=wall, host_wall_s=host_wall,
            ms_per_pass=info["loop_s"] / passes * 1e3,
            host_ms_per_chunk=host_wall / h_alloc["spent_chunks"] * 1e3,
            loop_ms=info["loop_s"] * 1e3,
            warmup_ms=info["warmup_s"] * 1e3,
            warmup_cell_ms=[x * 1e3 for x in info["warmup_cell_s"]],
            capture_ms=info["capture_s"] * 1e3,
            capture_cell_ms=[x * 1e3 for x in info["capture_cell_s"]],
            instantiate_ms=info["instantiate_s"] * 1e3,
            upload_ms=info["upload_s"] * 1e3,
            body_nodes=info["body_nodes"],
            body_nodes_total=info["body_nodes_total"],
            peak_mem_bytes=peak, host_peak_mem_bytes=host_peak)
        log("surface_path", run=label, config="33p/L64/d10",
            chunk_trials=cfg.trials, **rec)
        runs[label] = rec
        if label == "A":
            # Each cell equals its own targeted run_sweep.
            for c in dev_cells:
                own = run_sweep(c.result.cfg, SURFACE_BUDGET, cfg.trials,
                                target=target)
                if not (own.chunks == c.result.chunks
                        and own.stop.to_json() == c.result.stop.to_json()):
                    raise AssertionError(f"surface A: cell {c.strategy}/"
                                         f"{c.p_depolarize} != its own "
                                         "run_sweep")
            totals = ([c.result.successes for c in dev_cells],
                      [len(c.result.chunks) for c in dev_cells])
    # A pass out of capture order shows that the captures' shared memory
    # pool holds whatever order the branches run in.
    if not (runs["B"]["out_of_capture_order"]
            or runs["A"]["out_of_capture_order"]):
        raise AssertionError("surface: no pass picked a cell out of "
                             "capture order")
    kernels = surface_timing(*totals, [False] * n_cells, target, dev)
    log("surface_timing", config="33p/L64/d10 run A's totals, 4 cells",
        **kernels)

    import subprocess as sp

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "qba_tpu_torch", *CLI_SWEEP],
                  cwd=root, capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"sweep CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    stop_line = proc.stdout.strip().splitlines()[-1]
    if not stop_line.startswith("stop: decided_below after 7000 trials"):
        raise AssertionError(f"sweep CLI: {stop_line}")
    cli = dict(wall_s=cli_wall, argv=CLI_SWEEP, stop=stop_line)
    log("surface_path", run="cli", **cli)
    return dict(runs=runs, targets_tried=tried, kernels=kernels,
                cli=cli), launches


def parse_threshold(target):
    from qba_tpu_torch.stats import parse_target

    return parse_target(target).threshold


# The serving worker on the card: 1000-trial requests at full width in
# chunks of 64 trials, two in flight, fed as JSONL.  The targeted request
# comes first in its bucket, so its chunks start at chunk boundaries as
# the device path's do; its target decides inside the budget (below 0.58
# at chunk 7 on these keys; the sweep's 0.56 +-0.01 needs about 6000
# trials at 33p, PERF.md §5), so the device path's budget,
# floor-quantized to 15 chunks, does not cut it short of the host path's.
SERVE_CHUNK = 64
SERVE_TRIALS = 1000
SERVE_TARGET = "decide vs 0.58 +-0.02"
SERVE_REQUESTS = [
    ("33p-target", "33p/L64/d10", dict(seed=3, target=SERVE_TARGET)),
    ("33p", "33p/L64/d10", dict(seed=4)),
    ("11p-decisions", "11p/L64/d3", dict(seed=5, return_decisions=True)),
    ("33p-stabilizer", "33p/L64/d10", dict(seed=6, qsim_path="stabilizer")),
]


def median(xs):
    xs = sorted(xs)
    return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2 if xs else None


def serve_run(server, stream, events):
    """``stream`` through ``serve_jsonl`` on ``server``, every kernel's
    launch count set to 0 just before and read just after (with CUDA
    events when ``events``).  Returns the results by id, the wall
    seconds, the counts, the events and the peak memory."""
    import io

    import torch

    from qba_tpu_torch.serve import serve_jsonl

    fns = wrappers()
    for fn in fns.values():
        fn.launches, fn.events = 0, [] if events else None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    out = io.StringIO()
    t0 = time.perf_counter()
    serve_jsonl(server, io.StringIO(stream), out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in fns.items()}
    evs = {k: fn.events for k, fn in fns.items() if fn.events}
    for fn in fns.values():
        fn.events = None
    results = {r["request_id"]: r
               for r in map(json.loads, out.getvalue().splitlines())}
    return results, wall, counts, evs, torch.cuda.max_memory_allocated()


def behind_sleep(fn, cycles=400_000_000):
    """Host ms of ``fn()`` issued while the card runs a sleep kernel of
    ``cycles`` clocks, and the sleep's ms (CUDA events).  A call that
    reads the card waits out the sleep."""
    import torch

    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms, ev[0].elapsed_time(ev[1])


def dispatch_probe(req, dev):
    """Does a chunk's dispatch read the card?  One 64-trial dispatch runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing
    op torch knows raises); the pinned key upload is timed behind a sleep
    kernel (it must not wait); and the whole dispatch behind a sleep is
    set beside the time to enqueue N one-element adds behind a sleep: a
    dispatch of more launches than CUDA's launch queue holds waits
    for the card to drain it, which is not a read."""
    import dataclasses

    import numpy as np
    import torch

    from qba_tpu_torch.serve import QBAServer

    probe = QBAServer(chunk_trials=SERVE_CHUNK, depth=SERVE_CHUNK)
    probe.submit(dataclasses.replace(req, request_id="probe",
                                     trials=4 * SERVE_CHUNK))
    torch.cuda.set_sync_debug_mode("error")
    try:
        probe._dispatch(probe.scheduler.next_chunk())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = torch.from_numpy(np.zeros((SERVE_CHUNK, 2), dtype=np.int64))
    upload_ms, sleep_ms = behind_sleep(
        lambda: host.pin_memory().to(dev, non_blocking=True))
    dispatch_ms, _ = behind_sleep(
        lambda: probe._dispatch(probe.scheduler.next_chunk()))
    x = torch.zeros(1, device=dev)
    queue = {}
    for n in (256, 512, 1024, 2048, 4096):
        queue[n] = behind_sleep(lambda: [x.add_(1) for _ in range(n)])[0]
    probe.flush()
    out = dict(sync_debug_mode="error: nothing raised",
               sleep_ms=sleep_ms, upload_behind_sleep_ms=upload_ms,
               dispatch_behind_sleep_ms=dispatch_ms,
               adds_behind_sleep_ms=queue)
    if upload_ms > 0.5 * sleep_ms:
        raise AssertionError(f"serve: the key upload waited for the card: "
                             f"{out}")
    return out


def serve_path(configs, dev):
    """The serving worker (``qba_tpu_torch.serve``) on the card: the host
    path (``SERVE_REQUESTS`` through ``serve_jsonl`` on a
    ``QBAServer(chunk_trials=64, depth=2)``, after one warm-up pass of
    the same stream), every result held against a direct ``run_trials``
    of its config and keys, trial for trial; the device path (the
    targeted request on a ``dispatch="device"`` server: one graph launch,
    one readback) against its host-path twin; ``sweep_stop`` storing the
    success bits on a 64-trial chunk against its plain version, timed;
    and ``python -m qba_tpu_torch serve`` answering one request from a
    file queue.  Returns ``(report, launches)``."""
    import ast
    import dataclasses
    import shutil

    import torch

    from qba_tpu_torch.backends.torch_backend import run_trials
    from qba_tpu_torch.obs.telemetry import spans_from_jsonl
    from qba_tpu_torch.serve import EvalRequest, QBAServer, serve_batch
    from qba_tpu_torch.serve.queuefs import drop_request, queue_paths
    from qba_tpu_torch.serve.request import EvalResult

    def request(rid, name, kw):
        c = configs[name]
        return EvalRequest(request_id=rid, n_parties=c.n_parties,
                           size_l=c.size_l, n_dishonest=c.n_dishonest,
                           trials=SERVE_TRIALS, **kw)

    reqs = [request(*r) for r in SERVE_REQUESTS]
    stream = "".join(json.dumps(r.to_json()) + "\n" for r in reqs)
    launches = dict.fromkeys(COUNTED, 0)
    t0 = time.perf_counter()
    serve_run(QBAServer(chunk_trials=SERVE_CHUNK, depth=2), stream, False)
    warmup_s = time.perf_counter() - t0
    server = QBAServer(chunk_trials=SERVE_CHUNK, depth=2)
    results, wall, counts, events, peak = serve_run(server, stream, True)
    spans = server.recorder.spans
    dispatches = [sp for sp in spans if sp.name == "serve.dispatch"]
    readbacks = [sp for sp in spans if sp.name == "serve.readback"]
    # The chunks' megakernel launches, in dispatch order: the gen entry
    # on the stabilizer bucket, the keyed entry on the others.
    # A bucket's label leaves out its list generation: key chunks by both.
    key = [(sp.args["bucket"], sp.args["qsim_path"]) for sp in dispatches]
    is_gen = [q == "stabilizer" for _, q in key]
    want = {"trial_megakernel_keyed": is_gen.count(False),
            "trial_megakernel_gen_keyed": is_gen.count(True)}
    want = {k: want.get(k, 0) for k in COUNTED}
    if counts != want:
        raise AssertionError(f"serve host path: launches {counts}, "
                             f"expected {want}")
    for k, n in counts.items():
        launches[k] += n
    kernel_ms = {True: iter(events.get("trial_megakernel_gen_keyed", [])),
                 False: iter(events.get("trial_megakernel_keyed", []))}
    chunk_ms, dispatch_ms, readback_ms = {}, {}, {}
    for k, gen, d in zip(key, is_gen, dispatches):
        a, b = next(kernel_ms[gen])
        chunk_ms.setdefault(k, []).append(a.elapsed_time(b))
        dispatch_ms.setdefault(k, []).append(d.dur * 1e3)
    # A chunk's readback span carries its chunk index.
    bucket_of = {d.args["chunk"]: k for k, d in zip(key, dispatches)}
    for r in readbacks:
        readback_ms.setdefault(bucket_of[r.args["chunk"]], []).append(
            r.dur * 1e3)
    host = []
    for req in reqs:
        res = results[req.request_id]
        cfg = req.config()
        if res["error"] is not None:
            raise AssertionError(f"serve {req.request_id}: {res['error']}")
        direct = run_trials(cfg).trials
        n = res["n_trials"]
        if res["success"] != direct.success[:n].tolist():
            raise AssertionError(f"serve {req.request_id}: success != a "
                                 "direct run_trials of its keys")
        if req.return_decisions and (
                res["decisions"] != direct.decisions.tolist()):
            raise AssertionError(f"serve {req.request_id}: decisions != a "
                                 "direct run_trials of its keys")
        k = (res["bucket"], cfg.qsim_path)
        host.append(dict(
            request=req.request_id, config=res["bucket"],
            qsim_path=cfg.qsim_path, trials=n, target=req.target,
            stop=res["stop"] and res["stop"]["reason"],
            latency_s=res["latency_s"], chunks=res["chunks"],
            rounds_per_s=n * cfg.n_rounds / res["latency_s"],
            engine=res["engine"], dispatch_ms=median(dispatch_ms[k]),
            readback_ms=median(readback_ms[k]),
            kernel_ms_per_chunk=median(chunk_ms[k])))
    tgt = results["33p-target"]
    if not (tgt["stop"]["reason"].startswith("decided")
            and tgt["n_trials"] < SERVE_TRIALS):
        raise AssertionError(f"serve 33p-target: no early decision: "
                             f"{tgt['stop']}")
    # Depth 1 (no chunk in flight during a readback) on the same stream.
    _r, wall_d1, _c, _e, _p = serve_run(
        QBAServer(chunk_trials=SERVE_CHUNK, depth=1), stream, False)
    sync_probe = dispatch_probe(reqs[1], dev)
    log("serve_path", path="host", wall_s=wall, depth1_wall_s=wall_d1,
        warmup_s=warmup_s, chunk_trials=SERVE_CHUNK, depth=2,
        chunks=len(dispatches),
        launches={k: v for k, v in counts.items() if v},
        peak_mem_bytes=peak, sync_probe=sync_probe, requests=host)

    # The device path: the targeted request as one graph launch.
    tel = os.path.abspath(os.path.join("build", "serve_telemetry"))
    shutil.rmtree(tel, ignore_errors=True)
    dserver = QBAServer(chunk_trials=SERVE_CHUNK, dispatch="device",
                        telemetry_dir=tel)
    fns = wrappers()
    for fn in fns.values():
        fn.launches, fn.events = 0, None
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    [dres] = serve_batch(dserver, [reqs[0]])
    torch.cuda.synchronize()
    dwall = time.perf_counter() - t0
    dcounts = {k: fn.launches for k, fn in fns.items()}
    dwant = {k: 0 for k in COUNTED}
    dwant.update(trial_megakernel_keyed=2, sweep_stop=2)
    if dcounts != dwant:
        raise AssertionError(f"serve device path: launches {dcounts}, "
                             f"expected {dwant}")
    for k, n in dcounts.items():
        launches[k] += n
    (loop,) = [sp for sp in spans_from_jsonl(os.path.join(
        tel, reqs[0].request_id, "spans.jsonl"))
        if sp.name == "serve.device_loop"]
    info = loop.args
    # The span file keeps scalars; the node counts come back as text.
    info["body_nodes"] = ast.literal_eval(str(info["body_nodes"]))
    if info["dispatch"] != "graph" or info["readbacks"] != 1:
        raise AssertionError(f"serve device path: not one graph launch: "
                             f"{info}")
    if dres.error is not None or any(
            getattr(dres, f) != tgt[f]
            for f in ("stop", "n_trials", "success", "ci")):
        raise AssertionError("serve device path != its host-path twin: "
                             f"{dres.stop} against {tgt['stop']}")
    cfg = reqs[0].config()
    device = dict(
        request=reqs[0].request_id, trials=dres.n_trials,
        stop=dres.stop["reason"], chunks=dres.chunks,
        budget_chunks=SERVE_TRIALS // SERVE_CHUNK, wall_s=dwall,
        latency_s=dres.latency_s, readbacks=info["readbacks"],
        rounds_per_s=dres.n_trials * cfg.n_rounds / dres.latency_s,
        loop_rounds_per_s=dres.n_trials * cfg.n_rounds / info["loop_s"],
        warmup_ms=info["warmup_s"] * 1e3, capture_ms=info["capture_s"] * 1e3,
        instantiate_ms=info["instantiate_s"] * 1e3,
        loop_ms=info["loop_s"] * 1e3, body_nodes=info["body_nodes"],
        launches={k: v for k, v in dcounts.items() if v},
        peak_mem_bytes=torch.cuda.max_memory_allocated(), engine=dres.engine)
    log("serve_path", path="device", **device)

    stop_row = sweep_stop_timing(dataclasses.replace(
        cfg, trials=SERVE_CHUNK), dev, bits=True)
    log("sweep_stop_timing", config=f"33p/L64/d10 chunk of {SERVE_CHUNK}, "
        "storing the success bits", tolerance=0, **stop_row)

    # The worker's entry point from a file queue, in a process of its own.
    # Absolute: the worker runs from the checkout's root.
    qdir = os.path.abspath(os.path.join("build", "serve_queue"))
    shutil.rmtree(qdir, ignore_errors=True)
    inbox = queue_paths(qdir)["inbox"]
    os.makedirs(inbox)
    creq = request("cli-11p", "11p/L64/d3", dict(seed=7))
    drop_request(inbox, creq.to_json(), creq.request_id)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "qba_tpu_torch", "serve", "--transport",
         "file-queue", "--queue-dir", qdir, "--max-requests", "1"],
        cwd=root, capture_output=True, text=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    with open(os.path.join(queue_paths(qdir)["outbox"],
                           "cli-11p.json")) as f:
        cres = EvalResult.from_json(json.load(f))
    direct = run_trials(creq.config()).trials
    if cres.error is not None or cres.success != direct.success.tolist():
        raise AssertionError(f"serve CLI result != a direct run_trials: "
                             f"{cres.error}")
    cli = dict(wall_s=cli_wall, latency_s=cres.latency_s, engine=cres.engine,
               chunks=cres.chunks, trials=cres.n_trials)
    log("serve_path", path="cli file-queue", **cli)
    return dict(host=host, host_wall_s=wall, depth1_wall_s=wall_d1,
                host_peak_mem_bytes=peak, sync_probe=sync_probe,
                device=device, sweep_stop_bits=stop_row, cli=cli), launches


# The fleet on the card: two supervised ``serve`` workers behind the
# socket/HTTP front end, answering SERVE_REQUESTS over a socket and one
# more request by HTTP POST; one worker SIGKILLed after the first result.
FLEET_REPLICAS = 2
# The admission window of every fleet run: the default (8 chunks of 64 a
# replica) admits one 1000-trial request fleet-wide at a time, so the
# workers would take turns; this one admits the whole mix.
FLEET_CAPACITY = 8192
FLEET_HTTP = ("http-11p", "11p/L64/d3", dict(seed=8))
# What the workers run: the keyed megakernel on every chunk, its gen
# entry on the stabilizer request (the results' engine names the
# megakernel and its entry).
FLEET_ENGINE = "pallas_mega"
FLEET_KERNELS = ("trial_megakernel_keyed", "trial_megakernel_gen_keyed")
# The byte model against the card's peak: a worker's chunk and a batch
# of each kind of request in the mix, and a per-round engine's batch.
MEMORY_CASES = (("11p/L64/d3", 64, {}), ("11p/L64/d3", 1000, {}),
                ("33p/L64/d10", 64, {}), ("33p/L64/d10", 1000, {}),
                ("33p/L64/d10", 64, {"qsim_path": "stabilizer"}),
                ("33p/L64/d10", 1000, {"qsim_path": "stabilizer"}),
                ("11p/L64/d3", 1000, {"round_engine": "pallas_fused"}),
                ("11p/L64/d3", 64, {"round_engine": "xla"}))
# The atlas campaign: 2 x 2 x 2 x 2 = 16 cells at full width.
ATLAS_SPEC = ["--parties", "11", "33", "--dishonest", "0", "1/3",
              "--strategies", "reference", "split",
              "--noise", "0:0", "0.05:0.02", "--size-l", "64",
              "--chunk-trials", "64", "--budget-trials", "1024",
              "--max-escalations", "1"]


def port_cli(*args):
    """``python -m qba_tpu_torch`` with ``args``, run from the checkout's
    root."""
    return [sys.executable, "-m", "qba_tpu_torch", *args]


def memory_model(configs):
    """The admission model's bytes (``analysis.memory.batch_bytes``)
    against the card's peak for one batch (``torch.cuda.
    max_memory_allocated`` above what was held before it, after a
    warm-up of the same shape), at each of ``MEMORY_CASES``.  The model
    must not undershoot: admission would admit work that runs out of
    memory."""
    import dataclasses

    import torch

    import qba_tpu_torch
    from qba_tpu_torch.analysis.memory import batch_bytes, per_trial_bytes

    rows = []
    for name, n, kw in MEMORY_CASES:
        cfg = dataclasses.replace(configs[name], trials=n, **kw)
        qba_tpu_torch.run_trials(cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = qba_tpu_torch.run_trials(cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del res
        model = batch_bytes(cfg, n, "cuda")
        rows.append(dict(config=name, trials=n, **kw, peak_bytes=peak,
                         model_bytes=model, peak_per_trial=peak / n,
                         model_per_trial=per_trial_bytes(cfg, "cuda"),
                         model_over_peak=model / peak))
        if model < peak:
            raise AssertionError(f"memory model {model} B < the card's "
                                 f"peak {peak} B at {name} {kw} x {n}")
    return rows


def device_fds(pid):
    """How many of ``pid``'s open files are NVIDIA device nodes (a
    process that initialised CUDA holds ``/dev/nvidiactl`` and more)."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
        except OSError:
            pass
    return n


def compute_apps():
    """``nvidia-smi``'s compute processes as ``{pid: used MiB}``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout
    apps = {}
    for line in out.splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = float(mem) if mem.strip() else None
    return apps


def card_used_mib():
    """``nvidia-smi``'s ``memory.used`` of card 0, MiB."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])


def spawn_monotonic(pid):
    """``pid``'s start on ``time.monotonic()``'s clock (``/proc``'s
    start time is counted from boot)."""
    with open(f"/proc/{pid}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    boot = time.clock_gettime(time.CLOCK_BOOTTIME) - time.monotonic()
    return ticks / os.sysconf("SC_CLK_TCK") - boot


class BootWatch:
    """Polls the queue's flight recorders every 5 ms on a thread and
    keeps each worker incarnation's ``boot`` note (written with its
    first ``idle`` heartbeat) as ``{(replica, pid): monotonic}``."""

    def __init__(self, qdir, replicas):
        import threading

        self.qdir, self.replicas = qdir, replicas
        self.boots = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from qba_tpu_torch.serve.queuefs import read_flight_recorder

        while not self._stop.wait(0.005):
            for rid in self.replicas:
                rec = read_flight_recorder(self.qdir, rid)
                if rec is None or (rid, rec.get("pid")) in self.boots:
                    continue
                for ev in rec.get("events", []):
                    if ev.get("event") == "boot":
                        self.boots[(rid, rec["pid"])] = ev["monotonic"]

    def wait(self, n, timeout):
        """Block until ``n`` incarnations have booted."""
        end = time.monotonic() + timeout
        while len(self.boots) < n:
            if time.monotonic() > end:
                raise AssertionError(f"fleet: {len(self.boots)} of {n} "
                                     f"workers booted in {timeout} s")
            time.sleep(0.01)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def http(port, raw):
    """One HTTP exchange on the front end: ``(status, body)``."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=600) as c:
        c.sendall(raw)
        buf = b""
        while chunk := c.recv(65536):
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


def fleet_run(reqs, http_req, direct, *, replicas, chaos, root, cache,
              label):
    """``python -m qba_tpu_torch fleet --replicas N --supervise`` in a
    process group of its own over a fresh queue (and telemetry) dir;
    ``reqs`` over one socket, results read as they land, and
    ``http_req`` by HTTP POST once they have; with ``chaos`` one busy
    worker SIGKILLed after the first result.  Every result is held
    against ``direct`` (a direct ``run_trials`` of its config and keys).
    Returns the run's record and the workers' kernel launches."""
    import signal
    import socket

    from qba_tpu_torch.obs.metrics import validate_exposition
    from qba_tpu_torch.serve.queuefs import queue_paths, read_heartbeat

    qdir, tel = os.path.join(root, label, "q"), os.path.join(root, label,
                                                             "t")
    err_path = os.path.join(root, label, "fleet.stderr")
    os.makedirs(os.path.dirname(err_path), exist_ok=True)
    n_req = len(reqs) + 1
    rids = [f"r{i}" for i in range(replicas)]
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            port_cli("fleet", "--queue-dir", qdir, "--replicas",
                     str(replicas), "--supervise", "--chunk-trials",
                     str(SERVE_CHUNK), "--depth", "2", "--cache-dir", cache,
                     "--telemetry", tel, "--max-requests", str(n_req),
                     "--capacity-trials", str(FLEET_CAPACITY)),
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=err, start_new_session=True)
    used_before = card_used_mib()
    watch = BootWatch(qdir, rids)
    try:
        port = None
        end = time.monotonic() + 120
        while port is None:
            if proc.poll() is not None or time.monotonic() > end:
                raise AssertionError(f"fleet {label} did not listen: "
                                     f"{open(err_path).read()[-2000:]}")
            for line in open(err_path):
                if '"listening"' in line:
                    port = int(json.loads(line)["fleet"]["listening"]
                               .rsplit(":", 1)[1])
            time.sleep(0.05)
        watch.wait(replicas, timeout=300)
        with open(os.path.join(qdir, "replicas.json")) as f:
            pids = {r["replica_id"]: r["pid"]
                    for r in json.load(f)["replicas"]}
        boot_s = {rid: watch.boots[(rid, pid)] - spawn_monotonic(pid)
                  for rid, pid in pids.items()}
        used_idle = card_used_mib()
        sent, got, client_s = {}, {}, {}
        t0 = time.perf_counter()
        conn = socket.create_connection(("127.0.0.1", port), timeout=600)
        wire = conn.makefile("rw")
        for req in reqs:
            sent[req.request_id] = time.perf_counter()
            wire.write(json.dumps(req.to_json()) + "\n")
        wire.flush()
        conn.shutdown(socket.SHUT_WR)
        apps = kill = None
        for line in wire:
            res = json.loads(line)
            rid = res["request_id"]
            if rid in got:
                raise AssertionError(f"fleet {label}: {rid} answered twice")
            got[rid] = res
            client_s[rid] = time.perf_counter() - sent[rid]
            if len(got) == 1:
                apps, used_busy = compute_apps(), card_used_mib()
                fds = {"fleet": device_fds(proc.pid),
                       **{rid: device_fds(pid) for rid, pid in pids.items()}}
            if len(got) == 1 and chaos:
                busy = [rid for rid in rids
                        if (read_heartbeat(qdir, rid) or {}).get(
                            "phase", "idle") != "idle"]
                victim = (busy or rids)[-1]
                os.kill(pids[victim], signal.SIGKILL)
                kill = dict(replica=victim, pid=pids[victim],
                            at=time.monotonic(),
                            phase=(read_heartbeat(qdir, victim) or {}).get(
                                "phase"))
        conn.close()
        mix_s = time.perf_counter() - t0
        code, metrics = http(port, b"GET /metrics HTTP/1.1\r\n\r\n")
        problems = validate_exposition(metrics.decode())
        if code != 200 or problems or b"qba_intake_requests_total" not in (
                metrics):
            raise AssertionError(f"fleet {label}: GET /metrics {code}: "
                                 f"{problems[:3]}")
        code, status = http(port, b"GET /status HTTP/1.1\r\n\r\n")
        status = json.loads(status)
        body = (json.dumps(http_req.to_json()) + "\n").encode()
        t1 = time.perf_counter()
        code, out = http(port, b"POST /eval HTTP/1.1\r\nContent-Length: "
                         + str(len(body)).encode() + b"\r\n\r\n" + body)
        client_s[http_req.request_id] = time.perf_counter() - t1
        if code != 200:
            raise AssertionError(f"fleet {label}: POST answered {code}")
        [res] = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
        got[res["request_id"]] = res
        proc.wait(timeout=300)
    finally:
        watch.stop()
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"fleet {label} exited {proc.returncode}: "
                             f"{open(err_path).read()[-2000:]}")
    for rid, want in direct.items():
        res = got.get(rid)
        if res is None or res["error"] is not None:
            raise AssertionError(f"fleet {label} {rid}: "
                                 f"{res and res['error']}")
        n = res["n_trials"]
        if res["success"] != want.success[:n].tolist() or (
                res.get("decisions") is not None
                and res["decisions"] != want.decisions.tolist()):
            raise AssertionError(f"fleet {label} {rid}: != a direct "
                                 "run_trials of its keys")
        if not res["engine"].startswith(FLEET_ENGINE):
            raise AssertionError(f"fleet {label} {rid}: engine "
                                 f"{res['engine']}")
    paths = queue_paths(qdir)
    consumed = sorted(os.listdir(paths["consumed"]))
    if consumed != sorted(f"{rid}.json" for rid in direct) or os.listdir(
            paths["outbox"]):
        raise AssertionError(f"fleet {label}: results {consumed}")
    with open(os.path.join(qdir, "fleet_summary.json")) as f:
        summary = json.load(f)
    if summary["completed"] != n_req or summary["errored"]:
        raise AssertionError(f"fleet {label}: summary {summary['completed']}"
                             f" completed, {summary['errored']} errored")
    # The workers' exit summaries.  A SIGKILLed incarnation writes none
    # and its replacement reuses the id, so the counts leave out what the
    # killed worker launched.
    launches = {}
    for name in os.listdir(qdir):
        if name.startswith("summary-"):
            with open(os.path.join(qdir, name)) as f:
                counts = json.load(f)["resolver"]["kernel_launches"]
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    record = dict(
        replicas=replicas, chaos=kill is not None, mix_wall_s=mix_s,
        boot_s=boot_s, launches=launches,
        requests={rid: dict(latency_s=r["latency_s"],
                            queue_wait_s=r["queue_wait_s"],
                            client_s=client_s[rid], replica=r["replica_id"],
                            trials=r["n_trials"], chunks=r["chunks"])
                  for rid, r in sorted(got.items())},
        replica_latency={rid: {k: v["latency"].get(k)
                               for k in ("count", "p50_s", "p99_s")}
                         for rid, v in summary["replicas"].items()
                         if "latency" in v},
        self_healing=summary.get("self_healing"),
        status_replicas=sorted(status.get("replicas") or {}))
    if apps is not None:
        # The card's memory in use before the fleet, with its workers
        # booted and idle, and at the first result (MiB).
        record.update(compute_apps=apps, device_fds=fds,
                      fleet_pid=proc.pid, worker_pids=pids,
                      card_used_mib=dict(before=used_before, idle=used_idle,
                                         busy=used_busy))
    if kill is not None:
        respawn = [(pid, t) for (rid, pid), t in watch.boots.items()
                   if rid == kill["replica"] and pid != kill["pid"]]
        if not respawn:
            raise AssertionError(f"fleet {label}: {kill['replica']} was "
                                 "not respawned")
        record["kill"] = dict(kill, respawn_s=respawn[0][1] - kill["at"],
                              new_pid=respawn[0][0])
        del record["kill"]["at"]
        if not summary["self_healing"]["respawned"]:
            raise AssertionError(f"fleet {label}: no respawn recorded")
    return record, tel, qdir


def fleet_path(configs, dev):
    """The fleet (``qba_tpu_torch.serve.fleet``) on the card: the byte
    model against the peak (``memory_model``); ``python -m qba_tpu_torch
    fleet --replicas 2 --supervise`` answering SERVE_REQUESTS over a
    socket and one more by HTTP POST, one worker SIGKILLed after the
    first result (respawned, every request answered once, equal to a
    direct ``run_trials``), its fleet summary, ``GET /metrics``, ``python
    -m qba_tpu_torch trace`` (one closed trace per request) and the
    card's compute processes (the two workers, not the fleet process);
    then the same mix on a 1-replica and a clean 2-replica fleet, for
    the wall.  Returns ``(report, launches)``."""
    import shutil
    import tempfile

    from qba_tpu_torch.backends.torch_backend import run_trials
    from qba_tpu_torch.serve import EvalRequest

    def request(rid, name, kw):
        c = configs[name]
        return EvalRequest(request_id=rid, n_parties=c.n_parties,
                           size_l=c.size_l, n_dishonest=c.n_dishonest,
                           trials=SERVE_TRIALS, **kw)

    mem = memory_model(configs)
    log("fleet_path", part="memory_model", cases=mem)
    reqs = [request(*r) for r in SERVE_REQUESTS]
    http_req = request(*FLEET_HTTP)
    direct = {r.request_id: run_trials(r.config()).trials
              for r in reqs + [http_req]}
    root = tempfile.mkdtemp(prefix="qba_fleet_")
    cache = os.path.join(root, "cache")
    launches = {}
    try:
        runs = {}
        for label, replicas, chaos in (("chaos", FLEET_REPLICAS, True),
                                       ("one", 1, False),
                                       ("two", FLEET_REPLICAS, False)):
            rec, tel, qdir = fleet_run(
                reqs, http_req, direct, replicas=replicas, chaos=chaos,
                root=root, cache=cache, label=label)
            runs[label] = rec
            for k, v in rec["launches"].items():
                launches[k] = launches.get(k, 0) + v
            if label == "chaos":
                proc = subprocess.run(
                    port_cli("trace", "--queue-dir", qdir, "--telemetry",
                             tel), capture_output=True, text=True,
                    timeout=300, cwd=os.path.dirname(os.path.abspath(
                        __file__)))
                traces = json.loads(proc.stdout)["summary"]
                out = os.path.join(root, "trace.json")
                proc2 = subprocess.run(
                    port_cli("trace", "--queue-dir", qdir, "--telemetry",
                             tel, "--out", out), capture_output=True,
                    text=True, timeout=300,
                    cwd=os.path.dirname(os.path.abspath(__file__)))
                exported = json.loads(proc2.stdout)
                n = len(direct)
                if (traces["count"], traces["closed"], traces["open"],
                        traces["orphan_spans"], exported["traces"]) != (
                            n, n, 0, 0, n):
                    raise AssertionError(f"fleet trace: {traces}, "
                                         f"{exported}")
                rec["traces"] = dict(traces, exported_events=exported[
                    "events"])
            log("fleet_path", part=label, **rec)
        for k in FLEET_KERNELS:
            if not runs["chaos"]["launches"].get(k):
                raise AssertionError(f"fleet: the workers launched no {k}: "
                                     f"{runs['chaos']['launches']}")
        chaos = runs["chaos"]
        apps, fds = chaos["compute_apps"], chaos["device_fds"]
        workers = set(chaos["worker_pids"].values())
        if fds["fleet"] or not all(fds[r] for r in chaos["worker_pids"]):
            raise AssertionError(f"fleet: device files {fds}")
        if os.getpid() in apps:
            # nvidia-smi sees this machine's pids: the workers are there
            # and the fleet process is not.
            if chaos["fleet_pid"] in apps or not workers <= set(apps):
                raise AssertionError(f"fleet: compute apps {apps}, "
                                     f"workers {workers}")
            worker_mib = {p: apps[p] for p in workers}
            how = "pids"
        else:
            # nvidia-smi reports the pids of another namespace: the open
            # device files above are the proof, and the card's memory in
            # use on the clean 2-replica fleet, less before it, is its
            # workers' (idle, and at the first result).
            used = runs["two"]["card_used_mib"]
            worker_mib = {k: (used[k] - used["before"]) / FLEET_REPLICAS
                          for k in ("idle", "busy")}
            how = "device files; nvidia-smi pids of another namespace"
        report = dict(memory_model=mem, runs=runs, worker_mib=worker_mib,
                      compute_apps_by=how,
                      one_replica_wall_s=runs["one"]["mix_wall_s"],
                      two_replica_wall_s=runs["two"]["mix_wall_s"])
        log("fleet_path", part="card", compute_apps_by=how,
            worker_mib=worker_mib, device_fds=fds,
            one_replica_wall_s=report["one_replica_wall_s"],
            two_replica_wall_s=report["two_replica_wall_s"])
        return report, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def atlas_path():
    """``python -m qba_tpu_torch atlas`` over ``ATLAS_SPEC`` (16 cells)
    through a supervised 2-replica fleet with one worker SIGKILLed after
    the first result, and in process (``--executor local``): every cell
    closed and the two stores' digests equal.  Returns ``(report,
    launches)``."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="qba_atlas_")
    cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        runs = {}
        for executor in ("fleet", "local"):
            args = ["atlas", "--store", os.path.join(root, executor),
                    *ATLAS_SPEC, "--executor", executor,
                    "--capacity-trials", str(FLEET_CAPACITY)]
            if executor == "fleet":
                args += ["--queue-dir", os.path.join(root, "q"),
                         "--replicas", str(FLEET_REPLICAS), "--supervise",
                         "--chaos-kill", "--cache-dir",
                         os.path.join(root, "cache")]
            t0 = time.perf_counter()
            proc = subprocess.run(port_cli(*args), capture_output=True,
                                  text=True, timeout=900, cwd=cwd)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"atlas {executor} exited "
                                     f"{proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            summary = json.loads(proc.stdout)["atlas"]
            runs[executor] = dict(
                wall_s=wall, cells=summary["cells"],
                certified=summary["certified"], refused=summary["refused"],
                open=summary["open"], store_digest=summary["store_digest"],
                escalated=summary["metrics"]["escalated"],
                budget_trials=summary["metrics"]["budget_trials"],
                chaos=[json.loads(ln)["chaos"]
                       for ln in proc.stderr.splitlines()
                       if ln.startswith('{"chaos"')],
                self_healing=summary.get("self_healing"))
        fleet, local = runs["fleet"], runs["local"]
        # As in fleet_run: the killed incarnation's launches are left out.
        launches = {}
        qdir = os.path.join(root, "q")
        for name in os.listdir(qdir):
            if name.startswith("summary-"):
                with open(os.path.join(qdir, name)) as f:
                    for k, v in json.load(f)["resolver"][
                            "kernel_launches"].items():
                        launches[k] = launches.get(k, 0) + v
        if (fleet["open"], local["open"]) != (0, 0) or (
                fleet["store_digest"] != local["store_digest"]) or (
                fleet["cells"] != 16) or not fleet["chaos"]:
            raise AssertionError(f"atlas: fleet {fleet} against local "
                                 f"{local}")
        if not all(launches.get(k) for k in FLEET_KERNELS[:1]):
            raise AssertionError(f"atlas: the workers launched {launches}")
        report = dict(runs=runs, launches=launches)
        log("atlas_path", **report)
        return report, launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The message-level backends (run_path): trials each in process at full
# width, beside the batched runner's `auto` batch of the same keys.
RUN_TRIALS = {"11p/L64/d3": dict(native=1000, local=200, mp=100),
              "33p/L64/d10": dict(native=1000, local=20, mp=10)}
RUN_FIELDS = ("decisions", "success", "honest", "vi", "overflow")
# Configs of main's `small` list run on every message-level backend too
# (racy delivery under racy_mode="defer").
RUN_SMALL = ("11p/L64/d3 split", "5p/L16/d2 slots=1", "5p/L16/d1 racy")
# `python -m qba_tpu_torch run`: each backend at 11p (verdict blocks
# equal), the trail at 11p x 4 (-v --jsonl, equal event for event) and the
# profiled 33p batches.
CLI_RUN = ["run", "--n-parties", "11", "--size-l", "64", "--n-dishonest",
           "3"]
CLI_RUN_TRIALS = 100
CLI_TRAIL_TRIALS = 4
CLI_PROFILE = ["run", "--n-parties", "33", "--size-l", "64",
               "--n-dishonest", "10", "--trials", "1000"]
BACKENDS = ("torch", "local", "native", "mp")


def as_fields(cfg, rows):
    """The message-level backends' per-trial dicts as ``RUN_FIELDS``
    arrays (``vi``: bool ``[T, n_lieu, w]``)."""
    import numpy as np

    vi = np.zeros((len(rows), cfg.n_lieutenants, cfg.w), dtype=bool)
    for t, r in enumerate(rows):
        for i, s in enumerate(r["vi"]):
            vi[t, i, sorted(s)] = True
    return dict(decisions=np.array([r["decisions"] for r in rows]),
                success=np.array([r["success"] for r in rows]),
                honest=np.array([r["honest"] for r in rows]), vi=vi,
                overflow=np.array([r["overflow"] for r in rows]))


def check_equal(label, got, ref, n):
    """``got`` (``RUN_FIELDS`` arrays) equal to the first ``n`` trials of
    the batched runner's ``ref``, field by field."""
    import numpy as np

    for f in RUN_FIELDS:
        want = getattr(ref, f)[:n].cpu().numpy()
        if not np.array_equal(np.asarray(got[f]), want):
            bad = int((np.asarray(got[f]) != want).reshape(n, -1).any(1)
                      .argmax())
            raise AssertionError(f"{label}: {f} differs from run_trials "
                                 f"(first at trial {bad})")


def counted(fn):
    """``fn()`` with every kernel's launches set to 0 just before and read
    just after, and the draws kernel's CUDA events kept: ``(result,
    launches, draws_ms)``."""
    fns = wrappers()
    for w in fns.values():
        w.launches, w.events = 0, None
    fns["attack_draws"].events = []
    out = fn()
    import torch

    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in fns.items() if w.launches}
    ms = [a.elapsed_time(b) for a, b in fns["attack_draws"].events]
    fns["attack_draws"].events = None
    return out, launches, ms


def presampled(cfg, keys):
    """One counted presample (one draws launch asserted): ``(pre,
    launches, {setup_ms, draws_ms, draws_kernel_ms, copy_ms})``."""
    from qba_tpu_torch.backends.local_backend import presample_batch

    timings = {}
    pre, launches, ms = counted(lambda: presample_batch(cfg, keys, timings))
    if launches.get("attack_draws") != 1 or len(ms) != 1:
        raise AssertionError(f"presample: launches {launches}, expected one "
                             "attack_draws")
    return pre, launches, dict(
        setup_ms=timings["setup_s"] * 1e3, draws_ms=timings["draws_s"] * 1e3,
        draws_kernel_ms=ms[0], copy_ms=timings["copy_s"] * 1e3)


def check_draws(cfg, keys, pre, dev):
    """The presample's draws against the plain draws on the same keys, bit
    for bit, in the layouts the backends read: the tables ``local`` and
    ``native`` read (uint8 ``[T, n_rounds, n_pool, n_rv]``, the C engine
    at ``((round - 1) * n_pool + cell) * n_rv + receiver`` of a trial's
    rows) and each ``mp`` party's columns (``party_draws``)."""
    import numpy as np
    import torch

    from qba_tpu_torch import random as jr
    from qba_tpu_torch.adversary import adversary_ctx, assign_dishonest
    from qba_tpu_torch.adversary import commander_orders
    from qba_tpu_torch.backends.mp_backend import party_draws
    from qba_tpu_torch.ops.attack_draws import attack_draws_reference

    k = jr.split(keys, 4)
    honest = assign_dishonest(cfg, k[:, 0])
    v_sent, _vc = commander_orders(cfg, k[:, 2], honest[:, 1])
    k_rounds = k[:, 3].contiguous()
    want = attack_draws_reference(cfg, k_rounds,
                                  adversary_ctx(cfg, k_rounds, v_sent))
    err = 0
    for host, ref in zip((pre.attack, pre.rand_v, pre.late), want):
        got = torch.from_numpy(host).to(dev)
        err = max(err, max_err(got, ref))
    ref = [x.cpu().numpy() for x in want]
    for t in (0, len(pre) - 1):
        for rank in range(2, cfg.n_parties + 1):
            cols = np.stack([x[t, :, :, rank - 2] for x in ref], axis=-1)
            err = max(err, int(np.abs(party_draws(pre, t, rank).astype(
                np.int64) - cols).max()))
    if err:
        raise AssertionError(f"presampled draws differ from the plain "
                             f"draws by {err}")
    return err


def fork_probe():
    """A plain ``fork`` of this process, which holds a CUDA context: the
    child counts its open ``/dev/nvidia*`` files and exits.  Shows what a
    forked party would inherit (the mp backend starts its parties from a
    forkserver instead)."""
    import warnings

    r, w = os.pipe()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        pid = os.fork()
    if pid == 0:
        try:
            os.write(w, str(device_fds(os.getpid())).encode())
        finally:
            os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        child = int(f.read() or -1)
    _pid, status = os.waitpid(pid, 0)
    return dict(parent_device_fds=device_fds(os.getpid()),
                child_device_fds=child,
                child_exit=os.waitstatus_to_exitcode(status),
                fork_to_exit_s=time.perf_counter() - t0,
                warnings=[str(c.message)[:120] for c in caught])


def cli_run(args, root, name):
    """Start ``python -m qba_tpu_torch`` with ``args``, its output into
    files under ``root``: ``(process, stdout path, stderr path)``."""
    out, err = (os.path.join(root, f"{name}.{s}") for s in ("out", "err"))
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(port_cli(*args), stdout=fo, stderr=fe,
                                cwd=os.path.dirname(os.path.abspath(
                                    __file__)))
    return proc, out, err


def cli_wait(runs, timeout=600):
    """Wait for every ``cli_run``; raise unless each exits 0.  Returns
    each one's stdout and seconds."""
    done = {}
    for name, (proc, out, err, t0) in runs.items():
        try:
            proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        with open(out) as f, open(err) as fe:
            text, errs = f.read(), fe.read()
        if proc.returncode != 0:
            raise AssertionError(f"run {name}: exit {proc.returncode}: "
                                 f"{errs[-2000:]}")
        done[name] = (text, time.perf_counter() - t0)
    return done


def verdict_blocks(text):
    """``run``'s verdict blocks and aggregate lines, timing apart."""
    keep = ("trial ", "Decisions:", "Dishonests:", "Success:", "(mailbox",
            "config:", "trials:", "success rate:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def trail_events(path):
    """A ``--jsonl`` trail without its timestamps and the ``experiment``
    event (which names the backend)."""
    rows = []
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            e.pop("ts")
            if e["message"] != "experiment":
                rows.append(e)
    return rows


def run_cli_checks(root):
    """``python -m qba_tpu_torch run`` on the card: every backend at 11p x
    ``CLI_RUN_TRIALS`` (exit 0, the same verdict blocks and success rate),
    each at 11p x ``CLI_TRAIL_TRIALS`` with ``-v --jsonl`` (the same trail;
    ``torch`` replays through ``local``), then ``torch`` and ``native``
    at 33p x 1000 with ``--profile-dir``: each trace's device busy ms, top
    kernels and the idle share of its window."""
    import glob

    from qba_tpu_torch.obs.profiling import trace_summary

    runs = {}
    for b in BACKENDS:
        runs[f"verdicts-{b}"] = (*cli_run(
            [*CLI_RUN, "--trials", str(CLI_RUN_TRIALS), "--backend", b],
            root, f"verdicts-{b}"), time.perf_counter())
        runs[f"trail-{b}"] = (*cli_run(
            [*CLI_RUN, "--trials", str(CLI_TRAIL_TRIALS), "--backend", b,
             "-v", "--jsonl", os.path.join(root, f"trail-{b}.jsonl")],
            root, f"trail-{b}"), time.perf_counter())
    done = cli_wait(runs)
    blocks = {b: verdict_blocks(done[f"verdicts-{b}"][0]) for b in BACKENDS}
    trails = {b: trail_events(os.path.join(root, f"trail-{b}.jsonl"))
              for b in BACKENDS}
    for b in BACKENDS[1:]:
        if blocks[b] != blocks["torch"]:
            raise AssertionError(f"run --backend {b}: verdict blocks differ "
                                 "from --backend torch")
        if trails[b] != trails["local"]:
            raise AssertionError(f"run --backend {b} -v: trail differs from "
                                 "--backend local")
    rate = [ln for ln in blocks["torch"] if ln.startswith("success rate")]
    mismatch = [e for e in trails["torch"] if e["message"] ==
                "trail replay mismatch"]
    if len(blocks["torch"]) < 4 * 8 or not rate or mismatch:
        raise AssertionError(f"run: blocks {blocks['torch'][:8]}, "
                             f"{mismatch}")
    profiles = {}
    runs = {}
    for b in ("torch", "native"):
        d = os.path.join(root, f"profile-{b}")
        runs[b] = (*cli_run([*CLI_PROFILE, "--backend", b, "--profile-dir",
                             d], root, f"profile-{b}"), time.perf_counter())
    for b, (_text, secs) in cli_wait(runs).items():
        (path,) = glob.glob(os.path.join(root, f"profile-{b}", "*.json"))
        profiles[b] = dict(trace_summary(path), process_s=secs,
                           trace_bytes=os.path.getsize(path))
    return dict(
        success_rate=rate[0], verdict_lines=len(blocks["torch"]),
        trail_events=len(trails["local"]),
        cli_s={k: v[1] for k, v in done.items()}, profiles=profiles)


def run_path(configs, small, dev):
    """The reference's own runtime on the port (``qba_tpu_torch.backends``
    ``local``, ``native`` and ``mp``; ``python -m qba_tpu_torch run``).

    At 11p/L64/d3 and 33p/L64/d10 x 1000 (``RUN_TRIALS``), and on
    ``small``, each backend runs in process on the batch's keys and must
    equal the batched runner's ``auto`` batch trial for trial on
    ``RUN_FIELDS``: ``native`` over the whole batch, ``local`` and ``mp``
    (one party mesh a batch, the parties holding no ``/dev/nvidia*`` file
    and exiting 0) over its first trials; then ``native`` at 33p on
    ``qsim_path="stabilizer"`` and at 5p x 32 on ``dense_pallas``.  Each
    presample is one counted launch of the draws kernel (with a sweep
    launch on the stabilizer path, circuit launches on dense_pallas), and
    its draws equal the plain draws in each backend's layout.  Per
    backend: wall, trials/s, the presample's set-up, draws (and the
    kernel's CUDA-event ms) and host copy, the host message loop, and the
    mp mesh's start.  Then a warm ``run_trials`` batch at 33p under
    ``profile_trace``, a fork of this process (``fork_probe``) and the
    CLI (``run_cli_checks``).  Returns ``(report, launches)``."""
    import dataclasses
    import shutil
    import tempfile

    import qba_tpu_torch
    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.backends.local_backend import local_trial
    from qba_tpu_torch.backends.mp_backend import run_trials_mp
    from qba_tpu_torch.backends.native_backend import run_trials_native
    from qba_tpu_torch.backends.torch_backend import fence, trial_keys
    from qba_tpu_torch.obs import profile_trace
    from qba_tpu_torch.obs.profiling import trace_path, trace_summary

    from qba_tpu_torch import native

    # The C++ runtime's build (g++, at first use) before any timed run.
    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    log("run_path", part="native_build", seconds=native_build_s,
        library=native.library_path().name)
    launches, rows = {}, []

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def backends(name, cfg, sizes):
        keys = trial_keys(cfg, dev)
        ref = fence(qba_tpu_torch.run_trials(cfg, keys)).trials
        row = dict(config=name, trials=cfg.trials, rounds=cfg.n_rounds)
        for b, n in sizes.items():
            t0 = time.perf_counter()
            pre, counts, pms = presampled(cfg, keys[:n])
            add(counts)
            t1 = time.perf_counter()
            stats, pids = {}, []
            if b == "native":
                res = run_trials_native(cfg, keys[:n], pre=pre)
                got = {f: res[f] for f in RUN_FIELDS}
            elif b == "local":
                got = as_fields(cfg, [local_trial(cfg, pre, i)
                                      for i in range(n)])
            else:
                got = as_fields(cfg, run_trials_mp(
                    cfg, keys[:n], pre=pre, stats=stats,
                    on_mesh=lambda p: pids.extend(
                        (p_, device_fds(p_)) for p_ in p)))
                if (len(pids) != cfg.n_parties or any(f for _p, f in pids)
                        or stats["exitcodes"] != [0] * cfg.n_parties):
                    raise AssertionError(f"{name} mp: parties {pids}, exit "
                                         f"{stats['exitcodes']}")
            t2 = time.perf_counter()
            check_equal(f"{name} {b}", got, ref, n)
            if b == "native":
                row["draws_max_abs_err"] = check_draws(cfg, keys[:n], pre,
                                                       dev)
            row[b] = dict(trials=n, wall_s=t2 - t0,
                          trials_per_s=n / (t2 - t0), launches=counts,
                          presample=pms, loop_ms=(t2 - t1) * 1e3,
                          success_rate=float(got["success"].mean()))
            if b == "mp":
                row[b].update(parties=len(pids),
                              mesh_start_s=stats["mesh_start_s"],
                              loop_ms=(t2 - t1 - stats["mesh_start_s"])
                              * 1e3,
                              party_device_fds=sum(f for _p, f in pids),
                              exitcodes=sorted(set(stats["exitcodes"])))
        log("run_path", **row)
        rows.append(row)

    for name, sizes in RUN_TRIALS.items():
        backends(name, configs[name], sizes)
    for name, cfg in small:
        cfg = dataclasses.replace(cfg, racy_mode="defer") if (
            cfg.delivery == "racy") else cfg
        n = cfg.trials
        backends(name, cfg, dict(native=n, local=n, mp=n))
    # The list-generation kernels in the presample: one sweep launch on
    # the stabilizer path, the circuit kernel on dense_pallas (main's
    # dense batch: 5 parties, 18 qubits).
    name = "33p/L64/d10"
    for label, cfg, kernel in (
            (f"{name} stabilizer", dataclasses.replace(
                configs[name], qsim_path="stabilizer"), "gf2_sweep"),
            ("5p/L64/d2 dense_pallas", QBAConfig(
                n_parties=5, size_l=64, n_dishonest=2, trials=32,
                qsim_path="dense_pallas"), "fused_circuit")):
        keys = trial_keys(cfg, dev)
        ref = fence(qba_tpu_torch.run_trials(cfg, keys)).trials
        t0 = time.perf_counter()
        pre, counts, pms = presampled(cfg, keys)
        if not counts.get(kernel) or (kernel == "gf2_sweep"
                                      and counts[kernel] != 1):
            raise AssertionError(f"{label} presample: launches {counts}")
        add(counts)
        t1 = time.perf_counter()
        res = run_trials_native(cfg, keys, pre=pre)
        t2 = time.perf_counter()
        check_equal(f"{label} native", res, ref, cfg.trials)
        row = dict(config=label, trials=cfg.trials,
                   draws_max_abs_err=check_draws(cfg, keys, pre, dev),
                   native=dict(wall_s=t2 - t0, trials_per_s=cfg.trials
                               / (t2 - t0), launches=counts, presample=pms,
                               loop_ms=(t2 - t1) * 1e3,
                               success_rate=res["success_rate"]))
        log("run_path", **row)
        rows.append(row)

    root = tempfile.mkdtemp(prefix="qba_run_")
    try:
        # The batched runner's device account, warm: one 33p batch under
        # the profiler after a warm-up batch.
        cfg = configs[name]
        fence(qba_tpu_torch.run_trials(cfg))
        d = os.path.join(root, "in-process")
        with profile_trace(d):
            _out, counts, _ms = counted(
                lambda: fence(qba_tpu_torch.run_trials(cfg)))
        if counts != {"trial_megakernel_keyed": 1}:
            raise AssertionError(f"profiled batch: launches {counts}")
        add(counts)
        warm = dict(trace_summary(trace_path(d)), launches=counts)
        log("run_path", part="profile", config=f"{name} x{cfg.trials}",
            run="in process, warm", **warm)
        fork = fork_probe()
        log("run_path", part="fork_probe", **fork)
        cli = run_cli_checks(root)
        for b, p in cli["profiles"].items():
            log("run_path", part="profile", config=f"{name} x1000",
                run=f"python -m qba_tpu_torch run --backend {b} "
                "--profile-dir (cold process)", **p)
        log("run_path", part="cli", **{k: v for k, v in cli.items()
                                       if k != "profiles"})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(runs=rows, native_build_s=native_build_s, warm_profile=warm,
                fork_probe=fork, cli=cli), launches


LINT_TRIALS = 64
LINT_CLI = ["lint", "--effects", "--protocol", "--obs"]
# The engines the launch pin drives at each width; the mesh's at tp = 4.
LINT_ENGINES = ("xla", "pallas", "pallas_tiled", "pallas_fused",
                "pallas_mega", "auto")
LINT_MESH_ENGINES = ("auto", "pallas_fused", "pallas_tiled", "pallas")


def lint_pin(label, cfg, engine, dev, tp=None):
    """One traced batch's launches three ways against the engine's model
    (``analysis.launches.batch_launch_model``): its seams and wrappers'
    counts (``analysis.trace.trace_batch``), and the kernel records of
    its ``torch.profiler`` trace (``obs.profile_trace`` around the
    recorded batch), the megakernel's entries folded into one row."""
    import shutil
    import tempfile

    from qba_tpu_torch.analysis import launches as la
    from qba_tpu_torch.analysis.trace import trace_batch
    from qba_tpu_torch.obs import profile_trace
    from qba_tpu_torch.obs.profiling import trace_path

    model = la.batch_launch_model(cfg, engine, dev, tp)
    d = tempfile.mkdtemp(prefix="qba_pin_")
    try:
        rec = trace_batch(label, cfg, engine, dev, LINT_TRIALS, tp=tp,
                          within=profile_trace(d))
        events = []
        if os.path.exists(trace_path(d)):
            with open(trace_path(d)) as f:
                events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    seams = {k: v for k, v in rec.seams.items() if k not in la.UNPINNED}
    launches = {k: v for k, v in rec.launches.items() if k not in la.UNPINNED}
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    prof_counts = la.profiler_counts(names)
    got = {k: v for k, v in prof_counts.items() if k not in la.UNPINNED}
    row = dict(trials=rec.trials, model=model, seams=seams,
               launches=rec.launches,
               profiler=prof_counts, demoted=rec.demoted, refused=rec.refused,
               error=rec.error)
    if (rec.error or rec.refused or rec.demoted
            or not (launches == seams == model
                    and got == la.fold_mega(model))):
        raise AssertionError(f"lint {rec.path}: launches {row}; kernel "
                             f"records {len(names)}, e.g. "
                             f"{sorted(set(names))[:12]}")
    return row


def lint_path(configs, dev):
    """``python -m qba_tpu_torch lint`` on the card, and its dynamic
    checks at full width in process.

    In process, at 11p/L64/d3 and 33p/L64/d10 x ``LINT_TRIALS`` (fewer
    where half the admission model's ceiling is smaller, ``xla`` at 33p:
    ``analysis.trace.batch_trials``): the launch pin (``lint_pin``) on each
    of ``LINT_ENGINES``, on 33p ``stabilizer`` ``auto`` and on the 33p
    ``tp = 4`` mesh (``LINT_MESH_ENGINES``); KI-6's dynamic half
    (``analysis.transfers.check_device_loop``: the graph loop's chunk on
    every engine, with counters and on the dense paths, under
    ``set_sync_debug_mode("error")`` must raise nothing); KI-5's
    carry audit of the per-round engines (``analysis.effects``); KI-3 over
    the dots of a 33p ``stabilizer`` and a 5p/L64/d2 x 32 ``dense_pallas``
    batch (``analysis.dots``).  Beside them the CLI (``LINT_CLI`` over the
    built-in matrix, with ``--findings-json``) in a process of its own
    must exit 0 with the JAX package's JSON keys and no finding.  Per
    check its wall and findings; any finding fails the phase.  Returns
    ``(report, launches)``: the launches are the wrappers' counts after
    the in-process part less those before it (warm-ups, traced batches
    and sync probes alike, a cached record adding none), plus the CLI
    process's own ``kernel_launches()`` at its end."""
    import dataclasses
    import shutil
    import tempfile

    from qba_tpu_torch import QBAConfig
    from qba_tpu_torch.analysis import trace
    from qba_tpu_torch.analysis.dots import check_dots
    from qba_tpu_torch.analysis.effects import CARRY_ENGINES, check_effects
    from qba_tpu_torch.analysis.transfers import LOOP_ENGINES, check_device_loop
    from qba_tpu_torch.ops import kernel_launches

    launches, out = {}, {}
    # The CLI runs in a process of its own beside the checks below.
    root = tempfile.mkdtemp(prefix="qba_lint_")
    cli_json = os.path.join(root, "findings.json")
    cli_t0 = time.perf_counter()
    cli_log = open(os.path.join(root, "cli.log"), "w+")
    cli = subprocess.Popen(port_cli(*LINT_CLI, "--findings-json", cli_json),
                           stdout=cli_log, stderr=subprocess.STDOUT)

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def checked(name, fn):
        t0 = time.perf_counter()
        rep = fn()
        wall = time.perf_counter() - t0
        out[name] = dict(wall_s=wall, findings=len(rep.findings),
                         notes=len(rep.notes))
        log("lint_path", check=name, wall_s=wall,
            findings=[f.render() for f in rep.findings])
        if rep.findings:
            raise AssertionError(f"lint {name}: {rep.render()}")
        return rep

    def in_process():
        widths = [(name, dataclasses.replace(configs[name], trials=LINT_TRIALS))
                  for name in ("11p/L64/d3", "33p/L64/d10")]
        trace.reset()
        pins = {}
        t0 = time.perf_counter()
        cases = [(name, cfg, e, None) for name, cfg in widths
                 for e in LINT_ENGINES]
        stab = dataclasses.replace(widths[1][1], qsim_path="stabilizer")
        cases.append(("33p/L64/d10 stabilizer", stab, "auto", None))
        cases += [(widths[1][0], widths[1][1], e, 4) for e in LINT_MESH_ENGINES]
        for name, cfg, engine, tp in cases:
            row = lint_pin(name, cfg, engine, dev, tp)
            key = f"{name}/{engine}" + (f"/tp={tp}" if tp else "")
            pins[key] = row
            log("lint_path", check="launch_pin", batch=key, **row)
        out["launch_pin"] = dict(wall_s=time.perf_counter() - t0, findings=0,
                                 batches=pins)
        loop = checked("device_loop", lambda: check_device_loop(
            widths, LOOP_ENGINES, dev, LINT_TRIALS))
        verdicts = loop.stats["sync_verdicts"]
        out["device_loop"]["sync_verdicts"] = verdicts
        log("lint_path", check="sync_verdicts", **verdicts)
        carry = {}
        for name, cfg in widths:
            rep = checked(f"carry {name}", lambda: check_effects(
                name, cfg, CARRY_ENGINES, dev, LINT_TRIALS))
            carry[name] = [n for n in rep.notes]
        dense = QBAConfig(n_parties=5, size_l=64, n_dishonest=2,
                          qsim_path="dense_pallas", trials=32)
        dots = {}

        def dot_records():
            recs, errors = [], []
            for name, cfg, engine, trials in (
                    ("33p/L64/d10 stabilizer", stab, "auto", LINT_TRIALS),
                    ("5p/L64/d2 dense_pallas", dense, "auto", 32)):
                rec = trace.trace_batch(name, cfg, engine, dev, trials)
                if rec.error:
                    errors.append(trace.batch_error(rec))
                recs += rec.dots
                dots[name] = dict(
                    dots=len(rec.dots),
                    integral=sum(d.integral for d in rec.dots),
                    max_k=max((d.k for d in rec.dots), default=0),
                    max_operand=max((max(d.lhs_max, d.rhs_max)
                                     for d in rec.dots if d.integral), default=0),
                    sites=sorted({d.where for d in rec.dots}),
                    precision=sorted({d.precision for d in rec.dots}))
            rep = check_dots(recs)
            rep.findings += errors
            return rep

        checked("exact_dot", dot_records)
        out["exact_dot"]["records"] = dots
        log("lint_path", check="exact_dot_records", **dots)
        return carry

    try:
        before = kernel_launches()
        carry = in_process()
        in_proc = {k: n - before.get(k, 0)
                   for k, n in kernel_launches().items()
                   if n != before.get(k, 0)}
        add(in_proc)
        cli.wait(timeout=600)
        cli_s = time.perf_counter() - cli_t0
        if cli.returncode != 0:
            cli_log.seek(0)
            raise AssertionError(f"lint CLI exit {cli.returncode}: "
                                 f"{cli_log.read()[-6000:]}")
        with open(cli_json) as f:
            payload = json.load(f)
        keys = {"schema", "ok", "effects", "protocol", "obs", "findings",
                "notes", "stats"}
        if set(payload) != keys or not payload["ok"] or payload["findings"]:
            raise AssertionError(f"lint CLI findings json: {sorted(payload)}"
                                 f" ok={payload.get('ok')}")
        stats = payload["stats"]
        add(stats.get("kernel_launches", {}))
        out["launches"] = dict(in_process=in_proc,
                               cli=stats.get("kernel_launches", {}))
        log("lint_path", check="launches", **out["launches"])
        out["cli"] = dict(wall_s=cli_s, notes=len(payload["notes"]),
                          sync_verdicts=stats.get("sync_verdicts"),
                          kernel_launches=stats.get("kernel_launches"))
        log("lint_path", check="cli", wall_s=cli_s,
            notes=len(payload["notes"]), findings=0,
            sync_verdicts=stats.get("sync_verdicts"),
            kernel_launches=stats.get("kernel_launches"))
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        cli_log.close()
        shutil.rmtree(root, ignore_errors=True)
    return dict(out, carry=carry), launches


# The graph loop on every engine and list path: each sweep case runs the
# graph loop (one CUDA graph: warm-up, capture, one launch, one readback),
# the host loop and the fixed-budget run, at seed 3, and they agree chunk
# for chunk and stop for stop.  (config, target, budget chunks, chunk
# trials, config changes.)  The 33p per-round engines and the counters
# (``auto`` demotes to the fused round) take the first targeted case's
# target, ``xla`` the 11p one's (its 33p batch would need about 2.5 GB a
# trial: ``analysis.memory``); the dense paths run 5p/L64/d2 (18 qubits)
# in chunks of 32 on a width target (3 chunks), a budget of 4: a chunk
# takes 0.7-1.5 s.
GRAPH_DENSE = ("5p/L64/d2", dict(n_parties=5, size_l=64, n_dishonest=2))
GRAPH_DENSE_TARGET = "ci_width<=0.25"
GRAPH_SWEEPS = [
    ("33p/L64/d10", "decide vs 0.56 +-0.01", 12, 1000,
     dict(round_engine="pallas_fused")),
    ("33p/L64/d10", "decide vs 0.56 +-0.01", 12, 1000,
     dict(round_engine="pallas")),
    ("33p/L64/d10", "decide vs 0.56 +-0.01", 12, 1000,
     dict(round_engine="pallas_tiled")),
    ("33p/L64/d10", "decide vs 0.56 +-0.01", 12, 1000,
     dict(collect_counters=True)),
    ("11p/L64/d3", "decide vs 0.3 +-0.005", 12, 1000,
     dict(round_engine="xla")),
    ("5p/L64/d2", GRAPH_DENSE_TARGET, 4, 32, dict(qsim_path="dense_pallas")),
    ("5p/L64/d2", GRAPH_DENSE_TARGET, 4, 32, dict(qsim_path="dense")),
]
# The serving worker's device path: (request id, config, request fields,
# chunk trials).
GRAPH_SERVE = [
    ("33p-fused", "33p/L64/d10", dict(seed=3, trials=SERVE_TRIALS,
                                      target=SERVE_TARGET,
                                      round_engine="pallas_fused"), 64),
    ("5p-dense", "5p/L64/d2", dict(seed=4, trials=256,
                                   target=GRAPH_DENSE_TARGET,
                                   qsim_path="dense_pallas"), 32),
]
# The surfaces: 4 cells on the fused round (SURFACE_GRID), and 16 cells
# on ``auto`` (4 strategies x 2 noise points x 2 sizeL), each at 33p,
# chunks of 1000.  The 16-cell grid runs twice: a budget of one pass a
# cell (every pass a branch's first) and of two.
GRAPH_SURFACE_BUDGET = 8
GRAPH_GRID16 = (("reference", "collude", "adaptive", "split"),
                [(0.0, 0.0), (0.01, 0.01)], [32, 64])


def dense_circuit_launches(cfg):
    """Circuit-kernel launches of one ``dense_pallas`` batch of
    ``cfg.trials`` trials: one a chunk of list positions (the
    Q-correlated family's states) and one for the shared
    not-Q-correlated state."""
    from qba_tpu_torch.qsim.statevector import SAMPLE_CHUNK_ELEMS

    step = max(1, SAMPLE_CHUNK_ELEMS >> cfg.total_qubits)
    return -(-cfg.trials * cfg.size_l // step) + 1


def chunk_model(cfg, dev):
    """Every counted kernel's launches in one chunk of ``cfg`` (the
    launch model, plus the circuit kernel on ``dense_pallas``)."""
    model = modelled(cfg, cfg.round_engine, dev)
    if cfg.qsim_path == "dense_pallas":
        model["fused_circuit"] = dense_circuit_launches(cfg)
    return model


def graph_record(info):
    """A graph loop's record in ms, with its body's node count."""
    return dict(
        readbacks=info["readbacks"], warmup_ms=info["warmup_s"] * 1e3,
        capture_ms=info["capture_s"] * 1e3,
        instantiate_ms=info["instantiate_s"] * 1e3,
        loop_ms=info["loop_s"] * 1e3, body_nodes=info["body_nodes"],
        body_node_total=sum(info["body_nodes"].values()))


def graph_sweeps(configs, dev):
    """``GRAPH_SWEEPS``: per case the fixed-budget run, the host loop and
    the graph loop (launch counts asserted against the launch model: a
    chunk's launches per host chunk; the graph's eager warm-up and its
    capture once each, the replays counting nothing), equal chunk for
    chunk and stop for stop.  Returns ``(runs, launches)``."""
    import dataclasses

    import torch

    from qba_tpu_torch.sweep import run_sweep

    runs, launches = [], dict.fromkeys(COUNTED, 0)
    for name, spec, budget, trials, kw in GRAPH_SWEEPS:
        cfg = dataclasses.replace(configs[name], trials=trials,
                                  seed=TARGETED_SEED, **kw)
        label = " ".join([name, *(f"{k}={v}" for k, v in kw.items())])
        model = chunk_model(cfg, dev)
        t0 = time.perf_counter()
        fixed = run_sweep(cfg, budget, trials)
        fixed_s = time.perf_counter() - t0
        out = dict(config=label, target=spec, budget_chunks=budget,
                   chunk_trials=trials, rounds=cfg.n_rounds,
                   chunk_model={k: n for k, n in model.items() if n},
                   fixed_budget_ms_per_chunk=fixed_s / budget * 1e3)
        res = {}
        for dispatch in ("host", "device"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            r, wall, counts, timers = sweep_run(cfg, budget, spec, dispatch)
            peak = torch.cuda.max_memory_allocated()
            for k, n in counts.items():
                launches[k] += n
            done = len(r.chunks)
            if dispatch == "host":
                want = {k: done * n for k, n in model.items()}
                rec = dict(readbacks=timers.count("readback"), wall_s=wall,
                           ms_per_chunk=wall / done * 1e3)
            else:
                want = {k: 2 * n for k, n in model.items()}
                want["sweep_stop"] = 2
                (span,) = [sp for sp in timers.spans.spans
                           if sp.name == "device_loop"]
                info = span.args
                if info["dispatch"] != "graph" or info["readbacks"] != 1:
                    raise AssertionError(f"graph sweep {label}: not one "
                                         f"graph launch: {info}")
                rec = dict(graph_record(info), wall_s=wall,
                           ms_per_chunk=info["loop_s"] / done * 1e3)
            want = {k: want.get(k, 0) for k in COUNTED}
            if counts != want:
                raise AssertionError(f"graph sweep {label} {dispatch}: "
                                     f"launches {counts}, expected {want}")
            rec.update(chunks=done, stop=r.stop.reason, peak_mem_bytes=peak,
                       launches={k: n for k, n in counts.items() if n})
            res[dispatch] = r
            out[dispatch] = rec
        host, devr = res["host"], res["device"]
        if not (host.chunks == devr.chunks == fixed.chunks[:len(host.chunks)]
                and host.stop.to_json() == devr.stop.to_json()):
            raise AssertionError(f"graph sweep {label}: host loop, graph "
                                 "loop and fixed-budget prefix disagree")
        out["counts"] = [c.successes for c in host.chunks]
        out["host_over_graph"] = (out["host"]["ms_per_chunk"]
                                  / out["device"]["ms_per_chunk"])
        log("graph_path", part="sweep", **out)
        runs.append(out)
        torch.cuda.empty_cache()
    return runs, launches


def graph_serve(configs, dev):
    """``GRAPH_SERVE``: each request on a ``dispatch="device"`` server
    (one graph launch, one readback) against the host path's result and
    a direct ``run_trials`` of its keys.  Returns ``(runs, launches)``."""
    import ast
    import dataclasses
    import shutil

    import torch

    from qba_tpu_torch.backends.torch_backend import run_trials
    from qba_tpu_torch.obs.telemetry import spans_from_jsonl
    from qba_tpu_torch.serve import EvalRequest, QBAServer, serve_batch

    runs, launches = [], dict.fromkeys(COUNTED, 0)
    tel = os.path.abspath(os.path.join("build", "graph_telemetry"))
    for rid, name, kw, chunk in GRAPH_SERVE:
        c = configs[name]
        req = EvalRequest(request_id=rid, n_parties=c.n_parties,
                          size_l=c.size_l, n_dishonest=c.n_dishonest, **kw)
        cfg = req.config()
        [host] = serve_batch(QBAServer(chunk_trials=chunk, depth=2), [req])
        shutil.rmtree(tel, ignore_errors=True)
        server = QBAServer(chunk_trials=chunk, dispatch="device",
                           telemetry_dir=tel)
        fns = wrappers()
        for fn in fns.values():
            fn.launches, fn.events = 0, None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        [res] = serve_batch(server, [req])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in fns.items()}
        model = chunk_model(dataclasses.replace(cfg, trials=chunk), dev)
        want = {k: 2 * model.get(k, 0) for k in COUNTED}
        want["sweep_stop"] = 2
        if counts != want:
            raise AssertionError(f"graph serve {rid}: launches {counts}, "
                                 f"expected {want}")
        for k, n in counts.items():
            launches[k] += n
        (loop,) = [sp for sp in spans_from_jsonl(os.path.join(
            tel, rid, "spans.jsonl")) if sp.name == "serve.device_loop"]
        info = loop.args
        info["body_nodes"] = ast.literal_eval(str(info["body_nodes"]))
        if info["dispatch"] != "graph" or info["readbacks"] != 1:
            raise AssertionError(f"graph serve {rid}: not one graph launch: "
                                 f"{info}")
        direct = run_trials(cfg).trials
        if res.error is not None or host.error is not None or any(
                getattr(res, f) != getattr(host, f)
                for f in ("stop", "n_trials", "success", "ci")):
            raise AssertionError(f"graph serve {rid}: device path != host "
                                 f"path: {res.error or res.stop} against "
                                 f"{host.error or host.stop}")
        if res.success != direct.success[:res.n_trials].tolist():
            raise AssertionError(f"graph serve {rid}: success != a direct "
                                 "run_trials of its keys")
        out = dict(graph_record(info), request=rid, config=res.bucket,
                   chunk_trials=chunk, trials=res.n_trials,
                   stop=res.stop["reason"], chunks=res.chunks,
                   budget_chunks=cfg.trials // chunk, wall_s=wall,
                   latency_s=res.latency_s, host_latency_s=host.latency_s,
                   ms_per_chunk=info["loop_s"] / res.chunks * 1e3,
                   launches={k: n for k, n in counts.items() if n},
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   engine=res.engine)
        log("graph_path", part="serve", **out)
        runs.append(out)
    shutil.rmtree(tel, ignore_errors=True)
    return runs, launches


def surfaces_agree(label, host, dev_cells, target):
    """A device surface against the host surface: each cell's chunks, in
    both, are a prefix of one sequence (a cell's chunk i runs chunk i's
    keys, whichever pass picks it); where the two schedules are the same
    every cell is equal, stop included; else they part at a near-tie of
    the host's scores.  Returns ``(same, first_divergence)``."""
    h_alloc, d_alloc = surface_alloc(host), surface_alloc(dev_cells)
    h_sched = [t["cell"] for t in h_alloc["trace"]]
    d_sched = [t["cell"] for t in d_alloc["trace"]]
    same = h_sched == d_sched
    for h, d in zip(host, dev_cells):
        a, b = h.result.chunks, d.result.chunks
        n = min(len(a), len(b))
        if a[:n] != b[:n] or (same and (
                a != b or h.result.stop.to_json() != d.result.stop.to_json())):
            raise AssertionError(f"graph surface {label}: cell "
                                 f"{d.strategy}/{d.p_depolarize}/{d.size_l} "
                                 "differs from the host surface")
    first = next((s for s, (a, b) in enumerate(zip(h_sched, d_sched))
                  if a != b), None)
    if not same:
        scores = step_scores(h_alloc["trace"], host, parse_threshold(target),
                             0.95)
        if first is None or not near_tie(scores[first]):
            raise AssertionError(f"graph surface {label}: device schedule "
                                 f"{d_sched} != host {h_sched}")
    return same, first


def graph_surface_run(cfg, grid, target, budget, label, dev):
    """One device surface over ``grid`` beside the host surface: launch
    counts (the pick and fold twice, each cell's chunk twice: its warm-up
    and its capture), the graph's record, equal to the host surface
    (``surfaces_agree``)."""
    import torch

    host, host_wall, _hc, _i, _hp = surface_run(cfg, target, budget, "host",
                                                grid)
    torch.cuda.empty_cache()
    cells, wall, counts, info, peak = surface_run(cfg, target, budget,
                                                  "device", grid)
    n_cells = len(cells)
    want = {k: 0 for k in COUNTED}
    for c in cells:
        for k, n in chunk_model(c.result.cfg, dev).items():
            want[k] += 2 * n
    want.update(surface_pick=2, surface_fold=2)
    if counts != want:
        raise AssertionError(f"graph surface {label}: launches {counts}, "
                             f"expected {want}")
    if info["dispatch"] != "graph" or info["readbacks"] != 1:
        raise AssertionError(f"graph surface {label}: not one graph "
                             f"launch: {info}")
    same, first = surfaces_agree(label, host, cells, target)
    branch_nodes = [sum(v.values()) for k, v in info["body_nodes"].items()
                    if k.startswith("branch_")]
    passes = info["passes"]
    rec = dict(
        cells=n_cells, budget_chunks=budget, target=target,
        same_schedule=same, first_divergence=first, passes=passes,
        readbacks=info["readbacks"], wall_s=wall, host_wall_s=host_wall,
        ms_per_pass=info["loop_s"] / passes * 1e3,
        host_ms_per_chunk=host_wall / surface_alloc(host)["spent_chunks"]
        * 1e3,
        loop_ms=info["loop_s"] * 1e3, warmup_ms=info["warmup_s"] * 1e3,
        capture_ms=info["capture_s"] * 1e3,
        capture_cell_ms=[x * 1e3 for x in info["capture_cell_s"]],
        instantiate_ms=info["instantiate_s"] * 1e3,
        upload_ms=info["upload_s"] * 1e3,
        branch_nodes=branch_nodes, body_nodes_total=info["body_nodes_total"],
        peak_mem_bytes=peak,
        launches={k: n for k, n in counts.items() if n},
        stops=[c.result.stop.reason for c in cells])
    log("graph_path", part="surface", run=label, **rec)
    return rec, counts


def graph_surfaces(configs, dev):
    """The device surface with per-round branches (4 cells of
    ``SURFACE_GRID`` on the fused round) and past four cells (16 cells of
    ``GRAPH_GRID16`` on ``auto``, once at one pass a cell and once at
    two: a repeat pass's ms is the difference over the 16 extra passes).
    Returns ``(runs, launches)``."""
    import dataclasses

    import torch

    base = dataclasses.replace(configs["33p/L64/d10"], trials=1000,
                               seed=TARGETED_SEED)
    launches = dict.fromkeys(COUNTED, 0)
    runs = {}
    n16 = len(GRAPH_GRID16[0]) * len(GRAPH_GRID16[1]) * len(GRAPH_GRID16[2])
    for label, cfg, grid, budget in (
            ("4 cells pallas_fused",
             dataclasses.replace(base, round_engine="pallas_fused"),
             SURFACE_GRID, GRAPH_SURFACE_BUDGET),
            ("16 cells auto, one pass a cell", base, GRAPH_GRID16, n16),
            ("16 cells auto, two passes a cell", base, GRAPH_GRID16,
             2 * n16)):
        rec, counts = graph_surface_run(cfg, grid, SURFACE_TARGETS[0],
                                        budget, label, dev)
        for k, n in counts.items():
            launches[k] += n
        runs[label] = rec
        torch.cuda.empty_cache()
    one, two = (runs[f"16 cells auto, {x}"] for x in
                ("one pass a cell", "two passes a cell"))
    runs["16 cells first and repeat pass"] = dict(
        first_pass_ms=one["loop_ms"] / one["passes"],
        repeat_pass_ms=(two["loop_ms"] - one["loop_ms"])
        / max(1, two["passes"] - one["passes"]))
    log("graph_path", part="surface", run="16 cells first and repeat pass",
        **runs["16 cells first and repeat pass"])
    return runs, launches


def graph_path(configs, dev):
    """The graph loop on every engine and list path, at full width:
    ``graph_sweeps``, ``graph_serve`` and ``graph_surfaces``.  Returns
    ``(report, launches)``."""
    launches = dict.fromkeys(COUNTED, 0)
    out = {}
    for part, fn in (("sweeps", graph_sweeps), ("serve", graph_serve),
                     ("surfaces", graph_surfaces)):
        t0 = time.perf_counter()
        out[part], counts = fn(configs, dev)
        log("graph_path", part=part, seconds=time.perf_counter() - t0)
        for k, n in counts.items():
            launches[k] += n
    return out, launches


def modelled(cfg, engine, dev, tp=None):
    """Every counted kernel's launches in one batch of ``cfg`` with
    ``round_engine=engine``, by the package's launch model
    (``analysis.launches.batch_launch_model``; ``tp``: the party-sharded
    batch on one card)."""
    from qba_tpu_torch.analysis.launches import batch_launch_model

    model = batch_launch_model(cfg, engine, dev, tp)
    if set(model) - set(COUNTED):
        raise AssertionError(f"launch model {model} names a kernel the "
                             "smoke does not count")
    return {k: model.get(k, 0) for k in COUNTED}


def wrappers():
    from qba_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def drive(cfg, engine, mesh=None):
    """One main-path batch, ``run_trials(cfg)`` (``run_trials_spmd(cfg,
    mesh)`` with a mesh), after a warm-up, with every kernel's launch
    count set to 0 just before and read just after, and each launch's
    CUDA events kept."""
    import dataclasses

    import torch

    import qba_tpu_torch
    from qba_tpu_torch.backends.torch_backend import fence
    from qba_tpu_torch.parallel import run_trials_spmd

    if engine != "auto":
        cfg = dataclasses.replace(cfg, round_engine=engine)
    run = (qba_tpu_torch.run_trials if mesh is None
           else lambda c: run_trials_spmd(c, mesh))
    t0 = time.perf_counter()
    fence(run(cfg))  # warm-up
    warmup = time.perf_counter() - t0
    fns = wrappers()
    torch.cuda.reset_peak_memory_stats()
    for fn in fns.values():
        fn.launches, fn.events = 0, []
    t0 = time.perf_counter()
    out = fence(run(cfg))
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    events = {k: fn.events for k, fn in fns.items()}
    for fn in fns.values():
        fn.events = None
    drive.warmup_s = warmup
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
             for ln in text.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    log("build", seconds=build_s, kernels=list(logs), ptxas=ptxas)
    from qba_tpu_torch.ops import surface_loop as su

    driver, runtime = su.versions(dev)
    # The device surface's graph switches into a cell's chunk with a SWITCH
    # conditional node, which needs a CUDA 12.8 driver (check_driver).
    su.check_driver(dev)
    log("cuda_versions", driver=driver, runtime=runtime,
        surface_design="switch")

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
    sharded_checks = []
    for name, cfg in small:
        keys = trial_keys(cfg, dev)
        for tp in shard_tps(cfg.n_lieutenants):
            sharded_checks.append(dict(config=name, **sharded_mega_vs_plain(
                cfg, keys, tp, chunk=cfg.trials)))
    if not any(c["overflow"] for c in sharded_checks):
        raise AssertionError("no overflowing trial among the sharded checks")
    report["sharded_mega_vs_plain"] = sharded_checks
    log("sharded_mega_vs_plain", tolerance=0,
        max_abs_err=max(c["max_abs_err"] for c in sharded_checks),
        cases=[(c["config"], c["tp"], c["overflow"]) for c in sharded_checks])
    random_errs, facts = random_vs_plain(dev)
    report["random_vs_plain"] = dict(max_abs_err=random_errs, cases=facts)
    log("random_vs_plain", tolerance=0, max_abs_err=random_errs, cases=facts)
    ring_err, ring_cases = ring_vs_plain(dev)
    report["ring_vs_plain"] = dict(max_abs_err=ring_err, cases=ring_cases)
    log("ring_vs_plain", tolerance=0, max_abs_err=ring_err, cases=ring_cases,
        tp=[2, 4, 8], dtypes=["int8", "int32", "bool", "uint8", "int64"])
    circuit_cases, circuit_timing = circuit_vs_plain(dev)
    report["circuit_vs_plain"] = dict(cases=circuit_cases,
                                      timing=circuit_timing)
    log("circuit_vs_plain", tolerance=CIRCUIT_ATOL, cases=circuit_cases,
        **circuit_timing)
    sweep_err, sweep_facts = sweep_vs_plain(dev)
    report["sweep_vs_plain"] = dict(max_abs_err=sweep_err, cases=sweep_facts)
    log("sweep_vs_plain", tolerance=0, max_abs_err=sweep_err,
        cases=sweep_facts)
    if not quick:
        report["sweep_65p"] = sweep_65p(dev)
        log("sweep_65p", **report["sweep_65p"])
    gen_checks = []
    for name, kw in GEN_CASES:
        cfg = QBAConfig(**kw, trials=32, seed=21, qsim_path="stabilizer")
        gen, _vi = gen_vs_plain(cfg, trial_keys(cfg, dev))
        gen_checks.append(dict(config=name, **gen))
        log("gen_vs_plain", config=name, tolerance=0,
            max_abs_err=gen["max_abs_err"], overflow=gen["overflow"],
            gen=gen["gen"])
    report["gen_vs_plain"] = gen_checks
    draws_err, draws_facts = draws_vs_plain(dev)
    report["draws_vs_plain"] = dict(max_abs_err=draws_err, cases=draws_facts)
    log("draws_vs_plain", tolerance=0, max_abs_err=draws_err,
        cases=draws_facts)
    keyed_errs, keyed_facts = keyed_vs_plain(dev)
    if not any(f["overflow"] for f in keyed_facts):
        raise AssertionError("no overflowing trial among the keyed checks")
    report["keyed_vs_plain"] = dict(max_abs_err=keyed_errs,
                                    cases=keyed_facts)
    log("keyed_vs_plain", tolerance=0, max_abs_err=keyed_errs,
        cases=keyed_facts)
    stop_err = sweep_stop_vs_plain(dev)
    report["sweep_stop_vs_plain"] = dict(max_abs_err=stop_err)
    log("sweep_stop_vs_plain", tolerance=0, max_abs_err=stop_err,
        trials=[1, 37, 64, 1000, 5000], starts=[0, 1, 2, 3, 4], budget=4,
        succ_out=[False, True])
    pick_err, fold_err = surface_vs_plain(dev)
    report["surface_vs_plain"] = dict(pick_max_abs_err=pick_err,
                                      fold_max_abs_err=fold_err)
    log("surface_vs_plain", pick_tolerance=PICK_ATOL, fold_tolerance=0,
        pick_max_abs_err=pick_err, fold_max_abs_err=fold_err,
        cells=PICK_CELLS, thresholds=[0.3, 0.55, None])
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
    launches = dict.fromkeys(COUNTED, 0)
    runs, single = [], {}
    for name, cfg in main_cfgs:
        if resolve_round_engine(cfg, dev) != "pallas_mega":
            raise AssertionError("auto does not resolve to pallas_mega")
        per_engine, results = {}, {}
        for engine in ("auto", "pallas_fused", "pallas_tiled", "pallas"):
            out, wall, counts, events, peak = drive(cfg, engine)
            want = modelled(cfg, engine, dev)
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
                # The batch's draws on the card (none outside the keyed
                # megakernel, which hashes them).
                draws_ms=sum(a.elapsed_time(b)
                             for a, b in events["attack_draws"]),
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
        setup, *stats = replay(cfg, keys, chunk=32, reps=3)
        if not torch.equal(setup.pop("vi"), results["auto"].vi):
            raise AssertionError(f"{name}: main path != round-by-round replay")
        mega = mega_vs_plain(cfg, keys, chunk=32, reps=3)
        if not torch.equal(mega.pop("vi"), results["auto"].vi):
            raise AssertionError(f"{name}: main path != staged megakernel")
        mega_bound = bound(*mega_cost(cfg, stats, cfg.trials, keyed=True))
        stacked_bound = bound(*mega_cost(cfg, stats, cfg.trials))
        draws = draws_timing(cfg, keys)
        log("draws_timing", config=name, trials=cfg.trials, **draws)
        # The broadcast scope's walk over a cell's receivers, and racy
        # delivery's late words, against the stacked entry.
        laws = {}
        for law, kw in (("broadcast", dict(attack_scope="broadcast")),
                        ("racy", RACY), ("adaptive", dict(strategy="adaptive"))):
            lcfg = dataclasses.replace(cfg, **kw)
            laws[law] = keyed_timing(lcfg, trial_keys(lcfg, dev))
        log("keyed_timing", config=name, trials=cfg.trials, **laws)
        per_engine["auto"].update(
            engine="pallas_mega, keyed", setup_ms=mega["setup_ms"],
            stacked_draws_ms=mega["draws_ms"],
            bound_ms={"trial_megakernel": mega_bound[0]},
            bound_by={"trial_megakernel": mega_bound[1]})
        for engine, ks in (("pallas_fused", ("fused_round",)),
                           ("pallas_tiled", ("tiled_verdict",
                                             "tiled_rebuild")),
                           ("pallas", ("round_step",))):
            per_engine[engine].update(
                engine=engine, setup_ms=setup["setup_ms"],
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
            stacked_ms=mega["stacked_ms"], plain_ms=mega["plain_ms"],
            bound_ms=mega_bound[0], bound_by=mega_bound[1],
            stacked_bound_ms=stacked_bound[0], rehashes=rehashes(stats))
        run = dict(config=name, trials=cfg.trials, rounds=cfg.n_rounds,
                   vi=results["auto"].vi, attack_draws=draws,
                   keyed_timing=laws,
                   engines=per_engine, full_width_vs_plain=kern,
                   pool_bytes_per_trial=pool_bytes(cfg, 1),
                   replay=stats)
        for engine, e in per_engine.items():
            log("main_path", config=name, trials=cfg.trials,
                rounds=cfg.n_rounds, **e)
        log("full_width_vs_plain", config=name, tolerance=0, **kern)
        runs.append(run)
        single[name] = (results["auto"], stats)
    report["main_path"] = runs

    # The protocol counters on the default engine: they need the
    # per-round loop, so `auto` runs the fused per-round engine.
    name, cfg = main_cfgs[0]
    ccfg = dataclasses.replace(cfg, collect_counters=True)
    if resolve_round_engine(ccfg, dev) != "pallas_fused":
        raise AssertionError("auto with counters is not pallas_fused")
    out, wall, counts, _events, peak = drive(ccfg, "auto")
    want = modelled(ccfg, "auto", dev)
    if counts != want:
        raise AssertionError(
            f"{name} counters: launches {counts}, expected {want}")
    for k in ("fused_round", "attack_draws"):
        launches[k] += counts[k]
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
                     qsim_path="dense_pallas", trials=32)
    out, wall, counts, events, peak = drive(dcfg, "auto")
    want = modelled(dcfg, "auto", dev)
    if ({k: counts[k] for k in want if k != "fused_circuit"}
            != {k: n for k, n in want.items() if k != "fused_circuit"}
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

    # The stabilizer resource path at full width: `auto` is the
    # megakernel's gen entry (one launch, no sweep kernel), mega_gen="host"
    # the sweep kernel and the host-gen megakernel, pallas_fused the sweep
    # kernel and the fused round per round.
    from qba_tpu_torch.rounds.engine import resolve_mega_gen

    stab_runs_of = {"auto": {}, "host": dict(mega_gen="host"),
                    "pallas_fused": dict(round_engine="pallas_fused")}
    stab_runs = []
    for name, base in main_cfgs:
        cfg = dataclasses.replace(base, qsim_path="stabilizer")
        if (resolve_round_engine(cfg, dev) != "pallas_mega"
                or resolve_mega_gen(cfg, dev) != "gf2"):
            raise AssertionError("auto on the stabilizer path is not the "
                                 "megakernel's gen entry")
        per_engine, results = {}, {}
        for label, kw in stab_runs_of.items():
            scfg = dataclasses.replace(cfg, **kw)
            out, wall, counts, events, peak = drive(scfg, "auto")
            want = modelled(scfg, scfg.round_engine, dev)
            if counts != want:
                raise AssertionError(f"{name} stabilizer {label}: launches "
                                     f"{counts}, expected {want}")
            for k, n in counts.items():
                launches[k] += n
            rate = float(out.success_rate)
            if not (out.trials.decisions.shape == (cfg.trials, cfg.n_parties)
                    and 0.0 <= rate <= 1.0):
                raise AssertionError(f"{name} stabilizer {label}: malformed")
            results[label] = out.trials
            per_engine[label] = dict(
                launches={k: n for k, n in counts.items() if n},
                wall_s=wall, rounds_per_s=cfg.trials * cfg.n_rounds / wall,
                kernel_ms_per_launch={k: event_ms(ev)
                                      for k, ev in events.items() if ev},
                draws_ms=sum(a.elapsed_time(b)
                             for a, b in events["attack_draws"]),
                success_rate=rate, peak_mem_bytes=peak)
        for label in ("host", "pallas_fused"):
            for f in fields:
                if not torch.equal(getattr(results["auto"], f),
                                   getattr(results[label], f)):
                    raise AssertionError(f"{name} stabilizer: gen entry and "
                                         f"{label} disagree on {f}")
        log("engines_agree", config=name, qsim_path="stabilizer",
            trials=cfg.trials, engines=list(stab_runs_of))
        keys = trial_keys(cfg, dev)
        sweep, plain_bits = sweep_batch(cfg, keys)
        gen, gen_vi = gen_vs_plain(cfg, keys, reps=3,
                                   plain_sweep=(plain_bits, sweep["plain_ms"]))
        rounds, round_vi = pool_rounds(cfg, keys)
        for vi in (gen_vi, round_vi):
            if not torch.equal(vi, results["auto"].vi):
                raise AssertionError(f"{name} stabilizer: main path != "
                                     "staged replay")
        sweep_ops = sweep_cost(cfg.total_qubits, sweep["shots"])[1]
        gen_bound = bound(*gen_cost(cfg, rounds, cfg.trials, sweep_ops,
                                    keyed=True))
        host_bound = bound(*mega_cost(cfg, rounds, cfg.trials, keyed=True))
        gen_ms = per_engine["auto"]["kernel_ms_per_launch"][
            "trial_megakernel_gen_keyed"]
        per_engine["auto"].update(
            engine="pallas_mega, keyed gen entry", setup_ms=gen["setup_ms"],
            stacked_draws_ms=gen["draws_ms"],
            bound_ms={"trial_megakernel_gen": gen_bound[0]},
            bound_by={"trial_megakernel_gen": gen_bound[1]},
            gen_replay=gen["gen"],
            sweep_share=(gen["gen"]["ms"] - gen["host_gen"]["ms"])
            / gen["gen"]["ms"])
        per_engine["host"].update(
            engine="gf2_sweep + pallas_mega",
            bound_ms={"gf2_sweep": sweep["bound_ms"],
                      "trial_megakernel": host_bound[0]},
            host_gen_replay=gen["host_gen"])
        per_engine["pallas_fused"].update(engine="gf2_sweep + pallas_fused")
        stab_runs.append(dict(
            config=name, qsim_path="stabilizer", trials=cfg.trials,
            rounds=cfg.n_rounds, qubits=cfg.total_qubits,
            engines=per_engine, gen_ms_per_launch=gen_ms,
            gen=dict(max_abs_err=gen["max_abs_err"],
                     plain_ms=gen["plain_ms"], bound_ms=gen_bound[0],
                     bound_by=gen_bound[1],
                     stacked_ms=gen["gen_stacked"]["ms"],
                     rehashes=rehashes(rounds)),
            sweep=sweep, pool_rounds=rounds))
        for label, e in per_engine.items():
            log("main_path", config=name, qsim_path="stabilizer",
                trials=cfg.trials, rounds=cfg.n_rounds, run=label, **e)
        log("full_width_vs_plain", config=name, qsim_path="stabilizer",
            tolerance=0, trial_megakernel_gen=stab_runs[-1]["gen"],
            gf2_sweep={k: v for k, v in sweep.items() if k != "work"},
            sweep_work=sweep["work"])
    report["stabilizer_path"] = stab_runs

    # The party-sharded path on one card: each trial's tp shards as one
    # thread-block cluster (auto), or per round the ring gather and the
    # round's n_recv kernels; results as the single-device batch.
    from qba_tpu_torch.ops import round_kernel_tiled as rk
    from qba_tpu_torch.ops import trial_megakernel as tm
    from qba_tpu_torch.parallel import make_mesh
    from qba_tpu_torch.parallel.spmd import _resolve_spmd_engine
    from qba_tpu_torch.rounds.engine import setup_trial, step3a_one

    mesh_runs = []
    for name, tp in (("33p/L64/d10", 4), ("11p/L64/d3", 2)):
        cfg = dict(main_cfgs)[name]
        ref, stats = single[name]
        mesh = make_mesh({"dp": 1, "tp": tp}, devices=[dev] * tp)
        n_local = cfg.n_lieutenants // tp
        plan = rk.sharded_mega_plan(cfg, tp, dev)
        if _resolve_spmd_engine(cfg, n_local, dev) != "pallas_mega":
            raise AssertionError(f"{name}: auto under tp={tp} is not the "
                                 "sharded megakernel")
        per_run = {}
        # Per round: the ring once a leaf of the pool or mailbox (none
        # with all_gather), then the round's n_recv kernels.
        mesh_runs_of = [("auto", {})] + [
            (f"{engine} {comms}", dict(round_engine=engine, tp_comms=comms))
            for engine in ("pallas_fused", "pallas_tiled", "pallas")
            for comms in ("ring", "all_gather")]
        for label, kw in mesh_runs_of:
            mcfg = dataclasses.replace(cfg, **kw)
            out, wall, counts, events, peak = drive(mcfg, "auto", mesh)
            want = modelled(mcfg, mcfg.round_engine, dev, tp)
            if counts != want:
                raise AssertionError(f"{name} tp={tp} {label}: launches "
                                     f"{counts}, expected {want}")
            for k, n in counts.items():
                launches[k] += n
            for f in fields:
                if not torch.equal(getattr(out.trials, f), getattr(ref, f)):
                    raise AssertionError(f"{name} tp={tp} {label} != "
                                         f"single-device run_trials on {f}")
            per_run[label] = dict(
                launches={k: n for k, n in counts.items() if n},
                wall_s=wall, warmup_s=drive.warmup_s,
                rounds_per_s=cfg.trials * cfg.n_rounds / wall,
                kernel_ms_per_launch={k: event_ms(ev)
                                      for k, ev in events.items() if ev},
                success_rate=float(out.success_rate), peak_mem_bytes=peak)
            log("mesh_path", config=name, trials=cfg.trials, tp=tp,
                run=label, **per_run[label])
        # The ring on the batch's step-3a segments; the sharded megakernel
        # against its plain version; bounds from the single-device replay.
        keys = trial_keys(cfg, dev)
        _h, li, p_rows, v_sent, _vc, _kr = setup_trial(cfg, keys)
        cells = [rk.shard_receivers(x, tp)
                 for x in step3a_one(cfg, p_rows, v_sent, li)[1]]
        segs = [rk.pool_from_step3a(cfg, tuple(c[s] for c in cells),
                                    start=s * n_local) for s in range(tp)]
        ring = ring_timing([torch.stack(x) for x in zip(*segs)])
        del cells, segs
        sharded = sharded_mega_vs_plain(cfg, keys, tp, chunk=64, reps=3)
        nstats = n_recv_replay(cfg, keys, tp, chunk=125)
        mb = bound(*mega_cost(cfg, stats, cfg.trials, keyed=True))
        nb = [bound(*n_recv_cost(cfg, st["live"], st["rows"], st["dst"],
                                 st["dst_rows"], cfg.trials, tp))
              for st in stats]
        run = dict(
            config=name, trials=cfg.trials, rounds=cfg.n_rounds, tp=tp,
            plan=plan._asdict(), runs=per_run, ring_leaves=ring,
            sharded_trial_megakernel=dict(sharded, bound_ms=mb[0],
                                          bound_by=mb[1],
                                          rehashes=rehashes(stats)),
            fused_round_n_recv=dict(
                ms=per_run["pallas_fused ring"]["kernel_ms_per_launch"]
                ["fused_round"],
                bound_ms=sum(b[0] for b in nb) / len(nb),
                bound_by=max(nb)[1]),
            n_recv_replay=nstats)
        for k, engine in (("tiled_verdict", "pallas_tiled"),
                          ("tiled_rebuild", "pallas_tiled"),
                          ("round_step", "pallas")):
            run[k + "_n_recv"] = dict(
                max_abs_err=max(st["max_abs_err"][k] for st in nstats),
                ms=per_run[f"{engine} ring"]["kernel_ms_per_launch"][k],
                replay_ms=sum(st["ms"][k] for st in nstats) / len(nstats),
                plain_ms=sum(st["plain_ms"][k] for st in nstats)
                / len(nstats),
                bound_ms=sum(st["bound"][k][0] for st in nstats)
                / len(nstats),
                bound_by=max(st["bound"][k] for st in nstats)[1])
        log("mesh_vs_plain", config=name, tp=tp, tolerance=0, ring=ring,
            sharded_trial_megakernel=run["sharded_trial_megakernel"],
            **{k + "_n_recv": run[k + "_n_recv"]
               for k in ("fused_round", "tiled_verdict", "tiled_rebuild",
                         "round_step")}, plan=run["plan"])
        mesh_runs.append(run)

    # A small batch, where one block a trial leaves most SMs idle: the
    # sharded megakernel at tp=4 beside the single-device one.
    cfg = dataclasses.replace(dict(main_cfgs)["33p/L64/d10"], trials=64)
    body, k_rounds, ctx, _st, _s, _d = mega_inputs(cfg, trial_keys(cfg, dev))
    small_batch = {}
    for label, fn, pre in (("single-device", tm.trial_megakernel_keyed, ()),
                           ("sharded tp=4", tm.sharded_trial_megakernel_keyed,
                            (4,))):
        fn(cfg, *pre, *body, k_rounds, ctx)
        small_batch[label] = kernel_ms(fn, 5, cfg, *pre, *body, k_rounds,
                                       ctx)
    report["mesh_path"] = dict(runs=mesh_runs, small_batch_33p_x64_ms=small_batch)
    log("mesh_path", config="33p/L64/d10 x64", kernel_ms=small_batch)


    # Where a megakernel block's time goes: the phase clock's breakdown on
    # the main path's batches, the small batch and the sharded entry.
    phases = {}
    for label, pcfg, tp in (
            ("11p/L64/d3 x1000", dict(main_cfgs)["11p/L64/d3"], None),
            ("33p/L64/d10 x1000", dict(main_cfgs)["33p/L64/d10"], None),
            ("33p/L64/d10 x64", cfg, None),
            ("33p/L64/d10 x1000 tp=4", dict(main_cfgs)["33p/L64/d10"], 4)):
        phases[label] = mega_phases(pcfg, trial_keys(pcfg, dev), tp)
    report["mega_phases"] = phases
    log("mega_phases", unit="SM cycles of warp 0 per block", **phases)
    # The same for the fused and the dense-mailbox rounds, over the main
    # batches' rounds and the 33p batch's n_recv rounds at tp = 4.
    rphases = {}
    for label, pcfg, tp in (
            ("11p/L64/d3 x1000", dict(main_cfgs)["11p/L64/d3"], None),
            ("33p/L64/d10 x1000", dict(main_cfgs)["33p/L64/d10"], None),
            ("33p/L64/d10 x1000 tp=4", dict(main_cfgs)["33p/L64/d10"], 4)):
        rphases[label] = round_phases(pcfg, trial_keys(pcfg, dev), tp)
    report["round_phases"] = rphases
    log("round_phases", unit="SM cycles of warp 0 per block, summed over "
        "the batch's rounds", **rphases)

    # The targeted sweep: host loop against the graph loop (one launch,
    # one readback) and the fixed-budget prefix, at full width.
    sweep_runs, sweep_launches = sweep_path(dict(main_cfgs))
    for k, n in sweep_launches.items():
        launches[k] += n
    stop_row = sweep_stop_timing(dataclasses.replace(
        dict(main_cfgs)["33p/L64/d10"], seed=TARGETED_SEED), dev)
    report["sweep_path"] = dict(runs=sweep_runs, sweep_stop=stop_row)
    log("sweep_stop_timing", config="33p/L64/d10 chunk", tolerance=0,
        **stop_row)

    # The device surface: the grid as one graph, against the host surface.
    t0 = time.perf_counter()
    report["surface_path"], surface_launches = surface_path(dict(main_cfgs),
                                                            dev)
    report["surface_path"]["phase_s"] = time.perf_counter() - t0
    for k, n in surface_launches.items():
        launches[k] += n

    # The serving worker: the host path, the device path, the CLI.
    t0 = time.perf_counter()
    report["serve_path"], serve_launches = serve_path(dict(main_cfgs), dev)
    report["serve_path"]["phase_s"] = time.perf_counter() - t0
    for k, n in serve_launches.items():
        launches[k] += n

    # The fleet: two supervised workers on the card behind the front
    # end; then the atlas campaign through a fleet and in process.  The
    # workers' launches come from their exit summaries.
    for phase, run in (("fleet_path", lambda: fleet_path(dict(main_cfgs),
                                                         dev)),
                       ("atlas_path", atlas_path)):
        t0 = time.perf_counter()
        report[phase], phase_launches = run()
        report[phase]["phase_s"] = time.perf_counter() - t0
        log(phase, part="phase", seconds=report[phase]["phase_s"])
        for k, n in phase_launches.items():
            launches[k] += n

    # The message-level backends, presampled on the card, and `run`.
    t0 = time.perf_counter()
    report["run_path"], run_launches = run_path(
        dict(main_cfgs), [s for s in small if s[0] in RUN_SMALL], dev)
    report["run_path"]["phase_s"] = time.perf_counter() - t0
    log("run_path", part="phase", seconds=report["run_path"]["phase_s"])
    for k, n in run_launches.items():
        launches[k] += n

    # The invariant checker: `lint` on the card, and its launch, host-sync,
    # carry and exact-dot checks at full width.
    t0 = time.perf_counter()
    report["lint_path"], lint_launches = lint_path(dict(main_cfgs), dev)
    report["lint_path"]["phase_s"] = time.perf_counter() - t0
    log("lint_path", part="phase", seconds=report["lint_path"]["phase_s"])
    for k, n in lint_launches.items():
        if k in launches:
            launches[k] += n

    # The graph loop on every engine and list path: sweeps, the serving
    # worker's device path and the device surface past four cells.
    t0 = time.perf_counter()
    report["graph_path"], graph_launches = graph_path(
        dict(main_cfgs, **{GRAPH_DENSE[0]: QBAConfig(**GRAPH_DENSE[1],
                                                     trials=32)}), dev)
    report["graph_path"]["phase_s"] = time.perf_counter() - t0
    log("graph_path", part="phase", seconds=report["graph_path"]["phase_s"])
    for k, n in graph_launches.items():
        launches[k] += n

    big = runs[-1]
    kernels = []
    for k in ("fused_round", "trial_megakernel", "tiled_verdict",
              "tiled_rebuild", "round_step"):
        e = big["engines"][ENGINE_OF[k]]
        source, replaces = SOURCES[k]
        # The megakernel's row is its keyed entry, the main path's.
        main = KEYED.get(k, k)
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[main],
            # The round kernels also run their n_recv variants (the mesh
            # path); the megakernel its stacked entry.
            "max_abs_err": max(
                [r["full_width_vs_plain"][k]["max_abs_err"] for r in runs]
                + [random_errs[k], keyed_errs.get(k, 0)]
                + ([random_errs[k + "_n_recv"]]
                   + [r[k + "_n_recv"].get("max_abs_err", 0)
                      for r in mesh_runs]
                   if k + "_n_recv" in N_RECV_KERNELS else [])),
            "ms": e["kernel_ms_per_launch"][main],
            "plain_ms": big["full_width_vs_plain"][k]["plain_ms"],
            "bound_ms": e["bound_ms"][k],
            "bound_by": e["bound_by"][k],
            "library_ms": None,
            "config": f"{big['config']} x{big['trials']} trials",
        })
        if k in KEYED:
            kernels[-1]["stacked_ms"] = big["full_width_vs_plain"][k][
                "stacked_ms"]
            kernels[-1]["rehashes"] = big["full_width_vs_plain"][k][
                "rehashes"]
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
    sbig = stab_runs[-1]
    for k, e in (("gf2_sweep", sbig["sweep"]),
                 ("trial_megakernel_gen", sbig["gen"])):
        source, replaces = SOURCES[k]
        errs = [e["max_abs_err"], sweep_err if k == "gf2_sweep"
                else max([g["max_abs_err"] for g in gen_checks]
                         + [keyed_errs[k]])]
        errs += [r["sweep" if k == "gf2_sweep" else "gen"]["max_abs_err"]
                 for r in stab_runs]
        ms = e["ms"] if k == "gf2_sweep" else sbig["gen_ms_per_launch"]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[KEYED.get(k, k)],
            "max_abs_err": max(errs), "ms": ms, "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": None,
            "config": (f"{sbig['config']} qsim_path=stabilizer "
                       f"x{sbig['trials']} trials"),
        })
        if k in KEYED:
            kernels[-1]["stacked_ms"] = e["stacked_ms"]
            kernels[-1]["rehashes"] = e["rehashes"]
    mbig = mesh_runs[0]
    ring_errs = [ring_err] + [r["ring_leaves"]["max_abs_err"]
                              for r in mesh_runs]
    shard_errs = ([c["max_abs_err"] for c in sharded_checks]
                  + [random_errs["sharded_trial_megakernel"],
                     keyed_errs["sharded_trial_megakernel"]]
                  + [r["sharded_trial_megakernel"]["max_abs_err"]
                     for r in mesh_runs])
    sm = mbig["sharded_trial_megakernel"]
    for k, row in (("sharded_trial_megakernel",
                    dict(max_abs_err=max(shard_errs),
                         ms=mbig["runs"]["auto"]["kernel_ms_per_launch"]
                         ["sharded_trial_megakernel_keyed"],
                         stacked_ms=sm["stacked_ms"],
                         rehashes=sm["rehashes"],
                         plain_ms=sm["plain_ms"], bound_ms=sm["bound_ms"],
                         bound_by=sm["bound_by"], library_ms=None)),
                   ("ring_gather",
                    dict(max_abs_err=max(ring_errs),
                         ms=mbig["runs"]["pallas_fused ring"]
                         ["kernel_ms_per_launch"]["ring_gather"],
                         plain_ms=mbig["ring_leaves"]["plain_ms"],
                         bound_ms=mbig["ring_leaves"]["bound_ms"],
                         bound_by="bytes",
                         library_ms=mbig["ring_leaves"]["library_ms"]))):
        source, replaces = SOURCES[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[KEYED.get(k, k)],
            **row,
            "config": (f"{mbig['config']} x{mbig['trials']} trials, "
                       f"tp={mbig['tp']} on one card"),
        })
    # The draws kernel: every round of the 33p batch in one launch; the
    # main path's per-round engines launch it once a round.
    source, replaces = SOURCES["attack_draws"]
    kernels.append({
        "name": "attack_draws", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["attack_draws"],
        # 32 trials in every law; each main batch whole and a round a
        # launch (``checked_draws`` raises on a mismatch); the message-level
        # backends' presamples (``check_draws``).
        "max_abs_err": max([draws_err] + [r["attack_draws"]["max_abs_err"]
                                          for r in runs]
                           + [r["draws_max_abs_err"] for r in
                              report["run_path"]["runs"]
                              if "draws_max_abs_err" in r]),
        "presample_launches": run_launches["attack_draws"],
        "presample_ms": {r["config"]: r["native"]["presample"][
            "draws_kernel_ms"] for r in report["run_path"]["runs"][:2]},
        **{k: big["attack_draws"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")},
        "ms_per_round_launch": big["engines"]["pallas_fused"]
        ["kernel_ms_per_launch"]["attack_draws"],
        "config": (f"{big['config']} x{big['trials']} trials, "
                   f"{big['rounds']} rounds a launch"),
    })
    # The sweep loop's stop step: the graph loop's own kernel.
    source, replaces = SOURCES["sweep_stop"]
    kernels.append({
        "name": "sweep_stop", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["sweep_stop"],
        "max_abs_err": max(stop_row["max_abs_err"], stop_err,
                           report["serve_path"]["sweep_stop_bits"]
                           ["max_abs_err"]),
        **{k: stop_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "queued_ms")},
        "bits_64": {k: report["serve_path"]["sweep_stop_bits"][k]
                    for k in ("ms", "queued_ms", "plain_ms", "bound_ms")},
        "config": (f"33p/L64/d10 chunk of {stop_row['trials']} trials; "
                   "launched eagerly once and captured once a graph loop "
                   "(the sweep's and the serving worker's), then run once "
                   "a chunk by the graph; bits_64: storing the success "
                   "bits of a 64-trial chunk"),
    })
    # The device surface's two kernels: captured once each a surface graph,
    # then run once a pass.
    surf = report["surface_path"]
    for k, err in (("surface_pick", pick_err), ("surface_fold", fold_err)):
        source, replaces = SOURCES[k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": err,
            **{f: surf["kernels"][k][f] for f in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "queued_ms")},
            "library_note": "none: no PyTorch call sets a graph's handle",
            "config": ("33p/L64/d10 surface of 4 cells, chunks of 1000 "
                       "trials, budget 48; launched eagerly once and "
                       "captured once a surface graph, then run once a "
                       "pass by the graph"),
        })
    # What "launches" counts, and this slice's graph_path share of it.
    for row in kernels:
        row["launches_counted"] = (
            "each wrapper's launches over every phase, eager or into a "
            "graph being captured (a graph loop's chunk twice: its warm-up "
            "and its capture); the graphs' replays count none")
        row["graph_path_launches"] = graph_launches[KEYED.get(row["name"],
                                                              row["name"])]
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
