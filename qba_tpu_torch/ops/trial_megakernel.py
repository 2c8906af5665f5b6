"""A whole trial in one launch — counterpart of
:func:`qba_tpu.ops.trial_megakernel.build_trial_megakernel`.

:func:`trial_megakernel` runs step 3a, every voting round
``1..n_dishonest+1`` and the lieutenants' decisions for a batch of
trials.  For CUDA tensors it launches the hand-written CUDA kernel
(``csrc/trial_megakernel.cu``, one block per trial, one launch per
batch); for CPU tensors it runs :func:`trial_megakernel_reference`, the
plain PyTorch version, which composes the port's own step 3a, pool
compaction and :func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round_reference`
per round.  A CUDA tensor never reaches the plain version.

The stacked entries take every round's draws pre-sampled and stacked
trial-major, uint8 ``[T, n_rounds, n_pool, n_rv]`` by mailbox cell
(:func:`qba_tpu_torch.ops.attack_draws.attack_draws` over every round);
round ``r`` reads slab ``[:, r - 1]``.  The TPU kernel's ``variant``, ``blk_d``/``blk_v``
and ``trial_pack`` are layout choices of the TPU and have no
counterpart here.

:func:`trial_megakernel_gen` is the TPU kernel's ``gen=True`` form
(``mega_gen="gf2"``): the launch also generates the lists.  Its prologue
measures each trial's ``size_l`` shots with the device function the
standalone sweep kernel runs (``csrc/gf2_sweep.cuh``: each circuit
family's affine map, :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_sweep_tables`),
applies the readout flips, decodes the order values and writes P and
``li`` to scratch, which the body of the host-gen kernel then reads.
Its plain version, :func:`trial_megakernel_gen_reference`, is the plain
sweep, the same decode and :func:`trial_megakernel_reference`.

:func:`sharded_trial_megakernel` is the party-sharded form
(:func:`qba_tpu.ops.trial_megakernel.build_sharded_trial_megakernel`):
the same inputs, and each trial's ``n_tp`` shards run as one
thread-block cluster, block ``s`` draining the receivers ``[s *
n_local, (s + 1) * n_local)``.  Its plain version,
:func:`sharded_trial_megakernel_reference`, is the per-round schedule of
the party-sharded fused engine: each shard's local segment, the
segments assembled every round, and the ``n_recv`` plain fused round.

Each entry has a keyed form (:func:`trial_megakernel_keyed`,
:func:`trial_megakernel_gen_keyed`, :func:`sharded_trial_megakernel_keyed`),
the one the engines launch: it takes each trial's rounds key
``k_rounds`` int64 ``[T, 2]`` and the strategy's context in place of the
draw stacks, and the kernel hashes each draw where it reads it
(``csrc/draws.cuh``), so no stack exists.  Its plain version is
:func:`~qba_tpu_torch.ops.attack_draws.attack_draws_reference` followed by
the stacked entry's plain version.  Each keyed form takes JAX's threefry
mode as ``partitionable`` (None: the current mode) and launches that
mode's instantiation; the phase clock is the partitionable form's.
"""

from __future__ import annotations

import ctypes

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core import decide_order
from qba_tpu_torch.ops._launch import (
    KernelUnsupported,
    check,
    check_kernel_shapes,
    clock_breakdown,
    clock_ptr,
    dispatch,
    kernel_fn,
    no_clock,
    ptrs,
    timed_launch,
)
from qba_tpu_torch.ops.attack_draws import (
    attack_draws_reference,
    keyed_inputs,
    law_ints,
)
from qba_tpu_torch.ops.round_kernel_tiled import (
    assemble_pool,
    _align16,
    fused_round_reference,
    pool_from_step3a,
    shard_receivers,
    unshard_receivers,
)

# The kernel's warps (``kMegaWarps``, ``csrc/mega_phases.cuh``).
MEGA_WARPS = 16
# Entry buffers a warp (``kStages``): the copy pipeline's depth.
MEGA_STAGES = 2
# The phase clock's phases (``csrc/mega_phases.cuh``, ``MegaPhase``), in
# the order of its int64 ``[T, n_tp, len(MEGA_PHASES)]`` buffer.
MEGA_PHASES = ("gen", "entry", "clear", "stage", "verdict", "verdict_wait",
               "dedup", "offsets", "exchange", "rebuild", "written", "exit")


def trial_megakernel_reference(cfg: QBAConfig, p_rows, li, v_sent,
                               honest_c, attack, rand_v, late):
    """Whole trials in plain PyTorch.

    ``p_rows`` bool ``[T, n_rv, size_l]``, ``li`` int32 ``[T, n_rv,
    size_l]``, ``v_sent`` int32 ``[T, n_rv]``, ``honest_c`` int32 ``[T,
    n_pool]``, draws ``[T, n_rounds, n_pool, n_rv]``.  Returns ``(vi int32
    0/1 [T, n_rv, w], decisions int32 [T, n_rv], overflow bool [T])``;
    a decision is ``min(Vi)``, or ``w`` when ``Vi`` is empty.
    """
    from qba_tpu_torch.rounds.engine import step3a_one

    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    pool = pool_from_step3a(cfg, out_cells)
    vi = vi.to(torch.int32)
    overflow = torch.zeros(li.shape[0], dtype=torch.bool, device=li.device)
    for r in range(1, cfg.n_rounds + 1):
        pool, vi, ovf = fused_round_reference(
            cfg, r, pool, li, vi, honest_c, attack[:, r - 1],
            rand_v[:, r - 1], late[:, r - 1],
        )
        overflow |= ovf
    is_comm = torch.zeros(vi.shape[:-1], dtype=torch.bool, device=vi.device)
    decisions = decide_order(vi != 0, v_sent, is_comm, cfg.w)
    return vi, decisions, overflow


def trial_megakernel(cfg: QBAConfig, p_rows, li, v_sent, honest_c, attack,
                     rand_v, late):
    """Whole trials: ``(vi int32 [T, n_rv, w], decisions int32 [T, n_rv],
    overflow bool [T])``.

    CPU tensors run :func:`trial_megakernel_reference`.  CUDA tensors
    launch the CUDA kernel once for the batch; it takes exactly ``p_rows``
    bool, ``li``/``v_sent``/``honest_c`` int32 and the draw stacks uint8,
    contiguous, on one device, and allocates its two ping-pong pools as
    scratch.  Any other input raises.
    """
    if not dispatch("trial_megakernel", (li,)):
        return trial_megakernel_reference(cfg, p_rows, li, v_sent,
                                          honest_c, attack, rand_v, late)
    dev = li.device
    check_kernel_shapes(cfg, "trial megakernel")
    n_trials = _check_trial_inputs(cfg, p_rows, li, v_sent, honest_c)
    _check_stacks(cfg, n_trials, dev, attack, rand_v, late)
    out = _outputs(cfg, n_trials, dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel", 12, 8)
    args = ptrs(p_rows, li, v_sent, honest_c, attack, rand_v, late, *out)
    args += _body_ints(cfg, n_trials)
    timed_launch(trial_megakernel, fn, args, torch.cuda.current_stream(dev))
    return out[-3], out[-2], out[-1] != 0


trial_megakernel.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
trial_megakernel.events = None


def trial_megakernel_keyed_reference(cfg: QBAConfig, p_rows, li, v_sent,
                                     honest_c, k_rounds, ctx, *,
                                     partitionable: bool | None = None):
    """:func:`trial_megakernel_keyed` in plain PyTorch: every round's
    draws (:func:`~qba_tpu_torch.ops.attack_draws.attack_draws_reference`),
    then :func:`trial_megakernel_reference`."""
    return trial_megakernel_reference(
        cfg, p_rows, li, v_sent, honest_c,
        *attack_draws_reference(cfg, k_rounds, ctx,
                                partitionable=partitionable))


def trial_megakernel_keyed(cfg: QBAConfig, p_rows, li, v_sent, honest_c,
                           k_rounds, ctx, clock=None, *,
                           partitionable: bool | None = None):
    """Whole trials that hash their own draws: the results of
    :func:`trial_megakernel` on the draws of ``k_rounds`` (int64 ``[T,
    2]``, each trial's rounds key) and ``ctx``
    (:func:`~qba_tpu_torch.adversary.model.adversary_ctx`).

    CPU tensors run :func:`trial_megakernel_keyed_reference`.  CUDA
    tensors launch the kernel's keyed entry once for the batch, with the
    input rules of :func:`trial_megakernel` for the body's inputs and of
    :func:`~qba_tpu_torch.ops.attack_draws.keyed_inputs` for the keys and
    context; no draw stack is allocated.  ``clock``
    (:func:`phase_clock`) launches the phase clock's instantiation, which
    adds each phase's cycles into it (staged layouts only,
    :func:`mega_staged`; else the launch raises).
    """
    p = jr.resolve_mode(partitionable)
    if not dispatch("trial_megakernel_keyed", (li,)):
        no_clock(clock)
        return trial_megakernel_keyed_reference(
            cfg, p_rows, li, v_sent, honest_c, k_rounds, ctx,
            partitionable=p)
    dev = li.device
    check_kernel_shapes(cfg, "trial megakernel")
    n_trials = _check_trial_inputs(cfg, p_rows, li, v_sent, honest_c)
    keys, law = _keyed(cfg, n_trials, dev, k_rounds, ctx, clock, p)
    out = _outputs(cfg, n_trials, dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel_keyed", 13, 14)
    args = ptrs(p_rows, li, v_sent, honest_c) + keys + ptrs(*out)
    args += [_clock_ptr(clock, n_trials, 1, dev)]
    args += _body_ints(cfg, n_trials) + law
    timed_launch(trial_megakernel_keyed, fn, args,
                 torch.cuda.current_stream(dev))
    return out[-3], out[-2], out[-1] != 0


trial_megakernel_keyed.launches = 0
trial_megakernel_keyed.events = None


def mega_entry_bytes(cfg: QBAConfig) -> int:
    """Bytes of one entry of the megakernel's pools (``MegaEntry``,
    ``csrc/mega_phases.cuh``): meta int32 ``[4]``, lens int32
    ``[max_l]``, P over ``4 * sw`` positions and ``max_l`` rows of ``4 *
    sw`` bytes (``sw = ceil(size_l / 4)``), each part padded to 16
    bytes."""
    sw = -(-cfg.size_l // 4)
    return 16 + _align16(4 * cfg.max_l) + _align16(4 * sw) + _align16(
        4 * sw * cfg.max_l)


def mega_smem_bytes(cfg: QBAConfig, n_tp: int = 1, keyed: bool = True,
                    staged: bool = True) -> int:
    """Dynamic shared memory of a megakernel block (``MegaSmem`` and the
    keyed entries' draw words and rows, ``csrc/trial_megakernel.cu``),
    with or without the warps' entry buffers, for a block of
    ``n_lieutenants / n_tp`` receivers (its lists hold every receiver's:
    a cluster's blocks split the verdict by packets)."""
    n_rv = cfg.n_lieutenants // n_tp
    n_pool = cfg.n_lieutenants * cfg.slots
    sw = -(-cfg.size_l // 4)
    offs = 8 * n_pool + 8 * n_rv + 4 * n_pool + 4 * (-(-n_pool // 32))
    offs += 4 * n_rv * cfg.slots + 4 * n_rv
    misc = _align16(offs + 4 * (n_rv + 1))
    stage = _align16(misc + 32 + 2 * 4 * sw * (cfg.n_lieutenants + 1))
    total = stage + (MEGA_WARPS * MEGA_STAGES * mega_entry_bytes(cfg)
                     if staged else 0)
    return total + ((4 * (8 + 64 + 8) + MEGA_WARPS * 3 * 64) if keyed else 0)


def mega_staged(cfg: QBAConfig, n_tp: int = 1,
                limit: int = 232448) -> bool:
    """Whether a launch stages its entries through the warps' buffers
    (``choose_smem``): where the staged layout fits ``limit``, the card's
    shared memory for one block (the H100's 227 KB by default); else the
    kernel reads the entries where they lie."""
    return mega_smem_bytes(cfg, n_tp) <= limit


def _outputs(cfg: QBAConfig, n_trials: int, device, n_ovf: int | None = None):
    """A launch's scratch and outputs, in the kernels' argument order: the
    two ping-pong pools, uint8 ``[T, n_pool, mega_entry_bytes(cfg)]``
    each (private to the launch and never read before the kernel writes
    them, so they need no fill), then vi, the decisions and the overflow
    flags (``[T]``, or ``[T, n_ovf]`` a shard each)."""
    n_pool = cfg.n_lieutenants * cfg.slots
    pools = [torch.empty((n_trials, n_pool, mega_entry_bytes(cfg)),
                         dtype=torch.uint8, device=device) for _ in "ab"]
    n_rv = cfg.n_lieutenants
    return pools + [
        torch.empty((n_trials, n_rv, cfg.w), dtype=torch.int32, device=device),
        torch.empty((n_trials, n_rv), dtype=torch.int32, device=device),
        torch.empty((n_trials,) if n_ovf is None else (n_trials, n_ovf),
                    dtype=torch.int32, device=device)]


def phase_clock(n_trials: int, n_tp: int = 1, device=None):
    """A zeroed phase-clock buffer, int64 ``[n_trials, n_tp,
    len(MEGA_PHASES)]``, for a keyed entry's ``clock`` argument."""
    return torch.zeros((n_trials, n_tp, len(MEGA_PHASES)), dtype=torch.int64,
                       device=device)


def phase_breakdown(clock) -> dict:
    """A filled phase clock's breakdown (:func:`~qba_tpu_torch.ops._launch.
    clock_breakdown` over :data:`MEGA_PHASES`)."""
    return clock_breakdown(clock, MEGA_PHASES)


def _clock_ptr(clock, n_trials: int, n_tp: int, device):
    """The clock buffer's address after checking it, or None."""
    return clock_ptr(clock, (n_trials, n_tp, len(MEGA_PHASES)), device)


def _body_ints(cfg: QBAConfig, n_trials: int, n_tp: int | None = None):
    """The body's int arguments: the trials (and the shards), the sizes,
    the traitors and the split strategy's forged-presence flag."""
    lead = [n_trials] if n_tp is None else [n_trials, n_tp]
    return lead + [cfg.n_lieutenants, cfg.slots, cfg.max_l, cfg.size_l, cfg.w,
                   cfg.n_dishonest, int(cfg.strategy == "split")]


def _keyed(cfg: QBAConfig, n_trials: int, device, k_rounds, ctx, clock,
           partitionable: bool):
    """The keyed entries' pointer arguments ``(k_rounds, collude targets
    or null, adaptive's orders or null)`` and round-law ints with the
    threefry mode's flag last (1: legacy), from inputs
    :func:`~qba_tpu_torch.ops.attack_draws.keyed_inputs` admits, on
    ``device``, for ``n_trials`` trials.  The phase clock has no legacy
    instantiation: a clock in the legacy mode raises."""
    check("k_rounds", k_rounds, torch.int64, (n_trials, 2), device)
    if clock is not None and not partitionable:
        raise KernelUnsupported("the phase clock is instantiated for the "
                                "partitionable threefry mode only")
    keys = keyed_inputs(cfg, k_rounds, ctx)
    return ([None if x is None else x.data_ptr() for x in keys],
            law_ints(cfg) + [int(not partitionable)])


def sharded_trial_megakernel_reference(cfg: QBAConfig, n_tp: int, p_rows,
                                       li, v_sent, honest_c, attack, rand_v,
                                       late):
    """Whole trials with their receivers in ``n_tp`` shards, in plain
    PyTorch: step 3a, each shard's local segment
    (:func:`~qba_tpu_torch.ops.round_kernel_tiled.pool_from_step3a` with
    its ``start``), then per round the segments assembled in tp order and
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.fused_round_reference`
    with ``n_recv``.  Arguments and results as
    :func:`trial_megakernel_reference`, with every lieutenant's rows."""
    from qba_tpu_torch.rounds.engine import step3a_one

    n_local = cfg.n_lieutenants // n_tp
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    cells = [shard_receivers(x, n_tp) for x in out_cells]
    segs = [pool_from_step3a(cfg, tuple(c[s] for c in cells),
                             start=s * n_local) for s in range(n_tp)]
    pool = tuple(torch.stack(x) for x in zip(*segs))
    li_s = shard_receivers(li, n_tp)
    vi_s = shard_receivers(vi.to(torch.int32), n_tp)
    overflow = torch.zeros(li.shape[0], dtype=torch.bool, device=li.device)
    for r in range(1, cfg.n_rounds + 1):
        whole = assemble_pool(pool)
        pool, vi_s, ovf = fused_round_reference(
            cfg, r, tuple(x.expand((n_tp,) + x.shape) for x in whole),
            li_s, vi_s, honest_c, attack[:, r - 1], rand_v[:, r - 1],
            late[:, r - 1], n_recv=n_local)
        overflow |= ovf.any(0)
    vi = unshard_receivers(vi_s)
    is_comm = torch.zeros(vi.shape[:-1], dtype=torch.bool, device=vi.device)
    decisions = decide_order(vi != 0, v_sent, is_comm, cfg.w)
    return vi, decisions, overflow


def _check_trial_inputs(cfg: QBAConfig, p_rows, li, v_sent, honest_c):
    """Raise unless the host-gen megakernel's body inputs have exactly the
    kernel's dtypes and shapes, contiguous, on ``li``'s device.  Returns
    the trial count."""
    dev, n_trials = li.device, li.shape[0]
    n_rv, s = cfg.n_lieutenants, cfg.size_l
    for name, x, dt, shp in [
        ("p_rows", p_rows, torch.bool, (n_trials, n_rv, s)),
        ("li", li, torch.int32, (n_trials, n_rv, s)),
        ("v_sent", v_sent, torch.int32, (n_trials, n_rv)),
        ("honest_c", honest_c, torch.int32, (n_trials, n_rv * cfg.slots)),
    ]:
        check(name, x, dt, shp, dev)
    return n_trials


def _check_stacks(cfg: QBAConfig, n_trials: int, device, attack, rand_v,
                  late):
    """Raise unless the draw stacks are uint8 ``[T, n_rounds, n_pool,
    n_rv]``, contiguous, on ``device``."""
    n_rv = cfg.n_lieutenants
    stack = (n_trials, cfg.n_rounds, n_rv * cfg.slots, n_rv)
    for name, x in (("attack", attack), ("rand_v", rand_v), ("late", late)):
        check(name, x, torch.uint8, stack, device)


def sharded_trial_megakernel(cfg: QBAConfig, n_tp: int, p_rows, li, v_sent,
                             honest_c, attack, rand_v, late):
    """Whole trials, each trial's receivers in ``n_tp`` shards: ``(vi
    int32 [T, n_rv, w], decisions int32 [T, n_rv], overflow bool [T])``,
    the results of :func:`trial_megakernel` on the same inputs.

    CPU tensors run :func:`sharded_trial_megakernel_reference`.  CUDA
    tensors launch the kernel's sharded entry once for the batch, one
    cluster of ``n_tp`` blocks a trial, with the input rules of
    :func:`trial_megakernel`; ``n_tp`` must be admitted by
    :func:`~qba_tpu_torch.ops.round_kernel_tiled.sharded_mega_plan`
    (a refused cluster launch raises).  The pools, one assembled pair a
    trial, are scratch.
    """
    if not dispatch("sharded_trial_megakernel", (li,)):
        return sharded_trial_megakernel_reference(
            cfg, n_tp, p_rows, li, v_sent, honest_c, attack, rand_v, late)
    _check_shards(cfg, n_tp)
    n_trials = _check_trial_inputs(cfg, p_rows, li, v_sent, honest_c)
    dev = li.device
    _check_stacks(cfg, n_trials, dev, attack, rand_v, late)
    out = _outputs(cfg, n_trials, dev, n_tp)
    fn = kernel_fn("trial_megakernel", "qba_sharded_trial_megakernel", 12, 9)
    args = ptrs(p_rows, li, v_sent, honest_c, attack, rand_v, late, *out)
    args += _body_ints(cfg, n_trials, n_tp)
    timed_launch(sharded_trial_megakernel, fn, args,
                 torch.cuda.current_stream(dev))
    return out[-3], out[-2], (out[-1] != 0).any(-1)


sharded_trial_megakernel.launches = 0
sharded_trial_megakernel.events = None


def sharded_trial_megakernel_keyed_reference(
        cfg: QBAConfig, n_tp: int, p_rows, li, v_sent, honest_c, k_rounds,
        ctx, *, partitionable: bool | None = None):
    """:func:`sharded_trial_megakernel_keyed` in plain PyTorch: every
    round's draws, then :func:`sharded_trial_megakernel_reference`."""
    return sharded_trial_megakernel_reference(
        cfg, n_tp, p_rows, li, v_sent, honest_c,
        *attack_draws_reference(cfg, k_rounds, ctx,
                                partitionable=partitionable))


def sharded_trial_megakernel_keyed(cfg: QBAConfig, n_tp: int, p_rows, li,
                                   v_sent, honest_c, k_rounds, ctx,
                                   clock=None, *,
                                   partitionable: bool | None = None):
    """Whole trials in ``n_tp`` shards that hash their own draws: the
    results of :func:`sharded_trial_megakernel` on the draws of
    ``k_rounds`` and ``ctx``.  CPU tensors run
    :func:`sharded_trial_megakernel_keyed_reference`; CUDA tensors launch
    the sharded entry's keyed form once for the batch, with the input
    rules of :func:`trial_megakernel_keyed` and ``n_tp`` as
    :func:`sharded_trial_megakernel`; ``clock`` as
    :func:`trial_megakernel_keyed`, a row a block."""
    p = jr.resolve_mode(partitionable)
    if not dispatch("sharded_trial_megakernel_keyed", (li,)):
        no_clock(clock)
        return sharded_trial_megakernel_keyed_reference(
            cfg, n_tp, p_rows, li, v_sent, honest_c, k_rounds, ctx,
            partitionable=p)
    _check_shards(cfg, n_tp)
    n_trials = _check_trial_inputs(cfg, p_rows, li, v_sent, honest_c)
    dev = li.device
    keys, law = _keyed(cfg, n_trials, dev, k_rounds, ctx, clock, p)
    out = _outputs(cfg, n_trials, dev, n_tp)
    fn = kernel_fn("trial_megakernel", "qba_sharded_trial_megakernel_keyed",
                   13, 15)
    args = ptrs(p_rows, li, v_sent, honest_c) + keys + ptrs(*out)
    args += [_clock_ptr(clock, n_trials, n_tp, dev)]
    args += _body_ints(cfg, n_trials, n_tp) + law
    timed_launch(sharded_trial_megakernel_keyed, fn, args,
                 torch.cuda.current_stream(dev))
    return out[-3], out[-2], (out[-1] != 0).any(-1)


sharded_trial_megakernel_keyed.launches = 0
sharded_trial_megakernel_keyed.events = None


def _check_shards(cfg: QBAConfig, n_tp: int) -> None:
    """Raise unless the sharded entry takes ``n_tp`` shards of ``cfg``."""
    from qba_tpu_torch.ops.round_kernel_tiled import sharded_mega_plan

    check_kernel_shapes(cfg, "sharded trial megakernel")
    if sharded_mega_plan(cfg, n_tp) is None:
        raise ValueError(f"the sharded trial megakernel takes 1 <= n_tp <= 8 "
                         f"dividing the lieutenants; got n_tp={n_tp} at "
                         f"{cfg.n_lieutenants} lieutenants")


def sharded_megakernel_clusters(cfg: QBAConfig, n_tp: int, device=None):
    """``(shared memory bytes, clusters the card holds at once)`` of the
    sharded entry at ``n_tp`` (``cudaOccupancyMaxActiveClusters``);
    builds the kernel.  Raises on a CUDA error."""
    from qba_tpu_torch.ops._build import load_library

    fn = load_library("trial_megakernel").qba_sharded_megakernel_clusters
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(n_tp, cfg.n_lieutenants, cfg.slots, cfg.max_l, cfg.size_l,
                cfg.w, ctypes.byref(smem), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"sharded megakernel occupancy query failed: "
                           f"CUDA error {rc}")
    return smem.value, clusters.value


def gen_lists_reference(cfg: QBAConfig, gen_tables, gen_ops, v_sent):
    """The gen prologue in plain PyTorch: the plain sweep of every shot
    (:func:`~qba_tpu_torch.ops.gf2_sweep.gf2_sweep_reference`), the
    readout flips, the decode to order values and each lieutenant's P.
    Returns ``(p_rows bool [T, n_rv, S], li int32 [T, n_rv, S])``, what
    :func:`~qba_tpu_torch.rounds.engine.setup_trial` makes of the same
    lists."""
    from qba_tpu_torch.ops.gf2_sweep import gf2_sweep_reference
    from qba_tpu_torch.qsim.protocol_circuits import (
        lists_from_bits,
        stabilizer_bits,
    )
    from qba_tpu_torch.rounds.engine import p_sets

    bits = stabilizer_bits(cfg, gen_tables, gen_ops,
                           sweep=gf2_sweep_reference)
    lists = lists_from_bits(cfg, bits)
    return p_sets(lists, v_sent), lists[:, 2:].to(torch.int32).contiguous()


def trial_megakernel_gen_reference(cfg: QBAConfig, gen_tables, gen_ops,
                                   v_sent, honest_c, attack, rand_v, late):
    """Whole trials with their lists generated, in plain PyTorch:
    :func:`gen_lists_reference`, then :func:`trial_megakernel_reference`.
    Arguments as :func:`trial_megakernel_gen`."""
    p_rows, li = gen_lists_reference(cfg, gen_tables, gen_ops, v_sent)
    return trial_megakernel_reference(cfg, p_rows, li, v_sent, honest_c,
                                      attack, rand_v, late)


def trial_megakernel_gen(cfg: QBAConfig, gen_tables, gen_ops, v_sent,
                         honest_c, attack, rand_v, late):
    """Whole trials from the GF(2) generation operands: ``(vi int32 [T,
    n_rv, w], decisions int32 [T, n_rv], overflow bool [T])``.

    ``gen_tables`` are :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_gen_tables`
    (four int32 ``[2 * total, W]``), ``gen_ops`` are
    :func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_gen_operands`
    of the trials' ``k_lists`` keys (``qcorr`` bool ``[T, S]``, ``coins``
    and ``mflip`` uint8 ``[T, S, total]``, ``r_q`` and ``r_nq`` uint8
    ``[T, S, 2 * total]``); the rest as :func:`trial_megakernel`.

    CPU tensors run :func:`trial_megakernel_gen_reference`.  CUDA tensors
    launch the kernel's gen entry once for the batch, with exactly these
    dtypes, contiguous, on one device; any other input raises.  The
    prologue evaluates ``cfg``'s affine maps
    (:func:`~qba_tpu_torch.qsim.protocol_circuits.stabilizer_sweep_tables`)
    in place of ``gen_tables``, which must be ``cfg``'s.
    """
    if not dispatch("trial_megakernel_gen", (v_sent,)):
        return trial_megakernel_gen_reference(cfg, gen_tables, gen_ops,
                                              v_sent, honest_c, attack,
                                              rand_v, late)
    dev = v_sent.device
    n_trials, gen_ptrs, gen_ints, _keep = _gen_inputs(cfg, gen_tables,
                                                     gen_ops, v_sent, honest_c)
    _check_stacks(cfg, n_trials, dev, attack, rand_v, late)
    out = _outputs(cfg, n_trials, dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel_gen", 18, 10)
    args = gen_ptrs + ptrs(v_sent, honest_c, attack, rand_v, late, *out)
    args += _body_ints(cfg, n_trials) + gen_ints
    timed_launch(trial_megakernel_gen, fn, args,
                 torch.cuda.current_stream(dev))
    return out[-3], out[-2], out[-1] != 0


trial_megakernel_gen.launches = 0
trial_megakernel_gen.events = None


def trial_megakernel_gen_keyed_reference(cfg: QBAConfig, gen_tables,
                                         gen_ops, v_sent, honest_c, k_rounds,
                                         ctx, *,
                                         partitionable: bool | None = None):
    """:func:`trial_megakernel_gen_keyed` in plain PyTorch: every round's
    draws, then :func:`trial_megakernel_gen_reference`."""
    return trial_megakernel_gen_reference(
        cfg, gen_tables, gen_ops, v_sent, honest_c,
        *attack_draws_reference(cfg, k_rounds, ctx,
                                partitionable=partitionable))


def trial_megakernel_gen_keyed(cfg: QBAConfig, gen_tables, gen_ops, v_sent,
                               honest_c, k_rounds, ctx, clock=None, *,
                               partitionable: bool | None = None):
    """Whole trials from the GF(2) generation operands that hash their own
    draws: the results of :func:`trial_megakernel_gen` on the draws of
    ``k_rounds`` and ``ctx``.  CPU tensors run
    :func:`trial_megakernel_gen_keyed_reference`; CUDA tensors launch the
    gen entry's keyed form once for the batch, with the input rules of
    :func:`trial_megakernel_gen` and :func:`trial_megakernel_keyed`
    (``clock`` too)."""
    p = jr.resolve_mode(partitionable)
    if not dispatch("trial_megakernel_gen_keyed", (v_sent,)):
        no_clock(clock)
        return trial_megakernel_gen_keyed_reference(
            cfg, gen_tables, gen_ops, v_sent, honest_c, k_rounds, ctx,
            partitionable=p)
    dev = v_sent.device
    n_trials, gen_ptrs, gen_ints, _keep = _gen_inputs(cfg, gen_tables,
                                                     gen_ops, v_sent, honest_c)
    keys, law = _keyed(cfg, n_trials, dev, k_rounds, ctx, clock, p)
    out = _outputs(cfg, n_trials, dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel_gen_keyed",
                   19, 16)
    args = gen_ptrs + ptrs(v_sent, honest_c) + keys + ptrs(*out)
    args += [_clock_ptr(clock, n_trials, 1, dev)]
    args += _body_ints(cfg, n_trials) + gen_ints + law
    timed_launch(trial_megakernel_gen_keyed, fn, args,
                 torch.cuda.current_stream(dev))
    return out[-3], out[-2], out[-1] != 0


trial_megakernel_gen_keyed.launches = 0
trial_megakernel_gen_keyed.events = None


def _gen_inputs(cfg: QBAConfig, gen_tables, gen_ops, v_sent, honest_c):
    """Check the gen entry's operands (exactly the dtypes and shapes of
    :func:`trial_megakernel_gen`, contiguous, on ``v_sent``'s device) and
    allocate its scratch.  Returns ``(n_trials, the maps', operands' and
    scratch pointers, the gen ints (total, n_qubits), the tensors the
    pointers address)``."""
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_sweep_tables

    dev = v_sent.device
    check_kernel_shapes(cfg, "trial megakernel")
    n_trials = v_sent.shape[0]
    n_rv, s = cfg.n_lieutenants, cfg.size_l
    total = cfg.total_qubits
    words = -(-total // 32)
    qcorr, coins, r_q, r_nq, mflip = gen_ops
    inputs = [(f"table {i}", x, torch.int32, (2 * total, words))
              for i, x in enumerate(gen_tables)]
    inputs += [
        ("qcorr", qcorr, torch.bool, (n_trials, s)),
        ("coins", coins, torch.uint8, (n_trials, s, total)),
        ("r_q", r_q, torch.uint8, (n_trials, s, 2 * total)),
        ("r_nq", r_nq, torch.uint8, (n_trials, s, 2 * total)),
        ("mflip", mflip, torch.uint8, (n_trials, s, total)),
        ("v_sent", v_sent, torch.int32, (n_trials, n_rv)),
        ("honest_c", honest_c, torch.int32, (n_trials, n_rv * cfg.slots)),
    ]
    for name, x, dt, shp in inputs:
        check(name, x, dt, shp, dev)
    # The prologue writes P and li here; the body reads them.
    p_scr = torch.empty((n_trials, n_rv, s), dtype=torch.uint8, device=dev)
    li_scr = torch.empty((n_trials, n_rv, s), dtype=torch.int32, device=dev)
    keep = [stabilizer_sweep_tables(cfg, dev), qcorr, coins, r_q, r_nq, mflip,
            p_scr, li_scr]
    return n_trials, ptrs(*keep), [total, cfg.n_qubits], keep
