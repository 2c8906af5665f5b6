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

The draws of every round arrive pre-sampled and stacked trial-major,
uint8 ``[T, n_rounds, n_pool, n_rv]`` by mailbox cell
(:func:`qba_tpu_torch.rounds.engine._stacked_draws`); round ``r`` reads
slab ``[:, r - 1]``.  The TPU kernel's ``variant``, ``blk_d``/``blk_v``
and ``trial_pack`` are layout choices of the TPU and have no
counterpart here.

:func:`trial_megakernel_gen` is the TPU kernel's ``gen=True`` form
(``mega_gen="gf2"``): the launch also generates the lists.  Its prologue
sweeps each trial's ``size_l`` stabilizer tableaux with the device
function the standalone sweep kernel runs (``csrc/gf2_sweep.cuh``),
applies the readout flips, decodes the order values and writes P and
``li`` to scratch, which the body of the host-gen kernel then reads.
Its plain version, :func:`trial_megakernel_gen_reference`, is the plain
sweep, the same decode and :func:`trial_megakernel_reference`.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.core import decide_order
from qba_tpu_torch.ops._launch import (
    check,
    check_kernel_shapes,
    dispatch,
    kernel_fn,
    ptrs,
    timed_launch,
)
from qba_tpu_torch.ops.round_kernel_tiled import (
    empty_pool,
    fused_round_reference,
    pool_from_step3a,
)

# The kernel's warps: the gen prologue sweeps one shot per warp at a
# time, each in its own slot of per-trial global scratch.
MEGA_WARPS = 8


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
    n_trials = li.shape[0]
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    stack = (n_trials, cfg.n_rounds, n_pool, n_rv)
    for name, x, dt, shp in [
        ("p_rows", p_rows, torch.bool, (n_trials, n_rv, s)),
        ("li", li, torch.int32, (n_trials, n_rv, s)),
        ("v_sent", v_sent, torch.int32, (n_trials, n_rv)),
        ("honest_c", honest_c, torch.int32, (n_trials, n_pool)),
        ("attack", attack, torch.uint8, stack),
        ("rand_v", rand_v, torch.uint8, stack),
        ("late", late, torch.uint8, stack),
    ]:
        check(name, x, dt, shp, dev)
    # The pools are private to the launch and never read before the
    # kernel writes them, so they need no fill.
    layout = [(x.shape, x.dtype) for x in empty_pool(cfg, n_trials, "meta")]
    pools = [[torch.empty(shape, dtype=dt, device=dev) for shape, dt in layout]
             for _ in "ab"]
    vi = torch.empty((n_trials, n_rv, w), dtype=torch.int32, device=dev)
    dec = torch.empty((n_trials, n_rv), dtype=torch.int32, device=dev)
    ovf = torch.empty(n_trials, dtype=torch.int32, device=dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel", 18, 8)
    args = ptrs(p_rows, li, v_sent, honest_c, attack, rand_v, late,
                 *pools[0], *pools[1], vi, dec, ovf)
    args += [n_trials, n_rv, cfg.slots, cfg.max_l, s, w, cfg.n_dishonest,
             int(cfg.strategy == "split")]
    timed_launch(trial_megakernel, fn, args, torch.cuda.current_stream(dev))
    return vi, dec, ovf != 0


trial_megakernel.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
trial_megakernel.events = None


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
    prologue's tableaux live in per-warp global scratch, so the block
    keeps the round body's shared memory and its three blocks per SM.
    Shared-memory slots were level on the H100 at 11 parties (1.403
    against 1.407 ms a 1000-trial batch) and at 33 parties left one
    block per SM, 39.1 ms against 24.3 (``chip_smoke.py``, PERF.md).
    """
    from qba_tpu_torch.ops.gf2_sweep import MAX_WORDS, shot_bytes

    if not dispatch("trial_megakernel_gen", (v_sent,)):
        return trial_megakernel_gen_reference(cfg, gen_tables, gen_ops,
                                              v_sent, honest_c, attack,
                                              rand_v, late)
    dev = v_sent.device
    check_kernel_shapes(cfg, "trial megakernel")
    n_trials = v_sent.shape[0]
    n_rv, s, w = cfg.n_lieutenants, cfg.size_l, cfg.w
    total = cfg.total_qubits
    words = -(-total // 32)
    if words > MAX_WORDS:
        raise NotImplementedError(
            f"the gen entry takes at most {32 * MAX_WORDS} qubits; got "
            f"{total}")
    n_pool = n_rv * cfg.slots
    stack = (n_trials, cfg.n_rounds, n_pool, n_rv)
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
        ("honest_c", honest_c, torch.int32, (n_trials, n_pool)),
        ("attack", attack, torch.uint8, stack),
        ("rand_v", rand_v, torch.uint8, stack),
        ("late", late, torch.uint8, stack),
    ]
    for name, x, dt, shp in inputs:
        check(name, x, dt, shp, dev)
    slot = shot_bytes(total, words)
    scratch = torch.empty(n_trials * MEGA_WARPS * slot, dtype=torch.uint8,
                          device=dev)
    # The prologue writes P and li here; the body reads them.
    p_scr = torch.empty((n_trials, n_rv, s), dtype=torch.uint8, device=dev)
    li_scr = torch.empty((n_trials, n_rv, s), dtype=torch.int32, device=dev)
    layout = [(x.shape, x.dtype) for x in empty_pool(cfg, n_trials, "meta")]
    pools = [[torch.empty(shape, dtype=dt, device=dev) for shape, dt in layout]
             for _ in "ab"]
    vi = torch.empty((n_trials, n_rv, w), dtype=torch.int32, device=dev)
    dec = torch.empty((n_trials, n_rv), dtype=torch.int32, device=dev)
    ovf = torch.empty(n_trials, dtype=torch.int32, device=dev)
    fn = kernel_fn("trial_megakernel", "qba_trial_megakernel_gen", 28, 12)
    # The kernel keeps each tableau word-major, [W, 2 * total].
    tables_t = [t.t().contiguous() for t in gen_tables]
    args = ptrs(*tables_t, qcorr, coins, r_q, r_nq, mflip, p_scr, li_scr,
                scratch, v_sent, honest_c, attack, rand_v, late, *pools[0],
                *pools[1], vi, dec, ovf)
    args += [n_trials, n_rv, cfg.slots, cfg.max_l, s, w, cfg.n_dishonest,
             int(cfg.strategy == "split"), total, words, cfg.n_qubits, slot]
    timed_launch(trial_megakernel_gen, fn, args,
                 torch.cuda.current_stream(dev))
    return vi, dec, ovf != 0


trial_megakernel_gen.launches = 0
trial_megakernel_gen.events = None
