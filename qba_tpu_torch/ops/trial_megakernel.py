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
counterpart here; its ``gen=True`` GF(2) prologue waits for ROADMAP A7.
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
