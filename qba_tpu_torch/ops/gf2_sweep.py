"""The GF(2) measurement sweep over a batch of shots — the port's
counterpart of the JAX package's XLA host sweep
(:func:`qba_tpu.gf2.symplectic.gf2_measure_sweep`).

:func:`gf2_sweep` measures every qubit of each shot's stabilizer tableau.
For CUDA tensors it launches the hand-written kernel
(``csrc/gf2_sweep.cu``: one warp per shot, running the device function
``sweep_shot`` of ``csrc/gf2_sweep.cuh``, which the trial megakernel's
gen entry runs too); for CPU tensors it runs
:func:`gf2_sweep_reference`, the plain PyTorch version.  A CUDA tensor
never reaches the plain version.

Each shot starts from one of ``F`` static tableaux (a circuit family's
evolved rows), picked by ``family``; the kernel builds it in the warp's
own storage, so no ``[B, 2n, W]`` tensor exists on the card.  Words are
int32 holding the 32-bit patterns (:mod:`qba_tpu_torch.gf2.bitops`).
"""

from __future__ import annotations

import torch

from qba_tpu_torch.gf2.bitops import n_words
from qba_tpu_torch.gf2.symplectic import gf2_measure_sweep
from qba_tpu_torch.ops._launch import check, dispatch, kernel_fn, timed_launch

# Shared memory one SM holds on the H100.
SM_SMEM = 233472
# Warps an SM runs at most (2048 threads), and a block of the kernel.
SM_WARPS = 64
SWEEP_WARPS = 8
# The deterministic branch keeps its running prefix in registers.
MAX_WORDS = 128


def shot_bytes(n: int, w: int) -> int:
    """One shot's tableau slot, as ``gf2_sweep.cuh``'s ``shot_bytes``:
    x and z ``[2n, W]`` words, ``2n`` phase bytes, ``n`` outcome bytes,
    rounded up to 16."""
    return (2 * 2 * n * w * 4 + 2 * n + n + 15) // 16 * 16


def tableau_in_shared(n: int) -> bool:
    """Whether the kernel keeps ``n``-qubit tableaux in shared memory:
    only where an SM's shared memory holds a slot for each of the
    :data:`SM_WARPS` warps it can run, so that the placement costs no
    occupancy (up to 71 qubits: 11 parties, not 33).  Past that each
    warp's tableau is in global scratch.  Each warp's sweep is a serial
    chain of ballots and loads, and the card hides it only with many
    warps: at 33 parties (23,472 B a slot, eight warps an SM in shared
    memory) global scratch took 11.7 ms for 64,000 shots against 22.1
    ms, at 65 parties 73 ms against 379 ms; at 11 parties shared memory
    took 0.943 ms against 1.001 (``chip_smoke.py`` on the H100,
    PERF.md)."""
    return SM_WARPS * shot_bytes(n, n_words(n)) <= SM_SMEM


def gf2_sweep_reference(n: int, xw, zw, r, rnds, family=None, mflip=None,
                        work: dict | None = None) -> torch.Tensor:
    """The sweep in plain PyTorch: each shot's tableau ``xw[family]``,
    :func:`~qba_tpu_torch.gf2.symplectic.gf2_measure_sweep`, then the
    readout flips.  ``work`` as there."""
    fam = (torch.zeros(r.shape[0], dtype=torch.long, device=r.device)
           if family is None else family.long())
    bits = gf2_measure_sweep(n, xw[fam], zw[fam], r, rnds, work=work)
    if mflip is not None:
        bits = bits ^ (mflip.to(torch.int32) & 1)
    return bits


def gf2_sweep(n: int, xw, zw, r, rnds, family=None, mflip=None
              ) -> torch.Tensor:
    """Measure qubits ``0..n-1`` of ``B`` shots: int32 bits ``[B, n]``.

    ``xw``/``zw`` int32 ``[F, 2n, W]`` are the static tableaux,
    ``family`` uint8 ``[B]`` picks one per shot (``None``: the only one),
    ``r`` uint8 ``[B, 2n]`` the shots' phases, ``rnds`` uint8 ``[B, n]``
    their coins and ``mflip`` uint8 ``[B, n]`` (or ``None``) readout flips
    XORed into the bits.

    CPU tensors run :func:`gf2_sweep_reference`.  CUDA tensors launch the
    kernel once, with exactly these dtypes, contiguous, on one device; any
    other input raises.  Blocks are :data:`SWEEP_WARPS` warps, a warp a
    shot; each warp's tableau is in shared memory where
    :func:`tableau_in_shared` says so, one block per eight shots, else in
    per-warp global scratch over enough blocks to fill the card, each
    warp looping over its shots.
    """
    if not dispatch("gf2_sweep", (r,)):
        return gf2_sweep_reference(n, xw, zw, r, rnds, family, mflip)
    dev = r.device
    w = n_words(n)
    if w > MAX_WORDS:
        raise NotImplementedError(
            f"the gf2_sweep kernel takes at most {32 * MAX_WORDS} qubits; "
            f"got {n}")
    b, f = r.shape[0], xw.shape[0]
    check("xw", xw, torch.int32, (f, 2 * n, w), dev)
    check("zw", zw, torch.int32, (f, 2 * n, w), dev)
    check("r", r, torch.uint8, (b, 2 * n), dev)
    check("rnds", rnds, torch.uint8, (b, n), dev)
    if family is None:
        if f != 1:
            raise ValueError(f"{f} tableaux need a family per shot")
    else:
        check("family", family, torch.uint8, (b,), dev)
        if b and int(family.max()) >= f:
            raise ValueError(f"a family index is past the {f} tableaux")
    if mflip is not None:
        check("mflip", mflip, torch.uint8, (b, n), dev)
    slot = shot_bytes(n, w)
    warps = SWEEP_WARPS
    grid = -(-b // warps)
    scratch = None
    if not tableau_in_shared(n):
        # Enough warps to fill every SM; each loops over its shots in its
        # own slot of scratch.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = min(-(-b // warps), sms * SM_WARPS // warps)
        scratch = torch.empty(grid * warps * slot, dtype=torch.uint8,
                              device=dev)
    bits = torch.empty((b, n), dtype=torch.int32, device=dev)
    # The kernel keeps each tableau word-major, [W, 2n].
    xt, zt = (t.transpose(1, 2).contiguous() for t in (xw, zw))
    fn = kernel_fn("gf2_sweep", "qba_gf2_sweep", 8, 6)
    args = [xt.data_ptr(), zt.data_ptr(),
            None if family is None else family.data_ptr(), r.data_ptr(),
            rnds.data_ptr(), None if mflip is None else mflip.data_ptr(),
            bits.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, n, w, warps, grid, slot]
    timed_launch(gf2_sweep, fn, args, torch.cuda.current_stream(dev))
    return bits


gf2_sweep.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
gf2_sweep.events = None
