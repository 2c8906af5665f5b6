"""The GF(2) measurement sweep over a batch of shots — the port's
counterpart of the JAX package's XLA host sweep
(:func:`qba_tpu.gf2.symplectic.gf2_measure_sweep`).

:func:`gf2_sweep` measures every qubit of each shot's stabilizer tableau.
Each shot starts from one of ``F`` static tableaux (a circuit family's
evolved rows), picked by ``family``.  A shot's outcomes are an affine
map of its phases and coins, fixed per family
(:mod:`qba_tpu_torch.gf2.affine`), so for CUDA tensors the hand-written
kernel (``csrc/gf2_sweep.cu``, a warp a shot, running the device function
``shot_bits`` of ``csrc/gf2_sweep.cuh``, which the trial megakernel's gen
entry runs too) evaluates the families' maps, laid out by
:func:`sweep_tables`; it reads no tableau.  For CPU tensors it
runs :func:`gf2_sweep_reference`, the serial sweep in plain PyTorch, which
is the plain version the kernel is held against bit for bit.  A CUDA
tensor never reaches the plain version.  Words are int32 holding the
32-bit patterns (:mod:`qba_tpu_torch.gf2.bitops`).
"""

from __future__ import annotations

import torch

from qba_tpu_torch.gf2.affine import gf2_affine_map
from qba_tpu_torch.gf2.bitops import n_words, pack_bits
from qba_tpu_torch.gf2.symplectic import gf2_measure_sweep
from qba_tpu_torch.ops._launch import check, dispatch, kernel_fn, timed_launch

# The families' tables go into each block's shared memory up to this
# size, two blocks of 16 warps an SM (the 11 and 33 party tables, 10,240 B
# and 37,632 B); past it (65 parties, 172,800 B) the kernel reads them
# where they lie.
SMEM_TABLES = 113 * 1024


def tables_in_shared(tables: torch.Tensor) -> bool:
    """Whether the kernel copies ``tables`` into each block's shared
    memory (:data:`SMEM_TABLES`)."""
    return tables.numel() * 4 <= SMEM_TABLES


def table_dims(n: int) -> tuple[int, int, int, int]:
    """``(wr, wc, wt, n_pad)`` of an ``n``-qubit family's table, as
    ``gf2_sweep.cuh``'s ``affine_dims``: phase words, coin words, words a
    row with the constant's, and ``n`` rounded up to 32."""
    wr, wc = n_words(2 * n), n_words(n)
    return wr, wc, wr + wc + 1, 32 * n_words(n)


def sweep_tables(n: int, xw, zw) -> torch.Tensor:
    """The kernel's tables of ``F`` tableaux ``xw``/``zw`` int32 ``[F, 2n,
    W]``: int32 ``[F, wt, n_pad]`` on the CPU, family ``f``'s
    :func:`~qba_tpu_torch.gf2.affine.gf2_affine_map` word-major (word
    ``k`` of qubit ``q``'s row at ``[f, k, q]``), the constant as the last
    word.  Runs the symbolic sweep of each tableau on the host (copying
    the tableaux there): build them once for tableaux swept again."""
    _wr, _wc, wt, n_pad = table_dims(n)
    out = torch.zeros((xw.shape[0], wt, n_pad), dtype=torch.int32)
    for f in range(xw.shape[0]):
        a, c = gf2_affine_map(n, xw[f], zw[f])
        out[f, :wt - 1, :n] = a.T
        out[f, wt - 1, :n] = c
    return out


def affine_sweep_reference(n: int, tables, r, rnds, family=None,
                           mflip=None) -> torch.Tensor:
    """What the kernel computes from ``tables`` (:func:`sweep_tables`), in
    plain PyTorch: each shot's input words ``[r ; coins ; 1]``, ANDed
    with its family's row words, folded and reduced to their parity, XOR
    the readout flips.  Equal to :func:`gf2_sweep_reference` on the
    tableaux the tables were built from; a check of the layout."""
    dev = r.device
    wr, wc, wt, _n_pad = table_dims(n)
    b = r.shape[0]
    fam = (torch.zeros(b, dtype=torch.long, device=dev) if family is None
           else family.long())
    v = torch.cat([pack_bits(r), pack_bits(rnds),
                   torch.ones((b, 1), dtype=torch.int32, device=dev)], dim=1)
    rows = tables.to(dev)[fam][:, :, :n]                      # [B, wt, n]
    acc = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for k in range(wt):
        acc ^= rows[:, k] & v[:, k, None]
    for s in (16, 8, 4, 2, 1):
        acc = acc ^ (acc >> s)
    bits = acc & 1
    if mflip is not None:
        bits = bits ^ (mflip.to(torch.int32) & 1)
    return bits


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


def gf2_sweep(n: int, xw, zw, r, rnds, family=None, mflip=None, *,
              tables=None) -> torch.Tensor:
    """Measure qubits ``0..n-1`` of ``B`` shots: int32 bits ``[B, n]``.

    ``xw``/``zw`` int32 ``[F, 2n, W]`` are the static tableaux,
    ``family`` uint8 ``[B]`` picks one per shot (``None``: the only one),
    ``r`` uint8 ``[B, 2n]`` the shots' phases, ``rnds`` uint8 ``[B, n]``
    their coins and ``mflip`` uint8 ``[B, n]`` (or ``None``) readout flips
    XORed into the bits.

    CPU tensors run :func:`gf2_sweep_reference`.  CUDA tensors launch the
    kernel once, with exactly these dtypes, contiguous, on one device; any
    other input raises.  The kernel reads ``tables``,
    :func:`sweep_tables` of ``xw`` and ``zw`` on ``r``'s device; without
    them they are built here, which copies the tableaux to the host and
    waits for the card: a caller that sweeps the same tableaux again
    builds them once and passes them.
    """
    if not dispatch("gf2_sweep", (r,)):
        return gf2_sweep_reference(n, xw, zw, r, rnds, family, mflip)
    dev = r.device
    w = n_words(n)
    b, f = r.shape[0], xw.shape[0]
    _wr, _wc, wt, n_pad = table_dims(n)
    check("xw", xw, torch.int32, (f, 2 * n, w), dev)
    check("zw", zw, torch.int32, (f, 2 * n, w), dev)
    if tables is None:
        tables = sweep_tables(n, xw, zw).to(dev)
    check("tables", tables, torch.int32, (f, wt, n_pad), dev)
    check("r", r, torch.uint8, (b, 2 * n), dev)
    check("rnds", rnds, torch.uint8, (b, n), dev)
    if family is None:
        if f != 1:
            raise ValueError(f"{f} tableaux need a family per shot")
    else:
        # A family past the tableaux stops the kernel at a device-side
        # assert: checking it here would wait for the card.
        check("family", family, torch.uint8, (b,), dev)
    if mflip is not None:
        check("mflip", mflip, torch.uint8, (b, n), dev)
    bits = torch.empty((b, n), dtype=torch.int32, device=dev)
    fn = kernel_fn("gf2_sweep", "qba_gf2_sweep", 6, 4)
    args = [tables.data_ptr(),
            None if family is None else family.data_ptr(), r.data_ptr(),
            rnds.data_ptr(), None if mflip is None else mflip.data_ptr(),
            # qba-lint: sync-ok (a Python bool)
            bits.data_ptr(), b, n, f, int(tables_in_shared(tables))]
    timed_launch(gf2_sweep, fn, args, torch.cuda.current_stream(dev))
    return bits


gf2_sweep.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
gf2_sweep.events = None
