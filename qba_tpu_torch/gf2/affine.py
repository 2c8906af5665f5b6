"""The GF(2) measurement sweep as an affine map of each shot's phases and
coins.

:func:`~qba_tpu_torch.gf2.symplectic.gf2_measure_sweep` chooses its
pivots, row operations and selections from the tableau's x and z bits
alone, and those evolve from the static tableau whatever the phases
``r`` and the coins are.  The phases change affinely over GF(2): a row
that absorbs the pivot takes ``r_h ^= r_p ^ parity(z_h & x_p)``, the new
stabilizer takes the coin, and a deterministic outcome is ``sum_i s_i
r_{n+i}`` plus a term in x and z alone.  So every shot of one tableau
measures

    bits = A . [r ; coins] + c   (mod 2),

with ``A`` ``[n, 3n]`` and ``c`` ``[n]`` fixed by the tableau.
:func:`gf2_affine_map` runs the sweep once with each phase carried as a
symbolic affine form (a packed bit row over the ``2n`` phase variables,
the ``n`` coin variables and a constant) and returns ``A`` and ``c``;
:func:`gf2_affine_bits_reference` evaluates them for a batch of shots in
plain PyTorch.  The sweep kernel (``ops/csrc/gf2_sweep.cu``) evaluates
the same map, so it computes the serial sweep's function exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from qba_tpu_torch.gf2.bitops import n_words, pack_bits, unpack_bits
from qba_tpu_torch.gf2.linalg import gf2_matmul

_ONE = np.uint64(1)


def _pack64(bits: np.ndarray) -> np.ndarray:
    """0/1 ``[rows, m]`` -> uint64 ``[rows, ceil(m / 64)]``, bit ``j`` in
    word ``j >> 6`` at position ``j & 63``."""
    rows, m = bits.shape
    w = -(-m // 64)
    padded = np.zeros((rows, w * 64), np.uint8)
    padded[:, :m] = bits
    return np.packbits(padded, axis=1, bitorder="little").view(np.uint64)


def _unpack64(words: np.ndarray, m: int) -> np.ndarray:
    """Inverse of :func:`_pack64`: uint8 0/1 ``[rows, m]``."""
    return np.unpackbits(words.view(np.uint8), axis=1,
                         bitorder="little")[:, :m]


def _parity64(words: np.ndarray) -> np.ndarray:
    """Parity of the bits along the last axis of uint64 words: uint64 0/1."""
    x = np.bitwise_xor.reduce(words, axis=-1)
    for s in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> np.uint64(s))
    return x & _ONE


def gf2_affine_map(n: int, x0w, z0w) -> tuple[torch.Tensor, torch.Tensor]:
    """The affine map of the measurement sweep of one tableau.

    ``x0w``/``z0w`` are its packed rows, int32 ``[2n, W]`` (rows
    ``0..n-1`` destabilizers, ``n..2n-1`` stabilizers), as
    :func:`~qba_tpu_torch.gf2.symplectic.gf2_measure_sweep` takes them.
    Returns ``(a, c)``: ``a`` int32 ``[n, n_words(2n) + n_words(n)]``,
    row ``q`` the packed coefficients of qubit ``q``'s outcome over the
    phases (the first ``n_words(2n)`` words) and the coins (the rest),
    and ``c`` int32 0/1 ``[n]``, its constant term.  The sweep of a shot
    with phases ``r`` and coins ``k`` measures ``parity(a[q] & [r ; k])
    ^ c[q]`` at every qubit ``q`` (:func:`gf2_affine_bits_reference`).
    """
    x = _pack64(unpack_bits(torch.as_tensor(x0w).cpu(), n).numpy())
    z = _pack64(unpack_bits(torch.as_tensor(z0w).cpu(), n).numpy())
    if x.shape[0] != 2 * n or z.shape != x.shape:
        raise ValueError(f"a tableau of {n} qubits has 2n rows; got "
                         f"{tuple(x0w.shape)} and {tuple(z0w.shape)}")
    # Variables: phases 0..2n-1, coins 2n..3n-1, the constant 3n.
    n_var = 3 * n + 1
    const_w, const_b = (3 * n) >> 6, _ONE << np.uint64((3 * n) & 63)
    forms = _pack64(np.eye(2 * n, n_var, dtype=np.uint8))
    out = np.zeros((n, forms.shape[1]), np.uint64)
    for a in range(n):
        wa, ba = a >> 6, _ONE << np.uint64(a & 63)
        xa = (x[:, wa] & ba) != 0
        stab = np.flatnonzero(xa[n:])
        if stab.size:
            # Random: the pivot p absorbs into every other row with x_a.
            p = n + int(stab[0])
            rows = np.flatnonzero(xa)
            rows = rows[rows != p]
            cross = _parity64(z[rows] & x[p])
            forms[rows] ^= forms[p]
            forms[rows, const_w] ^= cross * const_b
            x[rows] ^= x[p]
            z[rows] ^= z[p]
            # Row surgery: the pivot retires to destabilizer p - n, row p
            # becomes Z_a signed by coin a.
            x[p - n], z[p - n], forms[p - n] = x[p], z[p], forms[p]
            x[p], z[p], forms[p] = 0, 0, 0
            z[p, wa] = ba
            coin = 2 * n + a
            forms[p, coin >> 6] = _ONE << np.uint64(coin & 63)
            out[a] = forms[p]
        else:
            # Deterministic: the selected stabilizers' phases, and the
            # triangular parity sum_{i<j} z_i . x_j over them.
            sel = n + np.flatnonzero(xa[:n])
            if not sel.size:
                continue
            out[a] = np.bitwise_xor.reduce(forms[sel], axis=0)
            pre = np.bitwise_xor.accumulate(z[sel], axis=0)[:-1]
            if pre.size:
                tri = _parity64(np.bitwise_xor.reduce(
                    pre & x[sel[1:]], axis=0))
                out[a, const_w] ^= tri * const_b
    bits = torch.from_numpy(_unpack64(out, n_var).astype(np.int32))
    a_words = torch.cat([pack_bits(bits[:, :2 * n]),
                         pack_bits(bits[:, 2 * n:3 * n])], dim=1)
    return a_words, bits[:, 3 * n].contiguous()


def gf2_affine_bits_reference(n: int, a, c, r, coins,
                              mflip=None) -> torch.Tensor:
    """The map of :func:`gf2_affine_map` on a batch of shots in plain
    PyTorch: int32 bits ``[B, n]`` = ``[r ; coins] . A^T + c`` (mod 2),
    XOR the readout flips.  ``r`` ``[B, 2n]``, ``coins`` and ``mflip``
    ``[B, n]`` (only the low bit of each entry is read); ``a`` and ``c``
    as :func:`gf2_affine_map` returns them."""
    dev = r.device
    wr = n_words(2 * n)
    a = a.to(dev)
    coef = torch.cat([unpack_bits(a[:, :wr], 2 * n),
                      unpack_bits(a[:, wr:], n)], dim=1)       # [n, 3n]
    v = torch.cat([r.to(torch.int32) & 1, coins.to(torch.int32) & 1], dim=1)
    bits = gf2_matmul(v, coef.T.contiguous()) ^ c.to(dev, torch.int32)
    if mflip is not None:
        bits = bits ^ (mflip.to(torch.int32) & 1)
    return bits
