"""Bit-packed GF(2) vectors — counterpart of :mod:`qba_tpu.gf2.bitops`.

A GF(2) vector of ``n`` bits occupies ``ceil(n / 32)`` words: bit ``j``
lives in word ``j >> 5`` at position ``j & 31``.  The JAX package holds
the words as uint32; PyTorch has no uint32 shift on every device, so the
port holds the same 32-bit patterns as **int32** (bit 31 is the sign
bit): ``words.numpy().view(np.uint32)`` gives JAX's words back.  Only
XOR, AND and right shifts followed by ``& 1`` touch them, which read the
same bits on either type.  PyTorch has no popcount, so parities are XOR
folds.
"""

from __future__ import annotations

import torch

#: Bits per packed word.
WORD = 32
_M32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    """Words needed for ``n_bits`` GF(2) entries."""
    return -(-n_bits // WORD)


def to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` as the int32 with the same bits."""
    return (((v + 2**31) & _M32) - 2**31).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack 0/1 entries along the last axis: ``[..., n] -> [..., W]``
    int32.  Only the low bit of each entry is read."""
    n = bits.shape[-1]
    w = n_words(n)
    b = bits.to(torch.int64) & 1
    pad = w * WORD - n
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (w, WORD))
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return to_int32((b << shifts).sum(-1))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., W] -> [..., n_bits]`` int32."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    bits = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return bits[..., :n_bits].to(torch.int32)


def get_bit(words: torch.Tensor, j: int) -> torch.Tensor:
    """Bit ``j`` along the last axis: ``[..., W] -> [...]`` int32 0/1."""
    return (words[..., j >> 5] >> (j & 31)) & 1


def unit_words(n_bits: int, j: int, device=None) -> torch.Tensor:
    """Packed standard basis vector ``e_j``: ``[W]`` int32."""
    out = torch.zeros(n_words(n_bits), dtype=torch.int64, device=device)
    out[j >> 5] = 1 << (j & 31)
    return to_int32(out)


def word_parity(words: torch.Tensor) -> torch.Tensor:
    """Parity of each 32-bit word, int32 0/1, by an XOR fold.  The
    arithmetic right shift of int32 copies the sign into the high bits
    only; bit 0 of the fold reads bits 0..31 alone."""
    x = words.to(torch.int32)
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def parity_words(words: torch.Tensor, axis=-1) -> torch.Tensor:
    """Parity (XOR-reduce) of all bits along packed axis or axes
    ``axis``: int32 in {0, 1}."""
    return (word_parity(words).sum(dim=axis) & 1).to(torch.int32)


def mask_words(mask: torch.Tensor) -> torch.Tensor:
    """0/1 (or bool) mask -> all-ones/all-zeros int32 word mask."""
    return torch.where(mask.to(torch.int32) != 0, -1, 0).to(torch.int32)


def prefix_xor_exclusive(words: torch.Tensor, axis: int) -> torch.Tensor:
    """Exclusive running XOR along ``axis``: output fiber ``i`` is the XOR
    of input fibers ``0..i-1`` (fiber 0 is all zeros).  A log-step
    (Hillis-Steele) scan, where the JAX package uses
    ``lax.associative_scan``."""
    x = words.movedim(axis, 0)
    n = x.shape[0]
    shift = 1
    while shift < n:
        x = torch.cat([x[:shift], x[shift:] ^ x[:-shift]])
        shift *= 2
    x = torch.cat([torch.zeros_like(x[:1]), x[:-1]])
    return x.movedim(0, axis)
