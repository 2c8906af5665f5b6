"""GF(2) linear algebra — counterpart of :mod:`qba_tpu.gf2.linalg`.

``gf2_matmul`` is a parity product of 0/1 matrices.  PyTorch has no
integer matmul on CUDA, so the port keeps the JAX package's form: a
K-tiled float32 product, each tile reduced mod 2 and the tiles
XOR-combined.  The value bound that keeps it exact: the operands are 0/1
(exact in every float format) and a tile sums at most
:data:`GF2_TILE_K` ``= 2048 = 2**11`` products, so its sum is exact even
where partial sums are held at TF32's 11-bit precision, let alone
float32's 24.  The rank-1 update and the triangular parity work on
packed words (:mod:`qba_tpu_torch.gf2.bitops`): XOR, AND and XOR-fold
parities, exact by construction.
"""

from __future__ import annotations

import torch

from qba_tpu_torch.gf2.bitops import mask_words, parity_words, prefix_xor_exclusive

#: Max contraction length per float tile (see the module docstring).
GF2_TILE_K = 2048


def gf2_matmul(a: torch.Tensor, b: torch.Tensor, *,
               tile_k: int = GF2_TILE_K) -> torch.Tensor:
    """Parity matmul ``c[..., i, j] = XOR_k a[..., i, k] & b[..., k, j]``
    of 0/1 integer (or bool) tensors; leading axes broadcast as in
    ``torch.matmul``.  Returns int32 in {0, 1}."""
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(
            f"gf2_matmul: contraction mismatch {tuple(a.shape)} @ "
            f"{tuple(b.shape)}")
    if tile_k < 1 or tile_k > GF2_TILE_K:
        raise ValueError(
            f"tile_k={tile_k} must be in [1, {GF2_TILE_K}]: larger tiles "
            "let a per-tile sum leave the exact range")
    k = a.shape[-1]
    if k == 0:
        shape = (*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]),
                 a.shape[-2], b.shape[-1])
        return torch.zeros(shape, dtype=torch.int32, device=a.device)
    af = (a.to(torch.int32) & 1).to(torch.float32)
    bf = (b.to(torch.int32) & 1).to(torch.float32)
    acc = None
    for k0 in range(0, k, tile_k):
        part = torch.matmul(af[..., :, k0:k0 + tile_k],
                            bf[..., k0:k0 + tile_k, :])
        tile = part.to(torch.int32) & 1
        acc = tile if acc is None else acc ^ tile
    return acc


def gf2_matvec(m: torch.Tensor, v: torch.Tensor, *,
               tile_k: int = GF2_TILE_K) -> torch.Tensor:
    """Parity mat-vec ``[..., m, k] @ [..., k] -> [..., m]``."""
    return gf2_matmul(m, v[..., None], tile_k=tile_k)[..., 0]


def rank1_update_packed(m_words: torch.Tensor, mask: torch.Tensor,
                        row_words: torch.Tensor) -> torch.Tensor:
    """Masked rank-1 update on packed rows: ``m ^= outer(mask, row)``;
    ``m_words`` ``[..., R, W]``, ``mask`` ``[..., R]`` 0/1, ``row_words``
    ``[..., W]``."""
    return m_words ^ (mask_words(mask)[..., None] & row_words[..., None, :])


def triangular_parity(z_words: torch.Tensor,
                      x_words: torch.Tensor) -> torch.Tensor:
    """Parity of ``sum_{a<b} z_a . x_b`` over the rows (axis -2) of packed
    operands whose unselected rows are already zero: an exclusive
    prefix-XOR over rows, one AND and a parity."""
    prefix = prefix_xor_exclusive(z_words, axis=-2)
    return parity_words(prefix & x_words, axis=(-2, -1))
