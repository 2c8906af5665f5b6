"""Factorized closed-form sampler — counterpart of
:mod:`qba_tpu.qsim.sampler`, the production quantum path.

Not-Q-correlated position: groups 1..n i.i.d. uniform on ``[0, w)``,
group 0 copies group 1.  Q-correlated position: ``r ~ U[0, w)``; group
``i`` measures ``r XOR perm[i-1]`` for a fresh uniform permutation of
``1..n`` (the stable argsort of ``n`` uint32 draws).
"""

from __future__ import annotations

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.config import QBAConfig


def generate_lists(cfg: QBAConfig, keys: torch.Tensor, *,
                   partitionable: bool | None = None):
    """All parties' lists for each trial key ``[..., 2]``.

    Returns ``(lists int32 [..., n_parties+1, size_l], qcorr bool
    [..., size_l])``: row 0 is the QSD's extra copy, row 1 the commander.
    CUDA keys launch the set-up kernel's ``"lists"`` form
    (:func:`~qba_tpu_torch.ops.setup_kernel.setup_kernel`, one launch);
    CPU keys run :func:`generate_lists_plain`.
    """
    from qba_tpu_torch.ops.setup_kernel import setup_kernel

    out = setup_kernel(cfg, keys, "lists", partitionable=partitionable)
    return out.lists, out.qcorr


def generate_lists_plain(cfg: QBAConfig, keys: torch.Tensor, *,
                         partitionable: bool | None = None):
    """:func:`generate_lists` in eager PyTorch on any device: the set-up
    kernel's plain version of the lists."""
    n, w, s = cfg.n_parties, cfg.w, cfg.size_l
    if w & (w - 1) != 0 or n >= w:
        raise ValueError(
            f"sampler range invariant broken: w={w} must be a power of "
            f"two > n_parties={n}; engine verdict identities assume "
            "vals in [0, w)"
        )
    p = jr.resolve_mode(partitionable)
    k = jr.split(keys, 4, partitionable=p)
    qcorr = jr.bernoulli(k[..., 0, :], 0.5, (s,), partitionable=p)
    r = jr.randint(k[..., 1, :], (s,), 0, w, partitionable=p)
    noise = jr.bits(k[..., 2, :], (s, n), partitionable=p)
    perms = (torch.argsort(noise, dim=-1, stable=True) + 1).to(torch.int32)
    rows_q = torch.cat(
        [r[..., None, :], r[..., None, :] ^ perms.transpose(-1, -2)], dim=-2
    )
    u = jr.randint(k[..., 3, :], (n, s), 0, w, partitionable=p)
    rows_nq = torch.cat([u[..., 0:1, :], u], dim=-2)
    lists = torch.where(qcorr[..., None, :], rows_q, rows_nq)
    if cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0:
        from qba_tpu_torch.qsim.noise import classical_flip_ints

        lists = lists ^ classical_flip_ints(
            keys, (n + 1, s), cfg.n_qubits,
            cfg.p_depolarize, cfg.p_measure_flip, partitionable=p,
        )
    return lists, qcorr
