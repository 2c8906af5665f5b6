"""Measurement-bit decoding — counterpart of :mod:`qba_tpu.core.decode`."""

from __future__ import annotations

import torch


def measure_to_ints(raw: torch.Tensor, size_l: int,
                    n_qubits: int) -> torch.Tensor:
    """Bits ``[..., size_l * n_qubits]`` -> ints ``[..., size_l]``,
    big-endian within each group of ``n_qubits`` bits."""
    bits = raw.reshape(raw.shape[:-1] + (size_l, n_qubits)).to(torch.int32)
    weights = 2 ** torch.arange(n_qubits - 1, -1, -1, dtype=torch.int32,
                                device=raw.device)
    return (bits * weights).sum(-1).to(torch.int32)
