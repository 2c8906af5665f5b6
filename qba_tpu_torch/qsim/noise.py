"""Imperfect quantum resources — counterpart of :mod:`qba_tpu.qsim.noise`
for the factorized sampler.

Per-qubit depolarizing (an X or Y error flips the outcome bit, with
probability ``2p/3``) and readout flips reduce exactly to classical XOR
masks on the decoded values.  The noise stream forks off the measurement
key with ``fold_in(key, NOISE_TAG)``, so zero-noise runs draw exactly the
noiseless key tree.
"""

from __future__ import annotations

import torch

from qba_tpu_torch import random as jr

# The JAX package's noise fold_in tag (qba_tpu/qsim/noise.py).
NOISE_TAG = 0x401E


def classical_flip_ints(keys: torch.Tensor, shape: tuple[int, ...],
                        n_qubits: int, p_depolarize: float,
                        p_measure_flip: float) -> torch.Tensor:
    """int32 ``[..., *shape]`` XOR masks in ``[0, 2**n_qubits)``: one
    independent channel per (group, position) qubit block, big-endian."""
    k_noise = jr.split(jr.fold_in(keys, NOISE_TAG), 3)
    full = (*shape, n_qubits)
    pauli = jr.bernoulli(k_noise[..., 0, :], p_depolarize, full)
    kind = jr.randint(k_noise[..., 1, :], full, 0, 3)
    bx = pauli & (kind != 2)
    mflip = jr.bernoulli(k_noise[..., 2, :], p_measure_flip, full)
    flips = (bx ^ mflip).to(torch.int32)
    shifts = torch.arange(n_qubits - 1, -1, -1, dtype=torch.int32,
                          device=keys.device)
    return (flips << shifts).sum(-1).to(torch.int32)
