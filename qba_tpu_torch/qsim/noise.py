"""Imperfect quantum resources — counterpart of :mod:`qba_tpu.qsim.noise`.

Per-qubit depolarizing (a uniformly random Pauli with probability ``p``)
and readout flips.  On the factorized and dense paths they reduce
exactly to classical XOR masks on the measured bits (an X or Y error
flips the outcome, a Z error is invisible); the stabilizer paths take the
drawn Pauli itself (:func:`noise_draws`) as a phase edit of the tableau.
The noise stream forks off the measurement key with ``fold_in(key,
NOISE_TAG)``, so zero-noise runs draw exactly the noiseless key tree.
"""

from __future__ import annotations

import torch

from qba_tpu_torch import random as jr

# The JAX package's noise fold_in tag (qba_tpu/qsim/noise.py).
NOISE_TAG = 0x401E


def _draws(keys: torch.Tensor, full: tuple[int, ...], p_depolarize: float,
           p_measure_flip: float):
    """``(bx, bz, mflip)`` int32 0/1 ``[..., *full]`` off each key's
    noise fork: the X and Z components of the drawn Pauli (X -> (1, 0),
    Y -> (1, 1), Z -> (0, 1)) and the readout flips."""
    k_noise = jr.split(jr.fold_in(keys, NOISE_TAG), 3)
    pauli = jr.bernoulli(k_noise[..., 0, :], p_depolarize, full)
    kind = jr.randint(k_noise[..., 1, :], full, 0, 3)
    mflip = jr.bernoulli(k_noise[..., 2, :], p_measure_flip, full)
    return tuple(x.to(torch.int32) for x in
                 (pauli & (kind != 2), pauli & (kind != 0), mflip))


def noise_draws(keys: torch.Tensor, n: int, p_depolarize: float,
                p_measure_flip: float):
    """One shot's channel draws per key: ``(bx, bz, mflip)`` int32
    ``[..., n]``, as the JAX package's ``noise_draws`` for each key."""
    return _draws(keys, (n,), p_depolarize, p_measure_flip)


def _flips(keys: torch.Tensor, full: tuple[int, ...], p_depolarize: float,
           p_measure_flip: float) -> torch.Tensor:
    """int32 0/1 ``[..., *full]`` outcome-bit flips: ``bx ^ mflip``."""
    bx, _bz, mflip = _draws(keys, full, p_depolarize, p_measure_flip)
    return bx ^ mflip


def classical_flips(keys: torch.Tensor, n: int, p_depolarize: float,
                    p_measure_flip: float) -> torch.Tensor:
    """The exact classical reduction for a terminal measurement of ``n``
    qubits: int32 ``[..., n]`` of outcome-bit flips per key."""
    return _flips(keys, (n,), p_depolarize, p_measure_flip)


def classical_flips_shots(key: torch.Tensor, shots: int, n: int,
                          p_depolarize: float,
                          p_measure_flip: float) -> torch.Tensor:
    """Flips for a multi-shot dense run: int32 ``[..., shots, n]``, one
    independent channel per shot, drawn off the run key's noise fork."""
    return _flips(key, (shots, n), p_depolarize, p_measure_flip)


def classical_flip_ints(keys: torch.Tensor, shape: tuple[int, ...],
                        n_qubits: int, p_depolarize: float,
                        p_measure_flip: float) -> torch.Tensor:
    """int32 ``[..., *shape]`` XOR masks in ``[0, 2**n_qubits)``: one
    independent channel per (group, position) qubit block, big-endian."""
    flips = _flips(keys, (*shape, n_qubits), p_depolarize, p_measure_flip)
    shifts = torch.arange(n_qubits - 1, -1, -1, dtype=torch.int32,
                          device=keys.device)
    return (flips << shifts).sum(-1).to(torch.int32)
