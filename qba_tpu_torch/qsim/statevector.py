"""Dense statevector functions — counterpart of
:mod:`qba_tpu.qsim.statevector`, the plain per-gate engine.

A batch of ``n``-qubit states is a complex64 tensor ``[B, 2, ..., 2]``:
axis 0 is the batch (one circuit run per row), qubit ``q`` is axis
``q + 1``, so qubit 0 is the most significant bit of the flat index, as
in the JAX package.  Gate application is axis algebra; measurement is
Born sampling over the flat amplitudes by the Gumbel-max rule of
:func:`qba_tpu_torch.random.categorical`, which draws the same uniforms
as ``jax.random.categorical``.
"""

from __future__ import annotations

import numpy as np
import torch

from qba_tpu_torch import random as jr

_SQRT2 = np.sqrt(2.0).astype(np.float32)
H = np.asarray([[1.0, 1.0], [1.0, -1.0]], dtype=np.complex64) / _SQRT2
X = np.asarray([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex64)
Y = np.asarray([[0.0, -1.0j], [1.0j, 0.0]], dtype=np.complex64)
Z = np.asarray([[1.0, 0.0], [0.0, -1.0]], dtype=np.complex64)
S = np.asarray([[1.0, 0.0], [0.0, 1.0j]], dtype=np.complex64)
T = np.asarray(
    [[1.0, 0.0], [0.0, np.exp(0.25j * np.pi)]], dtype=np.complex64
)
I2 = np.eye(2, dtype=np.complex64)

GATES = {"H": H, "X": X, "Y": Y, "Z": Z, "S": S, "T": T, "I": I2}

# Parameterized single-qubit families (static angle -> constant matrix).
_ROTATIONS = {
    "RX": lambda t: np.asarray(
        [
            [np.cos(t / 2), -1j * np.sin(t / 2)],
            [-1j * np.sin(t / 2), np.cos(t / 2)],
        ],
        dtype=np.complex64,
    ),
    "RY": lambda t: np.asarray(
        [
            [np.cos(t / 2), -np.sin(t / 2)],
            [np.sin(t / 2), np.cos(t / 2)],
        ],
        dtype=np.complex64,
    ),
    "RZ": lambda t: np.asarray(
        [[np.exp(-0.5j * t), 0.0], [0.0, np.exp(0.5j * t)]],
        dtype=np.complex64,
    ),
    "P": lambda t: np.asarray(
        [[1.0, 0.0], [0.0, np.exp(1j * t)]], dtype=np.complex64
    ),
}

# Elements of Gumbel noise drawn at once by the measurement functions:
# each element costs several int64 temporaries in the eager threefry.
SAMPLE_CHUNK_ELEMS = 1 << 24


def gate_matrix(kind: str, angle: float | None = None) -> np.ndarray:
    """Static 2x2 complex64 matrix for a gate kind: the fixed gates
    (H/X/Y/Z/S/T) take no angle, the rotation families (RX/RY/RZ/P)
    require one.  Controlled gates are the base gate plus ``controls`` at
    the circuit layer; the runtime ``XPOW`` is not a static matrix."""
    if kind in GATES:
        if angle is not None:
            raise ValueError(f"gate {kind!r} takes no angle")
        return GATES[kind]
    if kind in _ROTATIONS:
        if angle is None:
            raise ValueError(f"gate {kind!r} requires an angle")
        return _ROTATIONS[kind](float(angle))
    raise ValueError(f"unknown gate kind {kind!r}")


def init_state(n: int, batch: int = 1, device=None) -> torch.Tensor:
    """``batch`` copies of |0...0> on ``n`` qubits."""
    state = torch.zeros((batch, 1 << n), dtype=torch.complex64, device=device)
    state[:, 0].fill_(1.0)  # a fill, no scalar tensor from the host
    return state.reshape((batch,) + (2,) * n)


# Static gate matrices already copied to a device, by (matrix bytes,
# device): each constant crosses to a device once, so a CUDA graph that
# captures a circuit after a warm-up run copies nothing from the host.
_ON_DEVICE: dict = {}


def _as_matrix(mat, device) -> torch.Tensor:
    """``mat`` as complex64 on ``device``.  A numpy matrix is a
    constant: its device copy is made once per device and shared (read
    it, never write it)."""
    if isinstance(mat, torch.Tensor):
        return mat.to(device=device, dtype=torch.complex64)
    host = np.ascontiguousarray(mat, dtype=np.complex64)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (host.tobytes(), host.shape, dev)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.from_numpy(host).to(dev)
    return _ON_DEVICE[key]


def apply_1q(state: torch.Tensor, mat, target: int) -> torch.Tensor:
    """Apply a 2x2 ``mat`` (one matrix, or one per batch row as ``[B, 2,
    2]``) to qubit ``target``."""
    mat = _as_matrix(mat, state.device)
    moved = torch.movedim(state, target + 1, -1)
    # qba-lint: exact-dot (complex amplitudes, not integer data: exempt)
    out = torch.matmul(moved.reshape(state.shape[0], -1, 2),
                       mat.transpose(-1, -2))
    return torch.movedim(out.reshape(moved.shape), -1, target + 1)


def apply_controlled_1q(state: torch.Tensor, mat, target: int,
                        controls: tuple[int, ...]) -> torch.Tensor:
    """Apply ``mat`` to ``target`` where all ``controls`` qubits are |1>."""
    if not controls:
        return apply_1q(state, mat, target)
    n = state.dim() - 1
    ctrls = sorted(controls)
    rest = [q for q in range(n) if q not in ctrls and q != target]
    perm = [0] + [q + 1 for q in ctrls + [target] + rest]
    moved = state.permute(perm).clone()
    index = (slice(None),) + (1,) * len(ctrls)
    moved[index] = apply_1q(moved[index], mat, 0)
    inv = [0] * len(perm)
    for i, q in enumerate(perm):
        inv[q] = i
    return moved.permute(inv)


def xpow_matrix(bit: torch.Tensor) -> torch.Tensor:
    """``X**bit`` for runtime 0/1 bits ``[B]``: I where 0, X where 1, as
    complex64 ``[B, 2, 2]``."""
    b = bit.to(torch.complex64)[..., None, None]
    dev = bit.device
    return _as_matrix(I2, dev) * (1 - b) + _as_matrix(X, dev) * b


def _bits_of(idx: torch.Tensor, n: int) -> torch.Tensor:
    shifts = torch.arange(n - 1, -1, -1, device=idx.device)
    return ((idx[..., None] >> shifts) & 1).to(torch.int32)


def measure_all(state: torch.Tensor, keys: torch.Tensor, *,
                partitionable: bool | None = None) -> torch.Tensor:
    """One computational-basis sample of every qubit per key.

    ``state`` is flat, ``[2**n]`` (one state for every key) or ``[K,
    2**n]`` (one per key); ``keys`` ``[K, 2]``.  Returns int32 bits ``[K,
    n]``, qubit ``q`` at index ``q``.  The Gumbel noise is ``2**n``
    floats per key, drawn :data:`SAMPLE_CHUNK_ELEMS` elements at a time.
    """
    size = state.shape[-1]
    n = size.bit_length() - 1
    p = jr.resolve_mode(partitionable)
    logits = torch.log(torch.abs(state) ** 2)
    step = max(1, SAMPLE_CHUNK_ELEMS // size)
    idx = torch.empty(keys.shape[0], dtype=torch.int64, device=keys.device)
    for a in range(0, keys.shape[0], step):
        idx[a:a + step] = jr.categorical(
            keys[a:a + step],
            logits if logits.dim() == 1 else logits[a:a + step],
            partitionable=p)
    return _bits_of(idx, n)


def measure_shots(state: torch.Tensor, key: torch.Tensor, shots: int, *,
                  partitionable: bool | None = None) -> torch.Tensor:
    """``shots`` independent samples from ONE flat state ``[2**n]`` under
    one key ``[2]``: int32 bits ``[shots, n]``
    (``jax.random.categorical(key, logits, shape=(shots,))``)."""
    size = state.shape[-1]
    n = size.bit_length() - 1
    logits = torch.log(torch.abs(state) ** 2)
    g = jr.gumbel(key, (shots, size), partitionable=partitionable)
    return _bits_of(torch.argmax(g + logits, dim=-1), n)
