"""Aggregate symplectic compilation and the batched stabilizer sampler —
counterpart of :mod:`qba_tpu.gf2.symplectic`.

Conjugation by a Clifford circuit is linear on Pauli ``(x|z)`` vectors
over GF(2), so a static op list folds, once on the host, into the
evolved rows of the initial tableau, their phases at zero params and a
phase matrix linear in the runtime params (:func:`compile_symplectic`,
numpy).  A batch of shots is then one parity product for the phases and
one measurement sweep over the packed tableaux.

The sweep is :func:`qba_tpu_torch.ops.gf2_sweep.gf2_sweep`: on CUDA a
hand-written kernel (``ops/csrc/gf2_sweep.cu``, which evaluates the
sweep's affine map, :mod:`qba_tpu_torch.gf2.affine`), on the CPU
:func:`gf2_measure_sweep` below, which is also the plain version the
kernel is held against.  The key tree (``split(key, shots)``), the coins
(``bits(key, (n,)) & 1``), the pivot (the first anticommuting
stabilizer) and the mod-2 algebra are the JAX package's, so the outputs
are bit-identical to it and to the per-shot tableau engine
(:mod:`qba_tpu_torch.qsim.stabilizer`) under the same keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.gf2.bitops import pack_bits, parity_words
from qba_tpu_torch.gf2.linalg import gf2_matmul, rank1_update_packed, triangular_parity


@dataclasses.dataclass(frozen=True)
class SymplecticProgram:
    """One static Clifford op list, compiled (numpy, exact GF(2)) to its
    action on the standard initial tableau."""

    n: int
    x: np.ndarray   # [2n, n] 0/1: evolved X bits
    z: np.ndarray   # [2n, n] 0/1: evolved Z bits
    r: np.ndarray   # [2n] 0/1: phases at params = 0
    l: np.ndarray   # [2n, P]: phase coefficient of each runtime param


def compile_symplectic(n: int, ops, n_params: int) -> SymplecticProgram:
    """Push the identity tableau through the op list with the gate rules
    of :mod:`qba_tpu_torch.qsim.stabilizer`, keeping each ``X**b`` op's
    phase contribution symbolic: ``r ^= b & z_a`` reads a column known at
    compile time, so the whole contribution is ``L @ params``."""
    from qba_tpu_torch.qsim.stabilizer import _validate_ops

    ops = tuple(ops)
    _validate_ops(ops)
    x = np.concatenate(
        [np.eye(n, dtype=np.int32), np.zeros((n, n), np.int32)], axis=0)
    z = np.concatenate(
        [np.zeros((n, n), np.int32), np.eye(n, dtype=np.int32)], axis=0)
    r = np.zeros((2 * n,), np.int32)
    l = np.zeros((2 * n, max(n_params, 1)), np.int32)
    for op in ops:
        a = op.target
        if op.kind == "XPOW":
            l[:, op.param] ^= z[:, a]
        elif op.controls:
            (c,) = op.controls
            if op.kind == "X":  # CNOT c -> a
                x[:, a] ^= x[:, c]
                z[:, c] ^= z[:, a]
            else:  # CZ
                r ^= x[:, c] & x[:, a]
                zc = z[:, c] ^ x[:, a]
                z[:, a] ^= x[:, c]
                z[:, c] = zc
        elif op.kind == "H":
            r ^= x[:, a] & z[:, a]
            x[:, a], z[:, a] = z[:, a].copy(), x[:, a].copy()
        elif op.kind == "X":
            r ^= z[:, a]
        elif op.kind == "Y":
            r ^= x[:, a] ^ z[:, a]
        else:  # "Z"
            r ^= x[:, a]
    return SymplecticProgram(n=n, x=x, z=z, r=r, l=l)


def gf2_measure_sweep(n: int, xw: torch.Tensor, zw: torch.Tensor,
                      r: torch.Tensor, rnds: torch.Tensor,
                      work: dict | None = None) -> torch.Tensor:
    """Measure qubits ``0..n-1`` of a batch of packed tableaux:
    ``(xw, zw int32 [B, 2n, W], r [B, 2n], rnds [B, n]) -> bits int32
    [B, n]``.  Rows ``0..n-1`` are destabilizers, ``n..2n-1``
    stabilizers; ``r`` holds each row's phase bit, ``rnds`` the coins
    (read only where an outcome is random).

    Per qubit ``a``, a shot with a stabilizer row whose ``x_a`` is set is
    random: the first such row ``p`` is the pivot, every other row with
    ``x_a`` set absorbs it (its phase picks up ``r_p`` and the cross
    parity ``z_h . x_p``), row ``p`` retires to destabilizer ``p - n`` and
    becomes ``Z_a`` signed by the coin.  Otherwise the outcome is
    ``sum_i s_i r_{n+i} + sum_{i<j} z_{n+i} . x_{n+j} (mod 2)`` over the
    destabilizers ``s`` with ``x_a`` set.  The JAX package computes both
    branches for every shot and selects; here each shot runs only its
    own, on the index sets of the two kinds: the values are the same.

    ``work``, when a dict, gathers what the sweep did: ``random_steps``
    and ``det_steps`` (shot-steps of each kind), ``late_pivots`` (random
    steps whose pivot is not the first stabilizer row), ``rows_updated``
    (rows that absorbed a pivot) and ``rows_selected`` (stabilizers
    multiplied in a deterministic step).  The inputs are not modified.
    """
    b = rnds.shape[0]
    dev = rnds.device
    xw, zw = xw.to(torch.int32).clone(), zw.to(torch.int32).clone()
    r = r.to(torch.int32).clone()
    rnds = rnds.to(torch.int32) & 1
    out = torch.zeros((b, n), dtype=torch.int32, device=dev)
    for a in range(n):
        wa, sh = a >> 5, a & 31
        xa = (xw[:, :, wa] >> sh) & 1                      # [B, 2n]
        has = (xa[:, n:] != 0).any(1)
        rand = has.nonzero()[:, 0]
        det = (~has).nonzero()[:, 0]
        if rand.numel():
            xr, zr, rr, xar = xw[rand], zw[rand], r[rand], xa[rand]
            k = torch.arange(rand.numel(), device=dev)
            p = n + (xar[:, n:] != 0).to(torch.int8).argmax(1)
            xp, zp, rp = xr[k, p], zr[k, p], rr[k, p]
            cross = parity_words(zr & xp[:, None, :])     # [R, 2n]
            mask = xar.clone()
            mask[k, p] = 0
            rr = rr ^ (mask & (rp[:, None] ^ cross))
            xr = rank1_update_packed(xr, mask, xp)
            zr = rank1_update_packed(zr, mask, zp)
            coin = rnds[rand, a]
            xr[k, p - n], zr[k, p - n], rr[k, p - n] = xp, zp, rp
            xr[k, p] = 0
            zr[k, p] = 0
            zr[k, p, wa] = 1 << sh if sh < 31 else -(2**31)
            rr[k, p] = coin
            xw[rand], zw[rand], r[rand] = xr, zr, rr
            out[rand, a] = coin
            if work is not None:
                for key, v in (("random_steps", rand.numel()),
                               ("late_pivots", (p != n).sum()),
                               ("rows_updated", mask.sum())):
                    work[key] = work.get(key, 0) + int(v)
        if det.numel():
            s = xa[det, :n]
            phase = (s * r[det, n:]).sum(1) & 1
            sm = torch.where(s != 0, -1, 0).to(torch.int32)[..., None]
            tri = triangular_parity(sm & zw[det, n:], sm & xw[det, n:])
            out[det, a] = (phase ^ tri).to(torch.int32)
            if work is not None:
                for key, v in (("det_steps", det.numel()),
                               ("rows_selected", s.sum())):
                    work[key] = work.get(key, 0) + int(v)
    return out


def _draw_coins(keys: torch.Tensor, n: int,
                partitionable: bool | None = None) -> torch.Tensor:
    """Per-shot coins, ``bits(key, (n,)) & 1`` per key: int32 ``[..., n]``
    (the per-shot engine's draw)."""
    return (jr.bits(keys, (n,), partitionable=partitionable) & 1).to(
        torch.int32)


def build_gf2_sample_core(n: int, ops, n_params: int):
    """The batched sampler core: ``sample(rnds [B, n], params [B, P] |
    None, phase_noise [B, 2n] | None) -> int32 bits [B, n]``, with no
    random draws inside.  The phases are ``r0 ^ params @ L^T`` (one
    parity product for the batch), then the sweep
    (:func:`qba_tpu_torch.ops.gf2_sweep.gf2_sweep`) on the shared
    initial rows, whose kernel tables are built once a device."""
    from qba_tpu_torch.ops.gf2_sweep import gf2_sweep, sweep_tables

    prog = compile_symplectic(n, ops, n_params)
    x0w = pack_bits(torch.from_numpy(prog.x))[None]     # [1, 2n, W]
    z0w = pack_bits(torch.from_numpy(prog.z))[None]
    r0 = torch.from_numpy(prog.r)                       # [2n]
    lt = torch.from_numpy(np.ascontiguousarray(prog.l.T))  # [P, 2n]
    on_device: dict[torch.device, torch.Tensor] = {}

    def sample(rnds: torch.Tensor, params: torch.Tensor | None = None,
               phase_noise: torch.Tensor | None = None) -> torch.Tensor:
        dev, b = rnds.device, rnds.shape[0]
        r = r0.to(dev)[None, :].expand(b, 2 * n)
        if params is not None and n_params > 0:
            r = r ^ gf2_matmul(params.to(torch.int32) & 1, lt.to(dev))
        if phase_noise is not None:
            r = r ^ phase_noise
        if dev.type == "cuda" and dev not in on_device:
            on_device[dev] = sweep_tables(n, x0w, z0w).to(dev)
        return gf2_sweep(n, x0w.to(dev), z0w.to(dev),
                         r.to(torch.uint8).contiguous(),
                         (rnds & 1).to(torch.uint8).contiguous(),
                         tables=on_device.get(dev))

    sample.program = prog
    return sample


def build_gf2_tableau_run_batch(n: int, ops, n_params: int,
                                p_depolarize: float = 0.0,
                                p_measure_flip: float = 0.0):
    """``run_batch(keys [B, 2], params=None) -> int32 bits [B, n]``:
    ``params`` is ``None``, a shared ``[P]`` vector or ``[B, P]``.
    Nonzero noise draws :func:`qba_tpu_torch.qsim.noise.noise_draws` off
    each shot's key; the drawn Pauli lands as a phase parity against the
    compiled rows (two parity products), readout flips XOR the bits."""
    core = build_gf2_sample_core(n, ops, n_params)
    noisy = p_depolarize > 0.0 or p_measure_flip > 0.0

    def run_batch(keys: torch.Tensor, params: torch.Tensor | None = None, *,
                  partitionable: bool | None = None) -> torch.Tensor:
        p = jr.resolve_mode(partitionable)
        rnds = _draw_coins(keys, n, p)
        if params is not None and params.dim() == 1:
            params = params[None, :].expand(rnds.shape[0], params.shape[0])
        if not noisy:
            return core(rnds, params)
        from qba_tpu_torch.qsim.noise import noise_draws

        prog, dev = core.program, keys.device
        bx, bz, mflip = noise_draws(keys, n, p_depolarize, p_measure_flip,
                                    partitionable=p)
        phase_noise = (gf2_matmul(bx, torch.from_numpy(prog.z.T).to(dev))
                       ^ gf2_matmul(bz, torch.from_numpy(prog.x.T).to(dev)))
        return core(rnds, params, phase_noise=phase_noise) ^ mflip

    return run_batch


def build_gf2_tableau_run_shots(n: int, ops, n_params: int,
                                p_depolarize: float = 0.0,
                                p_measure_flip: float = 0.0):
    """``run(key [2], shots, params=None) -> int32 bits [shots, n]``: the
    key splits into ``shots`` subkeys, each shot's draws off its own."""
    run_batch = build_gf2_tableau_run_batch(n, ops, n_params, p_depolarize,
                                            p_measure_flip)

    def run(key: torch.Tensor, shots: int,
            params: torch.Tensor | None = None, *,
            partitionable: bool | None = None) -> torch.Tensor:
        p = jr.resolve_mode(partitionable)
        return run_batch(jr.split(key, shots, partitionable=p), params,
                         partitionable=p)

    return run
