"""The per-shot stabilizer tableau engine — counterpart of
:mod:`qba_tpu.qsim.stabilizer`, and like it the differential reference
of the batched GF(2) engine (:mod:`qba_tpu_torch.gf2.symplectic`).

Each tableau row stores a Pauli as ``(-1)^r prod_j X^x_j Z^z_j`` (XZ
normal form), so the gate set H, X, Y, Z, CNOT, CZ and the
classically-controlled ``X**b`` keeps phases in +-1 and a row product
costs one cross parity ``z_h . x_p``.  Rows ``0..n-1`` are
destabilizers (initially ``X_i``), ``n..2n-1`` stabilizers (``Z_i``).
S, T and rotations leave the form and are rejected.

The engine is plain PyTorch (the JAX package has no kernel for it
either).  It runs a batch of independent shots, one tableau per key, as
unpacked int32 ``[K, 2n, n]`` matrices: the op list edits columns, and
the per-qubit measurement computes both branches for every shot and
selects, where the JAX package vmaps a per-shot ``lax.cond``.

Gate rules (target ``a``, control ``c``; every row):
  H(a): r ^= x_a & z_a; swap x_a, z_a.   X(a): r ^= z_a.
  Y(a): r ^= x_a ^ z_a.                  Z(a): r ^= x_a.
  CNOT(c, a): x_a ^= x_c; z_c ^= z_a.
  CZ(c, a): r ^= x_c & x_a; z_a ^= x_c; z_c ^= x_a.
  X**b(a): r ^= b & z_a.
"""

from __future__ import annotations

import torch

from qba_tpu_torch import random as jr

CLIFFORD_FIXED = ("H", "X", "Y", "Z")


def is_clifford_ops(ops) -> bool:
    """True iff every op is representable by this engine (the predicate
    :func:`_validate_ops` enforces)."""
    try:
        _validate_ops(ops)
    except ValueError:
        return False
    return True


def _validate_ops(ops) -> None:
    for op in ops:
        if op.kind == "XPOW":
            if op.controls:
                raise ValueError("controlled XPOW is not supported")
            continue
        if op.kind not in CLIFFORD_FIXED:
            raise ValueError(
                f"gate {op.kind!r} is outside this engine's Clifford set "
                "(S/T/rotations change the XZ normal form); use the dense "
                "statevector engine for non-Clifford circuits"
            )
        if len(op.controls) > 1:
            raise ValueError(
                "multi-controlled gates are not Clifford; use the dense "
                "engine"
            )
        if op.controls and op.kind not in ("X", "Z"):
            raise ValueError(
                f"controlled-{op.kind} is not supported on the stabilizer "
                "engine (only CNOT/CZ); use the dense engine"
            )


def _apply_ops(ops, x, z, r, params):
    """Conjugate every shot's tableau (``x``/``z`` ``[K, 2n, n]``, ``r``
    ``[K, 2n]``) through the op list; ``XPOW`` reads ``params[:, i]``."""
    for op in ops:
        a = op.target
        if op.kind == "XPOW":
            r = r ^ (params[:, op.param, None] & z[:, :, a])
        elif op.controls:
            (c,) = op.controls
            if op.kind == "X":  # CNOT control c -> target a
                x[:, :, a] ^= x[:, :, c]
                z[:, :, c] ^= z[:, :, a]
            else:  # CZ
                r = r ^ (x[:, :, c] & x[:, :, a])
                zc = z[:, :, c] ^ x[:, :, a]
                z[:, :, a] ^= x[:, :, c]
                z[:, :, c] = zc
        elif op.kind == "H":
            r = r ^ (x[:, :, a] & z[:, :, a])
            xa = x[:, :, a].clone()
            x[:, :, a] = z[:, :, a]
            z[:, :, a] = xa
        elif op.kind == "X":
            r = r ^ z[:, :, a]
        elif op.kind == "Y":
            r = r ^ x[:, :, a] ^ z[:, :, a]
        else:  # "Z"
            r = r ^ x[:, :, a]
    return x, z, r


def build_tableau_run(n: int, ops, n_params: int, p_depolarize: float = 0.0,
                      p_measure_flip: float = 0.0):
    """Build ``run(keys [K, 2], params=None) -> int32 bits [K, n]``: one
    sample of every qubit per key, qubit ``q`` at index ``q``.  ``params``
    int ``[K, n_params]`` gives each key's ``X**b`` bits; ``None`` means
    all zero.

    Each shot's coins are ``bits(key, (n,)) & 1``, one per qubit, read
    where the outcome is random.  Nonzero noise draws
    :func:`~qba_tpu_torch.qsim.noise.noise_draws` off the key: the Pauli
    conjugates the evolved tableau as a phase edit, the readout flips
    XOR the bits.
    """
    ops = tuple(ops)
    _validate_ops(ops)
    noisy = p_depolarize > 0.0 or p_measure_flip > 0.0

    def run(keys: torch.Tensor, params: torch.Tensor | None = None, *,
            partitionable: bool | None = None) -> torch.Tensor:
        k, dev = keys.shape[0], keys.device
        mode = jr.resolve_mode(partitionable)
        if params is None:
            params = torch.zeros((k, max(n_params, 1)), dtype=torch.int32,
                                 device=dev)
        params = params.to(dev, torch.int32)
        eye = torch.eye(n, dtype=torch.int32, device=dev)
        zero = torch.zeros((n, n), dtype=torch.int32, device=dev)
        x = torch.cat([eye, zero]).expand(k, 2 * n, n).clone()
        z = torch.cat([zero, eye]).expand(k, 2 * n, n).clone()
        r = torch.zeros((k, 2 * n), dtype=torch.int32, device=dev)
        x, z, r = _apply_ops(ops, x, z, r, params)
        mflip = None
        if noisy:
            from qba_tpu_torch.qsim.noise import noise_draws

            bx, bz, mflip = noise_draws(keys, n, p_depolarize,
                                        p_measure_flip, partitionable=mode)
            r = r ^ (((z * bx[:, None, :]).sum(-1)
                      + (x * bz[:, None, :]).sum(-1)) & 1).to(torch.int32)
        rnds = (jr.bits(keys, (n,), partitionable=mode) & 1).to(torch.int32)
        rows = torch.arange(2 * n, device=dev)
        shots = torch.arange(k, device=dev)
        out = torch.zeros((k, n), dtype=torch.int32, device=dev)
        for a in range(n):
            xa = x[:, :, a]                               # [K, 2n]
            has = (xa[:, n:] != 0).any(1)
            # Random branch: the first anticommuting stabilizer pivots.
            p = n + (xa[:, n:] != 0).to(torch.int32).argmax(1)
            xp, zp, rp = x[shots, p], z[shots, p], r[shots, p]
            mask = xa * (rows[None] != p[:, None])
            cross = ((z * xp[:, None, :]).sum(-1) & 1).to(torch.int32)
            r_r = r ^ (mask & (rp[:, None] ^ cross))
            x_r = x ^ (mask[..., None] * xp[:, None, :])
            z_r = z ^ (mask[..., None] * zp[:, None, :])
            rnd = rnds[:, a]
            x_r[shots, p - n], z_r[shots, p - n] = xp, zp
            r_r[shots, p - n] = rp
            x_r[shots, p] = 0
            z_r[shots, p] = (torch.arange(n, device=dev) == a).to(
                torch.int32)
            r_r[shots, p] = rnd
            # Deterministic branch: the sign of the product of the
            # stabilizers whose destabilizers have x_a set, from the
            # strict upper triangle of their [n, n] cross counts.  The
            # counts are at most n < 2**24: exact in float32.
            s = xa[:, :n]
            xs = (s[..., None] * x[:, n:]).to(torch.float32)
            zs = (s[..., None] * z[:, n:]).to(torch.float32)
            # qba-lint: exact-dot (0/1 operands, float32 sums <= n < 2**24)
            m = (zs @ xs.transpose(1, 2)).to(torch.int64)
            upper = torch.triu(m, diagonal=1).sum((1, 2))
            det = ((s * r[:, n:]).sum(1) + upper) & 1
            sel = has[:, None]
            x = torch.where(sel[..., None], x_r, x)
            z = torch.where(sel[..., None], z_r, z)
            r = torch.where(sel, r_r, r)
            out[:, a] = torch.where(has, rnd, det.to(torch.int32))
        if mflip is not None:
            out = out ^ mflip
        return out

    return run


def build_tableau_run_shots(n: int, ops, n_params: int,
                            p_depolarize: float = 0.0,
                            p_measure_flip: float = 0.0):
    """``run(key [2], shots, params=None) -> int32 bits [shots, n]``: the
    key splits into ``shots`` subkeys, each an independent tableau run
    (``params``, if given, a shared ``[n_params]`` vector)."""
    run1 = build_tableau_run(n, ops, n_params, p_depolarize, p_measure_flip)

    def run(key: torch.Tensor, shots: int,
            params: torch.Tensor | None = None, *,
            partitionable: bool | None = None) -> torch.Tensor:
        mode = jr.resolve_mode(partitionable)
        keys = jr.split(key, shots, partitionable=mode)
        if params is not None:
            params = params.to(key.device)[None].expand(shots, -1)
        return run1(keys, params, partitionable=mode)

    return run
