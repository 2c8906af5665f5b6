"""Carry state across from the JAX package (the system has no weights).

Everything here takes plain Python or numpy values — what
``dataclasses.asdict``, ``jax.random.key_data`` and ``np.asarray`` give
on the JAX side — so a test hands both packages the same per-trial state
(config, keys, pool, mailbox, draws, circuits, stabilizer tableaux and
their generation operands) without this package importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from qba_tpu_torch.config import QBAConfig


def config_from_jax_fields(d: dict) -> QBAConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX
    ``QBAConfig`` (the fields are the same)."""
    return QBAConfig(**d)


def key_from_jax(key_data: np.ndarray, device=None) -> torch.Tensor:
    """Trial keys ``[..., 2]`` from ``jax.random.key_data`` (uint32 words
    held in int64)."""
    data = np.asarray(key_data)
    if data.shape[-1:] != (2,):
        raise ValueError(f"key data must end in 2 words; got {data.shape}")
    return torch.from_numpy(data.astype(np.int64)).to(device)


def pool_from_numpy(vals, lens, p, meta, device=None):
    """The port's pool from the JAX pool's arrays with a leading trial
    axis: ``vals`` ``[T, max_l, n_pool, S]`` and ``p`` ``[T, n_pool, S]``
    (any integer or float dtype holding integers — the TPU stores bf16),
    ``lens`` ``[T, n_pool, max_l]``, ``meta`` ``[T, n_pool, 4]``."""
    vals, p = np.asarray(vals).astype(np.int32), np.asarray(p).astype(np.int32)
    if vals.min(initial=0) < -1 or vals.max(initial=0) > 127:
        raise ValueError("pool values outside the int8 range [-1, 127]")

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return (
        t(vals, torch.int8),
        t(np.asarray(lens).astype(np.int32), torch.int32),
        t(p, torch.int8),
        t(np.asarray(meta).astype(np.int32), torch.int32),
    )


def draws_from_numpy(attack, rand_v, late, device=None):
    """One round's draw tables ``[T, n_cells, n_rv]`` as the kernel's
    uint8 tensors (attack bits < 32, forged values < w <= 64, late 0/1)."""
    out = []
    for x in (attack, rand_v, late):
        x = np.asarray(x).astype(np.int64)
        if x.min(initial=0) < 0 or x.max(initial=0) > 255:
            raise ValueError("draw values outside uint8")
        out.append(torch.from_numpy(x.astype(np.uint8)).to(device))
    return tuple(out)


def stacked_draws_from_numpy(attack, rand_v, late, device=None):
    """Every round's draw tables as the megakernel's uint8 stacks ``[T,
    n_rounds, n_cells, n_rv]``, from JAX's round-major per-trial stacks
    (``_stacked_draws``, ``[n_rounds, n_cells, n_rv]`` each) with a
    leading trial axis, as ``jax.vmap`` returns them."""
    out = draws_from_numpy(attack, rand_v, late, device)
    if out[0].dim() != 4:
        raise ValueError("stacked draws must be [T, n_rounds, n_cells, "
                         f"n_rv]; got {tuple(out[0].shape)}")
    return tuple(x.contiguous() for x in out)


def mailbox_from_numpy(vals, lens, count, p, v, sent, device=None):
    """The port's packed mailbox (see
    :mod:`qba_tpu_torch.ops.round_kernel`) from the JAX round kernel's
    packed operands with a leading trial axis: ``vals`` ``[T, max_l, n_pk,
    S]``, ``lens`` ``[T, n_pk, max_l]``, ``count``/``v``/``sent`` ``[T,
    n_pk, 1]``, ``p`` ``[T, n_pk, S]``."""
    vals = np.asarray(vals).astype(np.int32).transpose(0, 2, 1, 3)
    p = np.asarray(p).astype(np.int32)
    if vals.min(initial=0) < -1 or vals.max(initial=0) > 127:
        raise ValueError("mailbox values outside the int8 range [-1, 127]")
    n_trials, n_pk = vals.shape[:2]
    cells = np.broadcast_to(np.arange(n_pk, dtype=np.int32), (n_trials, n_pk))
    meta = np.stack(
        [np.asarray(x).astype(np.int32).reshape(n_trials, n_pk)
         for x in (count, v, sent)] + [cells], axis=-1)

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)

    return (t(vals, torch.int8),
            t(np.asarray(lens).astype(np.int32), torch.int32),
            t(p, torch.int8), t(meta, torch.int32))


def circuit_ops_from_tuples(ops):
    """The port's :class:`~qba_tpu_torch.qsim.circuit.Op` list from a JAX
    circuit's ops given as plain tuples ``(kind, target, controls, param,
    angle)`` (``dataclasses.astuple`` of each), so both packages run the
    same circuit."""
    from qba_tpu_torch.qsim.circuit import Op

    return [Op(str(kind), int(target), tuple(int(c) for c in controls),
               None if param is None else int(param),
               None if angle is None else float(angle))
            for kind, target, controls, param, angle in ops]


def gen_tables_from_numpy(tables, device=None):
    """The port's static tableaux from the JAX package's
    ``stabilizer_gen_tables(cfg)``: four uint32 ``[2 * total, W]`` word
    arrays as int32 tensors with the same bits."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(
            np.asarray(t).astype(np.uint32).view(np.int32))).to(device)
        for t in tables)


def gen_operands_from_numpy(qcorr, coins, r_q, r_nq, mflip, device=None):
    """The megakernel's generation operands from the JAX package's
    ``stabilizer_gen_operands(cfg, key)`` with a leading trial axis (as
    ``jax.vmap`` returns them): ``qcorr`` as bool ``[T, S]``, the 0/1
    ``coins``, ``r_q``, ``r_nq`` and ``mflip`` as uint8."""
    out = [torch.from_numpy(np.asarray(qcorr).astype(bool)).to(device)]
    for x in (coins, r_q, r_nq, mflip):
        x = np.asarray(x).astype(np.int64)
        if x.min(initial=0) < 0 or x.max(initial=0) > 1:
            raise ValueError("generation operands must be 0/1")
        out.append(torch.from_numpy(x.astype(np.uint8)).to(device))
    return tuple(out)
