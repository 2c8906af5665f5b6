"""Every round's attack draws on the card — the counterpart of the
threefry and adversary arithmetic XLA compiles for the JAX package
(``qba_tpu/adversary/model.py :: sample_attacks_round`` behind
``qba_tpu/rounds/engine.py :: _stacked_draws``); not a ``pallas_call``
site.

:func:`attack_draws` returns rounds ``r0 .. r0 + n_r - 1`` of a batch's
draws ``(attack, rand_v, late)``, each uint8 ``[T, n_r, n_pool, n_rv]``
trial-major, the layout the megakernel's stacks and the per-round
kernels' tables have.  For CUDA tensors it launches the hand-written
kernel (``csrc/attack_draws.cu``, one launch, over the device functions
of ``csrc/draws.cuh``, which the trial megakernels' keyed entries hash
their draws with); for CPU tensors it runs
:func:`attack_draws_reference`, the plain version: the loop over
:func:`~qba_tpu_torch.adversary.model.sample_attacks_round`.  A CUDA
tensor never reaches the plain version.

:func:`attack_draw_at_reference` is the formula the device code
implements, entry by entry, in int64 PyTorch: the tests hold it against
the JAX package's draws.
"""

from __future__ import annotations

import struct

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary.model import (
    ADAPT_TAG,
    ATTACK_TAG,
    CLEAR_L_BIT,
    CLEAR_P_BIT,
    DROP_BIT,
    FORGE_BIT,
    FORGE_P_BIT,
    LATE_TAG,
    STRATEGIES,
    AdversaryCtx,
    sample_attacks_round,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops._launch import (
    KernelUnsupported,
    check,
    dispatch,
    kernel_fn,
    ptrs,
    timed_launch,
)

# The device code's strategy codes (csrc/draws.cuh).
STRATEGY_CODE = {s: i for i, s in enumerate(STRATEGIES)}


def law_ints(cfg: QBAConfig) -> list[int]:
    """The round law as the kernels take it: ``[strategy code, broadcast
    scope, racy delivery, float32 bits of p_late, n_parties + 1]``."""
    p32 = struct.unpack("i", struct.pack("f", cfg.p_late))[0]
    return [STRATEGY_CODE[cfg.strategy], int(cfg.attack_scope == "broadcast"),
            int(cfg.delivery == "racy"), p32, cfg.n_parties + 1]


def keyed_inputs(cfg: QBAConfig, k_rounds, ctx: AdversaryCtx | None):
    """Raise unless ``k_rounds`` (int64 ``[T, 2]``) and the strategy's
    context (``collude_target`` int32 ``[T]`` for ``collude``, ``v_sent``
    int32 ``[T, n_rv]`` for ``adaptive``) are what the kernels take,
    contiguous, on ``k_rounds``' device.  Returns ``(k_rounds,
    collude_target or None, v_sent or None)``."""
    if cfg.w > 256:
        raise KernelUnsupported(
            f"the draws are uint8: w <= 256; got w={cfg.w}")
    dev, n = k_rounds.device, k_rounds.shape[0]
    check("k_rounds", k_rounds, torch.int64, (n, 2), dev)
    collude = v_sent = None
    if cfg.strategy in ("collude", "adaptive"):
        if ctx is None:
            raise ValueError(f"strategy={cfg.strategy!r} needs "
                             "ctx=adversary_ctx(...)")
        if cfg.strategy == "collude":
            collude = ctx.collude_target
            check("collude_target", collude, torch.int32, (n,), dev)
        else:
            v_sent = ctx.v_sent
            check("v_sent", v_sent, torch.int32, (n, cfg.n_lieutenants), dev)
    return k_rounds, collude, v_sent


def _round_range(cfg: QBAConfig, r0: int, n_r: int | None):
    n_r = cfg.n_rounds - r0 + 1 if n_r is None else n_r
    if not (1 <= r0 and n_r >= 1 and r0 + n_r - 1 <= cfg.n_rounds):
        raise ValueError(f"rounds {r0}..{r0 + n_r - 1} outside "
                         f"1..{cfg.n_rounds}")
    return n_r


def attack_draws_reference(cfg: QBAConfig, k_rounds, ctx, r0: int = 1,
                           n_r: int | None = None):
    """Rounds ``r0 .. r0 + n_r - 1`` (default: to the last) of the draws
    in plain PyTorch: round ``r``'s slab is ``sample_attacks_round(cfg,
    fold_in(k_rounds, r), r, ctx)``, written into one preallocated uint8
    tensor ``[T, n_r, n_pool, n_rv]`` a round at a time.  Every value fits
    uint8: attack bits < 32, forged values < w, late 0/1."""
    n_r = _round_range(cfg, r0, n_r)
    n_pool = cfg.n_lieutenants * cfg.slots
    shape = (k_rounds.shape[0], n_r, n_pool, cfg.n_lieutenants)
    out = tuple(torch.empty(shape, dtype=torch.uint8, device=k_rounds.device)
                for _ in range(3))
    for j in range(n_r):
        r = r0 + j
        draws = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        for dst, x in zip(out, draws):
            dst[:, j] = x
    return out


def attack_draws(cfg: QBAConfig, k_rounds, ctx, r0: int = 1,
                 n_r: int | None = None):
    """Rounds ``r0 .. r0 + n_r - 1`` of the attack draws ``(attack,
    rand_v, late)``, each uint8 ``[T, n_r, n_pool, n_rv]``.

    CPU tensors run :func:`attack_draws_reference`.  CUDA tensors launch
    the kernel once, a thread an entry (a warp a cell under
    ``attack_scope="broadcast"``, scanning its receivers); it takes the
    inputs :func:`keyed_inputs` admits, and any other input raises.
    """
    if not dispatch("attack_draws", (k_rounds,)):
        return attack_draws_reference(cfg, k_rounds, ctx, r0, n_r)
    n_r = _round_range(cfg, r0, n_r)
    k_rounds, collude, v_sent = keyed_inputs(cfg, k_rounds, ctx)
    dev, n = k_rounds.device, k_rounds.shape[0]
    n_rv = cfg.n_lieutenants
    shape = (n, n_r, n_rv * cfg.slots, n_rv)
    out = [torch.empty(shape, dtype=torch.uint8, device=dev)
           for _ in range(3)]
    fn = kernel_fn("attack_draws", "qba_attack_draws", 6, 12)
    args = [k_rounds.data_ptr(),
            None if collude is None else collude.data_ptr(),
            None if v_sent is None else v_sent.data_ptr(), *ptrs(*out)]
    strategy, broadcast, racy, p32, n_mod = law_ints(cfg)
    args += [n, n_r, r0, cfg.n_rounds, n_rv, cfg.slots, n_mod, cfg.w,
             strategy, broadcast, racy, p32]
    timed_launch(attack_draws, fn, args, torch.cuda.current_stream(dev))
    return tuple(out)


attack_draws.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
attack_draws.events = None


def attack_draw_at_reference(cfg: QBAConfig, k_rounds, ctx, r: int, cell,
                             rv):
    """Round ``r``'s draws at the entries ``(cell, rv)`` (int64 index
    tensors of one shape ``S``) of every trial, computed entry by entry as
    the device code does (``csrc/draws.cuh``): ``(attack int32, rand_v
    int32, late bool)``, each ``[T, *S]``.

    Each entry hashes its flat index ``i = cell * n_rv + rv`` on the
    round's attack stream (action, coin and the raw order), on the late
    stream under ``racy`` and on the adapt stream under ``adaptive``;
    under ``attack_scope="broadcast"`` it walks the receivers ``rv' <=
    rv`` of its cell, skipping the sender, for the last forge (its raw
    order; without one the raw order at ``rv' = 0``, the table's gather)
    and the running clears."""
    n_rv, slots = cfg.n_lieutenants, cfg.slots
    k_round = jr.fold_in(k_rounds, r)
    lead = (slice(None),) + (None,) * cell.dim()

    def stream(tag):
        k = jr.fold_in(k_round, tag)
        return k[..., 0][lead], k[..., 1][lead]

    def bits_at(key, i):
        y0, y1 = jr.threefry2x32(*key, torch.zeros_like(i), i)
        return y0 ^ y1

    def raw_rand_v(b):
        return ((b >> 3) & 0xFFFFFF) % (cfg.n_parties + 1)

    attack_key = stream(ATTACK_TAG)
    i = cell * n_rv + rv
    own = bits_at(attack_key, i)
    action, coin = own & 3, (own >> 2) & 1
    sender = cell // slots
    if cfg.attack_scope == "broadcast":
        forge = torch.zeros(own.shape, dtype=torch.bool, device=own.device)
        clear_p, clear_l = forge.clone(), forge.clone()
        rand_v = torch.zeros_like(own)
        for q in range(n_rv - 1, -1, -1):
            b = bits_at(attack_key, cell * n_rv + q)
            seen = (q <= rv) & (sender != q)
            a = b & 3
            hit = seen & (a == 1) & ~forge
            rand_v = torch.where(hit, raw_rand_v(b), rand_v)
            forge |= hit
            clear_p |= seen & (a == 2)
            clear_l |= seen & (a == 3)
            if q == 0:
                rand_v = torch.where(forge, rand_v, raw_rand_v(b))
        attack = (((action == 0) & (coin == 0)) * DROP_BIT + forge * FORGE_BIT
                  + clear_p * CLEAR_P_BIT + clear_l * CLEAR_L_BIT)
    else:
        attack = _attack_bits(cfg, r, action, coin)
        rand_v = raw_rand_v(own)
        if cfg.strategy == "collude":
            rand_v = ctx.collude_target.long()[lead].expand(own.shape)
        elif cfg.strategy == "adaptive":
            b2 = bits_at(stream(ADAPT_TAG), i)
            offset = (b2 & 0xFFFFFF) % max(cfg.w - 1, 1) + 1
            rand_v = (ctx.v_sent.long()[:, sender] + offset) % cfg.w
    if cfg.delivery == "racy":
        b = bits_at(stream(LATE_TAG), i)
        u = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        late = u < torch.tensor(cfg.p_late, dtype=torch.float32)
    else:
        late = torch.zeros(own.shape, dtype=torch.bool, device=own.device)
    return attack.to(torch.int32), rand_v.to(torch.int32), late


def _attack_bits(cfg: QBAConfig, r: int, action, coin):
    """An entry's attack bits under the delivery scope: the strategy's law
    on its action and coin (``adaptive`` by the phase ``2 * r >
    n_rounds``)."""
    if cfg.strategy == "adaptive":
        u3 = action * 2 + coin
        if 2 * r > cfg.n_rounds:
            drop, forge, clear_p, clear_l = u3 == 4, u3 < 4, u3 == 5, u3 == 6
        else:
            drop, forge, clear_p, clear_l = u3 < 4, u3 == 6, u3 == 4, u3 == 5
        return (drop * DROP_BIT + forge * FORGE_BIT + clear_p * CLEAR_P_BIT
                + clear_l * CLEAR_L_BIT)
    if cfg.strategy == "split":
        return ((action <= 1) * FORGE_P_BIT + (action == 1) * FORGE_BIT
                + (action == 2) * CLEAR_L_BIT
                + ((action == 3) & (coin == 0)) * DROP_BIT)
    return (((action == 0) & (coin == 0)) * DROP_BIT + (action == 1) * FORGE_BIT
            + (action == 2) * CLEAR_P_BIT + (action == 3) * CLEAR_L_BIT)
