"""A batch's trial set-up on the card — the counterpart of the set-up XLA
compiles for the JAX package inside its jitted batch
(``qba_tpu/rounds/engine.py:511`` ``setup_trial``, over
``qba_tpu/qsim/sampler.py:30`` and ``qba_tpu/adversary/model.py:63, 74,
227``) and of the trial keys' split before it
(``qba_tpu/backends/jax_backend.py:33``); not ``pallas_call`` sites.

:func:`setup_kernel` computes, for every trial key, what the eager
set-up computes: the key split ``(k_dis, k_lists, k_comm, k_rounds)``,
the honesty (``assign_dishonest``), the factorized lists
(``generate_lists``), the commander's orders (``commander_orders``), the
P-sets and the collude target (``adversary_ctx``).  Its forms serve each
caller (:data:`FORMS`):

* ``"whole"``: all of it, the factorized main path;
* ``"given"``: all but the lists, which it reads: the lists another path
  made (``dense``, ``dense_pallas``, ``stabilizer``) from ``k_lists``;
* ``"orders"``: the honesty, orders, rounds key, target and ``k_lists``,
  for the megakernel's gen entry, which makes the lists itself, and for
  the paths that make the lists before ``"given"``;
* ``"lists"``: the lists alone, from the lists keys
  (:func:`~qba_tpu_torch.qsim.sampler.generate_lists` on CUDA keys).

:func:`keys_kernel` makes the batch's trial keys, ``split(fold_in(root,
d), num)`` (``fold_in`` optional; the root a key or a seed), with the
same file's second entry: :func:`~qba_tpu_torch.backends.torch_backend.
trial_keys`, the sweeps' chunks, the graph loops' bodies and ``bench``'s
reps make their keys with one launch of it.

For CUDA tensors each wrapper launches its hand-written kernel
(``csrc/setup_trial.cu``: the set-up a block a trial, instantiated per
form and threefry mode; the keys a thread a key); for CPU tensors it runs
its plain version, :func:`setup_reference` (the eager functions the port
had before, unchanged) or :func:`keys_reference` (``random.py``'s
``split`` and ``fold_in``).  A CUDA tensor never reaches a plain version.
The wrappers allocate their outputs on the current stream and read
nothing back, so a CUDA graph may capture them.

:func:`setup_at_reference` is the set-up kernel's own algorithm for one
trial in plain PyTorch (draws only where the function needs them, the
rank in place of the stable argsort, a hash an entry with the legacy
mode's pairing, the lists written by rank): the tests hold it against
the plain version and the JAX package.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple

import torch

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary.model import (
    COLLUDE_TAG,
    assign_dishonest,
    collude_target,
    commander_orders,
    needs_target,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.ops._launch import (
    KernelUnsupported,
    check,
    clock_breakdown,
    clock_ptr,
    dispatch,
    kernel_fn,
    no_clock,
    timed_launch,
)
from qba_tpu_torch.qsim.noise import NOISE_TAG

FORMS = ("whole", "given", "orders", "lists")

#: Parties the kernel takes (its shared memory holds a trial's n words
#: twice over and a tile of positions' words).
MAX_PARTIES = 1024

#: Bounds a tile's positions: ``tile * n`` words (``csrc/setup_trial.cu``).
TILE_WORDS = 4096

#: Bounds a launch's dynamic shared memory: 48 KB, the most a launch takes
#: without opting in, less 1 KB for the kernel's static arrays.
SMEM_BYTES = 47 * 1024

#: The phase clock's phases, in the order of its int64 ``[T,
#: len(SETUP_PHASES)]`` buffer (``csrc/setup_trial.cu``'s ``SetupPhase``):
#: warp 0's SM cycles between the block's barriers.
SETUP_PHASES = ("keys", "perm", "words", "ranks", "flips", "out")


class TrialSetup(NamedTuple):
    """A set-up's outputs, leading axis the trials; None where the form
    makes none."""

    honest: torch.Tensor | None  # bool [T, n + 1]
    lieu_lists: torch.Tensor | None  # int32 [T, n_lieutenants, S]
    p_rows: torch.Tensor | None  # bool [T, n_lieutenants, S]
    v_sent: torch.Tensor | None  # int32 [T, n_lieutenants]
    v_comm: torch.Tensor | None  # int32 [T]
    k_rounds: torch.Tensor | None  # int64 [T, 2]
    target: torch.Tensor | None  # int32 [T] (collude, adaptive)
    k_lists: torch.Tensor | None = None  # int64 [T, 2] ("orders")
    lists: torch.Tensor | None = None  # int32 [T, n + 1, S]
    qcorr: torch.Tensor | None = None  # bool [T, S] ("lists")


def perm_rounds(n: int) -> int:
    """Rounds of JAX's sort-based permutation of ``n`` items
    (:func:`qba_tpu_torch.random.permutation`)."""
    return math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))


def setup_tile(cfg: QBAConfig) -> int:
    """List positions a tile of the kernel (``csrc/setup_trial.cu`` ::
    ``setup_tile``): as many as keep a tile's ``n`` words each within
    :data:`TILE_WORDS` and :func:`setup_smem_bytes` within
    :data:`SMEM_BYTES` (a multiple of 4 where that binds), at least
    one."""
    n = cfg.n_parties
    n_pad = (n + 3) & ~3
    per = 4 * n_pad + 4 * (n + 1) + 9  # a position's bytes, ld <= tile + 1
    fixed = 4 * (n_pad + (n + 1) + (n - 1)) + (n + 1)
    fit = (SMEM_BYTES - fixed) // per & ~3
    return max(1, min(cfg.size_l, TILE_WORDS // n, fit))


def setup_smem_bytes(cfg: QBAConfig) -> int:
    """A block's dynamic shared memory (``qba_setup_smem_bytes``): a
    tile's words and the permutation's (``n`` padded to 4 a position),
    the tile's ``n + 1`` rows (an odd stride), r and the Q list, the
    orders, the honesty and the Q bits."""
    n, tile = cfg.n_parties, setup_tile(cfg)
    n_pad = (n + 3) & ~3
    return (4 * (tile * n_pad + n_pad + (n + 1) * (tile | 1) + 2 * tile
                 + (n - 1)) + (n + 1) + tile)


def _check_form(form, lists):
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}; got {form!r}")
    if (form == "given") != (lists is not None):
        raise ValueError("the 'given' form takes lists, the others none")


def setup_reference(cfg: QBAConfig, keys: torch.Tensor, form: str = "whole",
                    lists: torch.Tensor | None = None, *,
                    full_lists: bool = False,
                    partitionable: bool | None = None) -> TrialSetup:
    """The plain version of :func:`setup_kernel`: the eager set-up
    (``split``, :func:`assign_dishonest`,
    :func:`~qba_tpu_torch.qsim.sampler.generate_lists_plain`,
    :func:`commander_orders`, ``p_sets``, :func:`collude_target`) on any
    device.  ``lieu_lists`` and ``k_rounds`` are views of the lists and
    the key split, as the eager set-up's were."""
    from qba_tpu_torch.qsim.sampler import generate_lists_plain
    from qba_tpu_torch.rounds.engine import p_sets

    _check_form(form, lists)
    p = jr.resolve_mode(partitionable)
    if form == "lists":
        got, qcorr = generate_lists_plain(cfg, keys, partitionable=p)
        return TrialSetup(None, None, None, None, None, None, None,
                          lists=got, qcorr=qcorr)
    k = jr.split(keys, 4, partitionable=p)
    honest = assign_dishonest(cfg, k[..., 0, :], partitionable=p)
    if form == "whole":
        lists, _qcorr = generate_lists_plain(cfg, k[..., 1, :],
                                             partitionable=p)
    v_sent, v_comm = commander_orders(cfg, k[..., 2, :], honest[..., 1],
                                      partitionable=p)
    k_rounds = k[..., 3, :]
    target = (collude_target(cfg, k_rounds, partitionable=p)
              if needs_target(cfg) else None)
    if form == "orders":
        return TrialSetup(honest, None, None, v_sent, v_comm, k_rounds,
                          target, k_lists=k[..., 1, :])
    return TrialSetup(honest, lists[..., 2:, :], p_sets(lists, v_sent),
                      v_sent, v_comm, k_rounds, target,
                      lists=lists if full_lists else None)


def _float_bits(x: float) -> int:
    return struct.unpack("i", struct.pack("f", x))[0]


def setup_kernel(cfg: QBAConfig, keys: torch.Tensor, form: str = "whole",
                 lists: torch.Tensor | None = None, *,
                 full_lists: bool = False,
                 partitionable: bool | None = None,
                 clock: torch.Tensor | None = None) -> TrialSetup:
    """The set-up of trial keys ``[T, 2]`` (``form="lists"``: lists keys
    ``[..., 2]``) in ``form`` (:data:`FORMS`); ``lists`` int32 ``[T, n +
    1, S]`` for ``"given"``.  ``full_lists`` also returns every party's
    lists (``"whole"``; ``lieu_lists`` is then their view).

    CPU keys run :func:`setup_reference`.  CUDA keys launch the kernel
    once (the instantiation of the form and of ``partitionable``'s
    threefry mode); keys that are not int64, a config past
    :data:`MAX_PARTIES` or a draw table past the legacy mode's ``2**32 -
    1`` words raise.  ``clock`` (:func:`setup_phase_clock`) launches the
    phase clock's instantiation, the whole form's in the partitionable
    mode only; the plain version refuses it."""
    _check_form(form, lists)
    p = jr.resolve_mode(partitionable)
    if not dispatch("setup_trial", (keys,)):
        no_clock(clock)
        return setup_reference(cfg, keys, form, lists, full_lists=full_lists,
                               partitionable=p)
    if clock is not None and (form != "whole" or not p):
        raise KernelUnsupported("the set-up kernel's phase clock runs the "
                                "whole form in the partitionable mode only")
    n, s, n_lt = cfg.n_parties, cfg.size_l, cfg.n_lieutenants
    if n > MAX_PARTIES:
        raise KernelUnsupported(
            f"the set-up kernel takes up to {MAX_PARTIES} parties; got {n}")
    if (n + 1) * s * cfg.n_qubits >= 2**32 - 1:
        raise KernelUnsupported(
            f"a set-up draw table of {(n + 1) * s * cfg.n_qubits} words "
            "passes 2**32 - 1")
    dev = keys.device
    batch = keys.shape[:-1]
    flat = keys.reshape(-1, 2).contiguous()
    t = flat.shape[0]
    check("keys", flat, torch.int64, (t, 2), dev)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    lists_in = None
    if form == "given":
        lists_in = lists.to(torch.int32).contiguous()
        check("lists", lists_in, torch.int32, (t, n + 1, s), dev)
    orders = form != "lists"
    honest = empty(t, n + 1, dtype=torch.bool) if orders else None
    v_sent = empty(t, n_lt) if orders else None
    v_comm = empty(t) if orders else None
    k_rounds = empty(t, 2, dtype=torch.int64) if orders else None
    target = empty(t) if orders and needs_target(cfg) else None
    k_lists = empty(t, 2, dtype=torch.int64) if form == "orders" else None
    row0 = 0 if full_lists or form == "lists" else 2
    out = empty(t, n + 1 - row0, s) if form != "orders" else None
    p_rows = (empty(t, n_lt, s, dtype=torch.bool)
              if form in ("whole", "given") else None)
    qcorr = empty(t, s, dtype=torch.bool) if form == "lists" else None

    def addr(x):
        return None if x is None else x.data_ptr()

    fn = kernel_fn("setup_trial", "qba_setup_trial", 12, 13)
    noise = cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0
    args = [addr(x) for x in (flat, lists_in, honest, out, p_rows, v_sent,
                              v_comm, k_rounds, target, k_lists, qcorr)]
    args += [clock_ptr(clock, (t, len(SETUP_PHASES)), dev)]
    args += [t, n, cfg.n_dishonest, s, cfg.w, cfg.n_qubits,
             int(cfg.strategy == "split"), row0, int(noise),
             _float_bits(cfg.p_depolarize), _float_bits(cfg.p_measure_flip),
             FORMS.index(form), int(not p)]
    timed_launch(setup_kernel, fn, args, torch.cuda.current_stream(dev))
    if form == "lists":
        return TrialSetup(None, None, None, None, None, None, None,
                          lists=out.reshape(batch + out.shape[1:]),
                          qcorr=qcorr.reshape(batch + (s,)))
    if form == "orders":
        return TrialSetup(honest, None, None, v_sent, v_comm, k_rounds,
                          target, k_lists=k_lists)
    lieu = out[:, 2:] if row0 == 0 else out
    return TrialSetup(honest, lieu, p_rows, v_sent, v_comm, k_rounds,
                      target, lists=out if row0 == 0 else None)


setup_kernel.launches = 0
# When set to a list, each launch appends its (start, end) CUDA events.
setup_kernel.events = None


def setup_phase_clock(n_trials: int, device=None) -> torch.Tensor:
    """A zeroed phase-clock buffer, int64 ``[n_trials,
    len(SETUP_PHASES)]``, for :func:`setup_kernel`'s ``clock``."""
    return torch.zeros((n_trials, len(SETUP_PHASES)), dtype=torch.int64,
                       device=device)


def setup_phase_breakdown(clock: torch.Tensor) -> dict:
    """A filled phase clock's breakdown (:func:`~qba_tpu_torch.ops.
    _launch.clock_breakdown` over :data:`SETUP_PHASES`)."""
    return clock_breakdown(clock, SETUP_PHASES)


def keys_reference(root, num: int, fold=None, *, device=None,
                   partitionable: bool | None = None) -> torch.Tensor:
    """The plain version of :func:`keys_kernel`: ``split(fold_in(root,
    fold), num)``, without the ``fold_in`` where ``fold`` is None; an int
    ``root`` is a seed, ``key(root)`` on ``device``."""
    k = root if isinstance(root, torch.Tensor) else jr.key(root, device)
    if fold is not None:
        k = jr.fold_in(k, fold)
    return jr.split(k, num, partitionable=partitionable)


def keys_at_reference(root, num: int, fold=None, *,
                      partitionable: bool | None = None) -> torch.Tensor:
    """The key entry's own algorithm in plain int64 PyTorch, a hash a
    thread ``t < num`` from its own counters: ``root' = fold_in(root,
    fold)`` (one hash of ``(0, fold)``), then in the partitionable mode
    key ``t`` is ``threefry2x32(root', (0, t))``; in the legacy mode the
    keys are ``2 num`` words, key ``t`` words ``2t`` and ``2t + 1``, and
    hash ``(t, t + num)`` gives word ``t`` (y0) and word ``t + num`` (y1).
    ``root`` as for :func:`keys_kernel` (a seed on the CPU)."""
    k = root if isinstance(root, torch.Tensor) else jr.key(root)
    if fold is not None:
        k = jr.fold_in(k, fold)
    t = torch.arange(num, dtype=torch.int64, device=k.device)
    if jr.resolve_mode(partitionable):
        y0, y1 = jr.threefry2x32(k[0], k[1], torch.zeros_like(t), t)
        return torch.stack([y0, y1], dim=-1)

    y0, y1 = jr.threefry2x32(k[0], k[1], t, t + num)
    return torch.cat([y0, y1]).reshape(num, 2)


def _int32(x: int) -> int:
    """A uint32 value as the int32 with its bits (a C int argument)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def keys_kernel(root, num: int, fold=None, *, device=None,
                partitionable: bool | None = None) -> torch.Tensor:
    """The trial keys ``split(fold_in(root, fold), num)``, int64 ``[num,
    2]`` (``jax.random.split(jax.random.fold_in(key, d), num)``; no
    ``fold_in`` where ``fold`` is None).  ``root`` is a key, int64 ``[2]``,
    or an int seed (``key(root)``, made on ``device``); ``fold`` an int or
    an int32 tensor of one element on the root's device (cast to uint32,
    as JAX casts a traced int).

    On the CPU it runs :func:`keys_reference`.  On CUDA it launches the
    key entry of ``csrc/setup_trial.cu`` once: a thread a key, the root
    and a tensor ``fold`` read from device memory where the launch runs,
    so a CUDA graph that captured it replays it with the carry's new
    value."""
    p = jr.resolve_mode(partitionable)
    seed = not isinstance(root, torch.Tensor)
    probe = (torch.empty(0, dtype=torch.int64, device=device) if seed
             else root)
    if not dispatch("trial_keys", (probe,)):
        return keys_reference(root, num, fold, device=device, partitionable=p)
    dev = probe.device
    num = int(num)
    if not 0 <= num < 2**31:
        raise ValueError(f"num must lie in [0, 2**31); got {num}")
    out = torch.empty((num, 2), dtype=torch.int64, device=dev)
    if num == 0:
        return out
    if seed:
        s = int(root)
        if not -(2**31) <= s < 2**31:
            raise ValueError(f"seed {s} outside int32 range")
        root_ptr, words = None, (0, s)  # jr.key's words
    else:
        check("root", root, torch.int64, (2,), dev)
        root_ptr, words = root.data_ptr(), (0, 0)
    fold_ptr, mode, value = None, 0, 0
    if isinstance(fold, torch.Tensor):
        if fold.dtype != torch.int32 or fold.numel() != 1:
            raise TypeError("fold must be an int32 tensor of one element; "
                            f"got {fold.dtype}{list(fold.shape)}")
        if fold.device != dev:
            raise ValueError(f"fold on {fold.device}, expected {dev}")
        fold_ptr, mode = fold.data_ptr(), 1
    elif fold is not None:
        mode, value = 2, int(fold)
    fn = kernel_fn("setup_trial", "qba_trial_keys", 3, 6)
    args = [root_ptr, fold_ptr, out.data_ptr(), num, _int32(words[0]),
            _int32(words[1]), mode, _int32(value), int(not p)]
    timed_launch(keys_kernel, fn, args, torch.cuda.current_stream(dev))
    return out


keys_kernel.launches = 0
keys_kernel.events = None


def randint_low(words: torch.Tensor, span: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span)`` for a power-of-two
    ``span`` up to ``2**16`` from its low words alone (``bits(split(key,
    2)[1], shape)``, the kernel's ``randint_pow2``): JAX scales the high
    word by ``(2**16 % span)**2 % span``, which is 0 for such a span, so
    its value is ``low % span``, ``low & (span - 1)``."""
    if span < 1 or span & (span - 1) or span > 2**16:
        raise ValueError(f"span must be a power of two up to 2**16; "
                         f"got {span}")
    return words & (span - 1)


def rank_sort(words: torch.Tensor) -> torch.Tensor:
    """The kernel's stable sort over the last axis as ranks: ``rank_i =
    #{j : x_j < x_i} + #{j < i : x_j == x_i}``, so ``perm[rank_i] = i``
    is ``argsort(words, stable=True)``, ties in index order."""
    x = words[..., None, :]  # x_j
    xi = words[..., :, None]  # x_i
    n = words.shape[-1]
    idx = torch.arange(n, device=words.device)
    before = idx[None, :] < idx[:, None]  # [i, j]: j < i
    return ((x < xi) | ((x == xi) & before)).sum(-1)


def setup_at_reference(cfg: QBAConfig, key: torch.Tensor, form: str = "whole",
                       lists: torch.Tensor | None = None, *,
                       partitionable: bool | None = None) -> TrialSetup:
    """One trial's set-up (``key`` int64 ``[2]``; ``lists`` int32 ``[n +
    1, S]`` for ``"given"``) computed as the kernel computes it, in plain
    int64 PyTorch: each draw hashes its own flat index (in the legacy
    mode paired with the one ``h = ceil(m / 2)`` away in its call's
    table of ``m`` words), only where the function needs it: ``r``, the
    noise words and their ranks (:func:`rank_sort`) at the Q-correlated
    positions alone (word ``i`` lands in row ``1 + rank_i``), ``u`` at the
    others, a randint of power-of-two span from its low word
    (:func:`randint_low`), a noise kind only where its Pauli draw fired.
    Outputs as :class:`TrialSetup` without the trial axis; ``lists`` holds
    every party's rows for ``"whole"``, ``"given"`` and ``"lists"``."""
    _check_form(form, lists)
    legacy = not jr.resolve_mode(partitionable)
    n, s, w, nq = cfg.n_parties, cfg.size_l, cfg.w, cfg.n_qubits
    i64 = dict(dtype=torch.int64)

    def hash_pair(k, x0, x1):
        return jr.threefry2x32(k[0], k[1], x0, x1)

    def bits_at(k, i, m):
        if legacy:
            h = m - m // 2
            second = i >= h
            y0, y1 = hash_pair(k, torch.where(second, i - h, i),
                               torch.where(second, i,
                                           torch.where(i + h == m, 0, i + h)))
            return torch.where(second, y1, y0)
        y0, y1 = hash_pair(k, torch.zeros_like(i), i)
        return y0 ^ y1

    def split_at(k, j, num):
        if legacy:
            words = bits_at(k, torch.tensor([2 * j, 2 * j + 1], **i64),
                            2 * num)
            return words[0], words[1]
        return hash_pair(k, torch.zeros((), **i64), torch.tensor(j, **i64))

    def fold_in(k, tag):
        return hash_pair(k, torch.zeros((), **i64), torch.tensor(tag, **i64))

    def uniform_at(k, i, m):
        b = bits_at(k, i, m)
        return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1

    def randint_at(k, i, span, m):
        hi, lo = split_at(k, 0, 2), split_at(k, 1, 2)
        mult = (2**16 % span) ** 2 % span
        off = ((bits_at(hi, i, m) % span) * mult & 0xFFFFFFFF) \
            + bits_at(lo, i, m) % span
        return (off & 0xFFFFFFFF) % span

    def low_at(k, i, m):
        # A power-of-two span's draw: the low words alone.
        return randint_low(bits_at(split_at(k, 1, 2), i, m), w)

    zero = torch.zeros((), **i64)

    def scalar_randint(k, span):
        # qba-lint: sync-ok (a CPU mirror: its tensors never live on the card)
        return int(randint_at(k, zero, span, 1))

    def p32(x):
        return torch.tensor(x, dtype=torch.float32)

    trial = (key[0], key[1])
    out = {}
    kl = trial if form == "lists" else split_at(trial, 1, 4)
    if form != "lists":
        kd = split_at(trial, 0, 4)
        perm = torch.arange(1, n + 1)
        for _ in range(perm_rounds(n)):
            sub, kd = split_at(kd, 1, 2), split_at(kd, 0, 2)
            nxt = torch.empty_like(perm)
            nxt[rank_sort(bits_at(sub, torch.arange(n), n))] = perm
            perm = nxt
        honest = torch.ones(n + 1, dtype=torch.bool)
        honest[perm[: cfg.n_dishonest]] = False
        kc = split_at(trial, 2, 4)
        # qba-lint: sync-ok (a CPU mirror: its tensors never live on the card)
        v, v1 = (int(low_at(split_at(kc, j, 3), zero, 1)) for j in (0, 1))
        v2 = (v1 + 1 + scalar_randint(split_at(kc, 2, 3), max(w - 1, 1))) % w
        ranks = torch.arange(2, n + 1)
        first = (ranks % 2 == 0 if cfg.strategy == "split"
                 else ranks <= (n + 1) // 2)
        v_sent = (torch.full((n - 1,), v) if honest[1]
                  else torch.where(first, v1, v2)).to(torch.int32)
        kr = split_at(trial, 3, 4)
        target = None
        if needs_target(cfg):
            target = torch.tensor(
                scalar_randint(fold_in(kr, COLLUDE_TAG), n + 1),
                dtype=torch.int32)
        out.update(honest=honest, v_sent=v_sent,
                   v_comm=torch.tensor(v, dtype=torch.int32),
                   k_rounds=torch.stack(kr), target=target)
        if form == "orders":
            return TrialSetup(**_fill(out), k_lists=torch.stack(kl))
    if form == "given":
        rows = lists.to(torch.int32)
    else:
        l0, l1, l2, l3 = (split_at(kl, j, 4) for j in range(4))
        pos = torch.arange(s)
        qcorr = uniform_at(l0, pos, s) < p32(0.5)
        # qba-lint: sync-ok (a CPU mirror: its tensors never live on the card)
        qpos, other = pos[qcorr], pos[~qcorr]
        word = torch.arange(n)
        rows = torch.empty(n + 1, s, **i64)
        # Q-correlated positions: r, the noise words, their ranks.
        r = low_at(l1, qpos, s)
        rank = rank_sort(bits_at(l2, qpos[:, None] * n + word, s * n))
        rows[0, qpos] = r
        rows[rank + 1, qpos[:, None].expand_as(rank)] = (
            r[:, None] ^ (word + 1))
        # The others: row j + 1 is u[j][s], row 0 is u[0][s].
        u = low_at(l3, word[:, None] * s + other, s * n)  # [n, others]
        rows[1:, other] = u
        rows[0, other] = u[0]
        if cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0:
            kn = fold_in(kl, NOISE_TAG)
            table = (n + 1) * s * nq
            i = torch.arange(table)
            flips = torch.zeros(table, dtype=torch.bool)
            if cfg.p_depolarize > 0.0:
                # qba-lint: sync-ok (a CPU mirror: its tensors never live on the card)
                fired = i[uniform_at(split_at(kn, 0, 3), i, table) < p32(
                    cfg.p_depolarize)]
                flips[fired] = randint_at(split_at(kn, 1, 3), fired, 3,
                                          table) != 2
            if cfg.p_measure_flip > 0.0:
                flips ^= uniform_at(split_at(kn, 2, 3), i, table) < p32(
                    cfg.p_measure_flip)
            shifts = torch.arange(nq - 1, -1, -1)
            rows = rows ^ (flips.long().reshape(n + 1, s, nq)
                           << shifts).sum(-1)
        rows = rows.to(torch.int32)
        if form == "lists":
            return TrialSetup(None, None, None, None, None, None, None,
                              lists=rows, qcorr=qcorr)
    is_q = rows[0] != rows[1]
    p_rows = is_q[None, :] & (rows[1][None, :] == out["v_sent"][:, None])
    out.update(lieu_lists=rows[2:], p_rows=p_rows)
    return TrialSetup(**_fill(out), lists=rows)


def _fill(fields: dict) -> dict:
    """``fields`` with every :class:`TrialSetup` field it lacks as None."""
    return {f: fields.get(f) for f in TrialSetup._fields[:7]}
