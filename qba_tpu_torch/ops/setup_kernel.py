"""A batch's trial set-up on the card — the counterpart of the set-up XLA
compiles for the JAX package inside its jitted batch
(``qba_tpu/rounds/engine.py:511`` ``setup_trial``, over
``qba_tpu/qsim/sampler.py:30`` and ``qba_tpu/adversary/model.py:63, 74,
227``); not a ``pallas_call`` site.

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

For CUDA keys it launches the hand-written kernel (``csrc/setup_trial.cu``,
one launch, a block a trial, instantiated per form and threefry mode);
for CPU keys it runs :func:`setup_reference`, the plain version: the
eager functions the port had before, unchanged.  A CUDA tensor never
reaches the plain version.  The wrapper allocates its outputs on the
current stream and reads nothing back, so a CUDA graph may capture it.

:func:`setup_at_reference` is the kernel's own algorithm for one trial
in plain PyTorch (the rank in place of the stable argsort, a hash an
entry with the legacy mode's pairing, the lists written by rank): the
tests hold it against the plain version and the JAX package.
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
    dispatch,
    kernel_fn,
    timed_launch,
)
from qba_tpu_torch.qsim.noise import NOISE_TAG

FORMS = ("whole", "given", "orders", "lists")

#: Parties the kernel takes (its shared memory holds a trial's n words
#: twice over and a tile of positions' words).
MAX_PARTIES = 1024

#: A tile's sort words in shared memory (``csrc/setup_trial.cu``).
TILE_WORDS = 4096


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
    """List positions a tile of the kernel: as many as keep a tile's
    ``n`` words each within :data:`TILE_WORDS`, at least one."""
    return min(cfg.size_l, max(1, TILE_WORDS // cfg.n_parties))


def setup_smem_bytes(cfg: QBAConfig) -> int:
    """A block's dynamic shared memory (``qba_setup_smem_bytes``)."""
    n, tile = cfg.n_parties, setup_tile(cfg)
    return 4 * (tile * n + 2 * n + (n - 1) + 3 * tile) + (n + 1) + tile


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
                 partitionable: bool | None = None) -> TrialSetup:
    """The set-up of trial keys ``[T, 2]`` (``form="lists"``: lists keys
    ``[..., 2]``) in ``form`` (:data:`FORMS`); ``lists`` int32 ``[T, n +
    1, S]`` for ``"given"``.  ``full_lists`` also returns every party's
    lists (``"whole"``; ``lieu_lists`` is then their view).

    CPU keys run :func:`setup_reference`.  CUDA keys launch the kernel
    once (the instantiation of the form and of ``partitionable``'s
    threefry mode); keys that are not int64, a config past
    :data:`MAX_PARTIES` or a draw table past the legacy mode's ``2**32 -
    1`` words raise."""
    _check_form(form, lists)
    p = jr.resolve_mode(partitionable)
    if not dispatch("setup_trial", (keys,)):
        return setup_reference(cfg, keys, form, lists, full_lists=full_lists,
                               partitionable=p)
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

    fn = kernel_fn("setup_trial", "qba_setup_trial", 11, 14)
    noise = cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0
    args = [addr(x) for x in (flat, lists_in, honest, out, p_rows, v_sent,
                              v_comm, k_rounds, target, k_lists, qcorr)]
    args += [t, n, cfg.n_dishonest, s, cfg.w, cfg.n_qubits,
             int(cfg.strategy == "split"), perm_rounds(n), row0, int(noise),
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
    table of ``m`` words), the permutation and each position's sort are
    :func:`rank_sort`, position ``s``'s word ``i`` lands in row ``1 +
    rank_i``.  Outputs as :class:`TrialSetup` without the trial axis;
    ``lists`` holds every party's rows for ``"whole"``, ``"given"`` and
    ``"lists"``."""
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

    def scalar_randint(k, span):
        # qba-lint: sync-ok (a CPU mirror: its tensors never live on the card)
        return int(randint_at(k, torch.zeros((), **i64), span, 1))

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
        v, v1 = (scalar_randint(split_at(kc, j, 3), w) for j in (0, 1))
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
        r = randint_at(l1, pos, w, s)
        rank = rank_sort(bits_at(l2, torch.arange(s * n), s * n)
                         .reshape(s, n))  # [S, n]
        word = torch.arange(n)[None, :]
        u = randint_at(l3, rank * s + pos[:, None], w, s * n)
        vals = torch.where(qcorr[:, None], r[:, None] ^ (word + 1), u)
        rows = torch.empty(n + 1, s, **i64)
        rows[rank + 1, pos[:, None].expand(s, n)] = vals
        rows[0] = torch.where(qcorr, r, randint_at(l3, pos, w, s * n))
        if cfg.p_depolarize > 0.0 or cfg.p_measure_flip > 0.0:
            kn = fold_in(kl, NOISE_TAG)
            table = (n + 1) * s * nq
            i = torch.arange(table)
            pauli = uniform_at(split_at(kn, 0, 3), i, table) < p32(
                cfg.p_depolarize)
            kind = randint_at(split_at(kn, 1, 3), i, 3, table)
            mflip = uniform_at(split_at(kn, 2, 3), i, table) < p32(
                cfg.p_measure_flip)
            flips = ((pauli & (kind != 2)) ^ mflip).long().reshape(
                n + 1, s, nq)
            shifts = torch.arange(nq - 1, -1, -1)
            rows = rows ^ (flips << shifts).sum(-1)
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
