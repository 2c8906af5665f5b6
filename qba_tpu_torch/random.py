"""threefry2x32 key tree, bit-identical to ``jax.random``.

A trial is a pure function of its key, so the port reproduces the exact
derivations :mod:`qba_tpu` calls: ``key``, ``split``, ``fold_in``,
``bits``, ``randint``, ``bernoulli``, ``permutation``, ``gumbel`` and
``categorical``, in both of JAX's threefry modes:

* partitionable (``jax_threefry_partitionable=True``, JAX's default since
  0.5): every output element hashes its own 64-bit flat index as the
  counter pair ``(hi, lo)``, and ``split`` hashes each new key's index;
* legacy (``False``, the default before): ``bits`` of ``n`` words hashes
  the halves of ``iota(n)`` (padded with one zero when ``n`` is odd) as
  counter pairs ``(i, i + h)``, ``h = ceil(n / 2)``, and concatenates the
  two output words, so an element depends on the array's size; ``split``
  is the words of ``iota(2 * num)`` as ``num`` keys.

``fold_in`` is the same in both.  The mode is read as JAX reads it: the
process default from ``JAX_THREEFRY_PARTITIONABLE`` (JAX's truth values,
default True), overridden in a thread by :func:`threefry_partitionable`
(``jax.threefry_partitionable``'s counterpart).  Every function that
draws takes ``partitionable=`` (None: the current mode, read once); the
port's entry points read the mode once and pass it down, so nothing
under a kernel launch or inside a captured graph reads it again.

Representation: a key is an int64 tensor ``[..., 2]`` holding two uint32
words; leading axes are a batch of independent keys (the trial axis), so
one call draws for every trial at once.  All arithmetic is int64 with
32-bit masks: PyTorch has no uint32 add or shift on every device.  Keys
are explicit tensors passed in, never global state.
"""

from __future__ import annotations

import contextlib
import math
import os
import struct
import threading

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

ENV_VAR = "JAX_THREEFRY_PARTITIONABLE"


def parse_bool_env(value: str | None, name: str = ENV_VAR,
                   default: bool = True) -> bool:
    """A boolean environment value as JAX's ``bool_env`` parses it: ``y,
    yes, t, true, on, 1`` and ``n, no, f, false, off, 0`` in any case,
    ``default`` when unset; anything else raises ``ValueError``."""
    val = str(default) if value is None else value
    val = val.lower()
    if val in ("y", "yes", "t", "true", "on", "1"):
        return True
    if val in ("n", "no", "f", "false", "off", "0"):
        return False
    raise ValueError(f"invalid truth value {val!r} for environment {name!r}")


# The process default, read once at import as JAX reads its flag.
_DEFAULT_PARTITIONABLE = parse_bool_env(os.environ.get(ENV_VAR))
_local = threading.local()


def partitionable_mode() -> bool:
    """The current threefry mode: this thread's
    :func:`threefry_partitionable` override, else the process default."""
    mode = getattr(_local, "mode", None)
    return _DEFAULT_PARTITIONABLE if mode is None else mode


def resolve_mode(partitionable: bool | None) -> bool:
    """``partitionable`` as a bool: the current mode where it is None."""
    return partitionable_mode() if partitionable is None else bool(partitionable)


@contextlib.contextmanager
def threefry_partitionable(flag: bool = True):
    """``jax.threefry_partitionable(flag)``: the threefry mode of this
    thread inside the block, restored on exit (an exception too)."""
    prev = getattr(_local, "mode", None)
    _local.mode = bool(flag)
    try:
        yield
    finally:
        _local.mode = prev


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s key data for a seed in int32 range (JAX
    truncates Python ints to int32 in its default 32-bit mode): ``[0,
    seed & M32]``, the high word being JAX's logical shift of the int32
    seed by 32 bits, which is 0 for a negative seed too.  Filled on
    ``device``, with no copy from host memory, so a CUDA graph may
    capture it."""
    s = int(seed)
    if not -(2**31) <= s < 2**31:
        raise ValueError(f"seed {s} outside int32 range")
    k = torch.full((2,), s & _M32, dtype=torch.int64, device=device)
    k[:1].fill_(0)
    return k


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function on broadcastable int64 operands
    holding uint32 values: returns the two output words."""
    ks = (k0, k1, (k0 ^ k1) ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_counts(keys: torch.Tensor, shape: tuple[int, ...]):
    """threefry over the flat-index counters of ``shape`` for every key:
    two int64 tensors ``[*batch, *shape]``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & _M32).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(keys[..., 0][expand], keys[..., 1][expand], hi, lo)


def _legacy_words(keys: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's non-partitionable ``threefry_2x32(key, iota(n))`` for every
    key: int64 ``[*batch, n]``.  Entry ``i < h = ceil(n / 2)`` is word 0
    of ``threefry(key, (i, i + h))``, the counter ``i + h == n`` being the
    odd size's zero pad; entry ``i >= h`` is word 1 of ``threefry(key,
    (i - h, i))``.  JAX splits past ``2**32 - 1`` words into blocks of
    subkeys; no draw of the port comes near, so that raises."""
    if n >= _M32:
        raise ValueError(
            f"legacy threefry draws of {n} words: JAX's block-split form "
            f"for 2**32 - 1 words or more is not implemented")
    h = n - n // 2
    x0 = torch.arange(h, dtype=torch.int64, device=keys.device)
    x1 = x0 + h
    x1 = torch.where(x1 == n, 0, x1)
    y0, y1 = threefry2x32(keys[..., 0, None], keys[..., 1, None], x0, x1)
    return torch.cat([y0, y1], dim=-1)[..., :n]


def split(keys: torch.Tensor, num: int = 2, *,
          partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2] -> [..., num, 2]``."""
    if not resolve_mode(partitionable):
        words = _legacy_words(keys, 2 * num)
        return words.reshape(keys.shape[:-1] + (num, 2))
    y0, y1 = _hash_counts(keys, (num,))
    return torch.stack([y0, y1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` with a Python integer or an integer tensor
    on the keys' device (cast to uint32, as JAX casts a traced int32).
    A tensor operand stays on the device: a CUDA graph may capture the
    call and read ``data`` when it replays."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _M32
    else:
        d = torch.full((), int(data) & _M32, dtype=torch.int64,
                       device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(keys: torch.Tensor, shape: tuple[int, ...], *,
         partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 ``[..., *shape]``
    holding uint32 values."""
    if not resolve_mode(partitionable):
        shape = tuple(int(d) for d in shape)
        words = _legacy_words(keys, math.prod(shape))
        return words.reshape(keys.shape[:-1] + shape)
    y0, y1 = _hash_counts(keys, shape)
    return y0 ^ y1


def randint(keys: torch.Tensor, shape: tuple[int, ...], minval: int,
            maxval: int, *, partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.randint(..., dtype=int32)``: two draws per value, the
    high one scaled by ``2**32 mod span`` (JAX's bias-reducing span
    construction), int32 ``[..., *shape]``."""
    if maxval <= minval:
        span = 1
    else:
        span = (maxval - minval) & _M32
    p = resolve_mode(partitionable)
    k = split(keys, 2, partitionable=p)
    higher = bits(k[..., 0, :], shape, partitionable=p)
    lower = bits(k[..., 1, :], shape, partitionable=p)
    mult = (2**16) % span
    mult = (mult * mult) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)


def uniform(keys: torch.Tensor, shape: tuple[int, ...], *,
            partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [0, 1): the top 23 bits as
    the mantissa of a float in [1, 2), minus one."""
    b = bits(keys, shape, partitionable=partitionable)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


_TINY = torch.finfo(torch.float32).tiny


def _float32(x: float) -> float:
    """``x`` rounded to float32, as a Python float: a scalar operand
    that compares with a float32 tensor as JAX's ``float32(x)`` does,
    with no tensor made from host memory."""
    return struct.unpack("f", struct.pack("f", x))[0]


def gumbel(keys: torch.Tensor, shape: tuple[int, ...], *,
           partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (JAX's default "low" mode):
    ``-log(-log(u))`` with ``u = uniform(minval=tiny, maxval=1)``, which
    JAX computes as ``max(tiny, f * (1 - tiny) + tiny)`` on the [0, 1)
    uniform ``f``.  The uniforms equal JAX's bit for bit; the two ``log``
    calls may differ from XLA's in the last place."""
    f = uniform(keys, shape, partitionable=partitionable)
    # float32(1 - tiny) is 1, and tiny is a float32 value: the float32
    # arithmetic is JAX's.
    u = (f + _TINY).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor, *,
                partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis:
    ``argmax(gumbel + logits)``, the first index on a tie.  ``logits`` is
    ``[..., n]`` with leading axes matching (or broadcasting against) the
    keys' batch axes; returns int64 ``[...]``."""
    g = gumbel(keys, (logits.shape[-1],), partitionable=partitionable)
    return torch.argmax(g + logits, dim=-1)


def bernoulli(keys: torch.Tensor, p: float, shape: tuple[int, ...], *,
              partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < float32(p)``, bool."""
    u = uniform(keys, shape, partitionable=partitionable)
    return u < _float32(p)


def permutation(keys: torch.Tensor, x: torch.Tensor, *,
                partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.permutation`` of a 1-D tensor ``x``: JAX's sort-based
    shuffle (``ceil(3 ln n / ln(2**32 - 1))`` rounds of a stable sort by
    fresh uint32 keys).  Returns ``[..., n]``."""
    n = x.shape[0]
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    p = resolve_mode(partitionable)
    out = x.expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        k = split(keys, 2, partitionable=p)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.argsort(bits(sub, (n,), partitionable=p), dim=-1,
                              stable=True)
        out = torch.gather(out, -1, order)
    return out
