"""The port's threefry key tree equals ``jax.random`` bit for bit.

Every function of :mod:`qba_tpu_torch.random` against its ``jax.random``
counterpart over several seeds and shapes, in JAX's partitionable mode
(set only inside ``jax.threefry_partitionable(True)``, never globally).
All comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary.model import (
    ADAPT_TAG,
    ATTACK_TAG,
    COLLUDE_TAG,
    LATE_TAG,
)
from qba_tpu_torch.qsim.noise import NOISE_TAG

SEEDS = [0, 1, 7, 2**31 - 1]
SHAPES = [(), (5,), (3, 4), (2, 3, 7)]


def keys(seed):
    with jax.threefry_partitionable(True):
        return jax.random.key(seed), jr.key(seed)


def data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key(seed):
    kj, kt = keys(seed)
    assert np.array_equal(data(kj), kt.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 4, 9])
def test_split(seed, num):
    kj, kt = keys(seed)
    with jax.threefry_partitionable(True):
        want = data(jax.random.split(kj, num))
    assert np.array_equal(want, jr.split(kt, num).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "tag", [0, 1, 11, ATTACK_TAG, LATE_TAG, COLLUDE_TAG, ADAPT_TAG, NOISE_TAG]
)
def test_fold_in(seed, tag):
    kj, kt = keys(seed)
    with jax.threefry_partitionable(True):
        want = data(jax.random.fold_in(kj, tag))
    assert np.array_equal(want, jr.fold_in(kt, tag).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits(seed, shape):
    kj, kt = keys(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.bits(kj, shape, jnp.uint32))
    assert np.array_equal(want.astype(np.int64), jr.bits(kt, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", [(0, 3), (0, 4), (0, 12), (0, 63), (0, 64),
                                  (2, 9)])
def test_randint(seed, span):
    kj, kt = keys(seed)
    for shape in SHAPES:
        with jax.threefry_partitionable(True):
            want = np.asarray(
                jax.random.randint(kj, shape, *span, dtype=jnp.int32)
            )
        got = jr.randint(kt, shape, *span)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), shape


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.0, 1e-3, 0.1, 0.3, 0.5, 1.0])
def test_bernoulli(seed, p):
    kj, kt = keys(seed)
    for shape in SHAPES:
        with jax.threefry_partitionable(True):
            want = np.asarray(jax.random.bernoulli(kj, p, shape))
        assert np.array_equal(want, jr.bernoulli(kt, p, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    kj, kt = keys(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.uniform(kj, (6, 5), jnp.float32))
    assert np.array_equal(want, jr.uniform(kt, (6, 5)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 5, 11, 33])
def test_permutation(seed, n):
    kj, kt = keys(seed)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.permutation(kj, jnp.arange(1, n + 1)))
    got = jr.permutation(kt, torch.arange(1, n + 1))
    assert np.array_equal(want, got.numpy())


def test_batched_keys_match_vmap():
    # A batch of keys [T, 2] draws what jax.vmap over the keys draws.
    with jax.threefry_partitionable(True):
        kj = jax.random.split(jax.random.key(3), 6)
        want_bits = np.asarray(
            jax.vmap(lambda k: jax.random.bits(k, (4, 7), jnp.uint32))(kj)
        )
        want_int = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (4, 7), 0, 64, dtype=jnp.int32)
        )(kj))
        want_fold = data(jax.vmap(lambda k: jax.random.fold_in(k, 5))(kj))
    kt = torch.from_numpy(data(kj))
    assert np.array_equal(want_bits.astype(np.int64), jr.bits(kt, (4, 7)).numpy())
    assert np.array_equal(want_int, jr.randint(kt, (4, 7), 0, 64).numpy())
    assert np.array_equal(want_fold, jr.fold_in(kt, 5).numpy())


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        jr.key(2**31)
