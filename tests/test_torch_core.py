"""The port's pure protocol functions equal :mod:`qba_tpu.core`.

``consistent``, ``sublist_row``, ``append_own``,
``consistent_after_append``, ``decide_order``, ``success_oracle`` and
``measure_to_ints`` on the same numpy-seeded random inputs, batched on
the port's side and vmapped on the JAX side.  Half of each batch is
protocol-shaped evidence (rows over one shared P, values distinct per
position) so every verdict branch is reached; all comparisons exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu.core import append_own as j_append_own
from qba_tpu.core import consistent as j_consistent
from qba_tpu.core import consistent_after_append as j_caa
from qba_tpu.core import decide_order as j_decide
from qba_tpu.core import measure_to_ints as j_measure
from qba_tpu.core import sublist_row as j_sublist
from qba_tpu.core import success_oracle as j_success
from qba_tpu.core.types import Evidence as JEvidence
from qba_tpu_torch.core import (
    Evidence,
    append_own,
    consistent,
    consistent_after_append,
    decide_order,
    measure_to_ints,
    sublist_row,
    success_oracle,
)

CASES = [(3, 8, 4, 0), (4, 16, 8, 1), (5, 16, 16, 2), (6, 12, 64, 3)]


def random_evidence(rng, n, max_l, size_l, w):
    """``n`` evidence sets: even samples protocol-shaped, odd ones
    uniformly random (out-of-range values and ragged lengths included)."""
    vals = np.full((n, max_l, size_l), -1, np.int32)
    lens = np.zeros((n, max_l), np.int32)
    count = rng.integers(0, max_l + 1, n).astype(np.int32)
    for i in range(n):
        if i % 2 == 0:
            p = rng.random(size_l) < 0.5
            for r in range(count[i]):
                vals[i, r, p] = rng.integers(0, w, p.sum())
                lens[i, r] = p.sum()
            if rng.random() < 0.5:  # make rows distinct per position
                for j in np.flatnonzero(p):
                    vals[i, : count[i], j] = rng.permutation(w)[: count[i]]
        else:
            vals[i] = rng.integers(-1, w + 2, (max_l, size_l))
            lens[i] = rng.integers(0, size_l + 1, max_l)
    return vals, lens, count


def to_jax(vals, lens, count):
    return JEvidence(vals=jnp.asarray(vals), lens=jnp.asarray(lens),
                     count=jnp.asarray(count))


def to_torch(vals, lens, count):
    return Evidence(vals=torch.from_numpy(vals), lens=torch.from_numpy(lens),
                    count=torch.from_numpy(count))


def inputs(case, n=64):
    max_l, size_l, w, seed = case
    rng = np.random.default_rng(seed)
    ev = random_evidence(rng, n, max_l, size_l, w)
    v = rng.integers(0, w, n).astype(np.int32)
    p_mask = rng.random((n, size_l)) < 0.5
    li = rng.integers(0, w, (n, size_l)).astype(np.int32)
    return ev, v, p_mask, li, w


@pytest.mark.parametrize("case", CASES)
def test_consistent(case):
    ev, v, _p, _li, w = inputs(case)
    want = jax.vmap(lambda vv, e: j_consistent(vv, e, w))(
        jnp.asarray(v), to_jax(*ev))
    got = consistent(torch.from_numpy(v), to_torch(*ev), w)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert 0 < got.sum() < len(v)  # both verdicts reached


@pytest.mark.parametrize("case", CASES)
def test_sublist_row(case):
    _ev, _v, p_mask, li, _w = inputs(case)
    want = jax.vmap(j_sublist)(jnp.asarray(p_mask), jnp.asarray(li))
    got = sublist_row(torch.from_numpy(p_mask), torch.from_numpy(li))
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("case", CASES)
def test_append_own(case):
    ev, _v, p_mask, li, _w = inputs(case)
    want = jax.vmap(j_append_own)(to_jax(*ev), jnp.asarray(p_mask),
                                  jnp.asarray(li))
    got = append_own(to_torch(*ev), torch.from_numpy(p_mask),
                     torch.from_numpy(li))
    for f in ("vals", "lens", "count"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f


@pytest.mark.parametrize("case", CASES)
def test_consistent_after_append(case):
    ev, v, p_mask, li, w = inputs(case)
    ok_j, cnt_j = jax.vmap(lambda vv, e, p, l: j_caa(vv, e, p, l, w))(
        jnp.asarray(v), to_jax(*ev), jnp.asarray(p_mask), jnp.asarray(li))
    ok_t, cnt_t = consistent_after_append(
        torch.from_numpy(v), to_torch(*ev), torch.from_numpy(p_mask),
        torch.from_numpy(li), w)
    assert np.array_equal(np.asarray(ok_j), ok_t.numpy())
    assert np.array_equal(np.asarray(cnt_j), cnt_t.numpy())


@pytest.mark.parametrize("w", [4, 16, 64])
def test_decide_order(w):
    rng = np.random.default_rng(w)
    vi = rng.random((40, w)) < 0.1
    vi[::4] = False  # empty rows decide the sentinel w
    v = rng.integers(0, w, 40).astype(np.int32)
    is_comm = rng.random(40) < 0.3
    want = jax.vmap(lambda a, b, c: j_decide(a, b, c, w))(
        jnp.asarray(vi), jnp.asarray(v), jnp.asarray(is_comm))
    got = decide_order(torch.from_numpy(vi), torch.from_numpy(v),
                       torch.from_numpy(is_comm), w)
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got == w).any()


@pytest.mark.parametrize("n", [3, 11, 33])
def test_success_oracle(n):
    rng = np.random.default_rng(n)
    decisions = rng.integers(0, 2, (50, n)).astype(np.int32)
    decisions[::3] = 1  # agreement
    honest = rng.random((50, n)) < 0.7
    honest[::7] = False  # all dishonest -> failure
    want = jax.vmap(j_success)(jnp.asarray(decisions), jnp.asarray(honest))
    got = success_oracle(torch.from_numpy(decisions), torch.from_numpy(honest))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert 0 < got.sum() < 50


@pytest.mark.parametrize("size_l,n_qubits", [(8, 2), (16, 4), (64, 6)])
def test_measure_to_ints(size_l, n_qubits):
    rng = np.random.default_rng(size_l)
    raw = rng.integers(0, 2, (5, size_l * n_qubits)).astype(np.int32)
    want = j_measure(jnp.asarray(raw), size_l, n_qubits)
    got = measure_to_ints(torch.from_numpy(raw), size_l, n_qubits)
    assert np.array_equal(np.asarray(want), got.numpy())
