"""The port's GF(2) layer equals the JAX package's, bit for bit.

The bit-packed vectors and the parity algebra (``qba_tpu_torch.gf2``
against ``qba_tpu.gf2``) on the same seeded numpy inputs; the symplectic
compilation of both protocol circuit families and of seeded random
Clifford circuits; the plain measurement sweep on the same tableaux,
phases and coins; the per-shot tableau engine on the same keys; and the
port's batched GF(2) engine against its own per-shot engine.  The port
holds packed words as int32 with the JAX package's uint32 bit patterns,
so words compare through ``view(np.uint32)``.  Exact equality
throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import gf2 as jgf2
from qba_tpu.gf2 import symplectic as jsym
from qba_tpu.qsim import protocol_circuits as jpc
from qba_tpu.qsim import stabilizer as jstab
from qba_tpu.qsim.circuit import Op as JOp
from qba_tpu_torch import gf2 as tgf2
from qba_tpu_torch import random as jr
from qba_tpu_torch.convert import circuit_ops_from_tuples, key_from_jax
from qba_tpu_torch.qsim import protocol_circuits as tpc
from qba_tpu_torch.qsim import stabilizer as tstab
from qba_tpu_torch.testing import random_clifford, random_sweep_inputs


def u32(words):
    """The port's int32 words as the JAX package's uint32."""
    return words.numpy().view(np.uint32)


def j_ops(ops):
    return tuple(JOp(*t) for t in ops)


def test_pack_unpack_and_bits():
    rng = np.random.default_rng(0)
    for n in (1, 32, 33, 70):
        bits = rng.integers(0, 2, (3, 4, n)).astype(np.int32)
        jw = np.asarray(jgf2.pack_bits(jnp.asarray(bits)))
        tw = tgf2.pack_bits(torch.from_numpy(bits))
        assert tw.dtype == torch.int32
        assert np.array_equal(jw, u32(tw))
        assert np.array_equal(
            np.asarray(jgf2.unpack_bits(jnp.asarray(jw), n)),
            tgf2.unpack_bits(tw, n).numpy())
        for j in {0, n // 2, n - 1}:
            assert np.array_equal(np.asarray(jgf2.get_bit(jnp.asarray(jw), j)),
                                  tgf2.get_bit(tw, j).numpy())
            assert np.array_equal(np.asarray(jgf2.unit_words(n, j)),
                                  u32(tgf2.unit_words(n, j)))
        assert tgf2.n_words(n) == jgf2.n_words(n)


def test_parity_mask_and_prefix():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (5, 9, 3), dtype=np.uint64).astype(
        np.uint32)
    words[0, 0, 0] = 0x80000000  # the sign bit alone
    tw = torch.from_numpy(words.view(np.int32))
    for axis in (-1, (-2, -1)):
        assert np.array_equal(
            np.asarray(jgf2.parity_words(jnp.asarray(words), axis=axis)),
            tgf2.parity_words(tw, axis=axis).numpy())
    mask = rng.integers(0, 2, (5, 9))
    assert np.array_equal(np.asarray(jgf2.mask_words(jnp.asarray(mask))),
                          u32(tgf2.mask_words(torch.from_numpy(mask))))
    for axis in (0, 1, -2):
        assert np.array_equal(
            np.asarray(jgf2.prefix_xor_exclusive(jnp.asarray(words), axis)),
            u32(tgf2.prefix_xor_exclusive(tw, axis)))


@pytest.mark.parametrize("k", [0, 5, 256, 300, 700])
def test_gf2_matmul(k):
    rng = np.random.default_rng(k)
    a = rng.integers(0, 2, (2, 7, k)).astype(np.int32)
    b = rng.integers(0, 2, (k, 9)).astype(np.int32)
    want = np.asarray(jgf2.gf2_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = tgf2.gf2_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())
    v = rng.integers(0, 2, (2, k)).astype(np.int32)
    assert np.array_equal(
        np.asarray(jgf2.gf2_matvec(jnp.asarray(a), jnp.asarray(v))),
        tgf2.gf2_matvec(torch.from_numpy(a), torch.from_numpy(v)).numpy())
    with pytest.raises(ValueError, match="contraction mismatch"):
        tgf2.gf2_matmul(torch.from_numpy(a), torch.from_numpy(b.T))


def test_rank1_update_and_triangular_parity():
    rng = np.random.default_rng(2)
    m = rng.integers(0, 2**32, (4, 12, 3), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (4, 12, 3), dtype=np.uint64).astype(np.uint32)
    mask = rng.integers(0, 2, (4, 12)).astype(np.int32)
    row = m[:, 0]
    tm_, tx = (torch.from_numpy(a.view(np.int32)) for a in (m, x))
    assert np.array_equal(
        np.asarray(jgf2.rank1_update_packed(jnp.asarray(m), jnp.asarray(mask),
                                            jnp.asarray(row))),
        u32(tgf2.rank1_update_packed(tm_, torch.from_numpy(mask), tm_[:, 0])))
    assert np.array_equal(
        np.asarray(jgf2.triangular_parity(jnp.asarray(m), jnp.asarray(x))),
        tgf2.triangular_parity(tm_, tx).numpy())


def _programs_equal(jp, tp):
    for f in ("x", "z", "r", "l"):
        assert np.array_equal(getattr(jp, f), getattr(tp, f)), f
    assert jp.n == tp.n


@pytest.mark.parametrize("n_parties", [3, 5, 11])
def test_compile_symplectic_protocol_families(n_parties):
    nq = int(np.ceil(np.log2(n_parties + 1)))
    total = (n_parties + 1) * nq
    for j_build, t_build in ((jpc.gen_q_corr_circuit, tpc.gen_q_corr_circuit),
                             (jpc.gen_nq_corr_circuit,
                              tpc.gen_nq_corr_circuit)):
        jc, tc = j_build(n_parties, nq), t_build(n_parties, nq)
        assert [dataclasses.astuple(o) for o in jc.ops] == [
            dataclasses.astuple(o) for o in tc.ops]
        _programs_equal(
            jsym.compile_symplectic(total, tuple(jc.ops), jc.n_params),
            tgf2.compile_symplectic(total, tuple(tc.ops), tc.n_params))


@pytest.mark.parametrize("n,seed", [(6, 0), (23, 1), (40, 2)])
def test_compile_symplectic_random_clifford(n, seed):
    ops = random_clifford(n, 5 * n, seed)
    _programs_equal(jsym.compile_symplectic(n, j_ops(ops), 3),
                    tgf2.compile_symplectic(n, circuit_ops_from_tuples(ops),
                                            3))
    with pytest.raises(ValueError, match="Clifford set"):
        tgf2.compile_symplectic(2, circuit_ops_from_tuples(
            [("S", 0, (), None, None)]), 0)


@pytest.mark.parametrize("n,seed", [(12, 3), (45, 4)])
def test_measure_sweep_matches_jax(n, seed):
    xw, zw, r, coins, family, _mflip = random_sweep_inputs(n, 24, seed)
    fam = family.long()
    x, z = xw[fam], zw[fam]
    work = {}
    got = tgf2.gf2_measure_sweep(n, x, z, r, coins, work=work)
    with jax.threefry_partitionable(True):
        want = jax.jit(jsym.gf2_measure_sweep, static_argnums=0)(
            n, jnp.asarray(u32(x)), jnp.asarray(u32(z)),
            jnp.asarray(r.numpy().astype(np.int32)),
            jnp.asarray(coins.numpy().astype(np.int32)))
    assert np.array_equal(np.asarray(want), got.numpy())
    # Both branches ran, and pivots fell past the first stabilizer row.
    assert work["random_steps"] and work["det_steps"] and work["late_pivots"]


def test_per_shot_engine_matches_jax():
    # Noiseless, the circuit API's test in test_torch_stabilizer.py.
    n, ops = 9, random_clifford(9, 40, 5)
    noise_args = (0.2, 0.1)
    params = np.array([1, 0, 1], np.int32)
    with jax.threefry_partitionable(True):
        key = jax.random.key(11)
        run = jax.jit(jstab.build_tableau_run_shots(n, j_ops(ops), 3,
                                                    *noise_args),
                      static_argnums=1)
        want = np.asarray(run(key, 16, jnp.asarray(params)))
        kd = np.asarray(jax.random.key_data(key))
    trun = tstab.build_tableau_run_shots(n, circuit_ops_from_tuples(ops), 3,
                                         *noise_args)
    got = trun(key_from_jax(kd), 16, torch.from_numpy(params))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("noise", [False, True])
def test_gf2_engine_matches_per_shot_engine(noise):
    n, ops = 30, circuit_ops_from_tuples(random_clifford(30, 120, 6))
    noise_args = (0.2, 0.1) if noise else (0.0, 0.0)
    params = torch.tensor([0, 1, 1], dtype=torch.int32)
    key = jr.key(12)
    fast = tgf2.build_gf2_tableau_run_shots(n, ops, 3, *noise_args)
    slow = tstab.build_tableau_run_shots(n, ops, 3, *noise_args)
    assert torch.equal(fast(key, 40, params), slow(key, 40, params))
    assert torch.equal(fast(key, 8), slow(key, 8))
