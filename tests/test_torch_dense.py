"""The port's dense circuit path equals the JAX package's.

Statevectors: the port's plain per-gate engine and the plain version of
its fused circuit kernel against JAX ``impl="xla"`` and
``impl="pallas_interpret"`` at ``atol=1e-6`` (float32 products of
``1/sqrt(2)`` taken in a different order), for both protocol circuits at
3 and 4 parties and seeded random complex circuits.  Sampling:
``random.gumbel`` and ``categorical`` against ``jax.random`` (the
uniforms are bit-equal; the two float ``log`` calls may differ in the
last place, so gumbel is held at ``rtol=1e-6`` plus two ulps at 1.0 and
indices must be equal).  The integer draws of list generation (``qcorr``, permutations,
params) are bit-equal, and the lists, and a whole trial on
``qsim_path="dense"``, equal JAX's at the test keys: every amplitude on
a protocol circuit's support goes through the same arithmetic, so the
argmax is decided by the uniforms.  The closed-form properties and the
chi-square laws of tests/test_qsim.py are the hard requirement on the
lists.
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

import qba_tpu_torch
from qba_tpu_torch.diagnostics import QBADemotionWarning
from qba_tpu.backends.jax_backend import run_trials as j_run_trials
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.qsim import noise as j_noise
from qba_tpu.qsim import protocol_circuits as j_pc
from qba_tpu.qsim import statevector as j_sv
from qba_tpu.qsim.circuit import Circuit as JCircuit
from qba_tpu.qsim.circuit import Op as JOp
from qba_tpu.qsim.compat import Drewom as JDrewom
from qba_tpu.qsim.compat import QCircuit as JQCircuit
from qba_tpu_torch import random as jr
from qba_tpu_torch.convert import (
    circuit_ops_from_tuples,
    config_from_jax_fields,
    key_from_jax,
)
from qba_tpu_torch.ops import fused_circuit as fc
from qba_tpu_torch.qsim import compat, noise, protocol_circuits as pc
from qba_tpu_torch.qsim import statevector as sv
from qba_tpu_torch.qsim.circuit import Circuit, Gate
from qba_tpu_torch.testing import random_circuit
from tests.test_qsim import check_closed_form_properties

ATOL = 1e-6
FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")


def jkeys(seed, n):
    """``n`` JAX keys and the same keys as the port's tensors."""
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(seed), n)
    return keys, key_from_jax(np.asarray(jax.random.key_data(keys)))


def jax_states(jcirc, impl, params):
    fn = jcirc.compile_state(impl)
    if params is None:
        return np.asarray(fn())[None]
    return np.asarray(jax.jit(jax.vmap(fn))(jnp.asarray(params)))


def port_states(circ, impl, params):
    fn = circ.compile_state(impl, "cpu")
    if params is None:
        return fn().numpy()[None]
    return fn(torch.from_numpy(params)).numpy()


def both_circuits(tuples, n):
    jcirc = JCircuit(n, ops=[JOp(*t) for t in tuples])
    return jcirc, Circuit(n, ops=circuit_ops_from_tuples(tuples))


@pytest.mark.parametrize("n_parties", [3, 4])
@pytest.mark.parametrize("family", ["q", "nq"])
def test_protocol_circuit_statevectors(n_parties, family):
    nq = JConfig(n_parties=n_parties, size_l=4).n_qubits
    if family == "q":
        jcirc = j_pc.gen_q_corr_circuit(n_parties, nq)
        circ = pc.gen_q_corr_circuit(n_parties, nq)
        rng = np.random.default_rng(n_parties)
        params = rng.integers(0, 2, (3, circ.n_params)).astype(np.int32)
    else:
        jcirc = j_pc.gen_nq_corr_circuit(n_parties, nq)
        circ = pc.gen_nq_corr_circuit(n_parties, nq)
        params = None
    assert [dataclasses.astuple(o) for o in jcirc.ops] == [
        dataclasses.astuple(o) for o in circ.ops]
    assert circ.n_params == jcirc.n_params
    want = jax_states(jcirc, "xla", params)
    kernel = jax_states(jcirc, "pallas_interpret", params)
    plain = port_states(circ, "xla", params)
    fused = port_states(circ, "pallas", params)
    assert plain.dtype == np.complex64 and fused.dtype == np.float32
    assert kernel.dtype == np.float32  # the all-real contract, both sides
    for got in (plain, fused):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose((np.abs(fused) ** 2).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_complex_circuit_statevectors(seed):
    n = 6
    tuples = random_circuit(n, 24, seed)
    jcirc, circ = both_circuits(tuples, n)
    rng = np.random.default_rng(seed)
    params = rng.integers(0, 2, (4, max(circ.n_params, 1))).astype(np.int32)
    want = jax_states(jcirc, "xla", params)
    kernel = jax_states(jcirc, "pallas_interpret", params)
    plain = port_states(circ, "xla", params)
    fused = port_states(circ, "pallas", params)
    assert fused.dtype == np.complex64 and kernel.dtype == np.complex64
    assert np.abs(want.imag).max() > 0.01  # genuinely complex
    for got in (plain, fused):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, kernel, atol=ATOL, rtol=0)


def test_real_general_gates_stay_float32():
    # Z, RY and multi-control ops are real: the coefficient form runs on
    # one float32 plane.
    tuples = [("H", 0, (), None, None), ("H", 1, (), None, None),
              ("RY", 2, (0,), None, 0.7), ("Z", 1, (0, 2), None, None),
              ("XPOW", 3, (1,), 0, None), ("X", 0, (3,), None, None)]
    jcirc, circ = both_circuits(tuples, 4)
    params = np.asarray([[0], [1]], np.int32)
    fused = port_states(circ, "pallas", params)
    assert fused.dtype == np.float32
    np.testing.assert_allclose(fused, jax_states(jcirc, "xla", params),
                               atol=ATOL, rtol=0)
    assert fc.circuit_tables(4, circ.ops, 1).is_real
    tables = fc.circuit_tables(4, circuit_ops_from_tuples(
        [("S", 0, (), None, None)]), 0)
    assert not tables.is_real and tables.n_params == 1


def test_fused_circuit_wrapper_uses_plain_version_on_cpu():
    circ = pc.gen_q_corr_circuit(3, 2)
    run = fc.build_fused_circuit_run(circ.n_qubits, circ.ops, circ.n_params)
    before = fc.fused_circuit.launches
    params = torch.ones((2, circ.n_params), dtype=torch.int32)
    out = run(params)
    assert fc.fused_circuit.launches == before
    assert torch.equal(out, fc.fused_circuit_reference(run.tables, params))
    assert run(None, device="cpu").shape == (256,)
    with pytest.raises(ValueError, match="qubits"):
        fc.circuit_tables(21, (), 0)


def test_gumbel_and_categorical_match_jax():
    keys, tkeys = jkeys(11, 6)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 512)).astype(np.float32)
    logits[:, ::3] = -np.inf  # off-support outcomes
    with jax.threefry_partitionable(True):
        g = np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (512,)))(keys))
        idx = np.asarray(jax.vmap(jax.random.categorical)(
            keys, jnp.asarray(logits)))
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (512,), minval=np.finfo(np.float32).tiny, maxval=1.0))(keys))
    # Near g = 0 the outer log's argument is near 1, where one ulp of it
    # (2**-23 at 1.0) is an absolute, not a relative, error of g: two
    # ulps of absolute slack beside the relative tolerance.
    np.testing.assert_allclose(jr.gumbel(tkeys, (512,)).numpy(), g,
                               rtol=1e-6, atol=2.0 ** -22)
    got = jr.categorical(tkeys, torch.from_numpy(logits))
    assert got.tolist() == idx.tolist()
    # The uniforms under the gumbels are JAX's bit for bit.
    f = jr.uniform(tkeys, (512,))
    tiny = torch.tensor(np.finfo(np.float32).tiny)
    assert np.array_equal(torch.maximum(tiny, f * (1 - tiny) + tiny).numpy(),
                          u)


def test_measurements_match_jax():
    circ = pc.gen_q_corr_circuit(3, 2)
    jcirc = j_pc.gen_q_corr_circuit(3, 2)
    params = np.asarray([0, 1, 1, 0, 1, 1], np.int32)
    keys, tkeys = jkeys(5, 9)
    with jax.threefry_partitionable(True):
        state = jcirc.compile_state("xla")(jnp.asarray(params))
        want = np.asarray(jax.vmap(
            lambda k: j_sv.measure_all(state.reshape((2,) * 8), k))(keys))
        shots = np.asarray(j_sv.measure_shots(
            state.reshape((2,) * 8), keys[0], 7))
    tstate = circ.compile_state("xla", "cpu")(
        torch.from_numpy(params)[None])[0]
    assert np.array_equal(sv.measure_all(tstate, tkeys).numpy(), want)
    assert np.array_equal(sv.measure_shots(tstate, tkeys[0], 7).numpy(),
                          shots)


@pytest.mark.parametrize("kw", [dict(n_parties=3, size_l=16),
                                dict(n_parties=4, size_l=8)])
def test_integer_draws_are_bit_equal(kw):
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    keys, tkeys = jkeys(3, 4)
    n, nq, s = jcfg.n_parties, jcfg.n_qubits, jcfg.size_l

    def one(key):
        k_qcorr, k_perm, _k_meas = jax.random.split(key, 3)
        qcorr = jax.random.bernoulli(k_qcorr, 0.5, (s,))
        perms = jax.vmap(lambda k: jax.random.permutation(
            k, jnp.arange(1, n + 1, dtype=jnp.int32)))(
                jax.random.split(k_perm, s))
        return qcorr, perms, jax.vmap(lambda p: j_pc._perm_bits(p, nq))(perms)

    with jax.threefry_partitionable(True):
        want = [np.asarray(x) for x in jax.vmap(one)(keys)]
    qcorr, perms, params, _meas = pc.dense_draws(cfg, tkeys)
    for a, b in zip(want, (qcorr, perms, params)):
        assert np.array_equal(a, b.numpy())
    assert params.dtype == torch.int32 and params.shape == (4, s, n * nq)


def jax_lists(jcfg, keys, impl):
    with jax.threefry_partitionable(True):
        lists, qcorr = jax.jit(jax.vmap(
            lambda k: j_pc.generate_lists_dense(jcfg, k, impl)))(keys)
    return np.asarray(lists), np.asarray(qcorr)


@pytest.mark.parametrize("kw,noisy", [
    (dict(n_parties=3, size_l=16), False),
    (dict(n_parties=4, size_l=8), False),
    (dict(n_parties=3, size_l=16, p_depolarize=0.2, p_measure_flip=0.1),
     True),
])
def test_dense_lists_match_jax(kw, noisy):
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    keys, tkeys = jkeys(3, 4)
    want, want_q = jax_lists(jcfg, keys, "xla")
    for impl in ("xla", "pallas", "auto"):
        lists, qcorr = pc.generate_lists_dense(cfg, tkeys, impl)
        assert lists.dtype == torch.int32
        assert np.array_equal(want_q, qcorr.numpy()), impl
        assert np.array_equal(want, lists.numpy()), impl
    if noisy:
        clean, _ = pc.generate_lists_dense(
            dataclasses.replace(cfg, p_depolarize=0.0, p_measure_flip=0.0),
            tkeys, "xla")
        assert not torch.equal(clean, lists)  # the channels acted
    elif cfg.n_parties == 3:
        kernel, _ = jax_lists(jcfg, keys, "pallas_interpret")
        assert np.array_equal(kernel, lists.numpy())


def test_noise_flips_match_jax():
    keys, tkeys = jkeys(8, 5)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.vmap(
            lambda k: j_noise.classical_flips(k, 8, 0.3, 0.2))(keys))
        shots = np.asarray(j_noise.classical_flips_shots(
            keys[0], 6, 8, 0.3, 0.2))
    assert np.array_equal(noise.classical_flips(tkeys, 8, 0.3, 0.2).numpy(),
                          want)
    assert np.array_equal(
        noise.classical_flips_shots(tkeys[0], 6, 8, 0.3, 0.2).numpy(), shots)
    assert want.any() and not want.all()


@pytest.mark.parametrize("path", ["dense", "dense_pallas"])
def test_whole_trial_on_the_dense_path_matches_jax(path):
    jcfg = JConfig(n_parties=3, size_l=16, n_dishonest=1, trials=6, seed=2,
                   qsim_path="dense")
    with jax.threefry_partitionable(True):
        res = j_run_trials(jcfg)
        want = {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}
    cfg = dataclasses.replace(
        config_from_jax_fields(dataclasses.asdict(jcfg)), qsim_path=path)
    got = qba_tpu_torch.run_trials(cfg, device="cpu")
    for f in FIELDS:
        assert np.array_equal(want[f], getattr(got.trials, f).numpy()), f


def test_closed_form_properties_and_laws():
    from scipy import stats

    cfg = qba_tpu_torch.QBAConfig(n_parties=3, size_l=256, qsim_path="dense")
    keys = jr.split(jr.key(4), 4)
    lists, qcorr = pc.generate_lists_dense(cfg, keys, "pallas")
    assert lists.shape == (4, 4, 256)
    for t in range(4):
        check_closed_form_properties(lists[t].numpy(), qcorr[t].numpy(),
                                     cfg.w)
    # One trial's worth of laws over the pooled 1024 positions.
    pooled = lists.permute(1, 0, 2).reshape(4, -1).numpy()
    q = qcorr.reshape(-1).numpy()
    assert stats.binomtest(int(q.sum()), q.size, 0.5).pvalue > 1e-4
    for row in pooled:
        obs = np.bincount(row, minlength=cfg.w)
        assert stats.chisquare(obs).pvalue > 1e-4
    r = pooled[0][q]
    assert stats.chisquare(np.bincount(r, minlength=cfg.w)).pvalue > 1e-4
    xors = pooled[1:, q] ^ pooled[0:1, q]
    for i in range(cfg.n_parties):
        obs = np.bincount(xors[i], minlength=cfg.n_parties + 1)[1:]
        assert stats.chisquare(obs).pvalue > 1e-4


def test_compat_shim_matches_jax():
    def build(qc_cls, gate_cls):
        g = gate_cls(3, 0, "bell+")
        g.add_operation("H", targets=0)
        g.add_operation("X", targets=1, controls=0)
        g.add_operation("RY", targets=2, angle=0.9)
        c = qc_cls(3, 3, "c")
        c.add_operation(g)
        for q in (2, 0, 1):
            c.add_operation("MEASURE", targets=q, outputs=2 - q)
        return c

    from qba_tpu.qsim.compat import QGate as JQGate

    with jax.threefry_partitionable(True):
        jd = JDrewom(seed=4)
        want = [jd.execute(build(JQCircuit, JQGate), shots=5)
                for _ in range(2)]
    d = compat.Drewom(seed=4, device="cpu")
    circ = build(compat.QCircuit, compat.QGate)
    assert [d.execute(circ, shots=5) for _ in range(2)] == want
    with pytest.raises(ValueError, match="after MEASURE"):
        circ.add_operation("H", targets=0)
    # Past the dense cap "auto" runs the stabilizer tableau (its results
    # against JAX's are in test_torch_stabilizer.py); a non-Clifford
    # circuit raises on the stabilizer engine.
    big = compat.QCircuit(24, 24)
    assert d.execute(big, shots=2) == [[0] * 24] * 2
    with pytest.raises(ValueError, match="Clifford set"):
        compat.Drewom(engine="stabilizer", device="cpu").execute(circ)


def test_impl_resolution_and_unported_engines():
    circ = Circuit(2).add_operation(Gate(2).add_operation("H", targets=0))
    assert circ.resolve_auto_impl("cpu") == "xla"
    assert circ.resolve_auto_impl(torch.device("cuda")) == "pallas"
    with pytest.raises(ValueError, match="no statevector"):
        circ.compile_state("stabilizer", "cpu")
    with pytest.warns(QBADemotionWarning, match="dense cap"):
        assert Circuit(21).resolve_auto_impl("cpu") == "stabilizer"
    with pytest.raises(ValueError, match="unknown circuit impl"):
        circ.compile_state("mosaic", "cpu")
    with pytest.raises(ValueError, match="XPOW requires"):
        Gate(2).add_operation("XPOW", targets=0)
    cfg = qba_tpu_torch.QBAConfig(n_parties=3, size_l=4,
                                  qsim_path="stabilizer")
    keys = jr.split(jr.key(0), 1)
    lists, qcorr = qba_tpu_torch.qsim.generate_lists_for(cfg, keys)
    assert lists.shape == (1, 4, 4) and qcorr.shape == (1, 4)
    assert torch.equal(lists, qba_tpu_torch.qsim.generate_lists_dense(
        cfg, keys, impl="stabilizer")[0])
