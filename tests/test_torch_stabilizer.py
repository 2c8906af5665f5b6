"""The port's stabilizer resource path equals the JAX package's.

On the same keys: the noise channel draws, the static tableaux and the
per-trial generation operands of the megakernel's gen entry, the lists
of ``generate_lists_stabilizer`` (5p, 11p/L64 and 33p/L8, noiseless and
noisy), the circuit API's stabilizer executors and its ``auto`` hand-off
past the dense cap, ``Drewom`` past 20 qubits, and whole trials with
``qsim_path="stabilizer"`` on the ``xla`` engine, the fused per-round
engine (host-generated lists) and the megakernel with ``mega_gen`` "gf2"
(its plain version here) and "host".  The JAX side is always its host
generation path: its gen-fused megakernel in interpret mode takes
minutes a case.  Exact equality throughout.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

import qba_tpu_torch
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.qsim import noise as jnoise
from qba_tpu.qsim import protocol_circuits as jpc
from qba_tpu.qsim.compat import Drewom as JDrewom
from qba_tpu.qsim.compat import QCircuit as JQCircuit
from qba_tpu.qsim.compat import QGate as JQGate
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    gen_operands_from_numpy,
    gen_tables_from_numpy,
    key_from_jax,
)
from qba_tpu_torch.diagnostics import QBADemotionWarning
from qba_tpu_torch.qsim import compat
from qba_tpu_torch.qsim import noise as tnoise
from qba_tpu_torch.qsim import protocol_circuits as tpc
from qba_tpu_torch.rounds.engine import resolve_mega_gen
from tests.test_torch_draws import jax_run_trials

NOISE = dict(p_depolarize=0.1, p_measure_flip=0.05)
GEN = {
    "5p": dict(n_parties=5, size_l=16),
    "5p-noisy": dict(n_parties=5, size_l=16, **NOISE),
    "11p": dict(n_parties=11, size_l=64),
    "11p-noisy": dict(n_parties=11, size_l=64, **NOISE),
    "33p-L8-noisy": dict(n_parties=33, size_l=8, **NOISE),
}
FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")


def jax_keys(n, seed):
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(seed), n)
        return keys, key_from_jax(np.asarray(jax.random.key_data(keys)))


def test_noise_draws_match_jax():
    jkeys, tkeys = jax_keys(6, 1)
    with jax.threefry_partitionable(True):
        want = jax.jit(jax.vmap(
            lambda k: jnoise.noise_draws(k, 23, 0.3, 0.2)))(jkeys)
    got = tnoise.noise_draws(tkeys, 23, 0.3, 0.2)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert all(g.any() for g in got)


@functools.lru_cache(maxsize=None)
def jax_generation(case):
    """JAX's tables, operands and lists for two trials of ``case``."""
    jcfg = JConfig(**GEN[case])
    jkeys, tkeys = jax_keys(2, 3)
    with jax.threefry_partitionable(True):
        ops, (lists, qcorr) = jax.jit(jax.vmap(lambda k: (
            jpc.stabilizer_gen_operands(jcfg, k),
            jpc.generate_lists_stabilizer(jcfg, k))))(jkeys)
        tables = jpc.stabilizer_gen_tables(jcfg)
    return (tables, [np.asarray(x) for x in ops], np.asarray(lists),
            np.asarray(qcorr), tkeys)


@pytest.mark.parametrize("case", ["5p", "5p-noisy", "11p", "11p-noisy"])
def test_gen_tables_and_operands_match_jax(case):
    tables, ops, _lists, _qcorr, tkeys = jax_generation(case)
    cfg = qba_tpu_torch.QBAConfig(**GEN[case])
    for w, g in zip(gen_tables_from_numpy(tables),
                    tpc.stabilizer_gen_tables(cfg)):
        assert torch.equal(w, g)
    got = tpc.stabilizer_gen_operands(cfg, tkeys)
    want = gen_operands_from_numpy(*ops)
    for name, w, g in zip(("qcorr", "coins", "r_q", "r_nq", "mflip"), want,
                          got):
        assert g.dtype == w.dtype and torch.equal(w, g), name
    assert got[4].any() == ("noisy" in case)


@pytest.mark.parametrize("case", list(GEN))
def test_generate_lists_stabilizer_matches_jax(case):
    _tables, _ops, lists, qcorr, tkeys = jax_generation(case)
    cfg = qba_tpu_torch.QBAConfig(**GEN[case])
    got_lists, got_qcorr = tpc.generate_lists_stabilizer(cfg, tkeys)
    assert np.array_equal(lists, got_lists.numpy())
    assert np.array_equal(qcorr, got_qcorr.numpy())
    assert torch.equal(
        got_lists, qba_tpu_torch.qsim.generate_lists_for(
            dataclasses.replace(cfg, qsim_path="stabilizer"), tkeys)[0])


def test_dense_generation_on_the_tableau_engines():
    # impl="stabilizer" (the per-shot engine) equals the batched path, and
    # impl="auto" past the dense cap hands the batch to it, recorded.
    _tables, _ops, lists, qcorr, tkeys = jax_generation("5p-noisy")
    cfg = qba_tpu_torch.QBAConfig(**GEN["5p-noisy"])
    got = tpc.generate_lists_dense(cfg, tkeys, impl="stabilizer")
    assert np.array_equal(lists, got[0].numpy())
    assert np.array_equal(qcorr, got[1].numpy())
    _tables, _ops, lists, _qcorr, tkeys = jax_generation("11p")
    cfg = qba_tpu_torch.QBAConfig(**GEN["11p"])
    with pytest.warns(QBADemotionWarning, match="dense cap"):
        got = tpc.generate_lists_dense(cfg, tkeys, impl="auto")
    assert np.array_equal(lists, got[0].numpy())


def test_circuit_stabilizer_executors_match_jax():
    nq, n = 2, 3
    jc, tc = jpc.gen_q_corr_circuit(n, nq), tpc.gen_q_corr_circuit(n, nq)
    params = np.array([1, 0, 0, 1, 1, 1], np.int32)
    jkeys, tkeys = jax_keys(5, 7)
    with jax.threefry_partitionable(True):
        run1 = jc.compile("stabilizer")
        want1 = jax.jit(jax.vmap(lambda k: run1(k, jnp.asarray(params))))(
            jkeys)
        want_shots = jax.jit(jc.compile_shots("stabilizer", 0.1, 0.05),
                             static_argnums=1)(jkeys[0], 12,
                                               jnp.asarray(params))
    got1 = tc.compile("stabilizer")(
        tkeys, torch.from_numpy(params)[None].expand(5, -1))
    got_shots = tc.compile_shots("stabilizer", 0.1, 0.05)(
        tkeys[0], 12, torch.from_numpy(params))
    assert np.array_equal(np.asarray(want1), got1.numpy())
    assert np.array_equal(np.asarray(want_shots), got_shots.numpy())
    with pytest.raises(ValueError, match="no statevector"):
        tc.compile_state("stabilizer", "cpu")
    # Past the cap: Clifford goes to the tableau, anything else raises.
    wide = qba_tpu_torch.qsim.Circuit(21)
    with pytest.warns(QBADemotionWarning, match="dense cap"):
        assert wide.resolve_auto_impl("cpu") == "stabilizer"
    wide.add_operation(qba_tpu_torch.qsim.Gate(21).add_operation(
        "RY", targets=0, angle=0.3))
    with pytest.raises(ValueError, match="no executor can run it"):
        wide.resolve_auto_impl("cpu")


def test_drewom_past_the_dense_cap_matches_jax():
    def build(qc_cls, qg_cls, size):
        g = qg_cls(size, 0, "ghz")
        g.add_operation("H", targets=0)
        for q in range(1, size):
            g.add_operation("X", targets=q, controls=q - 1)
        c = qc_cls(size, size, "c")
        c.add_operation(g)
        return c

    with jax.threefry_partitionable(True):
        jd, js = JDrewom(seed=2), JDrewom(seed=3, engine="stabilizer")
        want = [jd.execute(build(JQCircuit, JQGate, 24), shots=3)
                for _ in range(2)]
        want_s = js.execute(build(JQCircuit, JQGate, 5), shots=4)
    d = compat.Drewom(seed=2, device="cpu")
    circ = build(compat.QCircuit, compat.QGate, 24)
    got = [d.execute(circ, shots=3) for _ in range(2)]
    assert got == want
    assert all(len(set(row)) == 1 for shot in got for row in shot)  # GHZ
    got_s = compat.Drewom(seed=3, engine="stabilizer", device="cpu").execute(
        build(compat.QCircuit, compat.QGate, 5), shots=4)
    assert got_s == want_s


TRIALS = {
    "5p": dict(n_parties=5, size_l=16, n_dishonest=2, trials=8, seed=3,
               qsim_path="stabilizer"),
    "11p-noisy-split": dict(n_parties=11, size_l=64, n_dishonest=3,
                            trials=3, seed=1, qsim_path="stabilizer",
                            strategy="split", p_depolarize=0.05,
                            p_measure_flip=0.02),
}


@functools.lru_cache(maxsize=None)
def jax_trials(case):
    res = jax_run_trials(JConfig(**TRIALS[case]))
    return {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}


@pytest.mark.parametrize("case", list(TRIALS))
def test_stabilizer_trials_match_jax(case):
    want = jax_trials(case)
    cfg = config_from_jax_fields(dataclasses.asdict(JConfig(**TRIALS[case])))
    for engine in ("xla", "pallas_fused"):
        res = qba_tpu_torch.run_trials(
            dataclasses.replace(cfg, round_engine=engine), device="cpu")
        for f in FIELDS:
            assert np.array_equal(want[f], getattr(res.trials, f).numpy()), (
                engine, f)


@pytest.mark.parametrize("case", list(TRIALS))
def test_gen_megakernel_plain_matches_host_and_jax(case):
    want = jax_trials(case)
    cfg = config_from_jax_fields(dataclasses.asdict(JConfig(**TRIALS[case])))
    gen = dataclasses.replace(cfg, round_engine="pallas_mega", mega_gen="gf2")
    host = dataclasses.replace(gen, mega_gen="host")
    assert resolve_mega_gen(gen, torch.device("cpu")) == "gf2"
    assert resolve_mega_gen(host, torch.device("cpu")) == "host"
    a = qba_tpu_torch.run_trials(gen, device="cpu").trials
    b = qba_tpu_torch.run_trials(host, device="cpu").trials
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert np.array_equal(want[f], getattr(a, f).numpy()), f


def test_resolve_mega_gen():
    base = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16,
                                   qsim_path="stabilizer")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_mega_gen(base, cuda) == "gf2"  # auto -> pallas_mega
    assert resolve_mega_gen(base, cpu) == "host"  # auto -> xla
    for kw in [dict(mega_gen="host"), dict(round_engine="pallas_fused"),
               dict(collect_counters=True)]:
        assert resolve_mega_gen(dataclasses.replace(base, **kw), cuda) == \
            "host", kw
    # A forced gf2 never demotes on this card, and needs the stabilizer.
    forced = dataclasses.replace(base, mega_gen="gf2",
                                 round_engine="pallas_mega")
    assert resolve_mega_gen(forced, cpu) == "gf2"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_mega_gen(forced, cuda) == "gf2"
    with pytest.raises(ValueError, match="mega_gen='gf2'"):
        qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, mega_gen="gf2")


@pytest.mark.slow
def test_65p_generation_matches_jax():
    jcfg = JConfig(n_parties=65, size_l=4)
    jkeys, tkeys = jax_keys(1, 9)
    with jax.threefry_partitionable(True):
        lists, qcorr = jax.vmap(
            lambda k: jpc.generate_lists_stabilizer(jcfg, k))(jkeys)
    cfg = qba_tpu_torch.QBAConfig(n_parties=65, size_l=4)
    got = tpc.generate_lists_stabilizer(cfg, tkeys)
    assert np.array_equal(np.asarray(lists), got[0].numpy())
    assert np.array_equal(np.asarray(qcorr), got[1].numpy())
