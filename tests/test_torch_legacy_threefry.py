"""The port in JAX's legacy threefry mode equals the JAX package in it.

``jax_threefry_partitionable=False`` (JAX's default before 0.5, set with
``JAX_THREEFRY_PARTITIONABLE``) draws ``bits`` of ``n`` words over the
halves of ``iota(n)`` and ``split``s a key into the words of ``iota(2 *
num)``; the repo's golden pins (``tests/test_strategies.py:63-76``) were
recorded in that mode.  Here every ``random`` primitive, the draws'
per-entry formula and plain version (whole tables and the slices the
``n_recv`` shards and the broadcast walks take), every engine's CPU path
(the keyed megakernels' plain versions included), the three list paths
and the split/seed-9 targeted sweep are held against ``jax.random`` and
the JAX package in that mode, and the golden pins against their literals
(``qba_tpu_torch.testing.GOLD_PINS``).  Every JAX legacy computation runs
inside ``jax.threefry_partitionable(False)``, never ``jax.config.update``;
the port's inside its own ``threefry_partitionable(False)`` or with
``partitionable=False``.  The tolerance is exact equality, but for
``gumbel``'s floats, held as ``test_torch_dense.py`` holds them.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

import qba_tpu_torch
from qba_tpu.adversary import adversary_ctx as j_ctx
from qba_tpu.adversary import assign_dishonest as j_assign_dishonest
from qba_tpu.adversary import commander_orders as j_commander_orders
from qba_tpu.backends.jax_backend import aggregate as j_aggregate
from qba_tpu.backends.jax_backend import batched_trials as j_batched_trials
from qba_tpu.backends.jax_backend import trial_keys as j_trial_keys
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.qsim import generate_lists_for as j_generate_lists_for
from qba_tpu.rounds.engine import _stacked_draws as j_stacked_draws
from qba_tpu import sweep as jsweep
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import (
    adversary_ctx,
    assign_dishonest,
    commander_orders,
)
from qba_tpu_torch.backends.torch_backend import trial_keys
from qba_tpu_torch.convert import config_from_jax_fields, key_from_jax
from qba_tpu_torch.ops import attack_draws as ad
from qba_tpu_torch.ops import trial_megakernel as tm
from qba_tpu_torch.parallel import make_mesh, run_trials_spmd
from qba_tpu_torch.qsim import generate_lists_dense, generate_lists_for
from qba_tpu_torch.sweep import run_sweep
from qba_tpu_torch.testing import GOLD_PINS
from tests.test_torch_draws import COMBOS, FIELDS, SIZES, fast_jit, jcfg_of

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(), (5,), (3, 4), (2, 3, 7)]
ENGINES = ("xla", "pallas", "pallas_fused", "pallas_tiled", "pallas_mega")
DECIDE = "decide vs 1/3 @ 95%"


def legacy():
    """JAX's legacy mode, as the tests set it."""
    return jax.threefry_partitionable(False)


def keys_of(seed):
    with legacy():
        return jax.random.key(seed), jr.key(seed)


def data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def batch_of(seed, n=3):
    """``n`` JAX keys split off ``seed`` in the legacy mode and the same
    keys as the port's ``[n, 2]``."""
    with legacy():
        kj = jax.random.split(jax.random.key(seed), n)
    return kj, torch.from_numpy(data(kj))


def same(want, got):
    return np.array_equal(np.asarray(want), got.numpy())


# ---- the key tree --------------------------------------------------------


@pytest.mark.parametrize("num", [1, 2, 3, 5])
def test_split(num):
    for seed in SEEDS:
        kj, kt = keys_of(seed)
        bj, bt = batch_of(seed)
        with legacy():
            want = data(jax.random.split(kj, num))
            want_b = data(jax.vmap(lambda k: jax.random.split(k, num))(bj))
        with jr.threefry_partitionable(False):
            assert same(want, jr.split(kt, num))
            assert same(want_b, jr.split(bt, num))
        assert same(want, jr.split(kt, num, partitionable=False))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 2**18])
def test_bits(n):
    # Odd sizes pad the counters with one zero: the last entry of the
    # first half pairs with the pad.
    for seed in SEEDS[:2]:
        kj, kt = keys_of(seed)
        with legacy():
            want = np.asarray(jax.random.bits(kj, (n,), jnp.uint32))
        assert same(want.astype(np.int64), jr.bits(kt, (n,),
                                                   partitionable=False))
    bj, bt = batch_of(3)
    shape = (n,) if n < 64 else (4, n // 4)
    with legacy():
        want = np.asarray(jax.vmap(
            lambda k: jax.random.bits(k, shape, jnp.uint32))(bj))
    with jr.threefry_partitionable(False):
        assert same(want.astype(np.int64), jr.bits(bt, shape))


def test_bits_past_the_block_split_raise():
    # JAX draws 2**32 - 1 words or more in blocks of subkeys; the port
    # refuses before it allocates anything.
    with pytest.raises(ValueError, match="block-split"):
        jr.bits(jr.key(0), (2**16, 2**16), partitionable=False)


def test_integer_and_float_draws():
    for seed in SEEDS:
        kj, kt = keys_of(seed)
        for shape in SHAPES:
            with legacy():
                want = [
                    jax.random.randint(kj, shape, 0, 12, dtype=jnp.int32),
                    jax.random.randint(kj, shape, 2, 9, dtype=jnp.int32),
                    jax.random.uniform(kj, shape, jnp.float32),
                    jax.random.bernoulli(kj, 0.3, shape),
                ]
            with jr.threefry_partitionable(False):
                got = [jr.randint(kt, shape, 0, 12),
                       jr.randint(kt, shape, 2, 9),
                       jr.uniform(kt, shape), jr.bernoulli(kt, 0.3, shape)]
            for w, g in zip(want, got):
                assert same(w, g), shape
    bj, bt = batch_of(5, 4)
    with legacy():
        want = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, (3, 5), 0, 64,
                                         dtype=jnp.int32))(bj))
    assert same(want, jr.randint(bt, (3, 5), 0, 64, partitionable=False))


@pytest.mark.parametrize("n", [2, 5, 11, 33])
def test_permutation(n):
    for seed in SEEDS:
        kj, kt = keys_of(seed)
        with legacy():
            want = jax.random.permutation(kj, jnp.arange(1, n + 1))
        assert same(want, jr.permutation(kt, torch.arange(1, n + 1),
                                         partitionable=False))
    bj, bt = batch_of(6, 4)
    with legacy():
        want = jax.vmap(lambda k: jax.random.permutation(
            k, jnp.arange(1, n + 1)))(bj)
    with jr.threefry_partitionable(False):
        assert same(want, jr.permutation(bt, torch.arange(1, n + 1)))


def test_gumbel_and_categorical():
    bj, bt = batch_of(9, 6)
    logits = np.log(np.arange(1.0, 34.0, dtype=np.float32) / 561.0)
    with legacy():
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (33,)))(bj))
        u = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (33,), jnp.float32))(bj))
        idx = np.asarray(jax.vmap(jax.random.categorical, (0, None))(
            bj, jnp.asarray(logits)))
        shots = np.asarray(jax.random.gumbel(bj[0], (5, 33)))
    with jr.threefry_partitionable(False):
        # The uniforms under the gumbels are JAX's bit for bit; the two
        # logs may differ from XLA's in the last place (near g = 0 an ulp
        # of the outer log's argument is an absolute error of g).
        assert same(u, jr.uniform(bt, (33,)))
        np.testing.assert_allclose(jr.gumbel(bt, (33,)).numpy(), g,
                                   rtol=1e-6, atol=2.0 ** -22)
        np.testing.assert_allclose(jr.gumbel(bt[0], (5, 33)).numpy(), shots,
                                   rtol=1e-6, atol=2.0 ** -22)
        assert same(idx, jr.categorical(bt, torch.from_numpy(logits)))


@pytest.mark.parametrize("tag", [0, 11, 0x0AC7, 0x17A7E])
def test_fold_in_is_the_same_in_both_modes(tag):
    for seed in SEEDS:
        kj, kt = keys_of(seed)
        with legacy():
            want = data(jax.random.fold_in(kj, tag))
        with jax.threefry_partitionable(True):
            assert np.array_equal(want, data(jax.random.fold_in(kj, tag)))
        with jr.threefry_partitionable(False):
            assert same(want, jr.fold_in(kt, tag))
        assert same(want, jr.fold_in(kt, tag))


# ---- the mode ------------------------------------------------------------


def test_environment_variable_parses_as_jax(monkeypatch):
    from jax._src.config import bool_env

    values = ["1", "true", "True", "YES", "on", "t", "y",
              "0", "false", "FALSE", "no", "off", "f", "N"]
    for v in values:
        monkeypatch.setenv("QBA_TEST_THREEFRY", v)
        assert jr.parse_bool_env(v) == bool_env("QBA_TEST_THREEFRY", True), v
    for v in ("maybe", "", "2"):
        monkeypatch.setenv("QBA_TEST_THREEFRY", v)
        with pytest.raises(ValueError):
            bool_env("QBA_TEST_THREEFRY", True)
        with pytest.raises(ValueError, match="invalid truth value"):
            jr.parse_bool_env(v)
    assert jr.parse_bool_env(None) is True
    assert jr.ENV_VAR == "JAX_THREEFRY_PARTITIONABLE"


def test_process_default_comes_from_the_environment():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=repo, JAX_THREEFRY_PARTITIONABLE="off",
               OMP_NUM_THREADS="1")
    script = ("from qba_tpu_torch import random as jr\n"
              "from qba_tpu_torch.testing import GOLD_PINS\n"
              "import qba_tpu_torch\n"
              "name, kw, success, decisions = GOLD_PINS[0]\n"
              "res = qba_tpu_torch.run_trials(qba_tpu_torch.QBAConfig(**kw),"
              " device='cpu').trials\n"
              "print(jr.partitionable_mode(), res.decisions.tolist() == "
              "decisions)\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["False", "True"]


def test_context_manager_restores_the_mode():
    base = jr.partitionable_mode()
    with jr.threefry_partitionable(False):
        assert jr.partitionable_mode() is False
        with jr.threefry_partitionable(True):
            assert jr.partitionable_mode() is True
        assert jr.partitionable_mode() is False
        # Another thread keeps the process default, as in JAX.
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            jr.partitionable_mode()))
        t.start()
        t.join()
        assert seen == [base]
    assert jr.partitionable_mode() is base
    with pytest.raises(RuntimeError, match="inside"):
        with jr.threefry_partitionable(False):
            raise RuntimeError("inside")
    assert jr.partitionable_mode() is base
    with jr.threefry_partitionable():  # JAX's default argument: True
        assert jr.partitionable_mode() is True
    assert jr.resolve_mode(False) is False and jr.resolve_mode(None) is base


# ---- the draws -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_draws(size):
    """JAX's stacked draws ``[T, n_rounds, n_pool, n_rv]`` of the size's
    trial keys under every combination (one program), in the legacy
    mode, and the keys, as numpy."""
    jcfgs = {c: jcfg_of(size, c) for c in COMBOS}

    def one(jcfg, key):
        # setup_trial's key split: (k_dis, k_lists, k_comm, k_rounds).
        k_dis, _k_lists, k_comm, k_rounds = jax.random.split(key, 4)
        honest = j_assign_dishonest(jcfg, k_dis)
        v_sent, _v = j_commander_orders(jcfg, k_comm, honest[1])
        return j_stacked_draws(jcfg, k_rounds,
                               j_ctx(jcfg, k_rounds, v_sent))

    def every(keys):
        return {c: jax.vmap(functools.partial(one, j))(keys)
                for c, j in jcfgs.items()}

    with legacy():
        keys = jax.random.split(jax.random.key(SIZES[size]["seed"]),
                                SIZES[size]["trials"])
        draws = fast_jit(every)(keys)
        return ({c: tuple(np.asarray(x) for x in d)
                 for c, d in draws.items()},
                np.asarray(jax.random.key_data(keys)))


def port_keys(cfg, keys):
    """The port's rounds keys and adversary context of trial keys, in
    the legacy mode."""
    p = False
    k = jr.split(key_from_jax(keys), 4, partitionable=p)
    honest = assign_dishonest(cfg, k[..., 0, :], partitionable=p)
    v_sent, _v = commander_orders(cfg, k[..., 2, :], honest[..., 1],
                                  partitionable=p)
    k_rounds = k[..., 3, :].contiguous()
    return k_rounds, adversary_ctx(cfg, k_rounds, v_sent, partitionable=p)


@pytest.mark.parametrize("size", list(SIZES))
def test_draws_match_jax(size):
    every, keys = jax_draws(size)
    for combo in COMBOS:
        cfg = config_from_jax_fields(dataclasses.asdict(jcfg_of(size, combo)))
        want = every[combo]
        k_rounds, ctx = port_keys(cfg, keys)
        n_pool, n_rv = cfg.n_lieutenants * cfg.slots, cfg.n_lieutenants
        cell = torch.arange(n_pool)[:, None].expand(n_pool, n_rv)
        rv = torch.arange(n_rv)[None, :].expand(n_pool, n_rv)
        half = n_rv // 2
        for r in range(1, cfg.n_rounds + 1):
            got = ad.attack_draw_at_reference(cfg, k_rounds, ctx, r, cell,
                                              rv, partitionable=False)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy().astype(w.dtype),
                                      w[:, r - 1]), (combo, r)
            # A shard's receivers (the n_recv kernels' columns) and one
            # cell's walk (the broadcast scope's): the pairing spans the
            # whole table, whatever the slice.
            for cells, rvs in ((cell[:, half:], rv[:, half:]),
                               (cell[n_pool - 1:], rv[n_pool - 1:]),
                               (cell[:3, :1], rv[:3, :1])):
                got = ad.attack_draw_at_reference(cfg, k_rounds, ctx, r,
                                                  cells, rvs,
                                                  partitionable=False)
                for g, w in zip(got, want):
                    w = w[:, r - 1][:, cells, rvs]
                    assert np.array_equal(g.numpy().astype(w.dtype), w)
        with jr.threefry_partitionable(False):
            got = ad.attack_draws(cfg, k_rounds, ctx)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w.astype(np.uint8)), combo
        part = ad.attack_draws_reference(cfg, k_rounds, ctx, 2, 1,
                                         partitionable=False)
        for g, w in zip(part, got):
            assert torch.equal(g, w[:, 1:2])
    # The modes differ: the partitionable draws of the same rounds keys.
    other = ad.attack_draws(cfg, k_rounds, ctx, partitionable=True)
    assert not torch.equal(other[0], got[0])


# ---- whole trials --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_trials(i):
    """JAX's ``run_trials`` of ``GOLD_PINS[i]``'s config in the legacy
    mode (its unpacked path, ``FAST_COMPILE``), as numpy."""
    jcfg = JConfig(**GOLD_PINS[i][1])
    with legacy():
        keys = j_trial_keys(jcfg)
        res = fast_jit(lambda k: j_aggregate(j_batched_trials(jcfg, k)))(keys)
        return {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}


@pytest.mark.parametrize("i", range(len(GOLD_PINS)),
                         ids=[p[0] for p in GOLD_PINS])
def test_golden_pins_on_every_engine(i):
    name, kw, success, decisions = GOLD_PINS[i]
    want = jax_trials(i)
    # The JAX package itself reproduces its pins in this mode.
    assert want["success"].tolist() == success
    assert want["decisions"].tolist() == decisions
    cfg = qba_tpu_torch.QBAConfig(**kw)
    runs = {}
    with jr.threefry_partitionable(False):
        for engine in ENGINES:
            runs[engine] = qba_tpu_torch.run_trials(
                dataclasses.replace(cfg, round_engine=engine),
                device="cpu").trials
        mesh = make_mesh({"dp": 1, "tp": 2}, devices=["cpu"] * 2)
        for engine in ("auto", "pallas_fused", "pallas_mega"):
            runs[f"tp=2 {engine}"] = run_trials_spmd(
                dataclasses.replace(cfg, round_engine=engine), mesh).trials
    runs["argument"] = qba_tpu_torch.run_trials(cfg, device="cpu",
                                                partitionable=False).trials
    for label, got in runs.items():
        assert got.success.tolist() == success, label
        assert got.decisions.tolist() == decisions, label
        for f in FIELDS:
            assert np.array_equal(want[f], getattr(got, f).numpy()), (label,
                                                                      f)
    # The partitionable mode is a different key tree.
    other = qba_tpu_torch.run_trials(cfg, device="cpu",
                                     partitionable=True).trials
    assert other.decisions.tolist() != decisions


LIST_PATHS = {
    "factorized": dict(n_parties=5, size_l=16, p_depolarize=0.05,
                       p_measure_flip=0.02),
    "dense": dict(n_parties=3, size_l=16, p_depolarize=0.2,
                  p_measure_flip=0.1),
    "stabilizer": dict(n_parties=5, size_l=16, p_depolarize=0.05,
                       p_measure_flip=0.02),
}


@pytest.mark.parametrize("path", list(LIST_PATHS))
def test_list_paths_match_jax(path):
    jcfg = JConfig(**LIST_PATHS[path], qsim_path=path)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    bj, bt = batch_of(4, 4)
    with legacy():
        lists, qcorr = fast_jit(jax.vmap(
            lambda k: j_generate_lists_for(jcfg, k)))(bj)
    with jr.threefry_partitionable(False):
        got, got_q = generate_lists_for(cfg, bt)
    assert same(qcorr, got_q) and same(lists, got)
    if path == "dense":
        # The circuit kernel's path (its plain version on the CPU).
        got, _ = generate_lists_dense(cfg, bt, "pallas", partitionable=False)
        assert same(lists, got)


def test_gen_keyed_megakernel_plain_version():
    # The gen keyed entry's plain version on the legacy operands, against
    # the xla engine on the stabilizer path (the lists JAX's, above).
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.qsim.protocol_circuits import stabilizer_gen_tables
    from qba_tpu_torch.rounds import engine

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=8, seed=6, qsim_path="stabilizer",
                                  strategy="adaptive", delivery="racy",
                                  p_late=0.25)
    with jr.threefry_partitionable(False):
        want = qba_tpu_torch.run_trials(cfg, device="cpu").trials
        keys = trial_keys(cfg, "cpu")
    honest, ops, v_sent, v_comm, k_rounds = engine._mega_gen_setup(
        cfg, keys, partitionable=False)
    ctx = adversary_ctx(cfg, k_rounds, v_sent, partitionable=False)
    out = tm.trial_megakernel_gen_keyed(
        cfg, stabilizer_gen_tables(cfg), ops, v_sent.to(torch.int32),
        honest_cells(honest, cfg), k_rounds.contiguous(), ctx,
        partitionable=False)
    got = engine.mega_result(honest, v_comm, *out)
    for f in FIELDS:
        assert torch.equal(getattr(want, f), getattr(got, f)), f


def test_split_seed9_sweep_stops_where_jax_does(monkeypatch):
    # tests/test_device_loop.py:192's case: in the legacy mode the split
    # strategy at seed 9 decides exactly at the last budget chunk.
    kw = dict(n_parties=5, size_l=8, n_dishonest=2, trials=8, seed=9,
              strategy="split")
    runners = {}

    def runner(c, k):
        if c not in runners:
            runners[c] = fast_jit(functools.partial(j_batched_trials, c))
        return runners[c](k)

    monkeypatch.setattr(jsweep, "_default_runner",
                        lambda chunk_trials, log: runner)
    with legacy():
        want = jsweep.run_sweep(JConfig(**kw), n_chunks=4, chunk_trials=8,
                                target=DECIDE)
    assert len(want.chunks) == 4
    assert want.stop.reason in ("decided_above", "decided_below")
    cfg = qba_tpu_torch.QBAConfig(**kw)
    with jr.threefry_partitionable(False):
        for dispatch in ("host", "device"):
            got = run_sweep(
                cfg, n_chunks=4, chunk_trials=8, target=DECIDE,
                dispatch=dispatch, device="cpu")
            assert [(c.chunk, c.successes, c.overflow) for c in got.chunks] \
                == [(c.chunk, c.successes, c.overflow) for c in want.chunks]
            assert got.stop.reason == want.stop.reason, dispatch
            assert got.stop.n_trials == want.stop.n_trials
