"""The trial set-up kernel's algorithm, its plain version and its seams.

``setup_at_reference`` (the kernel's own algorithm, trial by trial: the
rank in place of the stable argsort, a hash an entry with the legacy
mode's pairing, rows written by rank) is held against the plain
versions (``setup_trial``, ``generate_lists``, ``_mega_gen_setup``,
``adversary_ctx``) and against the JAX package's jitted set-up, in both
threefry modes (JAX's set only inside ``jax.threefry_partitionable``).
CPU keys take the plain path and launch nothing; the launch and byte
models count the kernel.  The kernel itself runs in
``tests/test_torch_cuda.py`` on the card.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu.adversary import adversary_ctx as j_ctx
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.qsim import generate_lists_for as j_lists
from qba_tpu.rounds.engine import setup_trial as j_setup
from qba_tpu_torch import QBAConfig
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import adversary_ctx
from qba_tpu_torch.analysis import launches as plaunches
from qba_tpu_torch.analysis import memory
from qba_tpu_torch.convert import config_from_jax_fields, key_from_jax
from qba_tpu_torch.ops import _launch
from qba_tpu_torch.ops import setup_kernel as sk
from qba_tpu_torch.qsim.sampler import generate_lists
from qba_tpu_torch.rounds.engine import _mega_gen_setup, setup_trial

# Both widths, the four strategies, noise on, odd (5, 11, 7) and even (6)
# permutations, a size_l that is not a power of two.
CASES = {
    "5p-reference": dict(n_parties=5, size_l=16, n_dishonest=2),
    "5p-split": dict(n_parties=5, size_l=16, n_dishonest=2, strategy="split"),
    "5p-collude-noise": dict(n_parties=5, size_l=16, n_dishonest=2,
                             strategy="collude", p_depolarize=0.1,
                             p_measure_flip=0.05),
    "6p-split-L7": dict(n_parties=6, size_l=7, n_dishonest=5,
                        strategy="split"),
    "7p-adaptive-flip": dict(n_parties=7, size_l=9, n_dishonest=3,
                             strategy="adaptive", p_measure_flip=0.2),
    "11p-adaptive": dict(n_parties=11, size_l=64, n_dishonest=3,
                         strategy="adaptive"),
}
MODES = {"partitionable": True, "legacy": False}


def keys_of(cfg, p):
    return jr.split(jr.key(cfg.seed), cfg.trials, partitionable=p)


def mirror(cfg, keys, form, lists=None, p=True):
    """``setup_at_reference`` over the trials, stacked."""
    rows = [sk.setup_at_reference(cfg, keys[t], form,
                                  None if lists is None else lists[t],
                                  partitionable=p)
            for t in range(keys.shape[0])]
    return sk.TrialSetup(*(None if getattr(rows[0], f) is None
                           else torch.stack([getattr(r, f) for r in rows])
                           for f in sk.TrialSetup._fields))


def assert_same(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("n,hi", [(5, 2), (11, 3), (33, 1 << 32), (64, 4)])
def test_rank_sort_is_a_stable_argsort(n, hi):
    # Words drawn from a small range tie often: the rank keeps argsort's
    # index order among equal words.
    rng = np.random.default_rng(n)
    words = torch.from_numpy(rng.integers(0, hi, size=(7, n)))
    ranks = sk.rank_sort(words)
    perm = torch.empty_like(ranks)
    perm.scatter_(-1, ranks, torch.arange(n).expand(7, n))
    assert torch.equal(perm, torch.argsort(words, dim=-1, stable=True))


def test_rank_sort_all_tied():
    assert torch.equal(sk.rank_sort(torch.zeros(9, dtype=torch.int64)),
                       torch.arange(9))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_the_plain_setup(case, mode):
    p = MODES[mode]
    cfg = QBAConfig(trials=3, seed=17, **CASES[case])
    keys = keys_of(cfg, p)
    # The whole form against setup_trial, the collude target and the
    # lists, every party's rows.
    got = mirror(cfg, keys, "whole", p=p)
    honest, lieu, p_rows, v_sent, v_comm, k_rounds = setup_trial(
        cfg, keys, partitionable=p)
    want = sk.TrialSetup(honest, lieu, p_rows, v_sent, v_comm, k_rounds,
                         None)
    assert_same(got, want, sk.TrialSetup._fields[:6])
    ctx = adversary_ctx(cfg, k_rounds, v_sent, partitionable=p)
    assert (ctx is None) == (got.target is None)
    if ctx is not None:
        assert torch.equal(got.target, ctx.collude_target)
    k_lists = jr.split(keys, 4, partitionable=p)[:, 1]
    lists, qcorr = generate_lists(cfg, k_lists, partitionable=p)
    assert torch.equal(got.lists, lists)
    # The lists form on the lists keys.
    alone = mirror(cfg, k_lists, "lists", p=p)
    assert torch.equal(alone.lists, lists) and torch.equal(alone.qcorr, qcorr)
    # The orders form against the gen entry's set-up.
    orders = mirror(cfg, keys, "orders", p=p)
    g_honest, _ops, g_vs, g_vc, g_kr = _mega_gen_setup(
        dataclasses.replace(cfg, qsim_path="stabilizer"), keys, p)
    assert_same(orders, sk.TrialSetup(g_honest, None, None, g_vs, g_vc, g_kr,
                                      None), ("honest", "v_sent", "v_comm",
                                              "k_rounds"))
    assert torch.equal(orders.k_lists, k_lists)
    # The given form on other lists.
    other = torch.randint(0, cfg.w, lists.shape, dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    given = mirror(cfg, keys, "given", other, p=p)
    ref = sk.setup_reference(cfg, keys, "given", other, partitionable=p)
    assert_same(given, ref, ("honest", "lieu_lists", "p_rows", "v_sent",
                             "v_comm", "k_rounds"))


# The 11p widths meet JAX in test_torch_setup.py and
# test_torch_legacy_threefry.py through the plain set-up.
JAX_CASES = ("5p-collude-noise", "6p-split-L7")


def jax_setup(jcfg, keys, p):
    """The JAX package's jitted set-up of ``keys`` (typed JAX keys) in
    threefry mode ``p``: honesty, lieutenants' lists, P-sets, orders, every
    party's lists, the Q bits and the target (``v_comm`` without one)."""
    def one(key):
        honest, lieu, p_rows, v_sent, v_comm, k_rounds = j_setup(jcfg, key)
        lists, qcorr = j_lists(jcfg, jax.random.split(key, 4)[1])
        target = j_ctx(jcfg, k_rounds, v_sent).collude_target if (
            jcfg.strategy in ("collude", "adaptive")) else v_comm
        return (honest, lieu, p_rows, v_sent, v_comm, lists, qcorr, target)

    with jax.threefry_partitionable(p):
        return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(keys))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", JAX_CASES)
def test_mirror_and_plain_match_jax(case, mode):
    p = MODES[mode]
    jcfg = JConfig(trials=3, seed=23, **CASES[case])
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(p):
        keys = jax.random.split(jax.random.key(jcfg.seed), jcfg.trials)
    want = jax_setup(jcfg, keys, p)
    kt = key_from_jax(jax.random.key_data(keys))
    got = mirror(cfg, kt, "whole", p=p)
    plain = sk.setup_reference(cfg, kt, "whole", full_lists=True,
                               partitionable=p)
    for t in (got, plain):
        fields = (t.honest, t.lieu_lists, t.p_rows, t.v_sent, t.v_comm,
                  t.lists)
        for a, b in zip(fields, want):
            np.testing.assert_array_equal(a.numpy(), b)
        if t.target is not None:
            np.testing.assert_array_equal(t.target.numpy(), want[-1])
    lists_keys = jr.split(kt, 4, partitionable=p)[:, 1]
    np.testing.assert_array_equal(
        mirror(cfg, lists_keys, "lists", p=p).qcorr.numpy(), want[6])


@pytest.mark.parametrize("mode", list(MODES))
def test_mirror_at_the_q_extremes(mode):
    # Four positions a trial: trials whose positions are all Q-correlated
    # (every word ranked, r everywhere) and none (u alone, no rank), with
    # noise and the split strategy, against the plain set-up and JAX.
    p = MODES[mode]
    jcfg = JConfig(n_parties=5, size_l=4, n_dishonest=2, strategy="split",
                   p_depolarize=0.1, p_measure_flip=0.05, trials=64, seed=7)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    keys = keys_of(cfg, p)
    qcorr = sk.setup_reference(cfg, jr.split(keys, 4, partitionable=p)[:, 1],
                               "lists", partitionable=p).qcorr
    picks = [int(torch.nonzero(qcorr.all(-1))[0, 0]),
             int(torch.nonzero((~qcorr).all(-1))[0, 0])]
    kt = keys[picks]
    got = mirror(cfg, kt, "whole", p=p)
    plain = sk.setup_reference(cfg, kt, "whole", full_lists=True,
                               partitionable=p)
    assert_same(got, plain, ("honest", "lieu_lists", "p_rows", "v_sent",
                             "v_comm", "k_rounds", "lists"))
    want = jax_setup(jcfg, jax.random.wrap_key_data(
        kt.numpy().astype(np.uint32)), p)
    for a, b in zip((got.honest, got.lieu_lists, got.p_rows, got.v_sent,
                     got.v_comm, got.lists), want):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(want[6], qcorr[picks].numpy())


def test_cpu_keys_take_the_plain_path():
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2, trials=4,
                    strategy="collude")
    keys = keys_of(cfg, True)
    seen = []
    _launch.seam_observers.append(lambda name, t: seen.append(name))
    before = sk.setup_kernel.launches
    try:
        for form, args in (("whole", ()), ("orders", ()),
                           ("given", (generate_lists(cfg, keys)[0],))):
            got = sk.setup_kernel(cfg, keys, form, *args)
            want = sk.setup_reference(cfg, keys, form, *args)
            assert_same(got, want, [f for f in sk.TrialSetup._fields
                                    if getattr(want, f) is not None])
        generate_lists(cfg, keys)
    finally:
        _launch.seam_observers.pop()
    assert sk.setup_kernel.launches == before
    assert seen == ["setup_trial"] * 5
    with pytest.raises(ValueError, match="given"):
        sk.setup_kernel(cfg, keys, "given")
    with pytest.raises(ValueError, match="form"):
        sk.setup_kernel(cfg, keys, "all")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.setup_kernel(cfg, keys.to("meta"))


def test_tiles_bound_shared_memory():
    # Few parties with long lists: the shared memory's limit sizes the
    # tile (a multiple of 4), not its words.
    for n, size_l, tile in ((33, 64, 64), (65, 64, 63), (1024, 500, 4),
                            (11, 1000, 372), (5, 1000, 736),
                            (3, 2048, 1172), (2, 4096, 1296)):
        cfg = QBAConfig(n_parties=n, size_l=size_l, n_dishonest=0)
        assert sk.setup_tile(cfg) == tile
        assert sk.setup_smem_bytes(cfg) <= sk.SMEM_BYTES < 48 * 1024
    # 3 ln n / ln(2**32 - 1) passes 1 at n = 1626.
    assert sk.perm_rounds(1625) == 1 and sk.perm_rounds(1626) == 2


@pytest.mark.parametrize("qsim,engine,want", [
    ("factorized", "pallas_mega", 1), ("factorized", "pallas_fused", 1),
    ("factorized", "xla", 1), ("stabilizer", "pallas_mega", 1),
    ("stabilizer", "pallas_fused", 2), ("dense", "pallas_mega", 2),
    ("dense_pallas", "xla", 2)])
def test_launch_model_counts_the_setup(qsim, engine, want):
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2, qsim_path=qsim)
    assert plaunches.batch_launch_model(cfg, engine, "cuda")[
        "setup_trial"] == want
    host = dataclasses.replace(cfg, mega_gen="host")
    if qsim == "stabilizer":
        assert plaunches.batch_launch_model(host, engine, "cuda")[
            "setup_trial"] == 2
    if engine != "pallas_mega":  # (the sharded megakernel's plan builds it)
        assert plaunches.batch_launch_model(cfg, engine, "cuda", tp=2)[
            "setup_trial"] == (1 if qsim == "factorized" else 2)


def test_dense_batch_seams_meet_the_model():
    # On the CPU the seams are the plain versions' calls: a dense batch
    # reaches the set-up twice (orders, then the given lists) beside the
    # round's kernels.
    from qba_tpu_torch.analysis import trace as ptrace

    cfg = QBAConfig(n_parties=3, size_l=4, n_dishonest=1,
                    qsim_path="dense")
    rec = ptrace.trace_batch("3p dense", cfg, "pallas_fused", "cpu", 2)
    assert rec.seams["setup_trial"] == 2
    assert dict(rec.seams) == plaunches.batch_launch_model(
        cfg, "pallas_fused", "cpu")


def test_byte_model_prices_the_setup_kernel():
    cfg = QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                    round_engine="pallas_fused")
    card, host = memory.trial_bytes(cfg, "cuda"), memory.trial_bytes(
        cfg, "cpu")
    # The kernel's outputs on the card; the eager int64 draws elsewhere.
    assert card["setup_transient"] < 1000 < host["setup_transient"]
    assert card["lists"] == cfg.n_lieutenants * cfg.size_l * 5
    stab = dataclasses.replace(cfg, qsim_path="stabilizer")
    assert memory.trial_bytes(stab, "cuda")["setup_transient"] == (
        memory.trial_bytes(stab, "cpu")["setup_transient"])
