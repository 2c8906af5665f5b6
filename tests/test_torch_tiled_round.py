"""The port's plain tiled round equals the JAX tiled round kernels.

``verdict_reference`` and ``rebuild_reference`` (the plain PyTorch
versions the CUDA verdict and rebuild kernels are held against on the
card) against ``build_verdict_kernel(..., interpret=True)`` and
``build_rebuild_kernel(..., interpret=True)``, the TPU kernels run as
tests/test_round_kernel_tiled.py runs them on the CPU, with inputs made
(a) from numpy with a seed and (b) from the protocol state of real
trials.  The accepted matrix (the port's one receiver mask a packet,
unpacked), ``vi``, the successor pool and the overflow flag must be
equal.  The JAX verdict kernel followed by the JAX
rebuild kernel must equal the port's ``fused_round_reference``, and the
``pallas_tiled`` engine must equal JAX's and the port's ``xla`` engine
trial for trial.  Every output is an integer: the tolerance is 0.
"""

import dataclasses
import functools

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
from qba_tpu.ops.round_kernel_tiled import (
    build_rebuild_kernel,
    build_verdict_kernel,
    pool_vals_dtype,
    resolve_rebuild_block,
    resolve_tiled_block,
)
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    draws_from_numpy,
    pool_from_numpy,
)
from qba_tpu_torch.ops.round_kernel_tiled import (
    fused_round_reference,
    join_acc_shards,
    pack_acc,
    rebuild_reference,
    shard_receivers,
    tiled_rebuild,
    tiled_verdict,
    unpack_acc,
    unshard_receivers,
    verdict_reference,
)
from qba_tpu_torch.testing import random_round_inputs, random_state
from tests.test_torch_draws import jax_run_trials
from tests.test_torch_fused_round import jax_round_draws, protocol_states

FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")


@functools.lru_cache(maxsize=None)
def jax_verdict(jcfg):
    return jax.jit(build_verdict_kernel(jcfg, resolve_tiled_block(jcfg),
                                        interpret=True))


@functools.lru_cache(maxsize=None)
def jax_rebuild(jcfg):
    return jax.jit(build_rebuild_kernel(jcfg, resolve_rebuild_block(jcfg),
                                        interpret=True))


def jax_pool(jcfg, pool):
    vdt = pool_vals_dtype(jcfg)
    return tuple(jnp.asarray(x, dt)
                 for x, dt in zip(pool, (vdt, jnp.int32, vdt, jnp.int32)))


def run_jax_verdict(jcfg, round_idx, pool, li, vi, hc, att, rv, late):
    with jax.threefry_partitionable(True):
        acc, vi2 = jax_verdict(jcfg)(
            round_idx, *jax_pool(jcfg, pool), jnp.asarray(li),
            jnp.asarray(vi), jnp.asarray(hc), jnp.asarray(att),
            jnp.asarray(rv), jnp.asarray(late),
        )
    return np.asarray(acc), np.asarray(vi2)


def run_jax_rebuild(jcfg, round_idx, pool, li, acc, hc, att, rv):
    with jax.threefry_partitionable(True):
        out, ovf = jax_rebuild(jcfg)(
            round_idx, *jax_pool(jcfg, pool), jnp.asarray(li),
            jnp.asarray(acc), jnp.asarray(att), jnp.asarray(rv),
            jnp.asarray(hc),
        )
    return [np.asarray(x).astype(np.int32) for x in out], bool(ovf)


def port_args(pools, lis, hcs, atts, rvs, lates):
    """The stacked trials' round inputs as the port's CPU tensors."""
    pool = pool_from_numpy(*(np.stack([p[i] for p in pools])
                             for i in range(4)))
    draws = draws_from_numpy(np.stack(atts), np.stack(rvs), np.stack(lates))
    return (pool, torch.from_numpy(np.stack(lis)),
            torch.from_numpy(np.stack(hcs)[..., 0]), draws)


def assert_tiled_equal(jcfg, cfg, round_idx, states, acc_override=None):
    """The JAX verdict and rebuild kernels against the port's plain
    versions on per-trial states.  The rebuild reads the JAX verdict's
    ``acc`` (packed, :func:`pack_acc`), or ``acc_override`` per trial;
    the port's masks are unpacked against JAX's int32 0/1 matrix.
    Returns the JAX outputs."""
    pools, lis, vis, hcs, atts, rvs, lates = zip(*states)
    verdicts = [run_jax_verdict(jcfg, round_idx, *s) for s in states]
    accs = acc_override or [v[0] for v in verdicts]
    rebuilds = [run_jax_rebuild(jcfg, round_idx, s[0], s[1], a, s[3],
                                s[4], s[5])
                for s, a in zip(states, accs)]
    pool, li, hc, (att, rv, late) = port_args(pools, lis, hcs, atts, rvs,
                                              lates)
    vi = torch.from_numpy(np.stack(vis))
    acc_p, vi_p = verdict_reference(cfg, round_idx, pool, li, vi, hc, att,
                                    rv, late)
    acc_j = pack_acc(torch.from_numpy(np.stack(accs)))
    out_p, ovf_p = rebuild_reference(cfg, round_idx, pool, li, acc_j, hc,
                                     att, rv)
    acc_p = unpack_acc(acc_p, cfg.n_lieutenants)
    for t, ((acc_j, vi_j), (out_j, ovf_j)) in enumerate(
            zip(verdicts, rebuilds)):
        assert np.array_equal(acc_j, acc_p[t].numpy()), ("acc", t)
        assert np.array_equal(vi_j, vi_p[t].numpy()), ("vi", t)
        for name, a, b in zip(("vals", "lens", "p", "meta"), out_j, out_p):
            assert np.array_equal(a, b[t].numpy().astype(np.int32)), (name, t)
        assert ovf_j == bool(ovf_p[t]), ("overflow", t)
    return verdicts, rebuilds


CONFIGS = [
    (dict(n_parties=5, size_l=16, n_dishonest=2), 1),
    (dict(n_parties=5, size_l=16, n_dishonest=2), 2),
    (dict(n_parties=5, size_l=16, n_dishonest=2, strategy="split"), 1),
    (dict(n_parties=5, size_l=16, n_dishonest=2,
          max_accepts_per_round=1), 1),
    (dict(n_parties=7, size_l=8, n_dishonest=3), 3),
    (dict(n_parties=7, size_l=8, n_dishonest=3), 4),
]


@pytest.mark.parametrize("kw,round_idx", CONFIGS)
def test_verdict_and_rebuild_random_inputs(kw, round_idx):
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(round_idx * 31 + len(kw))
    states = [random_state(rng, cfg, round_idx) for _ in range(8)]
    verdicts, rebuilds = assert_tiled_equal(jcfg, cfg, round_idx, states)
    assert sum(int(v[0].sum()) for v in verdicts) > 0  # something accepted
    if round_idx <= cfg.n_dishonest:
        assert sum(int((r[0][3][:, 2] != 0).sum()) for r in rebuilds) > 0


def test_verdict_masks_cross_the_32_bit_line():
    # 33 lieutenants (34 parties, w = 64): receivers 32 and up sit in the
    # high half of the packet's word.
    jcfg = JConfig(n_parties=34, size_l=4, n_dishonest=2,
                   max_accepts_per_round=1)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    assert cfg.n_lieutenants == 33 and cfg.w == 64
    rng = np.random.default_rng(34)
    states = [random_state(rng, cfg, 1) for _ in range(2)]
    verdicts, _ = assert_tiled_equal(jcfg, cfg, 1, states)
    assert any(v[0][:, 32:].any() for v in verdicts)


@pytest.mark.parametrize("kw,tp,round_idx", [
    (dict(n_parties=5, size_l=16, n_dishonest=2), 2, 1),
    (dict(n_parties=7, size_l=8, n_dishonest=3), 3, 2),
    (dict(n_parties=34, size_l=4, n_dishonest=2), 3, 1),
])
def test_n_recv_masks_join_to_single_device(kw, tp, round_idx):
    # Each shard's masks hold its own receivers' bits from bit 0; joined
    # in shard order they are the single-device verdict's masks.
    cfg = qba_tpu_torch.QBAConfig(**kw)
    n_local = cfg.n_lieutenants // tp
    pool, li, vi, hc, *draws = random_round_inputs(cfg, round_idx, 6,
                                                   seed=tp)
    acc, vi2 = verdict_reference(cfg, round_idx, pool, li, vi, hc, *draws)
    shards = (tuple(x.expand((tp,) + x.shape).contiguous() for x in pool),
              shard_receivers(li, tp), shard_receivers(vi, tp), hc)
    s_acc, s_vi = verdict_reference(cfg, round_idx, *shards, *draws,
                                    n_recv=n_local)
    assert s_acc.shape == (tp,) + acc.shape and s_acc.dtype == torch.int64
    assert not (s_acc >> n_local).any()
    assert torch.equal(join_acc_shards(s_acc, n_local), acc)
    assert torch.equal(unshard_receivers(s_vi), vi2)
    assert bool(acc.any())


@pytest.mark.parametrize("kw,round_idx", CONFIGS[:4])
def test_rebuild_heavy_accepts(kw, round_idx):
    # An accepted matrix far denser than the protocol makes (half of all
    # sent (packet, receiver) pairs): many slots per receiver, overflow
    # wherever the slot bound is small.
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7 + round_idx)
    states = [random_state(rng, cfg, round_idx) for _ in range(6)]
    accs = [((rng.random(s[5].shape) < 0.5)
             & (s[0][3][:, 2:3] != 0)).astype(np.int32) for s in states]
    _, rebuilds = assert_tiled_equal(jcfg, cfg, round_idx, states, accs)
    if cfg.slots == 1:
        assert any(r[1] for r in rebuilds)


@pytest.mark.parametrize(
    "kw,trials,seed",
    [
        (dict(n_parties=5, size_l=16, n_dishonest=2), 4, 1),
        (dict(n_parties=5, size_l=16, n_dishonest=2, strategy="split"), 4, 0),
        (dict(n_parties=5, size_l=16, n_dishonest=2,
              max_accepts_per_round=1), 4, 1),
    ],
)
def test_jax_tiled_round_equals_port_fused_reference(kw, trials, seed):
    # Round by round on real trials: JAX's verdict kernel then its rebuild
    # kernel (the pallas_tiled round) against the port's plain fused
    # round, which is the composition of verdict_reference and
    # rebuild_reference.
    jcfg = JConfig(trials=trials, seed=seed, **kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(seed), trials)
    pool, lieu, vi, hc, k_rounds, ctx, _ = protocol_states(jcfg, keys)
    pools = [[np.asarray(x[t]).astype(np.int32) for x in pool]
             for t in range(trials)]
    lieu, vi, hc = np.array(lieu), np.array(vi), np.array(hc)
    accepted = 0
    for r in range(1, cfg.n_rounds + 1):
        att, rv, late = jax_round_draws(jcfg, k_rounds, ctx, r)
        states = [(pools[t], lieu[t], vi[t], hc[t], att[t], rv[t], late[t])
                  for t in range(trials)]
        verdicts, rebuilds = assert_tiled_equal(jcfg, cfg, r, states)
        p_pool, li, hcs, draws = port_args(pools, lieu, hc, att, rv, late)
        out, vi_p, ovf = fused_round_reference(
            cfg, r, p_pool, li, torch.from_numpy(vi), hcs, *draws)
        for t in range(trials):
            for a, b in zip(rebuilds[t][0], out):
                assert np.array_equal(a, b[t].numpy().astype(np.int32))
            assert np.array_equal(verdicts[t][1], vi_p[t].numpy())
            assert rebuilds[t][1] == bool(ovf[t])
        accepted += sum(int(v[0].sum()) for v in verdicts)
        pools = [r_[0] for r_ in rebuilds]
        vi = np.stack([v[1] for v in verdicts])
    assert accepted > 0


def jax_trials(jcfg):
    res = jax_run_trials(jcfg)
    return {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_parties=5, size_l=16, n_dishonest=2, trials=4, seed=3),
        dict(n_parties=5, size_l=16, n_dishonest=2, trials=4, seed=2,
             max_accepts_per_round=1),
        dict(n_parties=11, size_l=64, n_dishonest=3, trials=2, seed=1),
    ],
)
def test_tiled_engine_matches_jax_and_xla(kw):
    jcfg = JConfig(round_engine="pallas_tiled", **kw)
    want = jax_trials(jcfg)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    got = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    xla = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine="xla"), device="cpu").trials
    for f in FIELDS:
        assert np.array_equal(want[f], getattr(got, f).numpy()), f
        assert torch.equal(getattr(xla, f), getattr(got, f)), f


def test_wrappers_use_plain_versions_on_cpu():
    # CPU tensors take the plain versions and launch nothing.
    jcfg = JConfig(n_parties=5, size_l=16, n_dishonest=2)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    pool, li, vi, hc, att, rv, late = random_state(rng, cfg, 1)
    p_pool, li_t, hc_t, draws = port_args([pool], [li], [hc], [att], [rv],
                                          [late])
    vi_t = torch.from_numpy(vi[None])
    before = (tiled_verdict.launches, tiled_rebuild.launches)
    acc, vi2 = tiled_verdict(cfg, 1, p_pool, li_t, vi_t, hc_t, *draws)
    ref_acc, ref_vi = verdict_reference(cfg, 1, p_pool, li_t, vi_t, hc_t,
                                        *draws)
    out, ovf = tiled_rebuild(cfg, 1, p_pool, li_t, acc, hc_t, *draws[:2])
    ref_out, ref_ovf = rebuild_reference(cfg, 1, p_pool, li_t, acc, hc_t,
                                         *draws[:2])
    assert (tiled_verdict.launches, tiled_rebuild.launches) == before
    assert torch.equal(acc, ref_acc) and torch.equal(vi2, ref_vi)
    assert all(torch.equal(a, b) for a, b in zip(out, ref_out))
    assert torch.equal(ovf, ref_ovf)
    n_pool = cfg.n_lieutenants * cfg.slots
    assert acc.dtype == torch.int64 and acc.shape == (1, n_pool)

