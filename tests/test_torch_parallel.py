"""The port's mesh paths equal the JAX package's, trial for trial.

``qba_tpu_torch.parallel`` against ``qba_tpu.parallel`` and the
single-device engines, on the CPU: the mesh helpers and their errors;
``ring_gather_reference`` (the plain version of the ring kernel) against
JAX's ``ring_gather`` and the tiled ``all_gather`` under ``shard_map``
on the virtual CPU mesh; the plain ``n_recv`` variants of the fused
round, the tiled verdict and rebuild and the dense-mailbox round against
JAX's ``n_recv`` kernels in interpret mode, round by round on protocol
state and on seeded random shard inputs (stale entries between the
segments, stale unsent cells); and ``run_trials_spmd`` on the ``xla``,
``pallas``, ``pallas_fused``, ``pallas_tiled`` and ``pallas_mega``
engines (the kernels' plain versions here) against JAX's single-device
``run_trials`` and the port's own, with JAX's ``TestShardedMega`` and
``TestRingComms`` cases, an overflowing one and 65 parties (``w =
128``); one case against JAX's ``run_trials_spmd`` itself, counters
included; and the recorded demotions with JAX's reasons.  Every output
is an integer: the tolerance is 0.  The kernels themselves run on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import functools
import inspect
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
from qba_tpu.backends.jax_backend import run_trials as j_run_trials
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.diagnostics import record_decisions
from qba_tpu.ops.round_kernel import build_round_step
from qba_tpu.ops.round_kernel_tiled import (
    build_fused_round_kernel,
    build_rebuild_kernel,
    build_verdict_kernel,
)
from qba_tpu.ops.round_kernel_tiled import pool_from_step3a as j_pool_3a
from qba_tpu.ops.round_kernel_tiled import pool_vals_dtype
from qba_tpu.parallel import default_mesh_shape as j_default_mesh_shape
from qba_tpu.parallel import make_mesh as j_make_mesh
from qba_tpu.parallel import run_trials_spmd as j_run_trials_spmd
from qba_tpu.parallel import spmd as j_spmd
from qba_tpu.parallel.mesh import require_divisible as j_require_divisible
from qba_tpu.parallel.ring import ring_gather as j_ring_gather
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    mailbox_from_numpy,
    shards_from_numpy,
)
from qba_tpu_torch.diagnostics import QBADemotionWarning
from qba_tpu_torch.ops import round_kernel as rs
from qba_tpu_torch.ops import round_kernel_tiled as rk
from qba_tpu_torch.parallel import (
    default_mesh_shape,
    make_mesh,
    run_trials_sharded,
    run_trials_spmd,
)
from qba_tpu_torch.parallel.mesh import axis_sizes, require_divisible
from qba_tpu_torch.parallel.ring import all_gather, ring_gather_reference
from qba_tpu_torch.rounds.engine import setup_trial, step3a_one
from qba_tpu_torch.testing import (
    random_shard_inputs,
    random_shard_mailbox_inputs,
)

FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")
ENGINES = ("xla", "pallas", "pallas_fused", "pallas_tiled", "pallas_mega")
CPU = torch.device("cpu")


def cpu_mesh(axes):
    return make_mesh(axes, devices=[CPU] * int(np.prod(list(axes.values()))))


@functools.lru_cache(maxsize=None)
def jax_trials(jcfg):
    """JAX's single-device results for a config, once per config."""
    with jax.threefry_partitionable(True):
        res = j_run_trials(jcfg)
        return {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}


@functools.lru_cache(maxsize=None)
def port_trials(cfg):
    """The port's single-device results for a config, once per config."""
    return qba_tpu_torch.run_trials(cfg, device="cpu").trials


def assert_matches(got, want_np, port_ref, what):
    for f in FIELDS:
        g = getattr(got, f)
        assert np.array_equal(g.numpy(), want_np[f]), (what, f)
        assert torch.equal(g, getattr(port_ref, f)), (what, f)


# --------------------------------------------------------------- mesh --


def test_default_mesh_shape_matches_jax():
    for n in range(1, 17):
        for want_tp in (False, True):
            assert default_mesh_shape(n, want_tp=want_tp) == \
                j_default_mesh_shape(n, want_tp=want_tp)


def test_mesh_helpers_and_errors_match_jax():
    mesh = cpu_mesh({"dp": 2, "tp": 4})
    assert axis_sizes(mesh) == {"dp": 2, "tp": 4} == mesh.shape
    assert mesh.devices.shape == (2, 4) and mesh.axis_names == ("dp", "tp")
    assert make_mesh(devices=[CPU] * 3).shape == {"dp": 3}
    with pytest.raises(ValueError) as mine:
        make_mesh({"dp": 3, "tp": 2}, devices=[CPU] * 4)
    with pytest.raises(ValueError) as theirs:
        j_make_mesh({"dp": 3, "tp": 2}, devices=jax.devices()[:4])
    assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError) as mine:
        require_divisible(10, 4, "trials", "dp")
    with pytest.raises(ValueError) as theirs:
        j_require_divisible(10, 4, "trials", "dp")
    assert str(mine.value) == str(theirs.value)


def test_make_mesh_default_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh({"dp": 1, "tp": 2})


def test_spmd_errors_match_jax():
    cfg = JConfig(n_parties=4, size_l=4, trials=4)  # 3 lieutenants
    port = config_from_jax_fields(dataclasses.asdict(cfg))
    for axes in ({"dp": 2, "tp": 2}, {"dp": 4}, {"dp": 3, "tp": 1}):
        with pytest.raises(ValueError) as theirs:
            j_run_trials_spmd(cfg, j_make_mesh(
                axes, devices=jax.devices()[:int(np.prod(list(axes.values())))]))
        with pytest.raises(ValueError) as mine:
            run_trials_spmd(port, cpu_mesh(axes))
        assert str(mine.value) == str(theirs.value)


def test_tp_row_across_devices_raises():
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=8, trials=2)
    mesh = make_mesh({"dp": 1, "tp": 2},
                     devices=[CPU, torch.device("meta")])
    with pytest.raises(NotImplementedError, match="A12b"):
        run_trials_spmd(cfg, mesh)


def test_run_trials_sharded_matches_single_device():
    jcfg = JConfig(n_parties=5, size_l=8, n_dishonest=2, trials=8, seed=3)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    for axes in ({"dp": 4}, {"dp": 2, "sp": 2}):
        got = run_trials_sharded(cfg, cpu_mesh(axes)).trials
        assert_matches(got, jax_trials(jcfg), port_trials(cfg), axes)


# --------------------------------------------------------------- ring --


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("axis", [0, 1])
def test_ring_gather_reference_matches_jax(tp, axis):
    from jax.sharding import PartitionSpec as P

    mesh = j_make_mesh({"dp": 1, "tp": tp}, devices=jax.devices()[:tp])
    rng = np.random.default_rng(tp + 10 * axis)
    shape = [3, 5]
    shape[axis] *= tp
    xs = [rng.integers(-100, 100, shape) > 0]
    xs += [rng.integers(-100, 100, shape).astype(dt)
           for dt in (np.int8, np.int32)]

    def body(*shards):
        return tuple((j_ring_gather(x, tp, axis=axis),
                      jax.lax.all_gather(x, "tp", axis=axis, tiled=True))
                     for x in shards)

    spec = P(*([None] * axis + ["tp"]))
    outs = jax.jit(j_spmd._shard_map(
        body, mesh=mesh, in_specs=(spec,) * 3,
        out_specs=((P(), P()),) * 3, check_vma=False,
    ))(*map(jnp.asarray, xs))
    for x, (ring, gathered) in zip(xs, outs):
        shards = torch.from_numpy(np.stack(np.split(x, tp, axis=axis)))
        mine = ring_gather_reference(shards, axis)
        assert mine.dtype == shards.dtype
        assert torch.equal(mine, all_gather(shards, axis))
        for my in range(tp):
            assert np.array_equal(mine[my].numpy(), np.asarray(ring))
            assert np.array_equal(mine[my].numpy(), np.asarray(gathered))
            assert np.array_equal(mine[my].numpy(), x)


# ------------------------------------------------ the n_recv fused round --


@functools.lru_cache(maxsize=None)
def jax_n_recv_kernel(jcfg, n_local):
    n_pool = jcfg.n_lieutenants * jcfg.slots
    return jax.jit(build_fused_round_kernel(
        jcfg, n_local * jcfg.slots, n_pool, interpret=True, n_recv=n_local))


def test_n_recv_fused_round_matches_jax_round_by_round():
    jcfg = JConfig(n_parties=9, size_l=8, n_dishonest=2, trials=2, seed=5,
                   max_accepts_per_round=1)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    n_tp, trials = 2, jcfg.trials
    n_local = cfg.n_lieutenants // n_tp
    keys = qba_tpu_torch.backends.trial_keys(cfg, CPU)
    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    hc = rk.honest_cells(honest, cfg)
    vdt = pool_vals_dtype(jcfg)
    dts = (vdt, jnp.int32, vdt, jnp.int32)

    # Each shard's local segment equals JAX's (start, n_recv) compaction.
    segs = []
    for s in range(n_tp):
        lo = s * n_local
        cells = tuple(x[:, lo:lo + n_local] for x in out_cells)
        mine = rk.pool_from_step3a(cfg, cells, start=lo, n_recv=n_local)
        for t in range(trials):
            theirs = j_pool_3a(jcfg, tuple(jnp.asarray(x[t, :, None].numpy())
                                          for x in cells),
                               start=lo, n_recv=n_local)
            for a, b in zip(mine, theirs):
                assert np.array_equal(a[t].numpy().astype(np.int32),
                                      np.asarray(b).astype(np.int32))
        segs.append([x.numpy() for x in mine])
    pool = shards_from_numpy(segs)
    vi_l = rk.shard_receivers(vi.to(torch.int32), n_tp)
    li_l = rk.shard_receivers(li.to(torch.int32), n_tp)
    fused = jax_n_recv_kernel(jcfg, n_local)
    accepted, overflowed = 0, False
    for r in range(1, cfg.n_rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        whole = rk.assemble_pool(pool)
        assembled = tuple(x.expand((n_tp,) + x.shape) for x in whole)
        new, vi_new, ovf = rk.fused_round_reference(
            cfg, r, assembled, li_l, vi_l, hc, *draws, n_recv=n_local)
        for s in range(n_tp):
            lo = s * n_local
            for t in range(trials):
                with jax.threefry_partitionable(True):
                    out, vi_j, ovf_j = fused(
                        r, lo, *(jnp.asarray(x[t].numpy(), dt)
                                 for x, dt in zip(whole, dts)),
                        jnp.asarray(li_l[s, t].numpy()),
                        jnp.asarray(li_l[s, t].numpy()),
                        jnp.asarray(vi_l[s, t].numpy()),
                        jnp.asarray(hc[t, :, None].numpy()),
                        *(jnp.asarray(d[t, :, lo:lo + n_local].numpy()
                                      .astype(np.int32)) for d in draws))
                for name, a, b in zip(("vals", "lens", "p", "meta"), out,
                                      new):
                    assert np.array_equal(np.asarray(a).astype(np.int32),
                                          b[s, t].numpy().astype(np.int32)), \
                        (name, r, s, t)
                assert np.array_equal(np.asarray(vi_j), vi_new[s, t].numpy())
                assert bool(ovf_j) == bool(ovf[s, t])
        accepted += int(vi_new.sum() - vi_l.sum())
        overflowed |= bool(ovf.any())
        pool, vi_l = new, vi_new
    assert accepted > 0 and overflowed


# ------------------------------ the n_recv tiled and dense-mailbox rounds --

# Protocol state of the round-by-round tests: a slot a receiver, so that
# some rounds overflow.
N_RECV_CASE = dict(n_parties=9, size_l=8, n_dishonest=2, trials=2, seed=5,
                   max_accepts_per_round=1)


def shard_state(jcfg, n_tp):
    """Step 3a's state of ``jcfg``'s trials, its receivers in ``n_tp``
    shards: ``(cfg, out_cells, li_l, vi_l, honest_c, draws_of)``, where
    ``draws_of(r)`` gives round ``r``'s uint8 draw tables."""
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    keys = qba_tpu_torch.backends.trial_keys(cfg, CPU)
    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)

    def draws_of(r):
        return tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))

    return (cfg, out_cells, rk.shard_receivers(li.to(torch.int32), n_tp),
            rk.shard_receivers(vi.to(torch.int32), n_tp),
            rk.honest_cells(honest, cfg), draws_of)


def jnp_of(x):
    return jnp.asarray(x.numpy())


def jax_draws(draws, t, lo, n_local):
    """Trial ``t``'s draw columns of the receivers ``[lo, lo +
    n_local)``, as JAX's ``n_recv`` kernels take them."""
    return tuple(jnp.asarray(d[t, :, lo:lo + n_local].numpy().astype(np.int32))
                 for d in draws)


@functools.lru_cache(maxsize=None)
def jax_n_recv_tiled(jcfg, n_local):
    seg = n_local * jcfg.slots
    return (jax.jit(build_verdict_kernel(jcfg, seg, interpret=True,
                                         n_recv=n_local)),
            jax.jit(build_rebuild_kernel(jcfg, seg, interpret=True,
                                         n_recv=n_local)))


def check_tiled_n_recv(jcfg, cfg, r, pool, li_l, vi_l, hc, draws, n_local):
    """JAX's ``n_recv`` verdict then rebuild kernel, shard by shard and
    trial by trial, against the plain ``n_recv`` verdict and rebuild on
    the shards' assembled pools ``pool`` ``[n_sh, T, ...]``: ``acc``,
    ``vi``, the local successor segment and overflow must be equal.
    Returns the plain ``(pool', vi', overflow, acc)``."""
    verdict, rebuild = jax_n_recv_tiled(jcfg, n_local)
    acc, vi_new = rk.verdict_reference(cfg, r, pool, li_l, vi_l, hc, *draws,
                                       n_recv=n_local)
    new, ovf = rk.rebuild_reference(cfg, r, pool, li_l, acc, hc, *draws[:2],
                                    n_recv=n_local)
    vdt = pool_vals_dtype(jcfg)
    dts = (vdt, jnp.int32, vdt, jnp.int32)
    for s in range(li_l.shape[0]):
        lo = s * n_local
        for t in range(li_l.shape[1]):
            jpool = tuple(jnp.asarray(x[s, t].numpy(), dt)
                          for x, dt in zip(pool, dts))
            att, rv, late = jax_draws(draws, t, lo, n_local)
            hc_t = jnp.asarray(hc[t, :, None].numpy())
            with jax.threefry_partitionable(True):
                acc_j, vi_j = verdict(r, lo, *jpool, jnp_of(li_l[s, t]),
                                      jnp_of(vi_l[s, t]), hc_t, att, rv,
                                      late)
                out_j, ovf_j = rebuild(r, lo, *jpool, jnp_of(li_l[s, t]),
                                       acc_j, att, rv, hc_t)
            where = (r, s, t)
            assert np.array_equal(np.asarray(acc_j),
                                  rk.unpack_acc(acc[s, t], n_local).numpy()), \
                where
            assert np.array_equal(np.asarray(vi_j), vi_new[s, t].numpy()), \
                where
            for name, a, b in zip(("vals", "lens", "p", "meta"), out_j, new):
                assert np.array_equal(np.asarray(a).astype(np.int32),
                                      b[s, t].numpy().astype(np.int32)), \
                    (name,) + where
            assert bool(ovf_j) == bool(ovf[s, t]), where
    return new, vi_new, ovf, acc


@functools.lru_cache(maxsize=None)
def jax_n_recv_step(jcfg, n_local):
    return jax.jit(build_round_step(jcfg, interpret=True, n_recv=n_local))


def jax_mailbox(mailbox, t):
    """Trial ``t`` of the port's packed mailbox ``[T, ...]`` as the JAX
    round kernel's packed operands."""
    vals, lens, p, meta = (x[t].numpy().astype(np.int32) for x in mailbox)
    return tuple(map(jnp.asarray, (vals.transpose(1, 0, 2), lens,
                                   meta[:, 0:1], p, meta[:, 1:2],
                                   meta[:, 2:3])))


def check_round_step_n_recv(jcfg, cfg, r, mailbox, li_l, vi_l, hpk, draws,
                            n_local):
    """JAX's ``build_round_step(n_recv=...)``, shard by shard and trial by
    trial, against the plain ``n_recv`` dense-mailbox round on the
    shards' gathered mailboxes ``mailbox`` ``[n_sh, T, ...]``: the local
    mailbox (global ``cell`` lanes), ``vi`` and overflow must be equal.
    Returns the plain ``(mailbox', vi', overflow)``."""
    step = jax_n_recv_step(jcfg, n_local)
    new, vi_new, ovf = rs.round_step_reference(
        cfg, r, mailbox, li_l, vi_l, hpk, *draws, n_recv=n_local)
    for s in range(li_l.shape[0]):
        lo = s * n_local
        for t in range(li_l.shape[1]):
            with jax.threefry_partitionable(True):
                out = step(r, lo, *jax_mailbox(tuple(x[s] for x in mailbox),
                                               t),
                           jnp_of(li_l[s, t]), jnp_of(vi_l[s, t]),
                           jnp.asarray(hpk[t, :, None].numpy()),
                           *jax_draws(draws, t, lo, n_local))
            want = mailbox_from_numpy(*(np.asarray(x)[None] for x in out[:6]),
                                      start=lo, slots=cfg.slots)
            where = (r, s, t)
            for name, a, b in zip(("vals", "lens", "p", "meta"), want, new):
                assert torch.equal(a[0], b[s, t]), (name,) + where
            assert np.array_equal(np.asarray(out[6]), vi_new[s, t].numpy()), \
                where
            assert bool(np.asarray(out[7])[0, 0] > 0) == bool(ovf[s, t]), \
                where
    return new, vi_new, ovf


def test_n_recv_tiled_round_matches_jax_round_by_round():
    jcfg = JConfig(**N_RECV_CASE)
    n_tp = 2
    cfg, cells, li_l, vi_l, hc, draws_of = shard_state(jcfg, n_tp)
    n_local = cfg.n_lieutenants // n_tp
    pool = tuple(torch.stack(x) for x in zip(*[
        rk.pool_from_step3a(cfg, tuple(c[:, lo:lo + n_local] for c in cells),
                            start=lo, n_recv=n_local)
        for lo in range(0, cfg.n_lieutenants, n_local)]))
    accepted, overflowed = 0, False
    for r in range(1, cfg.n_rounds + 1):
        whole = rk.assemble_pool(pool)
        assembled = tuple(x.expand((n_tp,) + x.shape) for x in whole)
        new, vi_new, ovf, _acc = check_tiled_n_recv(
            jcfg, cfg, r, assembled, li_l, vi_l, hc, draws_of(r), n_local)
        accepted += int(vi_new.sum() - vi_l.sum())
        overflowed |= bool(ovf.any())
        pool, vi_l = new, vi_new
    assert accepted > 0 and overflowed


def test_n_recv_round_step_matches_jax_round_by_round():
    jcfg = JConfig(**N_RECV_CASE)
    n_tp = 2
    cfg, cells, li_l, vi_l, hc, draws_of = shard_state(jcfg, n_tp)
    n_local = cfg.n_lieutenants // n_tp
    mb = tuple(torch.stack(x) for x in zip(*[
        rs.mailbox_from_step3a(cfg, tuple(c[:, lo:lo + n_local]
                                          for c in cells), start=lo)
        for lo in range(0, cfg.n_lieutenants, n_local)]))
    # The local mailboxes in shard order are the whole step-3a mailbox,
    # cell lanes included.
    for a, b in zip(mb, rs.mailbox_from_step3a(cfg, cells)):
        assert torch.equal(torch.cat(list(a), dim=1), b)
    accepted, overflowed = 0, False
    for r in range(1, cfg.n_rounds + 1):
        gathered = tuple(all_gather(x, 1) for x in mb)
        new, vi_new, ovf = check_round_step_n_recv(
            jcfg, cfg, r, gathered, li_l, vi_l, hc, draws_of(r), n_local)
        accepted += int(vi_new.sum() - vi_l.sum())
        overflowed |= bool(ovf.any())
        mb, vi_l = new, vi_new
    assert accepted > 0 and overflowed


# Seeded random shard inputs: (config, tp, round, trials).  Random
# packets rarely pass the verdict: the trial counts are what it takes for
# each case to accept something.
N_RECV_RANDOM = {
    "5p-slots1-tp2-r1": (dict(n_parties=5, size_l=16, n_dishonest=2,
                              max_accepts_per_round=1), 2, 1, 8),
    "7p-split-tp3-r3": (dict(n_parties=7, size_l=8, n_dishonest=3,
                             strategy="split"), 3, 3, 4),
}


@pytest.mark.parametrize("case", list(N_RECV_RANDOM))
def test_n_recv_tiled_and_round_step_match_jax_on_random_shards(case):
    # Assembled pools with an empty segment, a full one and stale unsent
    # entries between the segments; gathered mailboxes whose unsent cells
    # hold stale packets.
    kw, tp, r, trials = N_RECV_RANDOM[case]
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    n_local = cfg.n_lieutenants // tp
    pool, li, vi, hc, *draws = random_shard_inputs(cfg, tp, r, trials,
                                                   seed=tp + r)
    _new, _vi, _ovf, acc = check_tiled_n_recv(jcfg, cfg, r, pool, li, vi,
                                              hc, draws, n_local)
    mb, li, vi, hpk, *draws = random_shard_mailbox_inputs(
        cfg, tp, r, trials, seed=tp + r)
    _mb, vi_m, _ovf = check_round_step_n_recv(jcfg, cfg, r, mb, li, vi, hpk,
                                              draws, n_local)
    assert bool(acc.any()) and int(vi_m.sum() - vi.sum()) > 0


# ---------------------------------------------------------- run_trials --


SPMD_CASES = {
    "9p-tp2": (dict(n_parties=9, size_l=16, n_dishonest=2, trials=4,
                    seed=42), 2),
    "9p-tp4": (dict(n_parties=9, size_l=16, n_dishonest=2, trials=4,
                    seed=42), 4),
    "17p-tp2": (dict(n_parties=17, size_l=8, n_dishonest=4, trials=4,
                     seed=41), 2),
    "17p-tp4": (dict(n_parties=17, size_l=8, n_dishonest=4, trials=4,
                     seed=41), 4),
    "17p-split-tp4": (dict(n_parties=17, size_l=8, n_dishonest=4, trials=4,
                           seed=43, strategy="split"), 4),
    "17p-noise-tp2": (dict(n_parties=17, size_l=8, n_dishonest=4, trials=4,
                           seed=44, p_depolarize=0.05,
                           p_measure_flip=0.02), 2),
    "5p-broadcast-racy-tp2": (dict(n_parties=5, size_l=8, n_dishonest=2,
                                   trials=4, seed=12,
                                   attack_scope="broadcast",
                                   delivery="racy", p_late=0.4), 2),
    "5p-overflow-tp2": (dict(n_parties=5, size_l=16, n_dishonest=2,
                             trials=8, seed=1, max_accepts_per_round=1), 2),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(SPMD_CASES))
def test_run_trials_spmd_matches_jax(case, engine):
    kw, tp = SPMD_CASES[case]
    jcfg = JConfig(**kw)
    cfg = dataclasses.replace(
        config_from_jax_fields(dataclasses.asdict(jcfg)), round_engine=engine)
    want, ref = jax_trials(jcfg), port_trials(cfg)
    mesh = cpu_mesh({"dp": 2, "tp": tp})
    with warnings.catch_warnings():
        warnings.simplefilter("error", QBADemotionWarning)
        for comms in ("ring", "all_gather"):
            got = run_trials_spmd(dataclasses.replace(cfg, tp_comms=comms),
                                  mesh).trials
            assert_matches(got, want, ref, (case, engine, comms))
    if case == "5p-overflow-tp2":
        assert want["overflow"].any()


def test_65_parties_on_the_plain_path():
    # w = 128 is past the kernels' 64-bit masks: no sharded plan, so a
    # forced megakernel demotes; the engines run their plain versions.
    # (The port's dense-mailbox xla engine takes about 25 s a batch here:
    # the pool engines are held against JAX's xla results instead.)
    jcfg = JConfig(n_parties=65, size_l=8, n_dishonest=1, trials=2, seed=9)
    cfg = dataclasses.replace(
        config_from_jax_fields(dataclasses.asdict(jcfg)),
        round_engine="pallas_fused")
    want, ref = jax_trials(jcfg), port_trials(cfg)
    mesh = cpu_mesh({"dp": 1, "tp": 4})
    got = run_trials_spmd(cfg, mesh).trials
    assert_matches(got, want, ref, "pallas_fused")
    assert rk.sharded_mega_plan(cfg, 4) is None
    with pytest.warns(QBADemotionWarning, match="unavailable") as rec:
        got = run_trials_spmd(
            dataclasses.replace(cfg, round_engine="pallas_mega"), mesh).trials
    assert_matches(got, want, ref, "pallas_mega")
    assert_reason(rec, "no_sharded_mega_plan")


def assert_reason(rec, reason):
    """One recorded demotion, with ``reason``, which JAX's resolver records
    for the same demotion."""
    reasons = [w.message.reason for w in rec
               if issubclass(w.category, QBADemotionWarning)]
    assert reasons == [reason]
    assert f'reason="{reason}"' in inspect.getsource(
        j_spmd._resolve_spmd_engine)


def test_direct_comparison_with_jax_spmd_and_counters():
    # JAX's own party-sharded run: the dp order of the keys and the
    # counters merged over tp, field by field.
    # JAX's xla engine does not trace with counters under shard_map's
    # replication checker (a carry's varying axes), so JAX runs its fused
    # engine, whose interpret mode runs with the checker off.
    jcfg = JConfig(n_parties=5, size_l=8, n_dishonest=2, trials=4, seed=11,
                   collect_counters=True, round_engine="pallas_fused")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(True):
        theirs = j_run_trials_spmd(jcfg, j_make_mesh(
            {"dp": 2, "tp": 2}, devices=jax.devices()[:4])).trials
    ref = port_trials(cfg)
    for engine in ("xla", "pallas", "pallas_fused", "pallas_tiled"):
        mine = run_trials_spmd(dataclasses.replace(cfg, round_engine=engine),
                               cpu_mesh({"dp": 2, "tp": 2})).trials
        assert_matches(mine, {f: np.asarray(getattr(theirs, f))
                              for f in FIELDS}, ref, engine)
        for f in dataclasses.fields(mine.counters):
            got = getattr(mine.counters, f.name)
            assert np.array_equal(got.numpy(),
                                  np.asarray(getattr(theirs.counters, f.name))
                                  ), f.name
            assert torch.equal(got, getattr(ref.counters, f.name)), f.name


def test_counters_demote_the_megakernel_with_jax_reason():
    jcfg = JConfig(n_parties=9, size_l=16, n_dishonest=2, trials=4, seed=45,
                   collect_counters=True, round_engine="pallas_mega")
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with record_decisions() as recs, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert j_spmd._resolve_spmd_engine(jcfg, 4) == "pallas_fused"
    with pytest.warns(QBADemotionWarning, match="counters") as rec:
        got = run_trials_spmd(cfg, cpu_mesh({"dp": 2, "tp": 2})).trials
    assert_reason(rec, recs[0]["reason"])
    ref = port_trials(dataclasses.replace(cfg, round_engine="pallas_fused"))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


def test_gen_stays_on_the_host_under_tp():
    jcfg = JConfig(n_parties=9, size_l=16, n_dishonest=2, trials=4, seed=46,
                   qsim_path="stabilizer")
    cfg = dataclasses.replace(
        config_from_jax_fields(dataclasses.asdict(jcfg)), mega_gen="gf2",
        round_engine="pallas_mega")
    with pytest.warns(QBADemotionWarning, match="gen-fused prologue") as rec:
        got = run_trials_spmd(cfg, cpu_mesh({"dp": 2, "tp": 2})).trials
    assert_reason(rec, "no_sharded_gen_fused")
    assert_matches(got, jax_trials(jcfg), port_trials(cfg), "gen")


def test_auto_engine_under_tp():
    from qba_tpu_torch.parallel.spmd import _resolve_spmd_engine

    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16)
    assert _resolve_spmd_engine(cfg, 4, CPU) == "xla"
    counted = dataclasses.replace(cfg, collect_counters=True)
    assert _resolve_spmd_engine(counted, 4, CPU) == "xla"
    plan = rk.sharded_mega_plan(cfg, 2)
    assert plan.n_local == 4 and plan.clusters is None
    assert rk.sharded_mega_plan(cfg, 16) is None  # past the portable cluster


def test_wrappers_use_plain_versions_on_cpu():
    # CPU tensors take the plain versions and launch nothing.
    from qba_tpu_torch.ops.ring_shuffle import ring_gather
    from qba_tpu_torch.ops.trial_megakernel import (
        sharded_trial_megakernel,
        sharded_trial_megakernel_reference,
        trial_megakernel_reference,
    )
    from qba_tpu_torch.testing import random_trial_inputs

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  max_accepts_per_round=1)
    fns = (ring_gather, rk.fused_round, rk.tiled_verdict, rk.tiled_rebuild,
           rs.round_step, sharded_trial_megakernel)
    before = [fn.launches for fn in fns]
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    assert torch.equal(ring_gather(x, 1), ring_gather_reference(x, 1))
    args = random_shard_inputs(cfg, 2, 1, 4, seed=0)
    got = rk.fused_round(cfg, 1, *args, n_recv=2)
    want = rk.fused_round_reference(cfg, 1, *args, n_recv=2)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)
    pool, li, vi, hc, att, rv, late = args
    acc, vi2 = rk.tiled_verdict(cfg, 1, *args, n_recv=2)
    ref_acc, ref_vi = rk.verdict_reference(cfg, 1, *args, n_recv=2)
    assert torch.equal(acc, ref_acc) and torch.equal(vi2, ref_vi)
    assert acc.dtype == torch.int64
    assert acc.shape == (2, 4, cfg.n_lieutenants * cfg.slots)
    out, ovf = rk.tiled_rebuild(cfg, 1, pool, li, acc, hc, att, rv, n_recv=2)
    # The pair is the fused round.
    for a, b in zip(out + (vi2, ovf), got[0] + got[1:]):
        assert torch.equal(a, b)
    margs = random_shard_mailbox_inputs(cfg, 2, 1, 4, seed=0)
    got = rs.round_step(cfg, 1, *margs, n_recv=2)
    want = rs.round_step_reference(cfg, 1, *margs, n_recv=2)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)
    assert got[0][0].shape == (2, 4, 2 * cfg.slots, cfg.max_l, cfg.size_l)
    targs = random_trial_inputs(cfg, 8, seed=1)
    got = sharded_trial_megakernel(cfg, 2, *targs)
    for a, b, c in zip(got, sharded_trial_megakernel_reference(cfg, 2, *targs),
                       trial_megakernel_reference(cfg, *targs)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert [fn.launches for fn in fns] == before


def test_shard_mailbox_layout():
    # A shard's local mailbox numbers its cells globally, whether made
    # empty or from the JAX kernel's operands; the shards' mailboxes in
    # shard order number every cell once.
    cfg = qba_tpu_torch.QBAConfig(n_parties=7, size_l=8, n_dishonest=2)
    slots, n_local = cfg.slots, 2
    empty = rs.empty_mailbox(cfg, 3, n_recv=n_local, start=4)
    want = 4 * slots + torch.arange(n_local * slots, dtype=torch.int32)
    assert torch.equal(empty[3][..., 3], want.expand(3, -1))
    assert int(empty[3][..., :3].abs().sum()) == 0
    assert empty[0].shape == (3, n_local * slots, cfg.max_l, cfg.size_l)
    jmb = [np.asarray(x)[None] for x in jax_mailbox(empty, 0)]
    for a, b in zip(mailbox_from_numpy(*jmb, start=4, slots=slots), empty):
        assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="slots"):
        mailbox_from_numpy(*jmb, start=4)
    segs = [rs.empty_mailbox(cfg, 1, n_recv=n_local, start=s)[3]
            for s in (0, 2, 4)]
    assert torch.equal(torch.cat(segs, dim=1)[..., 3],
                       torch.arange(6 * slots, dtype=torch.int32)[None])
