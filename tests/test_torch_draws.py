"""The port's attack draws and keyed trial megakernels equal the JAX package.

``attack_draw_at_reference`` (the per-entry formula the CUDA draws kernel
and the megakernels' keyed entries implement, ``csrc/draws.cuh``) and
``attack_draws`` on CPU tensors (its plain version) against JAX's
``_stacked_draws`` on the same trial keys, in every strategy, attack
scope and delivery the round engines take: ``reference``, ``collude``,
``adaptive`` and ``split`` under the delivery scope, ``reference`` under
the broadcast scope, each under ``sync`` and ``racy`` delivery, at
5p/L16 and 7p/L16.  Then the keyed megakernels' plain versions (the
``pallas_mega`` engine on the CPU, single-device and at ``tp = 2`` on a
CPU mesh, and the gen entry on ``qsim_path="stabilizer"``) against JAX's
``run_trials`` trial for trial.  Every output is an integer or a flag:
the tolerance is 0.

The JAX side is compiled once for a law's ``sync`` and ``racy`` forms
(one program computes both; the cases of a law sit side by side), at
XLA's cheapest optimisation level: the outputs are integers and flags,
which no optimisation level changes.
"""

import dataclasses
import functools

import jax
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
from qba_tpu.rounds.engine import _stacked_draws as j_stacked_draws
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import (
    adversary_ctx,
    assign_dishonest,
    commander_orders,
)
from qba_tpu_torch.convert import config_from_jax_fields, key_from_jax
from qba_tpu_torch.ops import attack_draws as ad
from qba_tpu_torch.ops import trial_megakernel as tm
from qba_tpu_torch.parallel import make_mesh, run_trials_spmd

RACY = dict(delivery="racy", p_late=0.25)
DELIVERIES = ("sync", "racy")
LAWS = {
    "reference": {},
    "collude": dict(strategy="collude"),
    "adaptive": dict(strategy="adaptive"),
    "split": dict(strategy="split"),
    "broadcast": dict(attack_scope="broadcast"),
}
COMBOS = {f"{law}-{delivery}": dict(kw, **(RACY if delivery == "racy" else {}))
          for law, kw in LAWS.items() for delivery in DELIVERIES}
SIZES = {"5p": dict(n_parties=5, size_l=16, n_dishonest=3, trials=6, seed=3),
         "7p": dict(n_parties=7, size_l=16, n_dishonest=3, trials=4, seed=4)}
FIELDS = ("decisions", "success", "vi", "overflow")


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jcfg_of(size, combo, **kw):
    return JConfig(**{**SIZES[size], **COMBOS[combo], **kw})


def law_of(combo):
    return combo.rsplit("-", 1)[0]


def run_jax(fn, keys):
    """``jax.jit(fn)(keys)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(keys).compile(FAST_COMPILE)(keys)


def fast_jit(fn):
    """``jax.jit(fn)``, compiled with ``FAST_COMPILE`` once for each
    argument signature (structure, shapes, dtypes and the threefry mode).
    The other test files' JAX references compile through it: their
    outputs are integers and flags too."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        sig = (jax.config.jax_threefry_partitionable, tree,
               tuple((np.shape(x), str(getattr(x, "dtype", type(x))))
                     for x in leaves))
        if sig not in compiled:
            compiled[sig] = jitted.lower(*args).compile(FAST_COMPILE)
        return compiled[sig](*args)

    return call


def jax_run_trials(jcfg, keys=None):
    """JAX's ``run_trials(jcfg, keys)`` in partitionable threefry mode,
    compiled with ``FAST_COMPILE``: its unpacked path, the one it takes
    off the TPU (``trial_pack`` unset)."""
    assert jcfg.trial_pack is None
    with jax.threefry_partitionable(True):
        if keys is None:
            keys = j_trial_keys(jcfg)
        return run_jax(lambda k: j_aggregate(j_batched_trials(jcfg, k)),
                       keys)


@functools.lru_cache(maxsize=None)
def jax_draws(size, law):
    """JAX's stacked draws ``[T, n_rounds, n_pool, n_rv]`` of the size's
    trial keys under the law's ``sync`` and ``racy`` delivery (one
    program), by combination, and the keys, as numpy."""
    jcfgs = {f"{law}-{d}": jcfg_of(size, f"{law}-{d}") for d in DELIVERIES}

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

    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(SIZES[size]["seed"]),
                                SIZES[size]["trials"])
        draws = run_jax(every, keys)
        return ({c: tuple(np.asarray(x) for x in d)
                 for c, d in draws.items()},
                np.asarray(jax.random.key_data(keys)))


def port_keys(cfg, keys):
    """The port's rounds keys and adversary context of trial keys."""
    k = jr.split(key_from_jax(keys), 4)
    honest = assign_dishonest(cfg, k[..., 0, :])
    v_sent, _v = commander_orders(cfg, k[..., 2, :], honest[..., 1])
    k_rounds = k[..., 3, :].contiguous()
    return k_rounds, adversary_ctx(cfg, k_rounds, v_sent)


@pytest.mark.parametrize(
    "size,combo", [(size, combo) for size in SIZES for combo in COMBOS],
    ids=[f"{combo}-{size}" for size in SIZES for combo in COMBOS])
def test_draws_match_jax(size, combo):
    # One JAX compile a law and size serves both checks: the per-entry
    # formula of the device code, and the draws wrapper's CPU path (its
    # plain version), each against JAX's stacked draws.
    jcfg = jcfg_of(size, combo)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    every, keys = jax_draws(size, law_of(combo))
    want = every[combo]
    k_rounds, ctx = port_keys(cfg, keys)
    n_pool, n_rv = cfg.n_lieutenants * cfg.slots, cfg.n_lieutenants
    cell = torch.arange(n_pool)[:, None].expand(n_pool, n_rv)
    rv = torch.arange(n_rv)[None, :].expand(n_pool, n_rv)
    for r in range(1, cfg.n_rounds + 1):
        got = ad.attack_draw_at_reference(cfg, k_rounds, ctx, r, cell, rv)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(w.dtype), w[:, r - 1])
    attack, _rand_v, late = want
    assert (attack != 0).any()
    assert late.any() == (cfg.delivery == "racy")

    before = ad.attack_draws.launches
    got = ad.attack_draws(cfg, k_rounds, ctx)
    assert ad.attack_draws.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and g.is_contiguous()
        assert np.array_equal(g.numpy(), w.astype(np.uint8))
    # A window of rounds is the same rounds' slabs.
    part = ad.attack_draws(cfg, k_rounds, ctx, 2, cfg.n_rounds - 2)
    for g, w in zip(part, got):
        assert torch.equal(g, w[:, 1:cfg.n_rounds - 1])


def test_attack_draws_input_checks():
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=4, strategy="adaptive")
    keys = jr.split(jr.key(1), 4)
    k_rounds = jr.split(keys, 4)[..., 3, :]
    v_sent = torch.zeros((4, cfg.n_lieutenants), dtype=torch.int32)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    # The kernel's inputs: what the CUDA path checks before a launch.
    with pytest.raises(ValueError, match="contiguous"):
        ad.keyed_inputs(cfg, k_rounds, ctx)
    k_rounds = k_rounds.contiguous()
    assert ad.keyed_inputs(cfg, k_rounds, ctx)[2] is ctx.v_sent
    with pytest.raises(TypeError, match="dtype"):
        ad.keyed_inputs(cfg, k_rounds.to(torch.int32), ctx)
    with pytest.raises(TypeError, match="v_sent has dtype"):
        ad.keyed_inputs(cfg, k_rounds, ctx._replace(v_sent=v_sent.long()))
    with pytest.raises(ValueError, match="v_sent on meta"):
        ad.keyed_inputs(cfg, k_rounds,
                        ctx._replace(v_sent=v_sent.to("meta")))
    with pytest.raises(ValueError, match="needs ctx"):
        ad.keyed_inputs(cfg, k_rounds, None)
    with pytest.raises(ValueError, match="outside"):
        ad.attack_draws(cfg, k_rounds, ctx, 2, cfg.n_rounds)
    with pytest.raises(ValueError, match="unsupported device"):
        ad.attack_draws(cfg, k_rounds.to("meta"), ctx)
    # The round law the kernels take: strategy code, scope, delivery,
    # float32 p_late's bits, the forge range.
    racy = dataclasses.replace(cfg, strategy="split", **RACY)
    assert ad.law_ints(racy) == [3, 0, 1, 0x3E800000, 6]


MEGA = dict(n_parties=5, size_l=16, n_dishonest=2, trials=8, seed=6)
GEN_COMBOS = ("adaptive-racy", "broadcast-sync")


def mega_jcfg(combo, **kw):
    return JConfig(round_engine="xla", **MEGA, **COMBOS[combo], **kw)


@functools.lru_cache(maxsize=None)
def jax_trials(combos, **kw):
    """JAX's trials (``run_trials``' batch on the ``xla`` engine) of
    ``MEGA`` under each of ``combos`` (one program), as numpy."""
    jcfgs = {c: mega_jcfg(c, **kw) for c in combos}

    def every(keys):
        return {c: j_batched_trials(j, keys) for c, j in jcfgs.items()}

    with jax.threefry_partitionable(True):
        res = run_jax(every, j_trial_keys(jcfgs[combos[0]]))
        return {c: {f: np.asarray(getattr(t, f)) for f in FIELDS}
                for c, t in res.items()}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_keyed_megakernels_match_jax(combo):
    jcfg = mega_jcfg(combo)
    law = law_of(combo)
    want = jax_trials(tuple(f"{law}-{d}" for d in DELIVERIES))[combo]
    cfg = config_from_jax_fields(
        dataclasses.asdict(dataclasses.replace(jcfg,
                                               round_engine="pallas_mega")))
    single = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    mesh = make_mesh({"dp": 1, "tp": 2}, devices=["cpu"] * 2)
    sharded = run_trials_spmd(cfg, mesh).trials
    for f in FIELDS:
        assert np.array_equal(want[f], getattr(single, f).numpy()), f
        assert np.array_equal(want[f], getattr(sharded, f).numpy()), f


@pytest.mark.parametrize("combo", GEN_COMBOS)
def test_keyed_gen_megakernel_matches_jax(combo):
    jcfg = mega_jcfg(combo, qsim_path="stabilizer")
    want = jax_trials(GEN_COMBOS, qsim_path="stabilizer")[combo]
    cfg = config_from_jax_fields(
        dataclasses.asdict(dataclasses.replace(jcfg,
                                               round_engine="pallas_mega")))
    before = tm.trial_megakernel_gen_keyed.launches
    got = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    assert tm.trial_megakernel_gen_keyed.launches == before
    for f in FIELDS:
        assert np.array_equal(want[f], getattr(got, f).numpy()), f


def test_keyed_wrappers_use_plain_versions_on_cpu():
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells
    from qba_tpu_torch.rounds.engine import setup_trial

    cfg = qba_tpu_torch.QBAConfig(**MEGA, strategy="collude", **RACY)
    keys = qba_tpu_torch.backends.torch_backend.trial_keys(cfg, "cpu")
    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    body = (p_rows.contiguous(), li.to(torch.int32).contiguous(),
            v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg))
    draws = ad.attack_draws(cfg, k_rounds, ctx)
    before = (tm.trial_megakernel_keyed.launches,
              tm.sharded_trial_megakernel_keyed.launches)
    got = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    sharded = tm.sharded_trial_megakernel_keyed(cfg, 2, *body, k_rounds, ctx)
    assert (tm.trial_megakernel_keyed.launches,
            tm.sharded_trial_megakernel_keyed.launches) == before
    for a, b, c in zip(got, sharded,
                       tm.trial_megakernel_reference(cfg, *body, *draws)):
        assert torch.equal(a, c) and torch.equal(b, c)
