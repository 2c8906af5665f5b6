"""The port's plain trial megakernel equals the JAX trial megakernel.

``trial_megakernel_reference`` (the plain PyTorch version the CUDA
megakernel is held against on the card) against
``build_trial_megakernel(..., interpret=True)``, the TPU kernel run on
the CPU as the JAX package's own megakernel tests run it, on the same
P-sets, lists, orders, cell honesty and stacked draws of real trials.
``vi``, the decisions and the overflow flag must be equal.  Also: the
port's stacked draws (``attack_draws`` over every round) equal JAX's
``_stacked_draws``, and the
``pallas_mega`` engine equals JAX's and the port's ``xla`` engine trial
for trial.  Every output is an integer: the tolerance is 0.
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
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.ops.round_kernel_tiled import honest_cells as j_honest_cells
from qba_tpu.ops.round_kernel_tiled import resolve_mega_block
from qba_tpu.ops.trial_megakernel import build_trial_megakernel
from qba_tpu.rounds.engine import _stacked_draws as j_stacked_draws
from qba_tpu.rounds.engine import setup_trial as j_setup
from qba_tpu_torch.adversary import adversary_ctx
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    key_from_jax,
    stacked_draws_from_numpy,
)
from qba_tpu_torch.ops.trial_megakernel import (
    trial_megakernel,
    trial_megakernel_reference,
)
from qba_tpu_torch.ops.attack_draws import attack_draws
from qba_tpu_torch.rounds.engine import setup_trial, step3a_one
from qba_tpu_torch.testing import random_trial_inputs
from tests.test_torch_draws import fast_jit, jax_run_trials

FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")
CASES = {
    "5p-L16-d2": dict(n_parties=5, size_l=16, n_dishonest=2, trials=4,
                      seed=11),
    "11p-L16-d3-split": dict(n_parties=11, size_l=16, n_dishonest=3,
                             trials=2, seed=12, strategy="split"),
    "5p-L16-d1-racy": dict(n_parties=5, size_l=16, n_dishonest=1, trials=4,
                           seed=5, delivery="racy", p_late=0.25),
    "5p-L16-d2-overflow": dict(n_parties=5, size_l=16, n_dishonest=2,
                               trials=16, seed=2, max_accepts_per_round=1),
}


def case_keys(jcfg):
    with jax.threefry_partitionable(True):
        return jax.random.split(jax.random.key(jcfg.seed), jcfg.trials)


@functools.lru_cache(maxsize=None)
def jax_inputs(case):
    """A case's per-trial megakernel inputs from the JAX package, vmapped,
    on its keys; computed once a case (two tests read them)."""
    jcfg = JConfig(**CASES[case])

    def one(key):
        honest, lieu, p_rows, v_sent, _v_comm, k_rounds = j_setup(jcfg, key)
        ctx = j_ctx(jcfg, k_rounds, v_sent)
        draws = j_stacked_draws(jcfg, k_rounds, ctx)
        return (p_rows, lieu, v_sent, j_honest_cells(honest, jcfg), *draws)

    with jax.threefry_partitionable(True):
        return fast_jit(jax.vmap(one))(case_keys(jcfg))


@functools.lru_cache(maxsize=None)
def jax_mega(jcfg):
    blk_d, blk_v = resolve_mega_block(jcfg)
    mega = build_trial_megakernel(jcfg, blk_d, blk_v, interpret=True)
    return fast_jit(jax.vmap(
        lambda p, li, v, hc, a, r, la: mega(p, li, li, v, hc, a, r, la)))


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_kernel(case):
    jcfg = JConfig(**CASES[case])
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    inputs = jax_inputs(case)
    with jax.threefry_partitionable(True):
        vi_j, dec_j, ovf_j = (np.asarray(x) for x in jax_mega(jcfg)(*inputs))
    p_rows, lieu, v_sent, hc, att, rv, late = (np.array(x) for x in inputs)
    vi, dec, ovf = trial_megakernel_reference(
        cfg, torch.from_numpy(p_rows), torch.from_numpy(lieu),
        torch.from_numpy(v_sent), torch.from_numpy(hc[..., 0]),
        *stacked_draws_from_numpy(att, rv, late),
    )
    assert np.array_equal(vi_j, vi.numpy())
    assert np.array_equal(dec_j, dec.numpy())
    assert np.array_equal(ovf_j, ovf.numpy())
    assert vi_j.any()  # somebody accepted something
    if cfg.slots == 1:
        assert ovf_j.any()
    if cfg.delivery == "racy":
        assert late.any()


@pytest.mark.parametrize("case", ["5p-L16-d2", "11p-L16-d3-split",
                                  "5p-L16-d1-racy"])
def test_stacked_draws_match_jax(case):
    jcfg = JConfig(**CASES[case])
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    want = stacked_draws_from_numpy(
        *(np.array(x) for x in jax_inputs(case)[4:]))
    kt = key_from_jax(jax.random.key_data(case_keys(jcfg)))
    _h, _li, _p, v_sent, _vc, k_rounds = setup_trial(cfg, kt)
    k_rounds = k_rounds.contiguous()
    got = attack_draws(cfg, k_rounds, adversary_ctx(cfg, k_rounds, v_sent))
    n_pool = cfg.n_lieutenants * cfg.slots
    for a, b in zip(want, got):
        assert b.dtype == torch.uint8
        assert b.shape == (cfg.trials, cfg.n_rounds, n_pool, cfg.n_lieutenants)
        assert torch.equal(a, b)


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
def test_mega_engine_matches_jax_and_xla(kw):
    jcfg = JConfig(round_engine="pallas_mega", **kw)
    want = jax_trials(jcfg)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    got = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    xla = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine="xla"), device="cpu").trials
    for f in FIELDS:
        assert np.array_equal(want[f], getattr(got, f).numpy()), f
        assert torch.equal(getattr(xla, f), getattr(got, f)), f


def test_trial_pack_gives_identical_results():
    # trial_pack folds k trials into one TPU launch; the CUDA grid already
    # runs a block per trial, so the port accepts it and nothing changes.
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=8, seed=4, round_engine="pallas_mega")
    plain = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    packed = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, trial_pack=2), device="cpu").trials
    for f in FIELDS:
        assert torch.equal(getattr(plain, f), getattr(packed, f)), f


def mega_args(cfg, device):
    keys = qba_tpu_torch.backends.torch_backend.trial_keys(cfg, device)
    from qba_tpu_torch.ops.round_kernel_tiled import honest_cells

    honest, li, p_rows, v_sent, _vc, k_rounds = setup_trial(cfg, keys)
    k_rounds = k_rounds.contiguous()
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    return (cfg, p_rows.contiguous(), li.to(torch.int32).contiguous(),
            v_sent.to(torch.int32).contiguous(), honest_cells(honest, cfg),
            *attack_draws(cfg, k_rounds, ctx))


def test_wrapper_uses_plain_version_on_cpu():
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=4, seed=9)
    args = mega_args(cfg, "cpu")
    before = trial_megakernel.launches
    got = trial_megakernel(*args)
    want = trial_megakernel_reference(*args)
    assert trial_megakernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    assert got[2].dtype == torch.bool and got[1].shape == (4, 4)



@pytest.mark.parametrize("case", ["5p-L16-d2", "5p-L16-d2-overflow"])
def test_reference_matches_jax_kernel_on_random_inputs(case):
    # Seeded inputs the protocol never makes: lieutenants whose P holds
    # their own order, a value above w, a negative value or the SENTINEL,
    # so step 3a rejects some and keeps others; random cell honesty and
    # draws.
    import jax.numpy as jnp

    jcfg = JConfig(**CASES[case])
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    args = random_trial_inputs(cfg, 4, seed=7)
    p_rows, li, v_sent, hc = (x.numpy() for x in args[:4])
    draws = [x.numpy().astype(np.int32) for x in args[4:]]
    with jax.threefry_partitionable(True):
        vi_j, dec_j, ovf_j = (np.asarray(x) for x in jax_mega(jcfg)(
            jnp.asarray(p_rows), jnp.asarray(li), jnp.asarray(v_sent),
            jnp.asarray(hc[..., None]), *(jnp.asarray(d) for d in draws)))
    vi, dec, ovf = trial_megakernel_reference(cfg, *args)
    assert np.array_equal(vi_j, vi.numpy())
    assert np.array_equal(dec_j, dec.numpy())
    assert np.array_equal(ovf_j, ovf.numpy())
    ok = step3a_one(cfg, args[0], args[2], args[1])[0].any(-1)
    assert ok.any() and not ok.all()  # step 3a kept some, rejected some
