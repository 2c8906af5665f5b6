"""The port's plain fused round equals the JAX fused round kernel.

``fused_round_reference`` (the plain PyTorch version the CUDA kernel is
held against on the card) against ``build_fused_round_kernel(...,
interpret=True)``, the TPU kernel run as tests/test_round_kernel_fused.py
runs it on the CPU.  Round by round the successor pool, ``vi`` and the
overflow flag must be equal, with inputs made (a) from numpy with a seed
and (b) from the protocol state of real trials, carried across with
:mod:`qba_tpu_torch.convert`.  The CUDA kernel itself runs only on the
card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
against this same plain version, on protocol state and on the random
inputs of :mod:`qba_tpu_torch.testing`.
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

from qba_tpu.adversary import adversary_ctx as j_ctx
from qba_tpu.adversary import sample_attacks_round as j_draws
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.ops.round_kernel_tiled import build_fused_round_kernel
from qba_tpu.ops.round_kernel_tiled import honest_cells as j_honest_cells
from qba_tpu.ops.round_kernel_tiled import pool_from_step3a as j_pool_3a
from qba_tpu.ops.round_kernel_tiled import pool_vals_dtype
from qba_tpu.rounds.engine import setup_trial as j_setup
from qba_tpu.rounds.engine import step3a_one as j_step3a
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    draws_from_numpy,
    pool_from_numpy,
)
from qba_tpu_torch.ops.round_kernel_tiled import (
    fused_round,
    fused_round_reference,
    pool_from_step3a,
)
from qba_tpu_torch.testing import random_state


@functools.lru_cache(maxsize=None)
def jax_kernel(jcfg):
    """One jitted interpret-mode fused kernel per config shape."""
    n_pool = jcfg.n_lieutenants * jcfg.slots
    call = build_fused_round_kernel(jcfg, n_pool, n_pool, interpret=True)
    return jax.jit(call)


def run_jax(jcfg, round_idx, pool, li, vi, hc, att, rv, late):
    """The JAX kernel on one trial's numpy state -> numpy outputs."""
    vdt = pool_vals_dtype(jcfg)
    dts = (vdt, jnp.int32, vdt, jnp.int32)
    with jax.threefry_partitionable(True):
        out, vi2, ovf = jax_kernel(jcfg)(
            round_idx, *(jnp.asarray(x, dt) for x, dt in zip(pool, dts)),
            jnp.asarray(li),
            jnp.asarray(li), jnp.asarray(vi), jnp.asarray(hc),
            jnp.asarray(att), jnp.asarray(rv), jnp.asarray(late),
        )
    return ([np.asarray(x).astype(np.int32) for x in out],
            np.asarray(vi2), bool(ovf))


def run_port(cfg, round_idx, pools, lis, vis, hcs, atts, rvs, lates):
    """The port's plain version on the stacked trials -> numpy outputs."""
    pool = pool_from_numpy(*(np.stack([p[i] for p in pools]) for i in range(4)))
    draws = draws_from_numpy(np.stack(atts), np.stack(rvs), np.stack(lates))
    out, vi2, ovf = fused_round_reference(
        cfg, round_idx, pool, torch.from_numpy(np.stack(lis)),
        torch.from_numpy(np.stack(vis)),
        torch.from_numpy(np.stack(hcs)[..., 0]), *draws,
    )
    return [x.numpy().astype(np.int32) for x in out], vi2.numpy(), ovf.numpy()


def assert_round_equal(jcfg, cfg, round_idx, states):
    """Run both on per-trial states; compare every output exactly.
    Returns the JAX outputs (the next round's state)."""
    want = [run_jax(jcfg, round_idx, *s) for s in states]
    got = run_port(cfg, round_idx, *zip(*states))
    for t, (pool_j, vi_j, ovf_j) in enumerate(want):
        for name, a, b in zip(("vals", "lens", "p", "meta"), pool_j, got[0]):
            assert np.array_equal(a, b[t]), (name, round_idx, t)
        assert np.array_equal(vi_j, got[1][t]), ("vi", round_idx, t)
        assert ovf_j == bool(got[2][t]), ("overflow", round_idx, t)
    return want


@pytest.mark.parametrize(
    "kw,round_idx",
    [
        (dict(n_parties=5, size_l=16, n_dishonest=2), 1),
        (dict(n_parties=5, size_l=16, n_dishonest=2), 2),
        (dict(n_parties=5, size_l=16, n_dishonest=2, strategy="split"), 1),
        (dict(n_parties=5, size_l=16, n_dishonest=2,
              max_accepts_per_round=1), 1),
        (dict(n_parties=7, size_l=8, n_dishonest=3), 3),
    ],
)
def test_random_inputs(kw, round_idx):
    jcfg = JConfig(**kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(round_idx * 100 + len(kw))
    states = [random_state(rng, cfg, round_idx) for _ in range(16)]
    want = assert_round_equal(jcfg, cfg, round_idx, states)
    accepted = sum(int(w[1].sum()) - int(s[2].sum())
                   for w, s in zip(want, states))
    assert accepted > 0  # the verdict accepted something


def protocol_states(jcfg, keys):
    """Per-trial round-1 inputs of real trials, from the JAX package."""
    with jax.threefry_partitionable(True):
        def one(key):
            honest, lieu, p_rows, v_sent, _vc, k_rounds = j_setup(jcfg, key)
            vi, out_cells = jax.vmap(
                lambda pr, v, li: j_step3a(jcfg, pr, v, li)
            )(p_rows, v_sent, lieu)
            return (j_pool_3a(jcfg, out_cells), lieu, vi.astype(jnp.int32),
                    j_honest_cells(honest, jcfg), k_rounds,
                    j_ctx(jcfg, k_rounds, v_sent), out_cells)

        return jax.jit(jax.vmap(one))(keys)


def jax_round_draws(jcfg, k_rounds, ctx, r):
    with jax.threefry_partitionable(True):
        fn = jax.jit(jax.vmap(lambda k, c: j_draws(
            jcfg, jax.random.fold_in(k, r), r, c)))
        return [np.asarray(x).astype(np.int32) for x in fn(k_rounds, ctx)]


@pytest.mark.parametrize(
    "kw,trials,seed",
    [
        (dict(n_parties=5, size_l=16, n_dishonest=2), 4, 1),
        (dict(n_parties=5, size_l=16, n_dishonest=2, strategy="split"), 4, 0),
        (dict(n_parties=5, size_l=16, n_dishonest=2,
              max_accepts_per_round=1), 4, 1),
        (dict(n_parties=11, size_l=64, n_dishonest=3), 1, 1),
    ],
)
def test_protocol_state_round_by_round(kw, trials, seed):
    jcfg = JConfig(trials=trials, seed=seed, **kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(seed), trials)
    pool, lieu, vi, hc, k_rounds, ctx, out_cells = protocol_states(jcfg, keys)

    # The port's own step-3a compaction builds the same pool.
    o = [torch.from_numpy(np.array(x)[:, :, 0]) for x in out_cells]
    mine = pool_from_step3a(cfg, o)
    for a, b in zip(mine, pool):
        assert np.array_equal(a.numpy().astype(np.int32),
                              np.asarray(b).astype(np.int32))

    pools = [[np.asarray(x[t]).astype(np.int32) for x in pool]
             for t in range(trials)]
    lieu, vi, hc = np.asarray(lieu), np.asarray(vi), np.asarray(hc)
    overflowed, accepted = False, 0
    for r in range(1, cfg.n_rounds + 1):
        att, rv, late = jax_round_draws(jcfg, k_rounds, ctx, r)
        states = [(pools[t], lieu[t], vi[t], hc[t], att[t], rv[t], late[t])
                  for t in range(trials)]
        want = assert_round_equal(jcfg, cfg, r, states)
        accepted += sum(int(w[1].sum()) for w in want) - int(vi.sum())
        overflowed |= any(w[2] for w in want)
        pools = [w[0] for w in want]
        vi = np.stack([w[1] for w in want])
    assert accepted > 0
    if cfg.slots == 1:
        assert overflowed


def test_wrapper_uses_plain_version_on_cpu():
    # CPU tensors take the plain version and launch nothing.
    jcfg = JConfig(n_parties=5, size_l=16, n_dishonest=2)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    pool, li, vi, hc, att, rv, late = random_state(rng, cfg, 1)
    before = fused_round.launches
    args = (cfg, 1, pool_from_numpy(*(x[None] for x in pool)),
            torch.from_numpy(li[None]), torch.from_numpy(vi[None]),
            torch.from_numpy(hc[None, :, 0]),
            *draws_from_numpy(att[None], rv[None], late[None]))
    out = fused_round(*args)
    ref = fused_round_reference(*args)
    assert fused_round.launches == before
    for a, b in zip(out[0], ref[0]):
        assert torch.equal(a, b)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])

