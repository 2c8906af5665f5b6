"""The port's dense-mailbox round equals the JAX round kernel.

``round_step_reference`` (the plain PyTorch version the CUDA kernel
``round_step.cu`` is held against on the card) against
``build_round_step(cfg, interpret=True)``, the TPU kernel run as
tests/test_round_kernel.py runs it on the CPU: round by round on the
protocol state of real trials, the same packed mailbox and draws go
through both, and the successor mailbox, ``vi`` and the overflow flag
must be equal.  Then the port's ``pallas`` engine against JAX's
``pallas`` engine and the port's ``xla`` engine, trial for trial.  Every
output is an integer: the tolerance is 0.
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
from qba_tpu.adversary import adversary_ctx as j_ctx
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.ops.round_kernel import build_round_step
from qba_tpu.ops.round_kernel import honest_packets as j_honest_packets
from qba_tpu.ops.round_kernel import pack_mailbox as j_pack_mailbox
from qba_tpu.rounds.engine import setup_trial as j_setup
from qba_tpu.rounds.engine import step3a_one as j_step3a
from qba_tpu.rounds.mailbox import Mailbox as JMailbox
from qba_tpu_torch.convert import (
    config_from_jax_fields,
    draws_from_numpy,
    mailbox_from_numpy,
)
from qba_tpu_torch.ops import round_kernel as rk
from qba_tpu_torch.rounds.engine import step3a_one
from qba_tpu_torch.rounds.mailbox import mailbox_from_step3a
from qba_tpu_torch.testing import random_mailbox_state
from tests.test_torch_draws import fast_jit, jax_run_trials
from tests.test_torch_fused_round import jax_round_draws

FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")
ROUND_CASES = {
    "5p": (dict(n_parties=5, size_l=16, n_dishonest=2), 4, 1),
    # n_lieutenants odd: the TPU kernel's tail-overlap lane group.
    "6p-odd": (dict(n_parties=6, size_l=48, n_dishonest=2), 3, 6),
    "4p-racy": (dict(n_parties=4, size_l=8, n_dishonest=1, delivery="racy",
                     p_late=0.5), 6, 2),
    "5p-overflow": (dict(n_parties=5, size_l=16, n_dishonest=2,
                         max_accepts_per_round=1), 6, 1),
    "5p-split": (dict(n_parties=5, size_l=16, n_dishonest=2,
                      strategy="split"), 4, 0),
}


@functools.lru_cache(maxsize=None)
def jax_step(jcfg):
    """The interpret-mode JAX kernel, jitted (``FAST_COMPILE``) and vmapped
    over trials; the round index is traced, as in the JAX engine's scan,
    so one compile serves every round."""
    step = build_round_step(jcfg, interpret=True)
    return fast_jit(jax.vmap(step, in_axes=(None,) + (0,) * 12))


def jax_state(jcfg, keys):
    """Packed step-3a mailbox, li, vi, honesty and round keys of real
    trials, from the JAX package."""
    n_pk = jcfg.n_lieutenants * jcfg.slots

    def one(key):
        honest, lieu, p_rows, v_sent, _vc, k_rounds = j_setup(jcfg, key)
        vi, out_cells = jax.vmap(
            lambda pr, v, li: j_step3a(jcfg, pr, v, li)
        )(p_rows, v_sent, lieu)
        packed = j_pack_mailbox(JMailbox(*out_cells), n_pk, jcfg.max_l,
                                jcfg.size_l)
        return (packed, lieu, vi.astype(jnp.int32),
                j_honest_packets(honest, jcfg), k_rounds,
                j_ctx(jcfg, k_rounds, v_sent))

    with jax.threefry_partitionable(True):
        return fast_jit(jax.vmap(one))(keys)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_reference_equals_jax_kernel_round_by_round(case):
    kw, trials, seed = ROUND_CASES[case]
    jcfg = JConfig(trials=trials, seed=seed, **kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(seed), trials)
    packed, lieu, vi, hpk, k_rounds, ctx = jax_state(jcfg, keys)
    li_t = torch.from_numpy(np.array(lieu))
    hpk_t = torch.from_numpy(np.array(hpk)[..., 0])
    accepted, overflowed, late_any = 0, False, False
    for r in range(1, cfg.n_rounds + 1):
        att, rv, late = jax_round_draws(jcfg, k_rounds, ctx, r)
        with jax.threefry_partitionable(True):
            out = jax_step(jcfg)(jnp.int32(r), *packed, lieu, vi, hpk,
                                 jnp.asarray(att), jnp.asarray(rv),
                                 jnp.asarray(late))
        got_mb, got_vi, got_ovf = rk.round_step_reference(
            cfg, r, mailbox_from_numpy(*packed), li_t,
            torch.from_numpy(np.array(vi)), hpk_t,
            *draws_from_numpy(att, rv, late))
        want_mb = mailbox_from_numpy(*out[:6])
        for name, a, b in zip(("vals", "lens", "p", "meta"), got_mb, want_mb):
            assert torch.equal(a, b), (name, r)
        assert np.array_equal(np.asarray(out[6]), got_vi.numpy()), ("vi", r)
        want_ovf = np.asarray(out[7])[:, 0, 0] > 0
        assert np.array_equal(want_ovf, got_ovf.numpy()), ("overflow", r)
        accepted += int(np.asarray(out[6]).sum()) - int(np.asarray(vi).sum())
        overflowed |= bool(want_ovf.any())
        late_any |= bool(late.any())
        packed, vi = out[:6], out[6]
    assert accepted > 0  # some round accepted something
    if cfg.slots == 1:
        assert overflowed
    if cfg.delivery == "racy":
        assert late_any


@pytest.mark.parametrize("case,round_idx", [
    ("5p", 1), ("5p", 2), ("5p-split", 1), ("5p-overflow", 1),
])
def test_reference_equals_jax_kernel_on_random_mailboxes(case, round_idx):
    # Seeded random mailboxes reach the verdict's guards (out-of-range
    # values, colliding rows, disagreeing lens, own rows already in L).
    kw, trials, seed = ROUND_CASES[case]
    jcfg = JConfig(trials=trials, seed=seed, **kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7 * round_idx + len(case))
    states = [random_mailbox_state(rng, cfg, round_idx) for _ in range(24)]
    packed, li, vi, hc, att, rv, late = (
        [np.stack(x) for x in zip(*col)] if isinstance(col[0], tuple)
        else np.stack(col) for col in zip(*states))
    with jax.threefry_partitionable(True):
        out = jax_step(jcfg)(jnp.int32(round_idx),
                             *(jnp.asarray(x) for x in packed),
                             jnp.asarray(li), jnp.asarray(vi),
                             jnp.asarray(hc), jnp.asarray(att),
                             jnp.asarray(rv), jnp.asarray(late))
    got_mb, got_vi, got_ovf = rk.round_step_reference(
        cfg, round_idx, mailbox_from_numpy(*packed), torch.from_numpy(li),
        torch.from_numpy(vi), torch.from_numpy(hc[..., 0]),
        *draws_from_numpy(att, rv, late))
    for name, a, b in zip(("vals", "lens", "p", "meta"), got_mb,
                          mailbox_from_numpy(*out[:6])):
        assert torch.equal(a, b), name
    assert np.array_equal(np.asarray(out[6]), got_vi.numpy())
    assert np.array_equal(np.asarray(out[7])[:, 0, 0] > 0, got_ovf.numpy())
    assert int(np.asarray(out[6]).sum()) > int(vi.sum())  # some accepted


# The cases of tests/test_round_kernel.py::TestKernelEquivalence, at
# their sizes with fewer trials.
ENGINE_CASES = {
    "all-honest": dict(n_parties=5, size_l=16, n_dishonest=0, trials=4,
                       seed=0),
    "adversarial": dict(n_parties=5, size_l=16, n_dishonest=2, trials=8,
                        seed=1),
    "wide-positions": dict(n_parties=4, size_l=128, n_dishonest=1, trials=3,
                           seed=5),
    "odd-lieutenants": dict(n_parties=6, size_l=48, n_dishonest=2, trials=4,
                            seed=6),
    "racy": dict(n_parties=4, size_l=8, n_dishonest=1, delivery="racy",
                 p_late=0.5, trials=8, seed=2),
    "overflow": dict(n_parties=5, size_l=16, n_dishonest=2,
                     max_accepts_per_round=1, trials=8, seed=1),
    "larger": dict(n_parties=7, size_l=32, n_dishonest=2, trials=3, seed=4),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_pallas_engine_matches_jax_and_xla(case):
    jcfg = JConfig(round_engine="pallas", **ENGINE_CASES[case])
    res = jax_run_trials(jcfg)
    want = {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    for engine in ("pallas", "xla"):
        got = qba_tpu_torch.run_trials(
            dataclasses.replace(cfg, round_engine=engine), device="cpu")
        for f in FIELDS:
            assert np.array_equal(want[f], getattr(got.trials, f).numpy()), (
                engine, f)
    if case == "overflow":
        assert want["overflow"].any()
    if case == "adversarial":
        assert not want["honest"].all()


def test_packed_step3a_mailbox_equals_packed_dense_mailbox():
    # mailbox_from_step3a (packed in place) and pack_mailbox of the dense
    # Mailbox give the same tensors; the empty mailbox numbers its cells.
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    rng = np.random.default_rng(0)
    li = torch.from_numpy(rng.integers(0, cfg.w, (3, 4, 16)).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, cfg.w, (3, 4)).astype(np.int32))
    p_rows = torch.from_numpy(rng.random((3, 4, 16)) < 0.4) & (
        li != v[..., None])
    _vi, out_cells = step3a_one(cfg, p_rows, v, li)
    a = rk.mailbox_from_step3a(cfg, out_cells)
    b = rk.pack_mailbox(cfg, mailbox_from_step3a(cfg, out_cells))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a[0].dtype == torch.int8 and a[0].shape == (3, 32, 4, 16)
    empty = rk.empty_mailbox(cfg, 2)
    assert torch.equal(empty[3][..., 3], torch.arange(32).expand(2, 32).int())
    assert int(empty[3][..., :3].abs().sum()) == 0


def test_wrapper_uses_plain_version_on_cpu():
    # CPU tensors take the plain version and launch nothing.
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    rng = np.random.default_rng(1)
    li = torch.from_numpy(rng.integers(0, cfg.w, (2, 4, 16)).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, cfg.w, (2, 4)).astype(np.int32))
    p_rows = torch.from_numpy(rng.random((2, 4, 16)) < 0.4) & (
        li != v[..., None])
    vi, out_cells = step3a_one(cfg, p_rows, v, li)
    mb = rk.mailbox_from_step3a(cfg, out_cells)
    hpk = torch.ones((2, 32), dtype=torch.int32)
    draws = [torch.zeros((2, 32, 4), dtype=torch.uint8) for _ in range(3)]
    before = rk.round_step.launches
    args = (cfg, 1, mb, li, vi.to(torch.int32), hpk, *draws)
    out = rk.round_step(*args)
    ref = rk.round_step_reference(*args)
    assert rk.round_step.launches == before
    for a, b in zip(out[0], ref[0]):
        assert torch.equal(a, b)
    assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
    assert int(out[0][3][..., 2].sum()) > 0  # honest senders: rebroadcasts


def test_honest_packets_layout():
    cfg = qba_tpu_torch.QBAConfig(n_parties=4, size_l=8, n_dishonest=1)
    honest = torch.tensor([[True, True, False, True, True]])
    want = torch.tensor([[0] * cfg.slots + [1] * cfg.slots * 2])
    assert torch.equal(rk.honest_packets(honest, cfg), want.int())
