"""Trial setup and per-round draws: the port equals :mod:`qba_tpu` per key.

For the same trial keys, ``setup_trial`` (honesty, lists, Q-correlation,
P-sets, orders), the collude target and every round's ``(attack, rand_v,
late)`` must match exactly, for the four strategies, both attack scopes,
noise on and off, and racy delivery.  JAX runs in partitionable threefry
mode, set only inside ``jax.threefry_partitionable(True)``.
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
from qba_tpu.adversary import sample_attacks_round as j_draws
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.qsim import generate_lists_for as j_lists
from qba_tpu.rounds.engine import setup_trial as j_setup
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
from qba_tpu_torch.convert import config_from_jax_fields, key_from_jax
from qba_tpu_torch.qsim import generate_lists_for
from qba_tpu_torch.rounds.engine import setup_trial

BASE = dict(n_parties=5, size_l=16, n_dishonest=2)
CASES = {
    "reference": dict(),
    "collude": dict(strategy="collude"),
    "adaptive": dict(strategy="adaptive"),
    "split": dict(strategy="split"),
    "broadcast": dict(attack_scope="broadcast"),
    "noise": dict(p_depolarize=0.1, p_measure_flip=0.05),
    "racy": dict(delivery="racy", p_late=0.25),
    "slots": dict(max_accepts_per_round=2, strategy="adaptive"),
    "11p": dict(n_parties=11, size_l=64, n_dishonest=3, strategy="collude"),
}


def jax_side(cfg, keys):
    """Setup, lists, collude target and every round's draws, vmapped."""

    def one(key):
        honest, lieu, p_rows, v_sent, v_comm, k_rounds = j_setup(cfg, key)
        k_lists = jax.random.split(key, 4)[1]
        lists, qcorr = j_lists(cfg, k_lists)
        ctx = j_ctx(cfg, k_rounds, v_sent)
        draws = [
            j_draws(cfg, jax.random.fold_in(k_rounds, r), r, ctx)
            for r in range(1, cfg.n_rounds + 1)
        ]
        target = None if ctx is None else ctx.collude_target
        return (honest, lieu, p_rows, v_sent, v_comm, lists, qcorr, target,
                draws)

    with jax.threefry_partitionable(True):
        return jax.tree.map(np.asarray, jax.jit(jax.vmap(one))(keys))


@pytest.mark.parametrize("case", list(CASES))
def test_setup_and_draws_match(case):
    kw = {**BASE, **CASES[case]}
    jcfg = JConfig(trials=6, seed=21, **kw)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(True):
        keys = jax.random.split(jax.random.key(jcfg.seed), jcfg.trials)
    (honest, lieu, p_rows, v_sent, v_comm, lists, qcorr, target,
     draws) = jax_side(jcfg, keys)

    kt = key_from_jax(jax.random.key_data(keys))
    t_honest, t_lieu, t_p, t_vs, t_vc, k_rounds = setup_trial(cfg, kt)
    t_lists, t_qcorr = generate_lists_for(cfg, jr.split(kt, 4)[:, 1])
    for name, a, b in [("honest", honest, t_honest), ("lieu", lieu, t_lieu),
                       ("p_rows", p_rows, t_p), ("v_sent", v_sent, t_vs),
                       ("v_comm", v_comm, t_vc), ("lists", lists, t_lists),
                       ("qcorr", qcorr, t_qcorr)]:
        assert np.array_equal(a, b.numpy()), name
    ctx = adversary_ctx(cfg, k_rounds, t_vs)
    if target is not None:
        assert np.array_equal(target, ctx.collude_target.numpy())
    for r in range(1, cfg.n_rounds + 1):
        got = sample_attacks_round(cfg, jr.fold_in(k_rounds, r), r, ctx)
        for name, a, b in zip(("attack", "rand_v", "late"), draws[r - 1], got):
            assert np.array_equal(a, b.numpy()), (name, r)
    # The case's feature was exercised: Byzantine parties, and its edits.
    assert not honest.all()
    attack = np.stack([d[0] for d in draws])
    if case == "split":
        assert (attack & 16).any()
    if case == "racy":
        assert np.stack([d[2] for d in draws]).any()


def test_trial_keys_match():
    from qba_tpu.backends.jax_backend import trial_keys as j_trial_keys
    from qba_tpu_torch.backends.torch_backend import trial_keys

    jcfg = JConfig(n_parties=5, size_l=16, trials=7, seed=99)
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.key_data(j_trial_keys(jcfg)))
    got = trial_keys(config_from_jax_fields(dataclasses.asdict(jcfg)))
    assert np.array_equal(want.astype(np.int64), got.numpy())


def test_config_mirror_validates_like_jax():
    # Same fields, same derived values, same rejections.
    for kw in [dict(n_parties=33, size_l=64, n_dishonest=10),
               dict(n_parties=5, size_l=16, max_accepts_per_round=3)]:
        j, t = JConfig(**kw), config_from_jax_fields(dataclasses.asdict(
            JConfig(**kw)))
        for prop in ("w", "n_qubits", "n_rounds", "max_l", "slots",
                     "n_lieutenants", "total_qubits", "no_decision"):
            assert getattr(j, prop) == getattr(t, prop), prop
    for bad in [dict(strategy="nope"), dict(n_dishonest=9),
                dict(attack_scope="broadcast", strategy="split"),
                dict(p_late=0.5), dict(max_evidence_rows=2)]:
        kw = {"n_parties": 5, "size_l": 16, "n_dishonest": 2, **bad}
        with pytest.raises(ValueError) as ej:
            JConfig(**kw)
        with pytest.raises(ValueError) as et:
            config_from_jax_fields(
                {**dataclasses.asdict(JConfig(n_parties=5, size_l=16)), **kw})
        assert str(ej.value) == str(et.value)


def test_unported_options_raise():
    from qba_tpu_torch import QBAConfig, run_trials

    # The one config value the port accepts but does not run yet.
    cfg = QBAConfig(n_parties=3, size_l=4, n_dishonest=1,
                    qsim_path="stabilizer")
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        run_trials(cfg, device="cpu")
    # Every other engine, the counters and the dense paths run.
    for kw in [dict(round_engine="pallas"), dict(collect_counters=True),
               dict(qsim_path="dense"), dict(qsim_path="dense_pallas")]:
        cfg = QBAConfig(n_parties=3, size_l=4, n_dishonest=1, trials=2, **kw)
        assert run_trials(cfg, device="cpu").trials.decisions.shape == (2, 3)
