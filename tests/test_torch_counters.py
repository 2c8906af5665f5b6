"""The port's protocol counters equal the JAX package's, field by field.

``collect_counters=True`` folds each round's ``vi`` delta and overflow
flag into ``ProtocolCounters`` in the round loop every per-round engine
shares.  For the same keys every field must equal JAX's, on every
per-round engine; the primary outputs must not change; and the trial
megakernel, which has no per-round loop on the host, must give way to
the fused per-round engine with a warning.  Integers: the tolerance is 0.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

import qba_tpu_torch
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu_torch.convert import config_from_jax_fields
from qba_tpu_torch.rounds.engine import (
    ProtocolCounters,
    QBADemotionWarning,
    counters_finish,
    counters_init,
    counters_step,
    resolve_round_engine,
)
from tests.test_torch_draws import jax_run_trials

COUNTER_FIELDS = [f.name for f in dataclasses.fields(ProtocolCounters)]
PRIMARY = ("decisions", "success", "vi", "overflow", "honest", "v_comm")
PER_ROUND = ("xla", "pallas", "pallas_fused", "pallas_tiled")
CASES = {
    "5p": dict(n_parties=5, size_l=16, n_dishonest=2, trials=8, seed=1),
    "5p-overflow": dict(n_parties=5, size_l=16, n_dishonest=2, trials=8,
                        seed=1, max_accepts_per_round=1),
    "5p-split-racy": dict(n_parties=5, size_l=16, n_dishonest=2, trials=8,
                          seed=3, strategy="split", delivery="racy",
                          p_late=0.2),
}


def jax_counters(jcfg):
    res = jax_run_trials(jcfg).trials
    return ({f: np.asarray(getattr(res.counters, f))
             for f in COUNTER_FIELDS},
            {f: np.asarray(getattr(res, f)) for f in PRIMARY})


@pytest.mark.parametrize("case", list(CASES))
def test_counters_match_jax_on_every_per_round_engine(case):
    jcfg = JConfig(collect_counters=True, round_engine="xla", **CASES[case])
    want, want_primary = jax_counters(jcfg)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    for engine in PER_ROUND:
        got = qba_tpu_torch.run_trials(
            dataclasses.replace(cfg, round_engine=engine), device="cpu").trials
        for f in COUNTER_FIELDS:
            x = getattr(got.counters, f)
            assert x.dtype == (torch.bool if f == "overflow_rounds"
                               else torch.int32), (engine, f)
            assert np.array_equal(want[f], x.numpy()), (engine, f)
        for f in PRIMARY:
            assert np.array_equal(want_primary[f], getattr(got, f).numpy())
    assert want["accepts_per_round"].sum() > 0
    assert (want["first_accept_round"] > 0).any()
    if case == "5p-overflow":
        assert want["overflow_rounds"].any()
        assert want["slot_high_water"].max() > 1  # queued past slots=1


def test_counters_match_jax_fused_engine():
    # JAX's own fused engine (interpret mode) carries the same counters.
    jcfg = JConfig(collect_counters=True, round_engine="pallas_fused",
                   n_parties=5, size_l=16, n_dishonest=2, trials=4, seed=1)
    want, _ = jax_counters(jcfg)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    got = qba_tpu_torch.run_trials(cfg, device="cpu").trials.counters
    for f in COUNTER_FIELDS:
        assert np.array_equal(want[f], getattr(got, f).numpy()), f


@pytest.mark.parametrize("engine", PER_ROUND)
def test_primary_outputs_unchanged_by_counters(engine):
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=8, seed=4, round_engine=engine)
    off = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    on = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, collect_counters=True), device="cpu").trials
    assert off.counters is None and on.counters is not None
    for f in PRIMARY:
        assert torch.equal(getattr(off, f), getattr(on, f)), f


def test_megakernel_demotes_to_fused_with_a_warning():
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=4, seed=1, collect_counters=True,
                                  round_engine="pallas_mega")
    with pytest.warns(QBADemotionWarning, match="pallas_mega"):
        assert resolve_round_engine(cfg, torch.device("cpu")) == "pallas_fused"
    with pytest.warns(QBADemotionWarning):
        got = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    want = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine="pallas_fused"),
        device="cpu").trials
    for f in COUNTER_FIELDS:
        assert torch.equal(getattr(got.counters, f), getattr(want.counters, f))


def test_auto_with_counters_resolves_to_fused_on_cuda_without_warning():
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16,
                                  collect_counters=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_round_engine(cfg, torch.device("cuda")) == "pallas_fused"
        assert resolve_round_engine(cfg, torch.device("cpu")) == "xla"
        plain = dataclasses.replace(cfg, collect_counters=False)
        assert resolve_round_engine(plain, torch.device("cuda")) == "pallas_mega"
        mega = dataclasses.replace(plain, round_engine="pallas_mega")
        assert resolve_round_engine(mega, torch.device("cuda")) == "pallas_mega"


def test_counter_folds_by_hand():
    # Two receivers, w = 4, d = 1: step 3a accepts (r0, v1); round 1 adds
    # (r0, v2), (r0, v3), (r1, v1); round 2 adds (r1, v0).
    cfg = qba_tpu_torch.QBAConfig(n_parties=3, size_l=4, n_dishonest=1)
    vi0 = torch.zeros((1, 2, 4), dtype=torch.bool)
    vi0[0, 0, 1] = True
    vi1 = vi0.clone()
    vi1[0, 0, 2] = vi1[0, 0, 3] = vi1[0, 1, 1] = True
    vi2 = vi1.clone()
    vi2[0, 1, 0] = True
    state = counters_init(cfg, vi0)
    state, a1 = counters_step(cfg, state, vi0, vi1, 1)
    state, a2 = counters_step(cfg, state, vi1, vi2, 2)
    c = counters_finish(cfg, state, vi2, torch.stack([a1, a2], -1),
                        torch.tensor([[False, True]]))
    assert c.first_accept_round.tolist() == [[[-1, 0, 1, 1], [2, 1, -1, -1]]]
    assert c.accept_counts.tolist() == [[1, 2, 1, 1]]
    assert c.accepts_per_round.tolist() == [[3, 1]]
    # Round 2 > n_dishonest queues no rebroadcast: the mark stays at 2.
    assert c.slot_high_water.tolist() == [2]
    assert c.overflow_rounds.tolist() == [[False, True]]


def test_stabilizer_path_counters_on_host_lists():
    # Counters need the per-round loop: pallas_mega demotes to the fused
    # engine, which takes host-generated lists (no gen entry).
    from qba_tpu_torch.rounds.engine import resolve_mega_gen

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=6, seed=4, qsim_path="stabilizer",
                                  collect_counters=True)
    mega = dataclasses.replace(cfg, round_engine="pallas_mega")
    assert resolve_mega_gen(mega, torch.device("cuda")) == "host"
    with pytest.warns(QBADemotionWarning, match="pallas_mega"):
        got = qba_tpu_torch.run_trials(mega, device="cpu").trials
    want = qba_tpu_torch.run_trials(cfg, device="cpu").trials
    for f in dataclasses.fields(want.counters):
        assert torch.equal(getattr(got.counters, f.name),
                           getattr(want.counters, f.name)), f.name
    assert torch.equal(got.vi, want.vi)
