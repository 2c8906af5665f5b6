"""The port's statistics equal the JAX package's, number for number.

``qba_tpu_torch.stats`` is a copy of ``qba_tpu.stats``'s host
arithmetic (the port imports nothing of ``qba_tpu``), so every table,
interval, decision and allocation here must be equal, not close: the
stop tables the device loop consults, the estimators and confidence
intervals on a ``(k, n)`` grid, the stopping rules' running state, the
target grammar and the adaptive allocator's schedule.  The atlas
store's content addresses and the slugs the sweep's checkpoint names go
through are held equal too.  Pure numpy and Python: no device, no JAX
program.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from qba_tpu import stats as jst
from qba_tpu.atlas import store as jstore
from qba_tpu.serve import queuefs as jqueuefs
from qba_tpu.stats.device import stop_tables as j_stop_tables
from qba_tpu_torch import stats as pst
from qba_tpu_torch.atlas import store as pstore
from qba_tpu_torch.serve import queuefs as pqueuefs
from qba_tpu_torch.stats.device import stop_tables

SPECS = [
    "decide vs 1/3",
    "decide vs 0.5 @ 99%",
    "decide vs 0.3 +-0.005",
    "decide vs 0.9 +-0.02 @ 90%",
    "ci_width<=0.28",
    "ci_width<=0.04 @ 95%",
    "ci_width<=0.5 @ 80%",
]
KN = [(0, 0), (0, 1), (1, 1), (0, 16), (5, 16), (16, 16), (3, 40),
      (269, 1000), (540, 1000), (999, 1000), (1234, 7000)]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n_chunks,chunk_trials", [(6, 7), (3, 16), (12, 1000)])
def test_stop_tables_equal(spec, n_chunks, chunk_trials):
    lo, hi = stop_tables(pst.parse_target(spec), n_chunks, chunk_trials)
    j_lo, j_hi = j_stop_tables(jst.parse_target(spec), n_chunks, chunk_trials)
    assert lo.dtype == j_lo.dtype == np.int32
    np.testing.assert_array_equal(lo, j_lo)
    np.testing.assert_array_equal(hi, j_hi)


@pytest.mark.parametrize("k,n", KN)
def test_estimators_and_intervals_equal(k, n):
    for method in ("wilson", "clopper_pearson"):
        for conf in (0.9, 0.95, 0.99):
            got = pst.rate_estimate(k, n, method=method, confidence=conf)
            want = jst.rate_estimate(k, n, method=method, confidence=conf)
            assert got.to_json() == want.to_json()
    if n:
        assert pst.wilson_ci(k, n) == jst.wilson_ci(k, n)
        assert pst.clopper_pearson_ci(k, n) == jst.clopper_pearson_ci(k, n)
    assert (np.isnan(pst.success_rate(k, n)) and np.isnan(
        jst.success_rate(k, n))) or pst.success_rate(k, n) == \
        jst.success_rate(k, n)
    mix = pst.MixtureMartingaleCI(confidence=0.95)
    j_mix = jst.MixtureMartingaleCI(confidence=0.95)
    assert mix.interval_at(k, n) == j_mix.interval_at(k, n)
    assert mix.width_at(k, n) == j_mix.width_at(k, n)
    sprt = pst.SPRT(threshold=1 / 3, delta=0.02)
    j_sprt = jst.SPRT(threshold=1 / 3, delta=0.02)
    assert sprt.llr_at(k, n) == j_sprt.llr_at(k, n)


def _stream(rule, counts, chunk):
    out = []
    for k in counts:
        rule.observe(k, chunk)
        dec = rule.decision()
        out.append(None if dec is None else dec.to_json())
    out.append(rule.exhausted().to_json())
    out.append(rule.estimate().to_json())
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_rules_equal_on_a_stream(spec):
    counts = [269, 307, 298, 295, 295, 277, 294, 281]
    got = _stream(pst.parse_target(spec).make_rule(), counts, 1000)
    want = _stream(jst.parse_target(spec).make_rule(), counts, 1000)
    assert got == want


@pytest.mark.parametrize("spec", SPECS)
def test_parse_target_round_trip(spec):
    got, want = pst.parse_target(spec), jst.parse_target(spec)
    assert got.to_json() == want.to_json()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.planning_trials(10**6) == want.planning_trials(10**6)
    assert pst.parse_target(got.to_json()["spec"]).to_json() == got.to_json()


@pytest.mark.parametrize("bad", ["decide vs 1.5", "ci_width<=0", "nope",
                                 "decide vs 1/3 @ 100%"])
def test_parse_target_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as got:
        pst.parse_target(bad)
    with pytest.raises(ValueError) as want:
        jst.parse_target(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["decide vs 0.5 +-0.1", "ci_width<=0.3"])
def test_allocator_schedule_equal(spec):
    # Three cells with fixed rates; the same counts go to both allocators.
    rates = [0.2, 0.5, 0.8]
    rng = np.random.default_rng(7)
    draws = [list(rng.binomial(16, p, size=20)) for p in rates]
    allocs = [mod.AdaptiveAllocator(["a", "b", "c"], mod.parse_target(spec),
                                    budget_chunks=20) for mod in (pst, jst)]
    allocs[0].preload(1, 9, 16)
    allocs[1].preload(1, 9, 16)
    ran = [0, 1, 0]
    while (idx := allocs[0].next_cell()) is not None:
        assert allocs[1].next_cell() == idx
        k = int(draws[idx][ran[idx]])
        ran[idx] += 1
        got, want = (a.record(idx, k, 16) for a in allocs)
        assert (got is None) == (want is None)
    assert allocs[1].next_cell() is None
    for a in allocs:
        a.finish()
    assert allocs[0].summary() == allocs[1].summary()


@pytest.mark.parametrize("rid", ["plain-id_1.2", "a/b", "a_b", "", "x" * 150,
                                 "cell~0123456789", "ünï"])
def test_slugs_and_cell_keys_equal(rid):
    assert pqueuefs.request_slug(rid) == jqueuefs.request_slug(rid)
    fp = {"n_parties": 5, "size_l": 16, "seed": len(rid), "id": rid,
          "trials": 3, "derived": {"w": 8}}
    assert pstore.cell_key(fp) == jstore.cell_key(fp)
    assert pstore.cell_slug(fp) == jstore.cell_slug(fp)
