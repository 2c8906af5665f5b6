"""The port's CUDA kernels against their plain versions, on the card.

Each kernel wrapper launches its hand-written kernel for CUDA tensors.
Here the fused round, the tiled verdict and rebuild, the trial
megakernel and the dense-mailbox round are each held bit-exact against
their plain PyTorch versions on the round state of real trials and on
seeded random inputs (:mod:`qba_tpu_torch.testing`: out-of-range values,
colliding rows, disagreeing lens, own rows already in L, dense accepted
matrices, inconsistent lieutenants), the fused circuit kernel is held
against its plain version at ``atol=1e-6`` on amplitudes (the compiler
may fuse a multiply and an add), and the five engines must agree trial
for trial.  Every test is marked ``cuda`` and skips without a card
(the kernels have no CPU mode; the CPU tests hold the plain versions
against ``qba_tpu``).  The file imports no JAX, so on a machine with the
card it runs without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import qba_tpu_torch
from qba_tpu_torch import random as jr
from qba_tpu_torch.adversary import adversary_ctx, sample_attacks_round
from qba_tpu_torch.backends.torch_backend import trial_keys
from qba_tpu_torch.convert import circuit_ops_from_tuples
from qba_tpu_torch.ops import fused_circuit as fc
from qba_tpu_torch.ops import round_kernel as rs
from qba_tpu_torch.ops import round_kernel_tiled as rk
from qba_tpu_torch.ops.trial_megakernel import (
    trial_megakernel,
    trial_megakernel_reference,
)
from qba_tpu_torch.rounds.engine import _stacked_draws, setup_trial, step3a_one
from qba_tpu_torch.qsim import protocol_circuits as pc
from qba_tpu_torch.testing import (
    dense_acc,
    random_circuit,
    random_mailbox_inputs,
    random_round_inputs,
    random_trial_inputs,
)

CONFIGS = {
    "5p-split": dict(n_parties=5, size_l=16, n_dishonest=2, trials=32,
                     seed=5, strategy="split"),
    "5p-overflow": dict(n_parties=5, size_l=16, n_dishonest=2, trials=32,
                        seed=2, max_accepts_per_round=1),
    "5p-racy": dict(n_parties=5, size_l=16, n_dishonest=1, trials=32, seed=5,
                    delivery="racy", p_late=0.25),
    "11p": dict(n_parties=11, size_l=64, n_dishonest=3, trials=16, seed=1),
}

# Random round inputs: (config, round).
RANDOM = {
    "5p-r1": (dict(n_parties=5, size_l=16, n_dishonest=2), 1),
    "5p-r2": (dict(n_parties=5, size_l=16, n_dishonest=2), 2),
    "5p-split-r1": (dict(n_parties=5, size_l=16, n_dishonest=2,
                         strategy="split"), 1),
    "5p-slots1-r1": (dict(n_parties=5, size_l=16, n_dishonest=2,
                          max_accepts_per_round=1), 1),
    "7p-L8-r3": (dict(n_parties=7, size_l=8, n_dishonest=3), 3),
    "7p-L8-r4": (dict(n_parties=7, size_l=8, n_dishonest=3), 4),
    "11p-L16-r1": (dict(n_parties=11, size_l=16, n_dishonest=3), 1),
    "11p-L64-r1": (dict(n_parties=11, size_l=64, n_dishonest=3), 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def trial_inputs(cfg, dev):
    keys = trial_keys(cfg, dev)
    honest, li, p_rows, v_sent, _v_comm, k_rounds = setup_trial(cfg, keys)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    return honest, li.to(torch.int32).contiguous(), p_rows, v_sent, k_rounds, ctx


def round_states(cfg, dev):
    """Each round's inputs ``(r, pool, li, vi, hc, attack, rand_v,
    late)`` of real trials, advanced by the plain fused round."""
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, dev)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    pool = rk.pool_from_step3a(cfg, out_cells)
    hc = rk.honest_cells(honest, cfg)
    vi = vi.to(torch.int32)
    for r in range(1, cfg.n_rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        yield (r, pool, li, vi, hc, *draws)
        pool, vi, _ovf = rk.fused_round_reference(cfg, r, pool, li, vi, hc,
                                                  *draws)


def assert_equal(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_equal(a, b)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONFIGS))
def test_fused_round_kernel(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[case])
    for r, *args in round_states(cfg, cuda):
        assert_equal(rk.fused_round(cfg, r, *args),
                     rk.fused_round_reference(cfg, r, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONFIGS))
def test_tiled_kernels(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[case])
    for r, pool, li, vi, hc, att, rv, late in round_states(cfg, cuda):
        acc, vi2 = rk.tiled_verdict(cfg, r, pool, li, vi, hc, att, rv, late)
        assert_equal((acc, vi2), rk.verdict_reference(
            cfg, r, pool, li, vi, hc, att, rv, late))
        assert_equal(rk.tiled_rebuild(cfg, r, pool, li, acc, hc, att, rv),
                     rk.rebuild_reference(cfg, r, pool, li, acc, hc, att, rv))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONFIGS))
def test_trial_megakernel(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[case])
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, cuda)
    args = (cfg, p_rows.contiguous(), li, v_sent.to(torch.int32).contiguous(),
            rk.honest_cells(honest, cfg), *_stacked_draws(cfg, k_rounds, ctx))
    before = trial_megakernel.launches
    got = trial_megakernel(*args)
    assert trial_megakernel.launches == before + 1
    assert_equal(got, trial_megakernel_reference(*args))


@pytest.mark.cuda
def test_engines_agree(cuda):
    cfg = qba_tpu_torch.QBAConfig(n_parties=7, size_l=32, n_dishonest=2,
                                  trials=64, seed=8, strategy="adaptive")
    first, *rest = (
        qba_tpu_torch.run_trials(dataclasses.replace(cfg, round_engine=e),
                                 device=cuda).trials
        for e in ("xla", "pallas", "pallas_fused", "pallas_tiled",
                  "pallas_mega"))
    for other in rest:
        for f in ("decisions", "success", "vi", "overflow"):
            assert torch.equal(getattr(first, f), getattr(other, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANDOM))
def test_round_kernels_on_random_inputs(cuda, case):
    kw, r = RANDOM[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    pool, li, vi, hc, att, rv, late = random_round_inputs(
        cfg, r, 32, seed=len(case) + r, device=cuda)
    assert_equal(rk.fused_round(cfg, r, pool, li, vi, hc, att, rv, late),
                 rk.fused_round_reference(cfg, r, pool, li, vi, hc, att, rv,
                                          late))
    acc, vi2 = rk.tiled_verdict(cfg, r, pool, li, vi, hc, att, rv, late)
    assert_equal((acc, vi2), rk.verdict_reference(cfg, r, pool, li, vi, hc,
                                                  att, rv, late))
    assert int(acc.sum()) > 0
    for a in (acc, dense_acc(cfg, pool, seed=r)):
        assert_equal(rk.tiled_rebuild(cfg, r, pool, li, a, hc, att, rv),
                     rk.rebuild_reference(cfg, r, pool, li, a, hc, att, rv))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["5p-split", "5p-overflow", "5p-racy", "11p"])
def test_trial_megakernel_on_random_inputs(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[case])
    args = random_trial_inputs(cfg, 32, seed=3, device=cuda)
    got = trial_megakernel(cfg, *args)
    assert_equal(got, trial_megakernel_reference(cfg, *args))
    ok = step3a_one(cfg, args[0], args[2], args[1])[0].any(-1)
    assert ok.any() and not ok.all()  # step 3a kept some, rejected some


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONFIGS))
def test_round_step_kernel(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[case])
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, cuda)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    mb = rs.mailbox_from_step3a(cfg, out_cells)
    hpk = rs.honest_packets(honest, cfg)
    vi = vi.to(torch.int32)
    for r in range(1, cfg.n_rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        before = rs.round_step.launches
        got = rs.round_step(cfg, r, mb, li, vi, hpk, *draws)
        assert rs.round_step.launches == before + 1
        assert_equal(got, rs.round_step_reference(cfg, r, mb, li, vi, hpk,
                                                  *draws))
        mb, vi, _ovf = got
    with pytest.raises(ValueError, match="aliases"):
        rs.round_step(cfg, 1, mb, li, vi, hpk, *draws, out=mb)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANDOM))
def test_round_step_kernel_on_random_mailboxes(cuda, case):
    kw, r = RANDOM[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    args = random_mailbox_inputs(cfg, r, 32, seed=len(case) + r, device=cuda)
    got = rs.round_step(cfg, r, *args)
    assert_equal(got, rs.round_step_reference(cfg, r, *args))
    assert int(got[1].sum()) > int(args[2].sum())  # something was accepted


CIRCUITS = {
    "q-3p": lambda: pc.gen_q_corr_circuit(3, 2),
    "nq-3p": lambda: pc.gen_nq_corr_circuit(3, 2),
    "q-4p": lambda: pc.gen_q_corr_circuit(4, 3),
    "nq-4p": lambda: pc.gen_nq_corr_circuit(4, 3),
    "q-5p": lambda: pc.gen_q_corr_circuit(5, 3),
    "nq-5p": lambda: pc.gen_nq_corr_circuit(5, 3),
}


def circuit_errs(n_qubits, ops, n_params, cuda, n_runs, seed):
    """Largest amplitude difference between the kernel and its plain
    version on seeded random params, both on the card."""
    tables = fc.circuit_tables(n_qubits, ops, n_params).to(cuda)
    gen = torch.Generator().manual_seed(seed)
    params = torch.randint(0, 2, (n_runs, tables.n_params), generator=gen,
                           dtype=torch.int32).to(cuda)
    before = fc.fused_circuit.launches
    got = fc.fused_circuit(tables, params)
    assert fc.fused_circuit.launches == before + 1
    want = fc.fused_circuit_reference(tables, params)
    assert got.dtype == want.dtype and got.shape == want.shape
    return float((got - want).abs().max()), got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CIRCUITS))
def test_fused_circuit_kernel_on_protocol_circuits(cuda, case):
    circ = CIRCUITS[case]()
    err, got = circuit_errs(circ.n_qubits, circ.ops, circ.n_params, cuda,
                            n_runs=5, seed=3)
    assert got.dtype == torch.float32
    assert err <= 1e-6
    assert torch.allclose((got ** 2).sum(-1), torch.ones(5, device=cuda),
                          atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,seed", [(6, 0), (10, 1), (16, 2)])
def test_fused_circuit_kernel_on_random_circuits(cuda, n_qubits, seed):
    ops = circuit_ops_from_tuples(random_circuit(n_qubits, 40, seed))
    err, got = circuit_errs(n_qubits, ops, 3, cuda, n_runs=4, seed=seed)
    assert got.dtype == torch.complex64
    assert err <= 1e-6


@pytest.mark.cuda
def test_dense_pallas_path_runs_the_circuit_kernel(cuda):
    cfg = qba_tpu_torch.QBAConfig(n_parties=4, size_l=16, n_dishonest=1,
                                  trials=8, seed=3, qsim_path="dense_pallas")
    before = fc.fused_circuit.launches
    fast = qba_tpu_torch.run_trials(cfg, device=cuda).trials
    assert fc.fused_circuit.launches > before
    plain = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, qsim_path="dense"), device=cuda).trials
    for f in ("decisions", "success", "vi", "overflow"):
        assert torch.equal(getattr(fast, f), getattr(plain, f)), f


@pytest.mark.cuda
def test_counters_agree_across_engines(cuda):
    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=32, seed=5, collect_counters=True)
    first, *rest = (
        qba_tpu_torch.run_trials(dataclasses.replace(cfg, round_engine=e),
                                 device=cuda).trials.counters
        for e in ("xla", "pallas", "pallas_fused", "pallas_tiled"))
    for other in rest:
        for f in dataclasses.fields(first):
            assert torch.equal(getattr(first, f.name), getattr(other, f.name))
