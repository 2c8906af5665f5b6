"""The port's CUDA kernels against their plain versions, on the card.

Each kernel wrapper launches its hand-written kernel for CUDA tensors.
Here the fused round, the tiled verdict and rebuild, the trial
megakernel and the dense-mailbox round are each held bit-exact against
their plain PyTorch versions on the round state of real trials and on
seeded random inputs (:mod:`qba_tpu_torch.testing`: out-of-range values,
colliding rows, disagreeing lens, own rows already in L, dense accepted
matrices, inconsistent lieutenants), the fused circuit kernel is held
against its plain version at ``atol=1e-6`` on amplitudes (the compiler
may fuse a multiply and an add), the GF(2) sweep kernel and the trial
megakernel's gen entry are held bit-exact against their plain versions
on the protocol's tableaux and on seeded random Clifford tableaux, the
party-sharded kernels (the ring gather, the ``n_recv`` variants of the
fused round, the tiled verdict and rebuild and the dense-mailbox round,
and the sharded trial megakernel) are held bit-exact against theirs,
and the engines, sharded or not, must agree trial for trial.  The draws
kernel and the megakernels' keyed entries (which hash their own draws)
are held bit-exact against their plain versions, and the keyed entries
against the stacked ones, in every strategy, attack scope and delivery.
The tiled verdict's receiver masks are held against their plain
versions at 33 and 34 parties (the word's high half) and at every
cluster size its launch takes, and ``auto`` at 65 parties, past the
masks, equals the ``xla`` engine trial for trial.  The device surface's
``surface_pick`` and ``surface_fold`` equal their plain versions, and
its graph (a WHILE node over pick, a SWITCH into the chosen cell's
captured chunk, and fold) equals the host surface and the plain loop.
In JAX's legacy threefry mode the draws kernel's and the keyed entries'
legacy instantiations equal their plain versions, and the repo's golden
pins come out exactly on every engine.
The invariant checker's dynamic checks (``qba_tpu_torch.analysis``: the
launch pin, the carry audit and the sync probe) pass on the kernels,
and the measurement harness's last rep (``benchmark.measure_batch``,
chunked or not) equals ``run_trials`` on the same keys.
Every test is marked ``cuda`` and skips without a card
(the kernels have no CPU mode; the CPU tests hold the plain versions
against ``qba_tpu``).  The file imports no JAX, so on a machine with the
card it runs without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import os
import subprocess
import sys

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
from qba_tpu_torch.ops import gf2_sweep as gs
from qba_tpu_torch.ops import trial_megakernel as tm
from qba_tpu_torch.ops.attack_draws import (
    attack_draws,
    attack_draws_reference,
)
from qba_tpu_torch.ops.ring_shuffle import ring_gather, ring_gather_reference
from qba_tpu_torch.ops.trial_megakernel import (
    sharded_trial_megakernel,
    sharded_trial_megakernel_reference,
    trial_megakernel,
    trial_megakernel_gen,
    trial_megakernel_gen_reference,
    trial_megakernel_reference,
)
from qba_tpu_torch.rounds.engine import (
    _mega_gen_setup,
    setup_trial,
    step3a_one,
)
from qba_tpu_torch.qsim import protocol_circuits as pc
from qba_tpu_torch.testing import (
    dense_acc,
    random_circuit,
    random_mailbox_inputs,
    random_round_inputs,
    random_shard_inputs,
    random_shard_mailbox_inputs,
    random_sweep_inputs,
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
            rk.honest_cells(honest, cfg),
            *attack_draws(cfg, k_rounds.contiguous(), ctx))
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
    assert bool(acc.any())
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
@pytest.mark.parametrize("tp", [1, 2])
def test_trial_megakernel_lists_past_int8(cuda, tp):
    # The megakernel keeps the lists as bytes in shared memory.  A value
    # past int8 (here x + 256, whose low byte is x) must match no row and
    # count as out of range, as in the plain version: such receivers take
    # the kernel's check in global memory.  The values sit off the
    # lieutenant's own P, so step 3a still accepts it.
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS["5p-split"])
    p_rows, li, v_sent, hc, *draws = random_trial_inputs(cfg, 32, seed=9,
                                                         device=cuda)
    li = li.clone()
    off_p = ~p_rows
    off_p[:, 1::2] = False
    off_p[:, :, ::2] = False
    li[off_p] += 256
    args = (p_rows, li, v_sent, hc, *draws)
    want = trial_megakernel_reference(cfg, *args)
    got = (trial_megakernel(cfg, *args) if tp == 1
           else sharded_trial_megakernel(cfg, tp, *args))
    assert_equal(got, want)
    # The lists changed the trials: the plain version on the low bytes
    # differs.
    low = li.to(torch.int8).to(torch.int32)
    assert not torch.equal(trial_megakernel_reference(
        cfg, p_rows, low, v_sent, hc, *draws)[0], want[0])


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
@pytest.mark.parametrize("n_qubits,seed", [(6, 0), (10, 1), (16, 2), (17, 3)])
def test_fused_circuit_kernel_on_random_circuits(cuda, n_qubits, seed):
    ops = circuit_ops_from_tuples(random_circuit(n_qubits, 40, seed))
    err, got = circuit_errs(n_qubits, ops, 3, cuda, n_runs=4, seed=seed)
    assert got.dtype == torch.complex64
    assert err <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,route", [(15, "block"), (16, "cluster"),
                                            (18, "cluster"), (19, "cluster"),
                                            (20, "global")])
def test_fused_circuit_kernel_on_each_route(cuda, n_qubits, route):
    ops = circuit_ops_from_tuples(random_circuit(n_qubits, 40, n_qubits,
                                                 real=True))
    assert fc.circuit_tables(n_qubits, ops, 3).route[0] == route
    err, got = circuit_errs(n_qubits, ops, 3, cuda, n_runs=3, seed=n_qubits)
    assert got.dtype == torch.float32
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


# The stabilizer resource path: (parties, trials, noise).  The sweep
# kernel keeps the families' maps in shared memory at 11p and 33p.
SWEEPS = {
    "11p": (11, 8, False),
    "11p-noisy": (11, 8, True),
    "33p": (33, 4, False),
    "33p-noisy": (33, 4, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SWEEPS))
def test_gf2_sweep_kernel_on_protocol_tableaux(cuda, case):
    n, trials, noisy = SWEEPS[case]
    cfg = qba_tpu_torch.QBAConfig(
        n_parties=n, size_l=64, p_depolarize=0.05 * noisy,
        p_measure_flip=0.02 * noisy)
    assert gs.tables_in_shared(pc.stabilizer_sweep_tables(cfg))
    keys = jr.split(jr.key(n, device=cuda), trials)
    ops = pc.stabilizer_gen_operands(cfg, keys)
    tables = pc.stabilizer_gen_tables(cfg, cuda)
    before = gs.gf2_sweep.launches
    got = pc.stabilizer_bits(cfg, tables, ops)
    assert gs.gf2_sweep.launches == before + 1
    assert_equal(got, pc.stabilizer_bits(cfg, tables, ops,
                                         sweep=gs.gf2_sweep_reference))


@pytest.mark.cuda
@pytest.mark.parametrize("n_qubits,in_shared", [(13, True), (40, True),
                                                (70, True), (100, True),
                                                (400, False)])
def test_gf2_sweep_kernel_on_random_tableaux(cuda, n_qubits, in_shared):
    args = random_sweep_inputs(n_qubits, 96, seed=n_qubits, device=cuda)
    xw, zw, r, coins, family, mflip = args
    tables = gs.sweep_tables(n_qubits, xw, zw).to(cuda)
    assert gs.tables_in_shared(tables) == in_shared
    work = {}
    want = gs.gf2_sweep_reference(n_qubits, *args, work=work)
    assert work["random_steps"] and work["det_steps"] and work["late_pivots"]
    assert_equal(gs.gf2_sweep(n_qubits, *args), want)
    assert_equal(gs.gf2_sweep(n_qubits, *args, tables=tables), want)
    # One family, no readout flips.
    assert_equal(gs.gf2_sweep(n_qubits, xw[:1], zw[:1], r, coins),
                 gs.gf2_sweep_reference(n_qubits, xw[:1], zw[:1], r, coins))
    # A family past the tableaux stops the kernel at its device-side
    # assert (in a process of its own: the assert ends the CUDA context).
    code = (
        "import torch; from qba_tpu_torch.ops import gf2_sweep as gs; "
        "from qba_tpu_torch.testing import random_sweep_inputs; "
        f"xw, zw, r, c, f, m = random_sweep_inputs({n_qubits}, 96, "
        f"seed={n_qubits}, device='cuda'); "
        "gs.gf2_sweep(xw.shape[1] // 2, xw[:1], zw[:1], r, c, f); "
        "torch.cuda.synchronize()")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=300)
    assert run.returncode != 0 and "assert" in run.stderr.lower()


def gen_inputs(cfg, dev):
    keys = trial_keys(cfg, dev)
    honest, gen_ops, v_sent, _v_comm, k_rounds = _mega_gen_setup(cfg, keys)
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    return (cfg, pc.stabilizer_gen_tables(cfg, dev), gen_ops,
            v_sent.to(torch.int32).contiguous(), rk.honest_cells(honest, cfg),
            *attack_draws(cfg, k_rounds.contiguous(), ctx))


GEN_CASES = {
    "11p-split-noisy": dict(n_parties=11, n_dishonest=3, strategy="split",
                            p_depolarize=0.02, p_measure_flip=0.01),
    "33p": dict(n_parties=33, n_dishonest=10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GEN_CASES))
def test_gen_megakernel(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(size_l=64, trials=32, seed=2,
                                  qsim_path="stabilizer", **GEN_CASES[case])
    args = gen_inputs(cfg, cuda)
    before = trial_megakernel_gen.launches
    got = trial_megakernel_gen(*args)
    assert trial_megakernel_gen.launches == before + 1
    assert_equal(got, trial_megakernel_gen_reference(*args))


@pytest.mark.cuda
def test_gen_and_host_engines_agree(cuda):
    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                  trials=64, seed=6, qsim_path="stabilizer")
    # The engines launch the keyed megakernels, which hash their draws;
    # the fused engine draws with the draws kernel, a launch a round.
    counts = (tm.trial_megakernel_gen_keyed, tm.trial_megakernel_keyed,
              gs.gf2_sweep, attack_draws)
    runs = {}
    for name, kw, launches in [
            ("gen", {}, (1, 0, 0, 0)),
            ("host", dict(mega_gen="host"), (0, 1, 1, 0)),
            ("fused", dict(round_engine="pallas_fused"),
             (0, 0, 1, cfg.n_rounds))]:
        before = [fn.launches for fn in counts]
        runs[name] = qba_tpu_torch.run_trials(
            dataclasses.replace(cfg, **kw), device=cuda).trials
        assert tuple(fn.launches - b for fn, b in zip(counts, before)) == \
            launches, name
    for other in ("host", "fused"):
        for f in ("decisions", "success", "vi", "overflow"):
            assert torch.equal(getattr(runs["gen"], f),
                               getattr(runs[other], f)), (other, f)


# Party-sharded cases: (config, tp).
SHARDED = {
    "5p-split-tp2": ("5p-split", 2),
    "5p-overflow-tp4": ("5p-overflow", 4),
    "5p-racy-tp2": ("5p-racy", 2),
    "11p-tp2": ("11p", 2),
    "11p-tp5": ("11p", 5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.bool,
                                   torch.uint8, torch.int64])
def test_ring_gather_kernel(cuda, tp, dtype):
    from qba_tpu_torch.parallel.ring import all_gather

    gen = torch.Generator().manual_seed(tp)
    # Ragged tiles: segments of 1 B, of 4 B and across several 16 KB tiles.
    for shard, axis in [((3, 5, 7), 1), ((2, 9000), 1), ((12, 40, 64), 1),
                        ((4, 2, 3, 8), 2), ((6,), 0)]:
        x = torch.randint(-100, 100, (tp,) + shard, generator=gen)
        x = (x > 0) if dtype == torch.bool else x.to(dtype)
        x = x.to(cuda)
        before = ring_gather.launches
        got = ring_gather(x, axis)
        assert ring_gather.launches == before + 1
        assert_equal(got, ring_gather_reference(x, axis))
        assert_equal(got, all_gather(x, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["5p-r1", "5p-split-r1", "5p-slots1-r1",
                                  "7p-L8-r3", "11p-L16-r1"])
def test_fused_round_n_recv_on_random_shards(cuda, case):
    kw, r = RANDOM[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    for tp in (t for t in (2, 3, 5) if cfg.n_lieutenants % t == 0):
        args = random_shard_inputs(cfg, tp, r, 16, seed=tp + r, device=cuda)
        n_local = cfg.n_lieutenants // tp
        got = rk.fused_round(cfg, r, *args, n_recv=n_local)
        assert_equal(got, rk.fused_round_reference(cfg, r, *args,
                                                   n_recv=n_local))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED))
def test_fused_round_n_recv_kernel(cuda, case):
    # On protocol state: each shard against the whole pool, whose accepted
    # sets must be the single-device round's.
    name, tp = SHARDED[case]
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[name])
    n_local = cfg.n_lieutenants // tp
    for r, pool, li, vi, hc, *draws in round_states(cfg, cuda):
        shards = (tuple(x.expand((tp,) + x.shape).contiguous() for x in pool),
                  rk.shard_receivers(li, tp), rk.shard_receivers(vi, tp), hc,
                  *draws)
        got = rk.fused_round(cfg, r, *shards, n_recv=n_local)
        assert_equal(got, rk.fused_round_reference(cfg, r, *shards,
                                                   n_recv=n_local))
        _pool, vi_one, ovf_one = rk.fused_round(cfg, r, pool, li, vi, hc,
                                                *draws)
        assert torch.equal(rk.unshard_receivers(got[1]), vi_one)
        assert torch.equal(got[2].any(0), ovf_one)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["5p-r1", "5p-split-r1", "5p-slots1-r1",
                                  "7p-L8-r3", "11p-L16-r1"])
def test_tiled_and_round_step_n_recv_on_random_shards(cuda, case):
    kw, r = RANDOM[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    for tp in (t for t in (2, 3, 5) if cfg.n_lieutenants % t == 0):
        n_local = cfg.n_lieutenants // tp
        pool, li, vi, hc, att, rv, late = random_shard_inputs(
            cfg, tp, r, 16, seed=tp + r, device=cuda)
        acc, vi2 = rk.tiled_verdict(cfg, r, pool, li, vi, hc, att, rv, late,
                                    n_recv=n_local)
        assert_equal((acc, vi2), rk.verdict_reference(
            cfg, r, pool, li, vi, hc, att, rv, late, n_recv=n_local))
        dense = torch.stack([dense_acc(cfg, tuple(x[s] for x in pool),
                                       seed=s, n_local=n_local)
                             for s in range(tp)])
        for a in (acc, dense):
            assert_equal(
                rk.tiled_rebuild(cfg, r, pool, li, a, hc, att, rv,
                                 n_recv=n_local),
                rk.rebuild_reference(cfg, r, pool, li, a, hc, att, rv,
                                     n_recv=n_local))
        args = random_shard_mailbox_inputs(cfg, tp, r, 16, seed=tp + r,
                                           device=cuda)
        assert_equal(launched_round_step(cfg, r, args, n_local),
                     rs.round_step_reference(cfg, r, *args, n_recv=n_local))


def launched_round_step(cfg, r, args, n_local):
    """``round_step``'s n_recv variant, asserted to launch its kernel
    once."""
    before = rs.round_step.launches
    got = rs.round_step(cfg, r, *args, n_recv=n_local)
    assert rs.round_step.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED))
def test_tiled_n_recv_kernels(cuda, case):
    # On protocol state: each shard against the whole pool; its accepted
    # masks are its receivers' bits of the single-device ones, and its
    # segments are the fused n_recv round's.
    name, tp = SHARDED[case]
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[name])
    n_local = cfg.n_lieutenants // tp
    for r, pool, li, vi, hc, *draws in round_states(cfg, cuda):
        shards = (tuple(x.expand((tp,) + x.shape).contiguous() for x in pool),
                  rk.shard_receivers(li, tp), rk.shard_receivers(vi, tp), hc)
        acc, vi2 = rk.tiled_verdict(cfg, r, *shards, *draws, n_recv=n_local)
        assert_equal((acc, vi2), rk.verdict_reference(
            cfg, r, *shards, *draws, n_recv=n_local))
        acc_one, vi_one = rk.tiled_verdict(cfg, r, pool, li, vi, hc, *draws)
        assert torch.equal(rk.join_acc_shards(acc, n_local), acc_one)
        assert torch.equal(rk.unshard_receivers(vi2), vi_one)
        got = rk.tiled_rebuild(cfg, r, shards[0], shards[1], acc, hc,
                               *draws[:2], n_recv=n_local)
        assert_equal(got, rk.rebuild_reference(
            cfg, r, shards[0], shards[1], acc, hc, *draws[:2],
            n_recv=n_local))
        fused = rk.fused_round(cfg, r, *shards, *draws, n_recv=n_local)
        assert_equal(got, (fused[0], fused[2]))


# The masks' halves: 33 parties fill the low word's 32 bits, 34 parties
# reach the high word (bit 32); at tp = 3, 34 parties' shards of 11.
TILED_WIDE = {
    "33p": (dict(n_parties=33, size_l=64, n_dishonest=10), (1, 4)),
    "34p": (dict(n_parties=34, size_l=16, n_dishonest=2), (1, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILED_WIDE))
def test_tiled_masks_wide(cuda, case):
    # The verdict's one mask a packet and the rebuild reading it at the
    # widths the masks hold, on protocol state and on random inputs,
    # single-device and n_recv: bit-exact against the plain versions.
    kw, tps = TILED_WIDE[case]
    cfg = qba_tpu_torch.QBAConfig(**kw, trials=8, seed=11)
    high = False
    for r, pool, li, vi, hc, *draws in round_states(cfg, cuda):
        acc_one, vi_one = rk.tiled_verdict(cfg, r, pool, li, vi, hc, *draws)
        for tp in tps:
            n_local = cfg.n_lieutenants // tp
            if tp == 1:
                args, kw_sh = (pool, li, vi, hc), {}
            else:
                args = (copies(pool, tp), rk.shard_receivers(li, tp),
                        rk.shard_receivers(vi, tp), hc)
                kw_sh = dict(n_recv=n_local)
            acc, vi2 = rk.tiled_verdict(cfg, r, *args, *draws, **kw_sh)
            assert acc.dtype == torch.int64
            assert_equal((acc, vi2), rk.verdict_reference(
                cfg, r, *args, *draws, **kw_sh))
            assert torch.equal(acc if tp == 1 else
                               rk.join_acc_shards(acc, n_local), acc_one)
            assert_equal(
                rk.tiled_rebuild(cfg, r, *args[:2], acc, hc, *draws[:2],
                                 **kw_sh),
                rk.rebuild_reference(cfg, r, *args[:2], acc, hc, *draws[:2],
                                     **kw_sh))
        high |= bool((acc_one >> 32).any())
        if r == 3:
            break
    args = random_round_inputs(cfg, 1, 16, seed=34, device=cuda)
    acc, vi2 = rk.tiled_verdict(cfg, 1, *args)
    assert_equal((acc, vi2), rk.verdict_reference(cfg, 1, *args))
    dense = dense_acc(cfg, args[0], seed=34)
    for a in (acc, dense):
        assert_equal(rk.tiled_rebuild(cfg, 1, *args[:2], a, args[3],
                                      *args[4:6]),
                     rk.rebuild_reference(cfg, 1, *args[:2], a, args[3],
                                          *args[4:6]))
    if cfg.n_lieutenants > 32:
        assert high or bool((acc >> 32).any())


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [1, 2])
@pytest.mark.parametrize("case", ["5p-r1", "7p-L8-r3", "11p-L64-r1"])
def test_tiled_verdict_cluster_sizes(cuda, case, ranks, monkeypatch):
    # Both cluster sizes the verdict's launch takes (verdict_ranks: one
    # block or two), on random inputs, single-device and n_recv: the same
    # masks and vi.
    kw, r = RANDOM[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    monkeypatch.setattr(rk, "verdict_ranks", lambda cfg, n_local: ranks)
    args = random_round_inputs(cfg, r, 24, seed=ranks + r, device=cuda)
    got = rk.tiled_verdict(cfg, r, *args)
    assert_equal(got, rk.verdict_reference(cfg, r, *args))
    assert bool(got[0].any())
    tp = 2
    n_local = cfg.n_lieutenants // tp
    sargs = random_shard_inputs(cfg, tp, r, 16, seed=ranks, device=cuda)
    assert_equal(rk.tiled_verdict(cfg, r, *sargs, n_recv=n_local),
                 rk.verdict_reference(cfg, r, *sargs, n_recv=n_local))


@pytest.mark.cuda
def test_auto_past_the_masks_equals_xla(cuda):
    # 65 parties (w = 128): auto demotes to the xla engine on the card,
    # with a recorded demotion, and equals it trial for trial.
    from qba_tpu_torch.diagnostics import QBADemotionWarning

    cfg = qba_tpu_torch.QBAConfig(n_parties=65, size_l=8, n_dishonest=1,
                                  trials=8, seed=65)
    with pytest.warns(QBADemotionWarning, match="64-bit masks"):
        got = qba_tpu_torch.run_trials(cfg, device=cuda).trials
    want = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine="xla"), device=cuda).trials
    for f in ("decisions", "success", "vi", "overflow", "honest", "v_comm"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED))
def test_round_step_n_recv_kernel(cuda, case):
    # On protocol state: each shard against the whole mailbox; the local
    # mailboxes in shard order are the single-device round's mailbox.
    name, tp = SHARDED[case]
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[name])
    n_local = cfg.n_lieutenants // tp
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, cuda)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    mb = rs.mailbox_from_step3a(cfg, out_cells)
    hpk = rs.honest_packets(honest, cfg)
    vi = vi.to(torch.int32)
    for r in range(1, cfg.n_rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        args = (tuple(x.expand((tp,) + x.shape).contiguous() for x in mb),
                rk.shard_receivers(li, tp), rk.shard_receivers(vi, tp), hpk,
                *draws)
        got = launched_round_step(cfg, r, args, n_local)
        assert_equal(got, rs.round_step_reference(cfg, r, *args,
                                                  n_recv=n_local))
        mb, vi, ovf = rs.round_step(cfg, r, mb, li, vi, hpk, *draws)
        for a, b in zip(got[0], mb):
            assert torch.equal(torch.cat(list(a), dim=1), b)
        assert torch.equal(rk.unshard_receivers(got[1]), vi)
        assert torch.equal(got[2].any(0), ovf)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARDED))
def test_sharded_trial_megakernel(cuda, case):
    name, tp = SHARDED[case]
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS[name])
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, cuda)
    args = (p_rows.contiguous(), li, v_sent.to(torch.int32).contiguous(),
            rk.honest_cells(honest, cfg),
            *attack_draws(cfg, k_rounds.contiguous(), ctx))
    before = sharded_trial_megakernel.launches
    got = sharded_trial_megakernel(cfg, tp, *args)
    assert sharded_trial_megakernel.launches == before + 1
    assert_equal(got, sharded_trial_megakernel_reference(cfg, tp, *args))
    assert_equal(got, trial_megakernel(cfg, *args))
    if name == "5p-overflow":
        assert got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_trial_megakernel_on_random_inputs(cuda, tp):
    cfg = qba_tpu_torch.QBAConfig(**CONFIGS["5p-split"])
    args = random_trial_inputs(cfg, 32, seed=tp, device=cuda)
    got = sharded_trial_megakernel(cfg, tp, *args)
    assert_equal(got, sharded_trial_megakernel_reference(cfg, tp, *args))
    assert_equal(got, trial_megakernel(cfg, *args))


@pytest.mark.cuda
def test_spmd_engines_on_one_card(cuda):
    from qba_tpu_torch.parallel import make_mesh, run_trials_spmd

    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=32, seed=9)
    ref = qba_tpu_torch.run_trials(cfg, device=cuda).trials
    mesh = make_mesh({"dp": 2, "tp": 4}, devices=[cuda] * 8)
    fns = (tm.sharded_trial_megakernel_keyed, ring_gather, rk.fused_round,
           rk.tiled_verdict, rk.tiled_rebuild, rs.round_step, attack_draws)
    for kw, counts in [({}, (1, 0, 0, 0, 0, 0, 0)),
                       (dict(round_engine="pallas_fused"),
                        (0, 4, 1, 0, 0, 0, 1)),
                       (dict(round_engine="pallas_fused",
                             tp_comms="all_gather"), (0, 0, 1, 0, 0, 0, 1)),
                       (dict(round_engine="pallas_tiled"),
                        (0, 4, 0, 1, 1, 0, 1)),
                       (dict(round_engine="pallas_tiled",
                             tp_comms="all_gather"), (0, 0, 0, 1, 1, 0, 1)),
                       (dict(round_engine="pallas"), (0, 4, 0, 0, 0, 1, 1)),
                       (dict(round_engine="pallas", tp_comms="all_gather"),
                        (0, 0, 0, 0, 0, 1, 1)),
                       (dict(round_engine="xla"), (0, 6, 0, 0, 0, 0, 0))]:
        before = [fn.launches for fn in fns]
        out = run_trials_spmd(dataclasses.replace(cfg, **kw), mesh).trials
        # Per dp row: one keyed megakernel launch, or per round one ring
        # launch per pool leaf (or mailbox field), the round's kernels and
        # one draws launch (the xla engine draws in plain PyTorch).
        want = tuple(2 * (c if i == 0 else c * cfg.n_rounds)
                     for i, c in enumerate(counts))
        assert tuple(fn.launches - b for fn, b in zip(fns, before)) == want
        for f in ("decisions", "success", "vi", "overflow"):
            assert torch.equal(getattr(ref, f), getattr(out, f)), (kw, f)


# Every strategy, attack scope and delivery of the draws.
DRAW_COMBOS = {
    f"{law}-{delivery}": dict(kw, **(dict(delivery="racy", p_late=0.25)
                                     if delivery == "racy" else {}))
    for law, kw in (("reference", {}), ("collude", dict(strategy="collude")),
                    ("adaptive", dict(strategy="adaptive")),
                    ("split", dict(strategy="split")),
                    ("broadcast", dict(attack_scope="broadcast")))
    for delivery in ("sync", "racy")}


def keyed_inputs_of(cfg, dev):
    """The keyed megakernels' body inputs, rounds keys and context."""
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, dev)
    body = (p_rows.contiguous(), li, v_sent.to(torch.int32).contiguous(),
            rk.honest_cells(honest, cfg))
    return body, k_rounds.contiguous(), ctx


@pytest.mark.cuda
@pytest.mark.parametrize("combo", list(DRAW_COMBOS))
def test_attack_draws_kernel(cuda, combo):
    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=16, n_dishonest=3,
                                  trials=16, seed=8, **DRAW_COMBOS[combo])
    _body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    before = attack_draws.launches
    got = attack_draws(cfg, k_rounds, ctx)
    assert attack_draws.launches == before + 1
    assert_equal(got, attack_draws_reference(cfg, k_rounds, ctx))
    assert_equal(attack_draws(cfg, k_rounds, ctx, 3, 1),
                 attack_draws_reference(cfg, k_rounds, ctx, 3, 1))
    with pytest.raises(ValueError, match="contiguous"):
        attack_draws(cfg, k_rounds.t().contiguous().t(), ctx)


# Past 32 receivers the broadcast scan carries from one warp-wide step of
# 32 receivers to the next (41p: 40 lieutenants; 65p: 64).
WIDE = {f"{n}p-{d}": (n, DRAW_COMBOS[f"broadcast-{d}"])
        for n in (41, 65) for d in ("sync", "racy")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE))
def test_attack_draws_kernel_wide(cuda, case):
    n, kw = WIDE[case]
    cfg = qba_tpu_torch.QBAConfig(n_parties=n, size_l=16, n_dishonest=n // 3,
                                  trials=8, seed=10, **kw)
    _body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    assert_equal(attack_draws(cfg, k_rounds, ctx),
                 attack_draws_reference(cfg, k_rounds, ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["41p-sync", "41p-racy"])
def test_keyed_megakernel_wide(cuda, case):
    n, kw = WIDE[case]
    cfg = qba_tpu_torch.QBAConfig(n_parties=n, size_l=16, n_dishonest=n // 3,
                                  trials=8, seed=10, **kw)
    body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    got = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    assert_equal(got, tm.trial_megakernel_keyed_reference(cfg, *body,
                                                          k_rounds, ctx))
    assert_equal(got, tm.trial_megakernel(cfg, *body,
                                          *attack_draws(cfg, k_rounds, ctx)))
    for tp in (2, 4):
        assert_equal(got, tm.sharded_trial_megakernel_keyed(
            cfg, tp, *body, k_rounds, ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("combo", list(DRAW_COMBOS))
def test_keyed_megakernels(cuda, combo):
    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=32, seed=9, **DRAW_COMBOS[combo])
    body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    stacks = attack_draws(cfg, k_rounds, ctx)
    want = tm.trial_megakernel_keyed_reference(cfg, *body, k_rounds, ctx)
    before = tm.trial_megakernel_keyed.launches
    got = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    assert tm.trial_megakernel_keyed.launches == before + 1
    assert_equal(got, want)
    assert_equal(got, tm.trial_megakernel(cfg, *body, *stacks))
    for tp in (2, 4):
        sharded = tm.sharded_trial_megakernel_keyed(cfg, tp, *body, k_rounds,
                                                    ctx)
        assert_equal(sharded, want)
        assert_equal(sharded, tm.sharded_trial_megakernel_keyed_reference(
            cfg, tp, *body, k_rounds, ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("combo", ["reference-sync", "adaptive-racy",
                                   "broadcast-racy", "split-sync"])
def test_keyed_gen_megakernel(cuda, combo):
    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                  trials=16, seed=10,
                                  qsim_path="stabilizer",
                                  **DRAW_COMBOS[combo])
    keys = trial_keys(cfg, cuda)
    honest, gen_ops, v_sent, _vc, k_rounds = _mega_gen_setup(cfg, keys)
    k_rounds = k_rounds.contiguous()
    ctx = adversary_ctx(cfg, k_rounds, v_sent)
    args = (cfg, pc.stabilizer_gen_tables(cfg, cuda), gen_ops,
            v_sent.to(torch.int32).contiguous(), rk.honest_cells(honest, cfg))
    got = tm.trial_megakernel_gen_keyed(*args, k_rounds, ctx)
    assert_equal(got, tm.trial_megakernel_gen_keyed_reference(
        *args, k_rounds, ctx))
    assert_equal(got, tm.trial_megakernel_gen(
        *args, *attack_draws(cfg, k_rounds, ctx)))


@pytest.mark.cuda
def test_auto_draws_in_the_megakernel(cuda):
    # auto launches the keyed megakernel and no draws kernel; the fused
    # engine one draws launch a round; the results agree.
    cfg = qba_tpu_torch.QBAConfig(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=200, seed=3)
    before = (tm.trial_megakernel_keyed.launches, attack_draws.launches)
    res = qba_tpu_torch.run_trials(cfg).trials
    assert (tm.trial_megakernel_keyed.launches, attack_draws.launches) == (
        before[0] + 1, before[1])
    fused = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine="pallas_fused")).trials
    assert attack_draws.launches == before[1] + cfg.n_rounds
    for f in ("decisions", "vi", "overflow"):
        assert torch.equal(getattr(res, f), getattr(fused, f))


# Edges of the keyed megakernels' layout and lane mapping: rows of 8 and
# 10 positions (10 leaves a partial last word of four), an evidence
# bound past the rounds' (entries whose rows the trial never fills; the
# protocol's own rounds stage at most max_l - 1 rows, and their appended
# verdicts fill L to max_l), 41 parties (a second pass of receivers past
# 32), one slot a round (overflow) and 512 positions at 33 parties (the
# unstaged layout).
EDGES = {
    "9p-L8": dict(n_parties=9, size_l=8, n_dishonest=3),
    "9p-L10": dict(n_parties=9, size_l=10, n_dishonest=3),
    "9p-L10-rows": dict(n_parties=9, size_l=10, n_dishonest=3,
                        max_evidence_rows=8),
    "41p-L64": dict(n_parties=41, size_l=64, n_dishonest=13),
    "11p-slots1": dict(n_parties=11, size_l=64, n_dishonest=3,
                       max_accepts_per_round=1),
    # Entries too large for the warps' buffers: read where they lie.
    "33p-L512": dict(n_parties=33, size_l=512, n_dishonest=10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGES))
def test_keyed_megakernel_edges(cuda, case):
    cfg = qba_tpu_torch.QBAConfig(**EDGES[case], trials=32, seed=12)
    body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    want = tm.trial_megakernel_keyed_reference(cfg, *body, k_rounds, ctx)
    assert_equal(tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx), want)
    for tp in (2, 4):
        if cfg.n_lieutenants % tp == 0:
            assert_equal(tm.sharded_trial_megakernel_keyed(
                cfg, tp, *body, k_rounds, ctx), want)
    if case == "11p-slots1":
        assert want[2].any()
    assert tm.mega_staged(cfg) == (case != "33p-L512")


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_keyed_megakernel_without_live_packets(cuda, tp):
    # In the odd trials every lieutenant's P holds its own order at
    # position 0, so step 3a rejects them all and no round has a live
    # packet; the even trials run as usual.
    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=32, seed=4)
    (p_rows, li, v_sent, hc), k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    p_rows, li = p_rows.clone(), li.clone()
    li[1::2, :, 0] = v_sent[1::2]
    p_rows[1::2, :, 0] = True
    body = (p_rows, li, v_sent, hc)
    want = tm.trial_megakernel_keyed_reference(cfg, *body, k_rounds, ctx)
    assert not want[0][1::2].any() and want[0][0::2].any()
    got = (tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx) if tp == 1
           else tm.sharded_trial_megakernel_keyed(cfg, tp, *body, k_rounds,
                                                  ctx))
    assert_equal(got, want)


@pytest.mark.cuda
def test_phase_clock(cuda):
    # The clocked instantiation gives the same trials and fills the clock:
    # every block spends cycles on entry, the verdicts some, the gen
    # prologue (a host-gen entry) none.
    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=16, seed=6)
    body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
    want = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
    for tp in (1, 2):
        clock = tm.phase_clock(cfg.trials, tp, cuda)
        got = (tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx,
                                         clock=clock) if tp == 1 else
               tm.sharded_trial_megakernel_keyed(cfg, tp, *body, k_rounds,
                                                 ctx, clock=clock))
        assert_equal(got, want)
        phases = dict(zip(tm.MEGA_PHASES, clock.unbind(-1)))
        assert (phases["entry"] > 0).all() and phases["verdict"].any()
        assert not phases["gen"].any()
        assert phases["exchange"].any() == (tp > 1)


# Edges of the per-round kernels' verdict (rows 1, 2 and 4, which share
# it): rows of 8 and 10 positions (10 leaves a partial last word, and
# neither is staged with 16-byte copies), 41 parties (a second pass of
# receivers past 32), 33 parties (w = 64, the masks' edge), one slot a
# round (overflow), lists holding values past int8 (x + 256 at the odd
# receivers' even positions: they match no row and are out of range, as in
# the plain version), rounds without a live packet (the odd trials'
# pools and mailboxes emptied) and 1024 positions at 33 parties (one
# packet buffer a warp).
VERDICT_EDGES = {
    "9p-L8": (dict(n_parties=9, size_l=8, n_dishonest=3), None),
    "9p-L10": (dict(n_parties=9, size_l=10, n_dishonest=3), None),
    "41p-L64": (dict(n_parties=41, size_l=64, n_dishonest=13), None),
    "33p-L64": (dict(n_parties=33, size_l=64, n_dishonest=10), None),
    "11p-slots1": (dict(n_parties=11, size_l=64, n_dishonest=3,
                        max_accepts_per_round=1), None),
    "9p-int8": (dict(n_parties=9, size_l=16, n_dishonest=3), "int8"),
    "9p-empty": (dict(n_parties=9, size_l=16, n_dishonest=3), "empty"),
    # One packet buffer a warp: two do not fit the block's shared memory.
    "33p-L1024": (dict(n_parties=33, size_l=1024, n_dishonest=10), None),
}
VERDICT_CASES = [(c, tp) for c, (kw, _m) in VERDICT_EDGES.items()
                 for tp in (1, 2, 4) if (kw["n_parties"] - 1) % tp == 0]


def protocol_rounds(cfg, dev, mutate=None):
    """Each round's ``(r, pool, mailbox, li, vi, hc, draws)`` of real
    trials, the pool advanced by the plain fused round and the mailbox by
    the plain dense-mailbox round; ``mutate`` as in VERDICT_EDGES."""
    honest, li, p_rows, v_sent, k_rounds, ctx = trial_inputs(cfg, dev)
    vi, out_cells = step3a_one(cfg, p_rows, v_sent, li)
    pool = rk.pool_from_step3a(cfg, out_cells)
    mbox = rs.mailbox_from_step3a(cfg, out_cells)
    hc = rk.honest_cells(honest, cfg)
    vi = vi.to(torch.int32)
    if mutate == "int8":
        li = li.clone()
        li[:, 1::2, ::2] += 256
    for r in range(1, cfg.n_rounds + 1):
        draws = tuple(x.to(torch.uint8) for x in sample_attacks_round(
            cfg, jr.fold_in(k_rounds, r), r, ctx))
        if mutate == "empty":
            for x in (pool[3], mbox[3]):
                x[1::2, :, rk.META_SENT] = 0
        yield r, pool, mbox, li, vi, hc, draws
        pool, vi, _ovf = rk.fused_round_reference(cfg, r, pool, li, vi, hc,
                                                  *draws)
        mbox = rs.round_step_reference(cfg, r, mbox, li, vi, hc, *draws)[0]


def copies(x, tp):
    return tuple(a.expand((tp,) + a.shape).contiguous() for a in x)


@pytest.mark.cuda
@pytest.mark.parametrize("case,tp", VERDICT_CASES)
def test_round_verdict_edges(cuda, case, tp):
    kw, mutate = VERDICT_EDGES[case]
    cfg = qba_tpu_torch.QBAConfig(**kw, trials=16, seed=7)
    accepted = overflowed = False
    for r, pool, mbox, li, vi, hc, draws in protocol_rounds(cfg, cuda,
                                                            mutate):
        if tp == 1:
            args, margs, kw_sh = (pool, li, vi, hc), (mbox, li, vi, hc), {}
        else:
            n_local = cfg.n_lieutenants // tp
            sli, svi = rk.shard_receivers(li, tp), rk.shard_receivers(vi, tp)
            args = (copies(pool, tp), sli, svi, hc)
            margs = (copies(mbox, tp), sli, svi, hc)
            kw_sh = dict(n_recv=n_local)
        fused = rk.fused_round(cfg, r, *args, *draws, **kw_sh)
        assert_equal(fused, rk.fused_round_reference(cfg, r, *args, *draws,
                                                     **kw_sh))
        acc, vi2 = rk.tiled_verdict(cfg, r, *args, *draws, **kw_sh)
        assert_equal((acc, vi2), rk.verdict_reference(cfg, r, *args, *draws,
                                                      **kw_sh))
        assert_equal(rk.tiled_rebuild(cfg, r, *args[:2], acc, hc, *draws[:2],
                                      **kw_sh),
                     (fused[0], fused[2]))
        assert_equal(rs.round_step(cfg, r, *margs, *draws, **kw_sh),
                     rs.round_step_reference(cfg, r, *margs, *draws,
                                             **kw_sh))
        accepted |= bool(acc.any())
        overflowed |= bool(fused[2].any())
        if mutate == "empty":
            assert not acc[..., 1::2, :].any()
    assert accepted
    if case == "11p-slots1":
        assert overflowed


@pytest.mark.cuda
def test_round_phase_clock(cuda):
    # The clocked instantiations of the fused round, the dense-mailbox
    # round and the tiled verdict, single-device and n_recv, give the plain
    # launch's round and fill the clock: every block spends cycles in
    # set-up, some in the receiver passes; the tiled rebuild's too, every
    # block in its slots (the "dedup" phase).
    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=16, seed=6)
    for r, pool, mbox, li, vi, hc, draws in protocol_rounds(cfg, cuda):
        for tp in (1, 2):
            if tp == 1:
                args, margs, kw_sh = (pool, li, vi, hc), (mbox, li, vi, hc), {}
                lead = None
            else:
                sli, svi = rk.shard_receivers(li, tp), rk.shard_receivers(vi, tp)
                args = (copies(pool, tp), sli, svi, hc)
                margs = (copies(mbox, tp), sli, svi, hc)
                kw_sh, lead = dict(n_recv=cfg.n_lieutenants // tp), tp
            for fn, a in ((rk.fused_round, args), (rs.round_step, margs)):
                clock = rk.round_phase_clock(cfg.trials, lead, cuda)
                assert_equal(fn(cfg, r, *a, *draws, **kw_sh, clock=clock),
                             fn(cfg, r, *a, *draws, **kw_sh))
                phases = dict(zip(rk.ROUND_PHASES, clock.unbind(-1)))
                assert (phases["setup"] > 0).all()
                if r == 1:
                    assert phases["receivers"].any()
            clock = rk.round_phase_clock(cfg.trials, lead, cuda)
            acc, vi2 = rk.tiled_verdict(cfg, r, *args, *draws, **kw_sh,
                                        clock=clock)
            assert_equal((acc, vi2),
                         rk.tiled_verdict(cfg, r, *args, *draws, **kw_sh))
            phases = dict(zip(rk.ROUND_PHASES, clock.unbind(-1)))
            assert (phases["setup"] > 0).all() and (phases["fill"] > 0).all()
            if r == 1:
                assert phases["receivers"].any()
            clock = rk.round_phase_clock(cfg.trials, lead, cuda)
            assert_equal(
                rk.tiled_rebuild(cfg, r, *args[:2], acc, hc, *draws[:2],
                                 **kw_sh, clock=clock),
                rk.tiled_rebuild(cfg, r, *args[:2], acc, hc, *draws[:2],
                                 **kw_sh))
            phases = dict(zip(rk.ROUND_PHASES, clock.unbind(-1)))
            assert (phases["dedup"] > 0).all()
        if r == 2:
            break


@pytest.mark.cuda
@pytest.mark.parametrize("n_trials", [1, 37, 1000, 5000])
def test_sweep_stop_equals_plain(cuda, n_trials):
    from qba_tpu_torch.ops import sweep_loop as sl

    g = torch.Generator().manual_seed(n_trials)
    success = torch.rand(n_trials, generator=g) < 0.4
    overflow = torch.rand(n_trials, generator=g) < 2.0 / n_trials
    n = 4
    lo = torch.tensor([-1, 0, 300, 700, 1500], dtype=torch.int32)
    hi = lo + torch.tensor([2, 900, 700, 600, 700], dtype=torch.int32)
    for start in range(n + 1):
        carry = sl.new_carry(n, start, 211 * start, "cpu")
        want = sl.sweep_stop_reference(success, overflow, lo, hi,
                                       carry.clone())
        got = sl.sweep_stop(success.to(cuda), overflow.to(cuda),
                            lo.to(cuda), hi.to(cuda), carry.to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (start, got, want)
        # With succ_out: the chunk's bits at rows start * T, the other
        # rows as they were, the carry the same.
        bits = torch.rand(n * n_trials, generator=g) < 0.5
        want_bits = bits.clone()
        sl.sweep_stop_reference(success, overflow, lo, hi, carry.clone(),
                                want_bits)
        got_bits = bits.to(cuda)
        got = sl.sweep_stop(success.to(cuda), overflow.to(cuda),
                            lo.to(cuda), hi.to(cuda), carry.to(cuda),
                            succ_out=got_bits)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), start
        assert torch.equal(got_bits.cpu(), want_bits), start


@pytest.mark.cuda
@pytest.mark.parametrize("qsim_path", ["factorized", "stabilizer"])
def test_prefix_graph_loop_equals_plain_loop(cuda, qsim_path):
    # The serving worker's loop over pre-assigned keys as one graph on
    # the card against the plain loop on the CPU: the same stop, counts
    # and success bits.
    from qba_tpu_torch.ops import sweep_loop as sl
    from qba_tpu_torch.stats import parse_target, stop_tables

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  trials=64, qsim_path=qsim_path)
    keys = jr.split(jr.key(3, "cpu"), 6 * 64)
    lo, hi = stop_tables(parse_target("decide vs 0.9 +-0.05"), 6, 64)
    want = sl.device_loop_prefix(cfg, 6, 64, keys, lo, hi, "cpu")
    got = sl.device_loop_prefix(cfg, 6, 64, keys.to(cuda), lo, hi, cuda)
    assert got[4]["dispatch"] == "graph" and got[4]["readbacks"] == 1
    assert got[0] == want[0]
    for a, b in zip(got[1:4], want[1:4]):
        assert (a == b).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["host", "device"])
def test_served_results_on_the_card_equal_the_cpu(cuda, dispatch):
    from qba_tpu_torch.serve import EvalRequest, QBAServer, serve_batch

    reqs = [EvalRequest(request_id="t", n_parties=5, size_l=16,
                        n_dishonest=2, trials=96, seed=4,
                        target="decide vs 0.9 +-0.05"),
            EvalRequest(request_id="d", n_parties=7, size_l=16,
                        n_dishonest=2, trials=40, seed=2,
                        return_decisions=True),
            EvalRequest(request_id="s", n_parties=5, size_l=16,
                        n_dishonest=2, trials=40, seed=1,
                        qsim_path="stabilizer")]
    runs = [{r.request_id: r.to_json() for r in serve_batch(
        QBAServer(chunk_trials=16, dispatch=dispatch, device=d), reqs)}
        for d in (None, "cpu")]
    for rid in ("t", "d", "s"):
        for f in ("success", "decisions", "n_trials", "stop", "chunks",
                  "error"):
            assert runs[0][rid][f] == runs[1][rid][f], (rid, f)
    assert runs[0]["t"]["engine"] == "pallas_mega/keyed"


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["decide vs 1/3", "ci_width<=0.01"])
def test_sweep_graph_loop_equals_host_loop(cuda, spec):
    # The graph loop (one launch, one readback) against the host loop on
    # the card and the plain loop on the CPU: the same chunks and stop.
    from qba_tpu_torch.obs.timers import PhaseTimers
    from qba_tpu_torch.ops.sweep_loop import BODY_NODE_TYPES
    from qba_tpu_torch.sweep import run_sweep

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                                  seed=3)
    runs = {}
    for device, dispatch in (("cuda", "host"), ("cuda", "device"),
                             ("cpu", "device")):
        timers = PhaseTimers()
        runs[device, dispatch] = res = run_sweep(
            cfg, 5, 64, target=spec, dispatch=dispatch, device=device,
            timers=timers)
        if (device, dispatch) == ("cuda", "device"):
            (span,) = [s for s in timers.spans.spans
                       if s.name == "device_loop"]
            assert span.args["dispatch"] == "graph"
            assert span.args["readbacks"] == 1
            assert set(span.args["body_nodes"]) <= set(
                BODY_NODE_TYPES.values())
        assert res.n_trials > 0
    want = runs["cpu", "device"]
    for res in runs.values():
        assert res.chunks == want.chunks
        assert res.stop.to_json() == want.stop.to_json()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(round_engine="pallas_fused"),
                                dict(round_engine="pallas"),
                                dict(round_engine="pallas_tiled"),
                                dict(round_engine="xla"),
                                dict(collect_counters=True),
                                dict(qsim_path="dense_pallas",
                                     n_parties=3, size_l=8, n_dishonest=1),
                                dict(qsim_path="dense", n_parties=3,
                                     size_l=8, n_dishonest=1)])
def test_graph_loop_every_engine_equals_plain_loop(cuda, kw):
    # The sweep's graph loop on each per-round engine, the counters and
    # the dense paths (one graph, one readback) against the plain loop
    # on the CPU, and the worker's prefix loop likewise (the dense paths
    # at 8 qubits: the plain statevector runs on the CPU).
    from qba_tpu_torch.ops import sweep_loop as sl
    from qba_tpu_torch.stats import parse_target, stop_tables

    cfg = qba_tpu_torch.QBAConfig(**{**dict(n_parties=5, size_l=16,
                                            n_dishonest=2, seed=3), **kw})
    lo, hi = stop_tables(parse_target("decide vs 0.9 +-0.05"), 5, 64)
    want = sl.device_loop(cfg, 5, 64, 0, 0, lo, hi, "cpu")
    got = sl.device_loop(cfg, 5, 64, 0, 0, lo, hi, cuda)
    assert got[3]["dispatch"] == "graph" and got[3]["readbacks"] == 1
    assert set(got[3]["body_nodes"]) <= set(sl.BODY_NODE_TYPES.values())
    assert got[0] == want[0] and got[0] > 0
    for a, b in zip(got[1:3], want[1:3]):
        assert (a == b).all()
    keys = jr.split(jr.key(3, "cpu"), 5 * 64)
    want = sl.device_loop_prefix(cfg, 5, 64, keys, lo, hi, "cpu")
    got = sl.device_loop_prefix(cfg, 5, 64, keys.to(cuda), lo, hi, cuda)
    assert got[0] == want[0]
    for a, b in zip(got[1:4], want[1:4]):
        assert (a == b).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_cells", [1, 33, 256])
def test_surface_kernels_equal_plain(cuda, n_cells):
    # surface_pick and surface_fold against their plain versions on the
    # card's tensors: the kernel rounds each float operation on its own
    # (-fmad=false), as the plain version does, so the endpoints are
    # equal; the chosen cell, its chunk index and tier, and the fold's
    # carry are exact.
    from qba_tpu_torch.ops import surface_loop as su

    g = torch.Generator().manual_seed(n_cells)
    layout = su.SurfaceLayout(n_cells, 33, 4)
    i = torch.randint(0, 33, (n_cells,), generator=g)
    k = (torch.rand(n_cells, generator=g) * i * 1000).long()
    done = torch.rand(n_cells, generator=g) < 0.25
    carry = su.new_surface_carry(layout, k, i, done, cuda)
    for threshold in (0.3, 0.55, None):
        cis = [torch.zeros((2, n_cells), device=cuda) for _ in "ab"]
        want = su.surface_pick_reference(carry.clone(), cis[0], layout, 1000,
                                         0.95, threshold)
        got = su.surface_pick(carry.clone(), cis[1], layout, 1000, 0.95,
                              threshold)
        torch.cuda.synchronize()
        assert torch.equal(got, want), threshold
        assert torch.equal(cis[0], cis[1]), threshold
    lo = (torch.arange(34) * 300).int().to(cuda)
    hi = (torch.arange(34) * 700).int().to(cuda)
    success = (torch.rand(1000, generator=g) < 0.5).to(cuda)
    overflow = (torch.rand(1000, generator=g) < 0.01).to(cuda)
    for step in (0, 3, 4):  # the last past the steps: nothing stored
        carry[su.STEP] = step
        su.surface_pick(carry, cis[1], layout, 1000, 0.95, 0.5)
        want = su.surface_fold_reference(success, overflow, lo, hi,
                                         carry.clone(), layout)
        got = su.surface_fold(success, overflow, lo, hi, carry.clone(),
                              layout)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [6, 16])
def test_surface_graph_equals_host_surface(cuda, budget):
    # The device surface as one graph (one launch, one readback) against
    # the host surface on the card and the plain loop on the CPU: the
    # same per-cell chunks, stops and schedule, with passes out of capture
    # order (the captures share one memory pool).
    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.sweep import run_surface

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=1,
                                  trials=64, seed=3)
    grid = (["reference", "split"], [(0.0, 0.0), (0.05, 0.02)], [16])
    kw = dict(chunk_trials=64, target="decide vs 0.9 +-0.02",
              budget_chunks=budget)
    records = []
    loop = su.device_surface_loop

    def recorded(*args, **kwargs):
        out, info = loop(*args, **kwargs)
        records.append(info)
        return out, info

    su.device_surface_loop = recorded
    try:
        runs = {(device, dispatch): run_surface(cfg, *grid, device=device,
                                                dispatch=dispatch, **kw)
                for device, dispatch in (("cuda", "host"), ("cuda", "device"),
                                         ("cpu", "device"))}
    finally:
        su.device_surface_loop = loop
    graph = records[0]
    assert graph["dispatch"] == "graph" and graph["readbacks"] == 1
    assert graph["design"] == "switch"
    for nodes in graph["body_nodes"].values():
        assert set(nodes) <= set(su.BODY_NODE_TYPES.values())
    want = runs["cpu", "device"]
    sched = [t["cell"] for t in want[0].manifest["stats"]["allocator"]
             ["trace"]]
    assert any(b < a for a, b in zip(sched, sched[1:]))
    for cells in runs.values():
        alloc = cells[0].manifest["stats"]["allocator"]
        assert [t["cell"] for t in alloc["trace"]] == sched
        for c, w in zip(cells, want):
            assert c.result.chunks == w.result.chunks
            assert c.result.stop.to_json() == w.result.stop.to_json()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["pallas", "pallas_tiled", "pallas_fused",
                                    "pallas_mega"])
def test_lint_launches_and_carry_on_the_card(cuda, engine):
    # The launch pin and the carry audit (analysis.launches, .effects) on
    # the kernels: wrappers, seams and the model agree; the per-round
    # engines ping-pong one buffer pair and allocate no pool in a round.
    from qba_tpu_torch.analysis import effects, launches, trace

    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3)
    trace.reset()
    rep = launches.check_launches("11p", cfg, [engine], cuda, 64)
    rep.extend(effects.check_effects("11p", cfg, [engine], cuda, 64))
    assert rep.ok, rep.render()
    rec = trace.trace_batch("11p", cfg, engine, cuda, 64)
    assert rec.launches == dict(rec.seams) == launches.batch_launch_model(
        cfg, engine, cuda)


@pytest.mark.cuda
def test_lint_sync_probe_on_the_card(cuda):
    # The megakernel's chunk runs under set_sync_debug_mode("error")
    # without a raise, and so do the fused round's with counters and the
    # dense paths'; the lint at 11p exits clean on the card.
    from qba_tpu_torch.analysis import run_lint, transfers

    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3)
    rep = transfers.check_device_loop([("11p", cfg)], ["pallas_mega"], cuda,
                                      64)
    assert rep.ok, rep.render()
    assert rep.stats["sync_verdicts"]["11p/pallas_mega"] == "no sync"
    rep = run_lint([("11p", cfg)], effects=True)
    assert rep.ok, rep.render()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 24])
def test_measure_batch_on_the_card_equals_run_trials(cuda, chunk):
    # The measurement harness (bench's timing loop) on the card: its last
    # rep's trials equal run_trials on the same keys, split before the
    # chunks (64 trials in chunks of 24: three, the last rounded up).
    from qba_tpu_torch.benchmark import measure_batch

    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                  trials=64, seed=4)
    times, n_run, results = measure_batch(cfg, 2, chunk, device=cuda)
    assert len(times) == 2 and n_run == (72 if chunk else 64)
    keys = jr.split(jr.key(cfg.seed + 2, cuda), n_run)
    want = qba_tpu_torch.run_trials(dataclasses.replace(cfg, trials=n_run),
                                    keys, device=cuda).trials
    for f in ("decisions", "success", "vi", "overflow"):
        got = torch.cat([getattr(r.trials, f) for r in results])
        assert got.device.type == "cuda" and torch.equal(got, getattr(want, f))


# ---- JAX's legacy threefry mode ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("combo", list(DRAW_COMBOS))
def test_legacy_attack_draws_kernel(cuda, combo):
    # The draws kernel's legacy instantiation: its tables pair entries
    # across the whole round's table, a window of rounds included.
    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=16, n_dishonest=3,
                                  trials=16, seed=8, **DRAW_COMBOS[combo])
    with jr.threefry_partitionable(False):
        _body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
        got = attack_draws(cfg, k_rounds, ctx)
        assert_equal(got, attack_draws_reference(cfg, k_rounds, ctx))
        assert_equal(attack_draws(cfg, k_rounds, ctx, 3, 1),
                     attack_draws_reference(cfg, k_rounds, ctx, 3, 1))
    other = attack_draws(cfg, k_rounds, ctx, partitionable=True)
    assert not torch.equal(other[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("combo", ["reference-sync", "adaptive-racy",
                                   "broadcast-racy", "split-sync",
                                   "collude-racy"])
def test_legacy_keyed_megakernels(cuda, combo):
    # The keyed, sharded keyed (tp 2 and 4) and gen keyed entries' legacy
    # instantiations against their plain versions.
    cfg = qba_tpu_torch.QBAConfig(n_parties=9, size_l=16, n_dishonest=3,
                                  trials=32, seed=9, **DRAW_COMBOS[combo])
    with jr.threefry_partitionable(False):
        body, k_rounds, ctx = keyed_inputs_of(cfg, cuda)
        want = tm.trial_megakernel_keyed_reference(cfg, *body, k_rounds, ctx)
        got = tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx)
        assert_equal(got, want)
        for tp in (2, 4):
            assert_equal(tm.sharded_trial_megakernel_keyed(
                cfg, tp, *body, k_rounds, ctx), want)
        scfg = dataclasses.replace(cfg, size_l=64, qsim_path="stabilizer")
        keys = trial_keys(scfg, cuda)
        honest, gen_ops, v_sent, _vc, kr = _mega_gen_setup(scfg, keys)
        kr = kr.contiguous()
        gctx = adversary_ctx(scfg, kr, v_sent)
        args = (scfg, pc.stabilizer_gen_tables(scfg, cuda), gen_ops,
                v_sent.to(torch.int32).contiguous(),
                rk.honest_cells(honest, scfg))
        assert_equal(tm.trial_megakernel_gen_keyed(*args, kr, gctx),
                     tm.trial_megakernel_gen_keyed_reference(*args, kr, gctx))
    # The phase clock has no legacy instantiation.
    with pytest.raises(tm.KernelUnsupported, match="phase clock"):
        tm.trial_megakernel_keyed(cfg, *body, k_rounds, ctx,
                                  clock=tm.phase_clock(32, 1, cuda),
                                  partitionable=False)


@pytest.mark.cuda
def test_golden_pins_on_the_card(cuda):
    # The repo's golden pins, recorded in JAX's legacy mode, on every
    # engine's kernels and on the sharded megakernel.
    from qba_tpu_torch.parallel import make_mesh, run_trials_spmd
    from qba_tpu_torch.testing import GOLD_PINS

    with jr.threefry_partitionable(False):
        for name, kw, success, decisions in GOLD_PINS:
            cfg = qba_tpu_torch.QBAConfig(**kw)
            runs = {e: qba_tpu_torch.run_trials(dataclasses.replace(
                cfg, round_engine=e)).trials
                for e in ("xla", "pallas", "pallas_fused", "pallas_tiled",
                          "auto")}
            mesh = make_mesh({"dp": 1, "tp": 2}, devices=[cuda] * 2)
            runs["tp=2"] = run_trials_spmd(cfg, mesh).trials
            for label, got in runs.items():
                assert got.success.tolist() == success, (name, label)
                assert got.decisions.tolist() == decisions, (name, label)


# ---- the trial set-up kernel ---------------------------------------------

SETUP_CASES = {
    "11p-reference": dict(n_parties=11, size_l=64, n_dishonest=3),
    "11p-split-noise": dict(n_parties=11, size_l=64, n_dishonest=3,
                            strategy="split", p_depolarize=0.05,
                            p_measure_flip=0.02),
    "33p-collude": dict(n_parties=33, size_l=64, n_dishonest=10,
                        strategy="collude"),
    "65p-adaptive": dict(n_parties=65, size_l=70, n_dishonest=21,
                         strategy="adaptive"),
    # Tiles sized by the shared memory's limit.
    "5p-L1000-noise": dict(n_parties=5, size_l=1000, n_dishonest=2,
                           p_depolarize=0.05, p_measure_flip=0.02),
    "3p-L2048-split": dict(n_parties=3, size_l=2048, n_dishonest=1,
                           strategy="split"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("case", list(SETUP_CASES))
def test_setup_kernel_forms(cuda, case, partitionable):
    # Every form of the set-up kernel equals its plain version bit for
    # bit on every output, in both threefry modes (65p: w = 128, two
    # tiles of positions).
    from qba_tpu_torch.ops import setup_kernel as sk

    p = partitionable
    cfg = qba_tpu_torch.QBAConfig(**SETUP_CASES[case], trials=64, seed=4)
    keys = trial_keys(cfg, cuda, partitionable=p)
    k_lists = jr.split(keys, 4, partitionable=p)[:, 1].contiguous()
    lists = sk.setup_reference(cfg, keys, "whole", full_lists=True,
                               partitionable=p).lists
    before = sk.setup_kernel.launches
    calls = [((cfg, keys, "whole"), {}), ((cfg, keys, "whole"),
                                          dict(full_lists=True)),
             ((cfg, keys, "given", lists), {}), ((cfg, keys, "orders"), {}),
             ((cfg, k_lists, "lists"), {})]
    for args, kw in calls:
        got = sk.setup_kernel(*args, partitionable=p, **kw)
        want = sk.setup_reference(*args, partitionable=p, **kw)
        for f in sk.TrialSetup._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), (args[2], f)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b), (args[2], f)
    assert sk.setup_kernel.launches == before + len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "pallas_fused", "pallas_tiled",
                                    "pallas", "xla"])
def test_every_engine_launches_the_setup_kernel(cuda, engine):
    # A batch launches the set-up kernel as the launch model says and no
    # eager set-up: its results equal the same batch on the plain set-up.
    from qba_tpu_torch.analysis.launches import batch_launch_model
    from qba_tpu_torch.ops import setup_kernel as sk

    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                  trials=64, strategy="collude",
                                  round_engine=engine)
    for qsim in ("factorized", "stabilizer"):
        qcfg = dataclasses.replace(cfg, qsim_path=qsim)
        before = sk.setup_kernel.launches
        got = qba_tpu_torch.run_trials(qcfg).trials
        assert sk.setup_kernel.launches - before == batch_launch_model(
            qcfg, engine, cuda)["setup_trial"]
        real = sk.dispatch
        try:
            sk.dispatch = lambda name, t: (name != "setup_trial"
                                           and real(name, t))
            want = qba_tpu_torch.run_trials(qcfg).trials
        finally:
            sk.dispatch = real
        for f in ("decisions", "success", "vi", "overflow", "honest"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (qsim, f)


@pytest.mark.cuda
def test_setup_kernel_refuses_what_it_cannot_serve(cuda):
    from qba_tpu_torch.ops import setup_kernel as sk

    cfg = qba_tpu_torch.QBAConfig(n_parties=1100, size_l=4, n_dishonest=0)
    with pytest.raises(sk.KernelUnsupported, match="parties"):
        sk.setup_kernel(cfg, jr.split(jr.key(0, device=cuda), 2))
    small = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    with pytest.raises(TypeError, match="dtype"):
        sk.setup_kernel(small, torch.zeros(2, 2, dtype=torch.int32,
                                           device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_keys_kernel_matches_plain(cuda, partitionable):
    # The key entry equals split(fold_in(root, d), num) bit for bit: odd
    # and even counts (the legacy pairing), seed and key roots, folds as
    # ints and as int32 tensors; one launch a call.
    from qba_tpu_torch.ops import setup_kernel as sk

    p = partitionable
    folds = (None, 9, -2, torch.tensor(-4, dtype=torch.int32, device=cuda))
    for num in (1, 6, 77):
        for root in (-3, 41, jr.key(5, device=cuda)):
            for fold in folds:
                before = sk.keys_kernel.launches
                got = sk.keys_kernel(root, num, fold, device=cuda,
                                     partitionable=p)
                assert sk.keys_kernel.launches == before + 1
                want = sk.keys_reference(root, num, fold, device=cuda,
                                         partitionable=p)
                assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(TypeError, match="int32"):
        sk.keys_kernel(3, 4, torch.tensor(1, device=cuda), device=cuda)


@pytest.mark.cuda
def test_setup_phase_clock(cuda):
    # The clocked instantiation fills every block's phases and equals the
    # unclocked launch; the legacy mode and the plain version refuse it.
    from qba_tpu_torch.ops import setup_kernel as sk

    cfg = qba_tpu_torch.QBAConfig(n_parties=11, size_l=64, n_dishonest=3,
                                  trials=32)
    keys = trial_keys(cfg, cuda)
    clock = sk.setup_phase_clock(cfg.trials, cuda)
    got = sk.setup_kernel(cfg, keys, "whole", clock=clock)
    want = sk.setup_kernel(cfg, keys, "whole")
    for f in ("honest", "lieu_lists", "p_rows", "v_sent", "v_comm"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    phases = sk.setup_phase_breakdown(clock)
    assert phases["block"]["mean"] > 0 and phases["words"]["cycles"] > 0
    with pytest.raises(sk.KernelUnsupported, match="phase clock"):
        sk.setup_kernel(cfg, keys, "whole", partitionable=False, clock=clock)
    with pytest.raises(ValueError, match="phase clock"):
        sk.setup_kernel(cfg, keys.cpu(), "whole", clock=clock.cpu())
