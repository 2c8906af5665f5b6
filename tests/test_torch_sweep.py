"""The port's sweeps equal the JAX package's, chunk for chunk and decision
for decision.

For one small config (4p/L16/d1, chunks of 12 trials) run by both
packages on the same chunk keys:

* ``chunk_keys`` equal ``jax.random.key_data`` of JAX's;
* ``run_chunk_counts`` / ``run_chunk_outcomes`` equal JAX's batch;
* the fixed-budget ``run_sweep`` chunks are equal;
* the triad: the port's host loop, the port's device loop (its plain
  form on the CPU), JAX's host loop and JAX's ``lax.while_loop`` execute
  the same chunks and stop with the same ``StopDecision`` JSON, for a
  target that decides inside the budget, one that decides on the final
  chunk and one that exhausts it, and each equals the fixed-budget run's
  prefix;
* a checkpoint written by either package resumes in the other;
* the host-targeted ``run_surface`` on a two-cell grid equals JAX's per
  cell, with the same content-addressed checkpoint names, atlas cell
  names and store digest;
* the device loop's chunk is capturable by a CUDA graph: on the path the
  card runs (the keyed megakernel engine), nothing makes a tensor from
  host data or reads one back.

JAX's side runs its batches through one jitted runner and its device
loop compiles once for the three targets (the stop tables are traced
arguments).  JAX's threefry mode is set only inside
``jax.threefry_partitionable(True)``.
"""

import dataclasses
import json
import os
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode

from qba_tpu import sweep as jsweep
from qba_tpu.atlas.store import AtlasStore as JAtlasStore
from qba_tpu.backends.jax_backend import batched_trials as j_batched_trials
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu_torch import sweep as psweep
from qba_tpu_torch.atlas.store import AtlasStore
from qba_tpu_torch.convert import config_from_jax_fields
from qba_tpu_torch.diagnostics import QBADemotionWarning
from qba_tpu_torch.ops import sweep_loop as sl
from qba_tpu_torch.ops import trial_megakernel as tm
from qba_tpu_torch.rounds.engine import run_chunk_counts, run_chunk_outcomes

KW = dict(n_parties=4, size_l=16, n_dishonest=1, seed=3)
CT = 12
BUDGET = 6
JCFG = JConfig(**KW, trials=CT)
CFG = config_from_jax_fields(dataclasses.asdict(JCFG))
# Decides at chunk 3; decides on the final budget chunk; never decides.
TARGETS = ["decide vs 0.7 +-0.1", "ci_width<=0.3", "decide vs 0.8 +-0.1"]

_j_runner = jax.jit(j_batched_trials, static_argnums=0)


def j_runner(cfg, keys):
    return _j_runner(cfg, keys)


def j_run_sweep(*args, **kw):
    if kw.get("dispatch") != "device":
        kw.setdefault("runner", j_runner)
    with jax.threefry_partitionable(True):
        return jsweep.run_sweep(*args, **kw)


def p_run_sweep(*args, **kw):
    return psweep.run_sweep(*args, device="cpu", **kw)


def chunk_tuples(res):
    return [(c.chunk, c.trials, c.successes, c.overflow) for c in res.chunks]


def test_chunk_keys_equal_jax():
    for chunk in (0, 1, 5, 2**31 - 1):
        with jax.threefry_partitionable(True):
            want = np.asarray(jax.random.key_data(
                jsweep.chunk_keys(JCFG, chunk, CT)))
        got = psweep.chunk_keys(CFG, chunk, CT, "cpu")
        assert got.dtype == torch.int64 and got.shape == (CT, 2)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_chunk_counts_and_outcomes_equal_jax():
    with jax.threefry_partitionable(True):
        want = j_runner(JCFG, jsweep.chunk_keys(JCFG, 1, CT))
    keys = psweep.chunk_keys(CFG, 1, CT, "cpu")
    k, o = run_chunk_counts(CFG, keys)
    s, o2 = run_chunk_outcomes(CFG, keys)
    assert k.dtype == torch.int32 and k.shape == () and o.shape == ()
    np.testing.assert_array_equal(s.numpy(), np.asarray(want.success))
    assert int(k) == int(np.sum(np.asarray(want.success)))
    assert bool(o) == bool(o2) == bool(np.any(np.asarray(want.overflow)))


def test_fixed_budget_chunks_equal_jax():
    got = p_run_sweep(CFG, BUDGET, CT)
    want = j_run_sweep(JCFG, BUDGET, CT)
    assert chunk_tuples(got) == chunk_tuples(want)
    assert got.success_rate == want.success_rate
    assert got.stats_summary() == want.stats_summary()


@pytest.fixture(scope="module")
def fixed():
    return p_run_sweep(CFG, BUDGET, CT)


@pytest.fixture(scope="module")
def jax_loops():
    """JAX's host and device loops on each of ``TARGETS``, run once."""
    return {spec: (j_run_sweep(JCFG, BUDGET, CT, target=spec),
                   j_run_sweep(JCFG, BUDGET, CT, target=spec,
                               dispatch="device"))
            for spec in TARGETS}


@pytest.mark.parametrize("spec", TARGETS)
def test_triad_equals_jax(spec, fixed, jax_loops):
    host = p_run_sweep(CFG, BUDGET, CT, target=spec)
    dev = p_run_sweep(CFG, BUDGET, CT, target=spec, dispatch="device")
    j_host, j_dev = jax_loops[spec]
    want = chunk_tuples(j_host)
    assert chunk_tuples(j_dev) == want
    assert chunk_tuples(host) == chunk_tuples(dev) == want
    assert (host.stop.to_json() == dev.stop.to_json()
            == j_host.stop.to_json() == j_dev.stop.to_json())
    assert dev.dispatch == "device" and host.dispatch == "host"
    assert chunk_tuples(host) == chunk_tuples(fixed)[:len(host.chunks)]
    reasons = {TARGETS[0]: (3, "decided_above"),
               TARGETS[1]: (BUDGET, "ci_width"),
               TARGETS[2]: (BUDGET, "budget_exhausted")}
    assert (len(host.chunks), host.stop.reason) == reasons[spec]


def test_device_loop_record():
    timers = psweep.PhaseTimers()
    p_run_sweep(CFG, BUDGET, CT, target=TARGETS[0], dispatch="device",
                timers=timers)
    (span,) = [sp for sp in timers.spans.spans if sp.name == "device_loop"]
    assert span.fenced and span.args["dispatch"] == "plain"
    assert span.args["readbacks"] == 3


def _strip_timings(path):
    with open(path) as f:
        payload = json.load(f)
    for c in payload["chunks"]:
        c.pop("dispatch_s"), c.pop("readback_s")
    return payload


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    spec = TARGETS[1]
    path = str(tmp_path / "ckpt.json")
    first, resume = ((j_run_sweep, JCFG), (p_run_sweep, CFG))
    if writer == "port":
        first, resume = resume, first
    part = first[0](first[1], 2, CT, target=spec, checkpoint=path)
    assert len(part.chunks) == 2 and part.stop.reason == "budget_exhausted"
    with open(path) as f:
        written = f.read()
    whole = resume[0](resume[1], BUDGET, CT, target=spec)
    for dispatch in ("host", "device"):
        with open(path, "w") as f:
            f.write(written)
        res = resume[0](resume[1], BUDGET, CT, target=spec, checkpoint=path,
                        dispatch=dispatch)
        assert res.resumed_chunks == 2
        assert chunk_tuples(res) == chunk_tuples(whole)
        assert res.stop.to_json() == whole.stop.to_json()
        with open(path) as f:
            assert len(json.load(f)["chunks"]) == BUDGET


def test_checkpoint_mismatch_as_jax(tmp_path):
    # A chunk_trials mismatch raises, or with resume_force warns, records
    # the same decision as JAX's and re-chunks; a config mismatch is never
    # forceable.
    from qba_tpu.diagnostics import record_decisions as j_record
    from qba_tpu_torch.diagnostics import QBACheckpointMismatch
    from qba_tpu_torch.diagnostics import record_decisions as p_record

    path = str(tmp_path / "ckpt.json")
    p_run_sweep(CFG, 2, CT, checkpoint=path)
    with pytest.raises(QBACheckpointMismatch, match="chunk_trials"):
        p_run_sweep(CFG, 2, CT + 1, checkpoint=path)
    records = []
    for record, load, cfg in ((p_record, psweep.load_checkpoint, CFG),
                              (j_record, jsweep.load_checkpoint, JCFG)):
        with record() as recs, pytest.warns(RuntimeWarning,
                                            match="re-chunking"):
            assert load(path, cfg, CT + 1, force=True) == []
        records.append([{k: v for k, v in r.items() if k != "message"}
                        for r in recs])
    assert records[0] == records[1] and records[0][0]["kind"] == "checkpoint"
    with pytest.raises(QBACheckpointMismatch, match="different config") as e:
        psweep.load_checkpoint(path, dataclasses.replace(CFG, seed=4), CT,
                               force=True)
    assert e.value.kind == "config" and not e.value.forceable


def test_checkpoint_files_equal(tmp_path):
    paths = [str(tmp_path / f"{who}.json") for who in ("jax", "port")]
    j_run_sweep(JCFG, 3, CT, checkpoint=paths[0])
    p_run_sweep(CFG, 3, CT, checkpoint=paths[1])
    assert _strip_timings(paths[0]) == _strip_timings(paths[1])


def test_surface_targeted_equals_jax(tmp_path):
    grid = (["reference", "split"], [(0.0, 0.0)], [16])
    kw = dict(chunk_trials=CT, target=TARGETS[0], budget_chunks=5)
    with jax.threefry_partitionable(True):
        want = jsweep.run_surface(
            JCFG, *grid, runner=j_runner, with_manifest=False,
            checkpoint_dir=str(tmp_path / "j_ckpt"),
            store_dir=str(tmp_path / "j_store"), **kw)
    got = psweep.run_surface(
        CFG, *grid, device="cpu", checkpoint_dir=str(tmp_path / "p_ckpt"),
        store_dir=str(tmp_path / "p_store"), **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.strategy, g.size_l) == (w.strategy, w.size_l)
        assert chunk_tuples(g.result) == chunk_tuples(w.result)
        assert g.result.stop.to_json() == w.result.stop.to_json()
    for sub in ("ckpt", "store/cells"):
        names = [sorted(os.listdir(tmp_path / f"{who}_{sub}"))
                 for who in ("j", "p")]
        assert names[0] == names[1] and len(names[0]) == 2
    assert (AtlasStore(str(tmp_path / "p_store")).digest()
            == JAtlasStore(str(tmp_path / "j_store")).digest())
    # A re-run resumes every cell from its checkpoint.
    again = psweep.run_surface(
        CFG, *grid, device="cpu", checkpoint_dir=str(tmp_path / "j_ckpt"),
        **kw)
    assert [c.result.resumed_chunks for c in again] == [
        len(c.result.chunks) for c in want]


def test_unported_surface_options_raise():
    # The device loops' own refusals, as JAX's: a device sweep or surface
    # needs a target and runs the built-in chunk, no custom runner.
    grid = (["reference"], [(0.0, 0.0)], [16])
    with pytest.raises(ValueError, match="needs a target"):
        p_run_sweep(CFG, 2, CT, dispatch="device")
    with pytest.raises(ValueError, match="needs a target"):
        psweep.run_surface(CFG, *grid, dispatch="device", device="cpu")
    with pytest.raises(ValueError, match="cannot take a custom runner"):
        psweep.run_surface(CFG, *grid, target=TARGETS[0], dispatch="device",
                           runner=lambda cfg, keys: None, device="cpu")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        psweep.run_sweep(CFG, 1, CT)
    with pytest.raises(RuntimeError, match="CUDA"):
        psweep.run_surface(CFG, ["reference"], [(0.0, 0.0)], [16])


def test_sweep_stop_plain_version():
    # One step of the loop at every index of a three-chunk budget: the
    # counts land at the index, the flag is the table test at i + 1.
    lo = torch.tensor([-1, 2, 6, 7], dtype=torch.int32)
    hi = torch.tensor([1, 9, 20, 30], dtype=torch.int32)
    success = torch.tensor([True, False, True, True, False])
    overflow = torch.tensor([False, False, True, False, False])
    # k_total 3, 6 and 9 at i + 1: on; lo fires; past the budget.
    want_go = {0: True, 1: False, 2: False}
    for i in range(3):
        carry = sl.new_carry(3, i, 3 * i, "cpu")
        sl.sweep_stop(success, overflow, lo, hi, carry)
        i_new, k_total, counts, ovf = sl.read_carry(carry)
        assert (i_new, k_total, int(carry[2])) == (i + 1, 3 * i + 3,
                                                   want_go[i])
        assert counts[i] == 3 and ovf[i] and counts.sum() == 3
    carry = sl.new_carry(3, 3, 9, "cpu")  # past the budget: no step
    sl.sweep_stop(success, overflow, lo, hi, carry)
    assert sl.read_carry(carry)[:2] == (3, 9) and int(carry[2]) == 0
    with pytest.raises(ValueError, match="only on CUDA"):
        sl.sweep_stop(success, overflow, lo, hi, carry, handle=1)


class _HostData(TorchDispatchMode):
    """Records the ops a CUDA graph cannot capture: a tensor made from
    host data (an upload: ``torch.tensor``, ``torch.from_numpy``) and a
    read of a tensor's value."""

    BAD = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
           "aten.nonzero.default", "aten.masked_select.default",
           "aten.is_nonzero.default", "aten.equal.default"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __enter__(self):
        self._from_numpy = torch.from_numpy

        def from_numpy(a):
            self.seen.append("torch.from_numpy")
            return self._from_numpy(a)

        torch.from_numpy = from_numpy
        return super().__enter__()

    def __exit__(self, *exc):
        torch.from_numpy = self._from_numpy
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in self.BAD:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _zeros_mega(cfg, *args):
    v_sent = args[-4]
    t, n = v_sent.shape
    return (torch.zeros((t, n, cfg.w), dtype=torch.int32),
            torch.zeros((t, n), dtype=torch.int32),
            torch.zeros(t, dtype=torch.bool))


def _stub_round_kernels(monkeypatch):
    """The per-round engines' kernels and the draws kernel replaced by
    stubs that return outputs of the kernels' shapes, as a launch does
    (their plain versions read the host on purpose: ``nonzero``)."""
    from qba_tpu_torch.ops import round_kernel as rk
    from qba_tpu_torch.ops import round_kernel_tiled as rt
    from qba_tpu_torch.rounds import engine

    def ovf(vi):
        return torch.zeros(vi.shape[:-2], dtype=torch.bool)

    def fused(cfg, r, pool, li, vi, hc, a, rv, late, out=None, **k):
        return (out if out is not None else pool), vi, ovf(vi)

    def verdict(cfg, r, pool, li, vi, hc, a, rv, late, **k):
        return torch.zeros(a.shape[:2], dtype=torch.int64), vi

    def rebuild(cfg, r, pool, li, acc, hc, a, rv, out=None, **k):
        return (out if out is not None else pool), torch.zeros(
            acc.shape[0], dtype=torch.bool)

    def draws(cfg, k_rounds, ctx, r0, n_r, **k):
        shape = (k_rounds.shape[0], n_r, cfg.n_lieutenants * cfg.slots,
                 cfg.n_lieutenants)
        return tuple(torch.zeros(shape, dtype=torch.uint8) for _ in "abc")

    monkeypatch.setattr(rt, "fused_round", fused)
    monkeypatch.setattr(rk, "round_step", fused)
    monkeypatch.setattr(rt, "tiled_verdict", verdict)
    monkeypatch.setattr(rt, "tiled_rebuild", rebuild)
    monkeypatch.setattr(engine, "attack_draws", draws)


@pytest.mark.parametrize("kw", [{}, dict(strategy="adaptive"),
                                dict(strategy="split"),
                                dict(p_depolarize=0.05, delivery="racy",
                                     p_late=0.25),
                                dict(qsim_path="stabilizer"),
                                dict(qsim_path="stabilizer", mega_gen="host",
                                     p_depolarize=0.05, p_measure_flip=0.02),
                                dict(round_engine="pallas_fused"),
                                dict(round_engine="pallas"),
                                dict(round_engine="pallas_tiled",
                                     strategy="adaptive"),
                                dict(round_engine="xla"),
                                dict(round_engine="pallas_fused",
                                     collect_counters=True,
                                     qsim_path="stabilizer"),
                                dict(round_engine="pallas",
                                     collect_counters=True, delivery="racy",
                                     p_late=0.25),
                                dict(round_engine="pallas_fused",
                                     qsim_path="dense", n_parties=3,
                                     size_l=8),
                                dict(round_engine="pallas_fused",
                                     qsim_path="dense_pallas", n_parties=3,
                                     size_l=8, p_depolarize=0.05)])
def test_chunk_step_is_capturable(kw, monkeypatch):
    # Every engine and list path the card runs, the kernels stubbed (the
    # keyed megakernel, on the stabilizer path its gen entry or the sweep
    # and the host-gen megakernel; the per-round kernels and the draws
    # kernel; the circuit kernel on dense_pallas): after the graph loop's
    # preparation (the per-config tables, from empty caches), the sweep's
    # chunk, the serving worker's prefix chunk and a device surface's
    # branch must stay on the device, and so must the surface's pick and
    # fold on their launch path (the library and the stream stubbed).
    import types

    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.ops import gf2_sweep as gs
    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.qsim import protocol_circuits as pc
    from qba_tpu_torch.qsim import statevector as sv
    from qba_tpu_torch.qsim.circuit import Circuit

    cfg = dataclasses.replace(CFG, **{"round_engine": "pallas_mega", **kw})
    monkeypatch.setattr(tm, "trial_megakernel_keyed", _zeros_mega)
    monkeypatch.setattr(tm, "trial_megakernel_gen_keyed", _zeros_mega)
    monkeypatch.setattr(gs, "gf2_sweep", lambda n, xw, zw, r, *a, **k:
                        torch.zeros((r.shape[0], n), dtype=torch.int32))
    monkeypatch.setattr(sl, "sweep_stop", lambda *a, **k: None)
    _stub_round_kernels(monkeypatch)
    if cfg.qsim_path == "dense_pallas":
        monkeypatch.setattr(Circuit, "resolve_auto_impl",
                            lambda self, device=None: "pallas")
        monkeypatch.setattr(fc, "fused_circuit", lambda tables, params:
                            torch.ones((params.shape[0],
                                        1 << tables.n_qubits)))
    for cache in (pc._gen_tables, pc._operand_tables, pc._sweep_tables,
                  pc._dense_states):
        cache.cache_clear()
    monkeypatch.setattr(sv, "_ON_DEVICE", {})
    sl.prepare_capture(cfg, "cpu")
    carry = sl.new_carry(4, 1, 0, "cpu")
    lo, hi = (torch.zeros(5, dtype=torch.int32) for _ in "ab")
    root = psweep.jr.key(cfg.seed, "cpu")
    keys = psweep.jr.split(root, 4 * CT)
    succ = torch.zeros(4 * CT, dtype=torch.bool)
    offsets = torch.arange(CT)
    layout = su.SurfaceLayout(3, 4, 5)
    s_carry = su.new_surface_carry(layout, [0, 3, 9], [0, 1, 2], [0, 0, 1],
                                   "cpu")
    s_carry[su.I_CUR] = 2
    slot = torch.zeros((2, CT), dtype=torch.bool)
    ci = torch.zeros((2, 3), dtype=torch.float32)
    launched = []
    lib = types.SimpleNamespace(
        qba_surface_pick=lambda *a: launched.append("pick") or 0,
        qba_surface_fold=lambda *a: launched.append("fold") or 0)
    monkeypatch.setattr(su, "dispatch", lambda name, tensors: True)
    monkeypatch.setattr(su, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    for fn in (su.surface_pick, su.surface_fold):
        monkeypatch.setattr(fn, "launches", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", QBADemotionWarning)
        with _HostData() as mode:
            sl.chunk_step(cfg, CT, root, carry, lo, hi)
            sl.prefix_step(cfg, CT, keys, offsets, carry, lo, hi, succ)
            su.branch_step(cfg, CT, root, s_carry, slot)
            su.surface_pick(s_carry, ci, layout, CT, 0.95, 0.5, handle=7)
            su.surface_fold(slot[0], slot[1], lo, hi, s_carry, layout,
                            handle=9)
    assert mode.seen == []
    assert launched == ["pick", "fold"]


# The dense paths' config: 3p/L8/d1 (8 qubits), with a target that
# stops at chunk 3 of the budget.
DENSE_CFG = dataclasses.replace(CFG, n_parties=3, size_l=8)
DENSE_TARGET = "ci_width<=0.3"


@pytest.fixture(scope="module")
def jax_dense_loop():
    """JAX's device loop on ``qsim_path="dense"`` at ``DENSE_CFG``,
    compiled at XLA's lowest optimisation level (its lists equal
    ``dense_pallas``'s)."""
    from tests.test_torch_draws import FAST_COMPILE

    real = jsweep._device_loop_foldin

    def fast(cfg, n, ct, carry, lo, hi):
        return real.lower(cfg, n, ct, carry, lo, hi).compile(FAST_COMPILE)(
            carry, lo, hi)

    jcfg = JConfig(**{**KW, "n_parties": 3, "size_l": 8}, trials=CT,
                   qsim_path="dense")
    jsweep._device_loop_foldin = fast
    try:
        return j_run_sweep(jcfg, BUDGET, CT, target=DENSE_TARGET,
                           dispatch="device")
    finally:
        jsweep._device_loop_foldin = real


@pytest.mark.parametrize("kw", [dict(qsim_path="dense"),
                                dict(qsim_path="dense_pallas"),
                                dict(round_engine="pallas_fused"),
                                dict(collect_counters=True),
                                dict(round_engine="pallas"),
                                dict(round_engine="pallas_tiled"),
                                dict(round_engine="xla"),
                                dict(round_engine="pallas_mega",
                                     collect_counters=True)])
def test_graph_loop_refuses_uncapturable_chunks(kw, monkeypatch, jax_loops,
                                                jax_dense_loop):
    # These configs were refused before any capture (ROADMAP A14); the
    # graph loop now runs every engine and list path, and its plain form
    # equals JAX's device loop chunk for chunk and stop for stop:
    # ``dense_pallas`` on the circuit kernel's plain version, every
    # per-round engine on its kernels' plain versions, the counters on
    # the fused round (``pallas_mega`` demotes to it, as on the card).
    from qba_tpu_torch.qsim.circuit import Circuit

    if kw.get("qsim_path") == "dense_pallas":
        monkeypatch.setattr(Circuit, "resolve_auto_impl",
                            lambda self, device=None: "pallas")
    if "qsim_path" in kw:
        cases = [(DENSE_CFG, DENSE_TARGET, jax_dense_loop)]
    else:
        cases = [(CFG, spec, jax_loops[spec][1]) for spec in TARGETS]
    for base, spec, want in cases:
        cfg = dataclasses.replace(base, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", QBADemotionWarning)
            got = p_run_sweep(cfg, BUDGET, CT, target=spec,
                              dispatch="device")
        assert got.dispatch == "device"
        assert chunk_tuples(got) == chunk_tuples(want), (kw, spec)
        assert got.stop.to_json() == want.stop.to_json(), (kw, spec)


def test_dense_lists_select_one_sample_per_position(monkeypatch):
    # The dense list generation has no data-dependent shape: every
    # position's state is picked by torch.where and sampled once, on its
    # key (one Born sample per position, not one per family).
    from qba_tpu_torch.qsim import protocol_circuits as pc
    from qba_tpu_torch.qsim import statevector as sv

    keys = psweep.chunk_keys(DENSE_CFG, 0, CT, "cpu")
    want, qcorr = pc.generate_lists_dense(DENSE_CFG, keys)
    sampled = []
    real = sv.measure_all
    monkeypatch.setattr(sv, "measure_all", lambda state, k: sampled.append(
        k.shape[0]) or real(state, k))
    with _HostData() as mode:
        got, got_q = pc.generate_lists_dense(DENSE_CFG, keys)
    assert mode.seen == []
    assert sum(sampled) == qcorr.numel() == CT * DENSE_CFG.size_l
    assert torch.equal(got, want) and torch.equal(got_q, qcorr)


def test_events_list_refused_while_capturing(monkeypatch):
    # A wrapper whose events is a list would record an event node in the
    # capture; the launch is refused before anything runs.
    import types

    from qba_tpu_torch.ops import _launch

    def wrapper():
        pass

    wrapper.launches, wrapper.events = 0, []
    ran = []
    stream = types.SimpleNamespace(cuda_stream=0, device=None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="events is a list while a CUDA "
                       "graph is being captured"):
        _launch.timed_launch(wrapper, lambda s: ran.append(s) or 0, [],
                             stream)
    assert ran == [] and wrapper.launches == 0 and wrapper.events == []


def test_sweep_stop_reference_stores_success_bits():
    # With succ_out the chunk's bits land at rows carry[0] * T; the carry
    # is what it is without; past the budget nothing is stored.
    success = torch.tensor([True, False, True, True, False])
    overflow = torch.zeros(5, dtype=torch.bool)
    lo = torch.full((4,), -1, dtype=torch.int32)
    hi = torch.full((4,), 99, dtype=torch.int32)
    for start in range(4):
        succ = torch.zeros(15, dtype=torch.bool)
        plain = sl.new_carry(3, start, 2, "cpu")
        got = sl.new_carry(3, start, 2, "cpu")
        sl.sweep_stop_reference(success, overflow, lo, hi, plain)
        sl.sweep_stop(success, overflow, lo, hi, got, succ_out=succ)
        assert torch.equal(got, plain)
        want = torch.zeros(15, dtype=torch.bool)
        if start < 3:
            want[start * 5:(start + 1) * 5] = success
        assert torch.equal(succ, want), start


def test_device_loop_prefix_equals_host_chunks():
    # The plain prefix loop over pre-assigned keys: chunk i runs rows
    # [i * CT, (i + 1) * CT), its bits and counts equal that batch's.
    from qba_tpu_torch.stats import parse_target, stop_tables

    keys = psweep.jr.split(psweep.jr.key(7, "cpu"), BUDGET * CT)
    lo, hi = stop_tables(parse_target(TARGETS[0]), BUDGET, CT)
    i_stop, counts, ovf, succ, info = sl.device_loop_prefix(
        CFG, BUDGET, CT, keys, lo, hi, "cpu")
    assert 0 < i_stop <= BUDGET and info["readbacks"] == i_stop
    want = run_chunk_outcomes(CFG, keys[:i_stop * CT])[0].numpy()
    np.testing.assert_array_equal(succ[:i_stop * CT], want)
    assert not succ[i_stop * CT:].any()
    assert counts[:i_stop].tolist() == [
        int(want[c * CT:(c + 1) * CT].sum()) for c in range(i_stop)]
