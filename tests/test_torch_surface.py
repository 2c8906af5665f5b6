"""The port's device surface, run manifests and ``sweep``/``study``
subcommands equal the JAX package's.

On the CPU (``device="cpu"``) the port's device surface is its plain
loop: :func:`~qba_tpu_torch.ops.surface_loop.surface_pick_reference`, the
chosen cell's chunk as a call and
:func:`~qba_tpu_torch.ops.surface_loop.surface_fold_reference` a pass.
For the config of ``tests/test_device_loop.py::TestDeviceSurface``
(5p/L16/d1, chunks of 8 trials, ``decide vs 1/3 @ 95%``) on a grid of
two strategies x two noise points x one ``sizeL`` (budget 6, which runs
out before every cell resolves) and on that test's own grid (one
strategy and noise point, ``size_ls=[8, 16]``, budget 8):

* ``device_ci_interval`` equals JAX's on a grid of totals;
* the port's ``run_surface(dispatch="device")`` equals JAX's on the
  first grid: per-cell chunks and stop, the allocator's spent chunks,
  each cell's chunks run and decision, and the schedule step by step
  (where the two best scores of a step lie within 1e-4 the two orders
  are both right: float32 widths order near-tied cells, and the test
  then accepts either); on both grids it equals the port's host
  allocator cell by cell;
* the plain pick and fold on hand-built carries: ties, done cells,
  bootstrap order, width targets, and stops at the tables' edges;
* a device surface resumes from per-cell checkpoints the other package
  wrote, and ends equal to an uninterrupted run;
* every cell's manifest, on both surface paths, passes both packages'
  validators, and its ``stats`` block equals JAX's;
* ``python -m qba_tpu_torch sweep`` and ``study`` print JAX's lines, and
  ``--telemetry`` writes the three files (``sweep`` with ``jax``,
  ``flax`` and ``qba_tpu`` blocked runs in
  ``tests/test_torch_e2e.py::test_port_runs_with_jax_blocked``).

Each JAX surface is run once, in a module-scoped fixture.  JAX's threefry
mode is set only inside ``jax.threefry_partitionable(True)``.
"""

import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import cli as jcli
from qba_tpu import sweep as jsweep
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.obs.manifest import validate_manifest as j_validate_manifest
from qba_tpu.stats.device import device_ci_interval as j_device_ci_interval
from qba_tpu_torch import cli as pcli
from qba_tpu_torch import sweep as psweep
from qba_tpu_torch.convert import config_from_jax_fields
from qba_tpu_torch.obs.manifest import validate_manifest
from qba_tpu_torch.ops import surface_loop as su
from qba_tpu_torch.ops.sweep_loop import GraphLoopUnsupported
from qba_tpu_torch.stats.device import device_ci_interval

DECIDE = "decide vs 1/3 @ 95%"
JCFG = JConfig(n_parties=5, size_l=16, n_dishonest=1, trials=8, seed=3)
CFG = config_from_jax_fields(dataclasses.asdict(JCFG))
CT = 8
# name -> (grid, budget chunks).
GRIDS = {
    "sizes": ((["reference"], [(0.0, 0.0)], [8, 16]), 8),
    "strategies_noise": ((["reference", "split"],
                          [(0.0, 0.0), (0.05, 0.02)], [16]), 6),
}
# Scores of one step closer than this are a near-tie: float32 widths may
# order the two cells either way.
NEAR_TIE = 1e-4

def j_surface(name, **kw):
    # JAX's host path on its default runner (chunks of 8 dp-sharded over
    # the test process's eight virtual CPU devices): in one process the
    # CLI's sweeps below reuse its compiled program.
    grid, budget = GRIDS[name]
    kw.setdefault("budget_chunks", budget)
    with jax.threefry_partitionable(True):
        return jsweep.run_surface(JCFG, *grid, chunk_trials=CT,
                                  target=DECIDE, **kw)


def p_surface(name, **kw):
    grid, budget = GRIDS[name]
    kw.setdefault("budget_chunks", budget)
    return psweep.run_surface(CFG, *grid, chunk_trials=CT, target=DECIDE,
                              device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_device():
    return j_surface("strategies_noise", dispatch="device")


@pytest.fixture(scope="module")
def jax_host():
    return j_surface("sizes")


def chunk_tuples(res):
    return [(c.chunk, c.trials, c.successes, c.overflow) for c in res.chunks]


def alloc_of(cells):
    return cells[0].manifest["stats"]["allocator"]


def scores(trace, cells):
    """The device's float32 score of every cell at each step of
    ``trace``, from the chunks each cell had run by then."""
    counts = [[c.successes for c in cell.result.chunks] for cell in cells]
    done_at = [len(cell.result.chunks) if cell.result.stop.reason
               .startswith("decided") else None for cell in cells]
    ran = [0] * len(cells)
    out = []
    for step in trace:
        out.append(su.surface_scores(
            torch.tensor([sum(c[:r]) for c, r in zip(counts, ran)]),
            torch.tensor(ran),
            torch.tensor([d is not None and r >= d
                          for d, r in zip(done_at, ran)]),
            CT, 0.95, 1 / 3)[0])
        ran[step["cell"]] += 1
    return out


def assert_schedules_agree(got, want, cells):
    """Equal step for step, but at a step whose two best scores (past the
    bootstraps) lie within ``NEAR_TIE``, where either order is right."""
    assert len(got) == len(want)
    for step, (g, w, s) in enumerate(zip(got, want, scores(want, cells))):
        if g["cell"] != w["cell"]:
            # Not a bootstrap (index order on both sides) nor a done cell.
            a, b = torch.sort(s).values[:2].tolist()
            assert 2.0 <= a and b < 1e9 and b - a <= NEAR_TIE, (step, g, w)
            return
        assert (g["label"], g["reason"]) == (w["label"], w["reason"]), step


def test_device_ci_interval_equals_jax():
    # JAX's gammaln and torch's lgamma differ by a few float32 ulps (about
    # 4e-3 for lgamma near 5e4 at n = 16000), and each mixture evaluation
    # inherits that before the bisections settle on the crossing: the
    # endpoints agree to 2.4e-6 on this grid, held at 2e-5.  The ends that
    # take no bisection (n == 0, k == 0 or k == n, where the mixture stays
    # under crit to the edge) are exact.
    ks, ns = [], []
    for n in (0, 8, 64, 1000, 16000):
        for k in sorted({0, 1, n // 3, n // 2, n}):
            if k <= n:
                ks.append(k)
                ns.append(n)
    ks, ns = np.array(ks, np.int32), np.array(ns, np.int32)
    for confidence in (0.9, 0.95):
        want = jax.jit(jax.vmap(
            lambda k, n: j_device_ci_interval(k, n, confidence)))(ks, ns)
        got = device_ci_interval(torch.from_numpy(ks), torch.from_numpy(ns),
                                 confidence)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=2e-5)
        assert got[0][ns == 0].tolist() == [0.0]
        assert got[1][ns == 0].tolist() == [1.0]
        for g, w, edge in zip(got, want, (0.0, 1.0)):
            at_edge = np.asarray(w) == edge
            assert at_edge.sum() >= 5
            np.testing.assert_array_equal(g.numpy()[at_edge],
                                          np.asarray(w)[at_edge])


def test_device_surface_equals_jax(jax_device):
    got = p_surface("strategies_noise", dispatch="device")
    assert len(got) == len(jax_device) == 4
    for g, w in zip(got, jax_device):
        assert (g.strategy, g.p_depolarize, g.size_l) == (
            w.strategy, w.p_depolarize, w.size_l)
        assert chunk_tuples(g.result) == chunk_tuples(w.result)
        assert g.result.stop.to_json() == w.result.stop.to_json()
        assert g.result.dispatch == "device"
    ga, wa = alloc_of(got), alloc_of(jax_device)
    assert ga["spent_chunks"] == wa["spent_chunks"] == 6
    assert ga["cells"] == wa["cells"]
    assert_schedules_agree(ga["trace"], wa["trace"], jax_device)
    reasons = {c.result.stop.reason for c in got}
    assert reasons == {"decided_above", "budget_exhausted"}
    # Every cell's manifest passes both validators, its stats block JAX's.
    assert_manifests_equal(got, jax_device)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_device_surface_equals_host_allocator(name):
    # As JAX's TestDeviceSurface asserts for its own pair: the same
    # per-cell work, decisions and budget.
    got = p_surface(name, dispatch="device")
    host = p_surface(name)
    for g, h in zip(got, host):
        assert chunk_tuples(h.result) == chunk_tuples(g.result)
        assert h.result.stop.to_json() == g.result.stop.to_json()
        assert (g.result.dispatch, h.result.dispatch) == ("device", "host")
    ga, ha = alloc_of(got), alloc_of(host)
    assert ga["spent_chunks"] == ha["spent_chunks"]
    assert [c["chunks_run"] for c in ha["cells"]] == [
        c["chunks_run"] for c in ga["cells"]]
    assert_schedules_agree(ga["trace"], ha["trace"], host)


def _carry(k, i, done, budget=4, steps=3, step=0):
    layout = su.SurfaceLayout(len(k), budget, steps)
    carry = su.new_surface_carry(layout, k, i, done, "cpu")
    carry[su.STEP] = step
    ci = torch.zeros((2, len(k)), dtype=torch.float32)
    return layout, carry, ci


def _pick(k, i, done, threshold=0.5, **kw):
    layout, carry, ci = _carry(k, i, done, **kw)
    su.surface_pick_reference(carry, ci, layout, 10, 0.95, threshold)
    out = su.read_surface_carry(layout, carry)
    return out["chosen"], out["tier"][out["step"]], ci


def test_surface_pick_reference_rules():
    # Ties go to the first index: three cells at the same totals.
    assert _pick([5, 5, 5], [1, 1, 1], [0, 0, 0])[:2] == (0, 1)
    # A done cell is never chosen, not even a bootstrap one.
    assert _pick([5, 5, 5], [1, 1, 1], [1, 0, 0])[0] == 1
    assert _pick([0, 5, 5], [0, 1, 1], [1, 0, 0])[:2] == (1, 1)
    # Bootstrap cells come first, in index order.
    assert _pick([5, 0, 0], [1, 0, 0], [0, 0, 0])[:2] == (1, 0)
    assert _pick([5, 0, 0], [1, 0, 0], [0, 1, 0])[:2] == (2, 0)
    # Straddling (tier 1) before undecided (tier 2), widest first: cell 1
    # (k = 30 of 40, interval above 0.5) is undecided, cells 0 and 2
    # straddle and cell 2 (fewer trials) is wider.
    chosen, tier, ci = _pick([20, 30, 5], [4, 4, 1], [0, 0, 0])
    assert (chosen, tier) == (2, 1)
    assert ci[0, 1] > 0.5 and ci[0, 0] < 0.5 < ci[1, 0]
    # With no threshold (a width target) every open cell straddles: the
    # widest interval wins whatever its totals.
    assert _pick([20, 30, 5], [4, 4, 1], [0, 0, 0], threshold=None)[:2] == (
        2, 1)
    assert _pick([30, 20], [4, 4], [0, 0], threshold=None)[0] == 1
    # The tier lands at the carry's step; past the steps nothing is stored.
    layout, carry, ci = _carry([1, 0], [1, 0], [0, 0], step=2)
    su.surface_pick_reference(carry, ci, layout, 10, 0.95, 0.5)
    assert su.read_surface_carry(layout, carry)["tier"].tolist() == [0, 0, 0]
    layout, carry, ci = _carry([1, 0], [1, 0], [0, 0], step=3)
    before = carry.clone()
    su.surface_pick_reference(carry, ci, layout, 10, 0.95, 0.5)
    assert torch.equal(carry[layout.section("tier")],
                       before[layout.section("tier")])
    with pytest.raises(ValueError, match="only on CUDA"):
        su.surface_pick(carry, ci, layout, 10, 0.95, 0.5, handle=1)


@pytest.mark.parametrize("k_chunk,stopped", [(2, True), (3, False),
                                             (6, False), (7, True),
                                             (1, True), (8, True)])
def test_surface_fold_reference_stops_at_table_edges(k_chunk, stopped):
    # Cell 1 (4 successes in 1 chunk) folds its second chunk: the tables
    # at i = 2 fire at k <= 6 and k >= 11, so a chunk of 2 lands on the
    # lower edge, 3 one above it, 6 one below the upper edge, 7 on it.
    lo = torch.tensor([-1, 2, 6, 9, 12], dtype=torch.int32)
    hi = torch.tensor([1, 9, 11, 15, 20], dtype=torch.int32)
    layout, carry, _ci = _carry([3, 4, 0], [1, 1, 0], [0, 0, 1], steps=3,
                                step=1)
    carry[su.CHOSEN], carry[su.I_CUR] = 1, 1
    success = torch.arange(10) < k_chunk
    overflow = torch.arange(10) == 9
    su.surface_fold_reference(success, overflow, lo, hi, carry, layout)
    out = su.read_surface_carry(layout, carry)
    assert (out["k"][1], out["i"][1], out["done"][1]) == (4 + k_chunk, 2,
                                                          stopped)
    assert out["counts"][1].tolist() == [0, k_chunk, 0, 0]
    assert out["ovf"][1].tolist() == [False, True, False, False]
    assert (out["step"], out["sched"][1]) == (2, 1)
    # The loop goes on while a step is left and a cell is open: cell 0
    # is still open here.
    assert out["flag"]
    # The last step clears the flag; so does every cell done.
    layout, carry, _ci = _carry([3, 4, 0], [1, 1, 0], [1, 0, 1], steps=2,
                                step=0)
    carry[su.CHOSEN], carry[su.I_CUR] = 1, 1
    su.surface_fold_reference(success, overflow, lo, hi, carry, layout)
    assert bool(carry[su.FLAG]) == (not stopped)
    # A step past the steps stores nothing.
    layout, carry, _ci = _carry([3, 4, 0], [1, 1, 0], [0, 0, 1], steps=2,
                                step=2)
    carry[su.CHOSEN], carry[su.I_CUR] = 1, 1
    before = carry.clone()
    su.surface_fold_reference(success, overflow, lo, hi, carry, layout)
    assert not bool(carry[su.FLAG])
    carry[su.FLAG] = before[su.FLAG]
    assert torch.equal(carry, before)


def test_device_surface_resumes_from_jax_checkpoints(tmp_path, jax_host):
    # JAX's host allocator writes per-cell checkpoints (budget 3: both
    # bootstraps and one more chunk); the port's device surface resumes
    # them and ends where an uninterrupted run ends.
    ckpt = str(tmp_path / "ckpt")
    part = j_surface("sizes", budget_chunks=3, checkpoint_dir=ckpt)
    got = p_surface("sizes", dispatch="device", checkpoint_dir=ckpt)
    assert [c.result.resumed_chunks for c in got] == [
        len(c.result.chunks) for c in part]
    for g, w in zip(got, jax_host):
        assert chunk_tuples(g.result) == chunk_tuples(w.result)
        assert g.result.stop.to_json() == w.result.stop.to_json()
    assert alloc_of(got)["spent_chunks"] == alloc_of(jax_host)["spent_chunks"]
    assert [t["reason"] for t in alloc_of(got)["trace"]][:3] == ["resume"] * 3


def test_jax_device_surface_resumes_from_port_checkpoints(tmp_path):
    # The other way round: the port writes (budget 2, the bootstraps),
    # JAX's device surface resumes, and ends where the port's
    # uninterrupted device surface ends.
    ckpt = str(tmp_path / "ckpt")
    p_surface("sizes", budget_chunks=2, checkpoint_dir=ckpt)
    resumed = j_surface("sizes", dispatch="device", checkpoint_dir=ckpt)
    whole = p_surface("sizes", dispatch="device")
    assert [c.result.resumed_chunks for c in resumed] == [1, 1]
    for r, w in zip(resumed, whole):
        assert chunk_tuples(r.result) == chunk_tuples(w.result)
        assert r.result.stop.to_json() == w.result.stop.to_json()
    with open(os.path.join(ckpt, os.listdir(ckpt)[0])) as f:
        assert json.load(f)["stats"]["dispatch"] == "device"


STATS_KEYS = ("target", "allocator", "dispatch", "stop", "n_trials")


def assert_manifests_equal(got, want):
    for g, w in zip(got, want):
        validate_manifest(g.manifest)
        j_validate_manifest(json.loads(json.dumps(g.manifest)))
        assert g.manifest["command"] == w.manifest["command"] == "surface"
        assert g.manifest["config"] == w.manifest["config"]
        gs, ws = g.manifest["stats"], w.manifest["stats"]
        assert {k: gs[k] for k in STATS_KEYS} == {k: ws[k] for k in STATS_KEYS}


def test_surface_manifests_validate_and_equal_jax(jax_host):
    # The host surface's manifests (the device surface's are checked
    # beside its results, above); the default is with manifests, and
    # without them every cell's is None.
    assert_manifests_equal(p_surface("sizes"), jax_host)
    for dispatch in ("host", "device"):
        assert all(c.manifest is None
                   for c in p_surface("sizes", dispatch=dispatch,
                                      with_manifest=False))


def test_uniform_surface_manifests():
    grid = GRIDS["sizes"][0]
    cells = psweep.run_surface(CFG, *grid, n_chunks=2, chunk_trials=CT,
                               device="cpu")
    for cell in cells:
        validate_manifest(cell.manifest)
        j_validate_manifest(json.loads(json.dumps(cell.manifest)))
        assert cell.manifest["stats"] == cell.result.stats_summary()
        assert cell.manifest["config"]["size_l"] == cell.size_l


def test_device_surface_refuses_uncapturable_grids(monkeypatch):
    # Every cell is checked before anything runs, on every device.
    def forbidden(*a, **k):
        raise AssertionError("ran before the intake check")

    monkeypatch.setattr(su, "device_surface_loop", forbidden)
    monkeypatch.setattr(psweep, "run_chunk", forbidden)
    grid = GRIDS["sizes"][0]
    for kw in (dict(qsim_path="dense"), dict(round_engine="pallas_fused")):
        with pytest.raises(GraphLoopUnsupported, match="A14"):
            psweep.run_surface(dataclasses.replace(CFG, **kw), *grid,
                               target=DECIDE, dispatch="device",
                               device="cpu")


def test_check_driver_refuses_a_driver_without_switch(monkeypatch):
    # The graph's SWITCH node needs a CUDA 12.8 driver: an older one is
    # refused at intake, naming its version.
    monkeypatch.setattr(su, "versions", lambda device: (12040, 12090))
    with pytest.raises(GraphLoopUnsupported, match="12.8 or later.*12.4"):
        su.check_driver("cuda")
    monkeypatch.setattr(su, "versions", lambda device: (13000, 12090))
    assert su.check_driver("cuda") == 13000


def test_device_surface_record(monkeypatch):
    # On the CPU the loop reads the chosen cell and the flag back a pass.
    records = []
    real = su.device_surface_loop

    def spy(*a, **k):
        out, info = real(*a, **k)
        records.append(info)
        return out, info

    monkeypatch.setattr(su, "device_surface_loop", spy)
    cells = p_surface("sizes", dispatch="device")
    (info,) = records
    spent = alloc_of(cells)["spent_chunks"]
    assert info == dict(dispatch="plain", readbacks=spent, passes=spent)


# --- the command line ------------------------------------------------------

# The config of the surfaces' cell at size_l=16.
CLI_BASE = ["--n-parties", "5", "--size-l", "16", "--n-dishonest", "1",
            "--trials", "8", "--seed", "3"]
CLI_TARGET = "decide vs 0.9 +-0.05"
CLI_SWEEPS = {
    "fixed": ["--n-chunks", "3"],
    "target_host": ["--n-chunks", "6", "--target", CLI_TARGET],
    "target_device": ["--n-chunks", "6", "--target", CLI_TARGET,
                      "--dispatch", "device"],
}


def cli_lines(main, argv, jax_side):
    out = io.StringIO()
    if jax_side:
        with jax.threefry_partitionable(True):
            rc = main(argv, out=out)
    else:
        rc = main([*argv, "--device", "cpu"], out=out)
    assert rc == 0
    # The throughput line is a wall-clock rate, and JAX's runner says how
    # it laid the chunk over the test process's eight virtual CPU devices.
    return [ln for ln in out.getvalue().splitlines()
            if not ln.startswith("throughput:")
            and "device count" not in ln and "dp-sharded" not in ln]


@pytest.mark.parametrize("variant", sorted(CLI_SWEEPS))
def test_cli_sweep_prints_jax_lines(variant):
    argv = ["sweep", *CLI_BASE, *CLI_SWEEPS[variant]]
    got = cli_lines(pcli.main, argv, False)
    assert got == cli_lines(jcli.main, argv, True)
    if variant == "fixed":
        assert "success rate: 0.8333" in got
    else:
        assert got[-1].startswith("stop: decided_below after 32 trials")


def test_cli_study_prints_jax_lines():
    argv = ["study", "--n-parties", "3", "--size-l", "4", "--n-dishonest",
            "1", "--trials", "12", "--seed", "3", "--param", "size_l",
            "--values", "4,8"]
    got = cli_lines(pcli.main, argv, False)
    assert got == cli_lines(jcli.main, argv, True)
    assert got[0].startswith("size_l=4: success_rate=")
    assert any(ln.startswith("  validity (honest commander):") for ln in got)


def test_cli_sweep_telemetry(tmp_path):
    out = io.StringIO()
    rc = pcli.main(["sweep", *CLI_BASE, *CLI_SWEEPS["target_device"],
                    "--device", "cpu", "--telemetry", str(tmp_path)], out=out)
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["run_manifest.json",
                                            "spans.jsonl", "trace.json"]
    with open(tmp_path / "run_manifest.json") as f:
        manifest = json.load(f)
    validate_manifest(manifest)
    j_validate_manifest(manifest)
    assert manifest["command"] == "sweep"
    assert manifest["stats"]["dispatch"] == "device"
    assert manifest["stats"]["stop"]["reason"] == "decided_below"
    assert "device_loop" in manifest["phase_totals"]
    with open(tmp_path / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    # --plot without matplotlib, or a bad target: a clean usage error.
    rc = pcli.main(["sweep", *CLI_BASE, "--n-chunks", "1", "--device", "cpu",
                    "--target", "nonsense"], out=io.StringIO())
    assert rc == 2
