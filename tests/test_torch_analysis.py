"""The port's invariant checker (``qba_tpu_torch.analysis``, ``python -m
qba_tpu_torch lint``) against the JAX package's (``qba_tpu.analysis``).

The same inputs go through both packages:

* KI-10: the protocol model explores the same states with the same
  verdicts; the seeded fixtures give the same findings; the port's
  conformance sweep binds all nine sites;
* KI-8: the same manifests give the same findings;
* KI-11: a store written by the port's campaign driver, and a tampered
  copy, give the same findings;
* KI-12 and KI-6's AST half: the seeded fixtures give the same findings
  at the same lines, and the port's tree is clean;
* launches: the port's model is the JAX package's table, and at
  5p/L16/d2 its seams count JAX's ``launches_per_trial``.

Then the port's own checks, one seeded violation each (a float32 dot
past the exact range, ``gf2_matmul`` with its tile past it, a round loop
that allocates a fresh pool each round, a hot-path ``.item()``, a
shared-memory plan over budget), and the CLI: ``lint --device cpu``
exits 0 with JAX's JSON keys while ``jax``, ``flax`` and ``qba_tpu``
cannot be imported, and 1 on a finding.  Everything runs on the CPU,
with the kernels' plain versions.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import QBAConfig as JConfig
from qba_tpu.analysis import atlas as jatlas_lint
from qba_tpu.analysis import launches as jlaunches
from qba_tpu.analysis import manifests as jmanifests
from qba_tpu.analysis import obs as jobs
from qba_tpu.analysis import protocol as jprotocol
from qba_tpu.analysis import transfers as jtransfers
from qba_tpu.analysis.findings import Report as JReport
from qba_tpu_torch import QBAConfig, cli
from qba_tpu_torch import atlas as patlas
from qba_tpu_torch.analysis import atlas as patlas_lint
from qba_tpu_torch.analysis import dots as pdots
from qba_tpu_torch.analysis import effects as peffects
from qba_tpu_torch.analysis import launches as plaunches
from qba_tpu_torch.analysis import manifests as pmanifests
from qba_tpu_torch.analysis import memory as pmemory
from qba_tpu_torch.analysis import obs as pobs
from qba_tpu_torch.analysis import protocol as pprotocol
from qba_tpu_torch.analysis import trace as ptrace
from qba_tpu_torch.analysis import transfers as ptransfers
from qba_tpu_torch.analysis.findings import Report
from qba_tpu_torch.atlas import cube as pcube
from qba_tpu_torch.serve import fleet as pfleet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")


def fixture(name):
    return os.path.join(FIXTURES, name)


def ki_checks(report):
    return sorted((f.ki, f.check) for f in report.findings)


def located(report):
    return sorted((f.ki, f.check, f.where) for f in report.findings)


# ---- KI-10 -------------------------------------------------------------


def test_protocol_model_explores_the_jax_state_space():
    got = pprotocol.check_protocol_model(pprotocol.extract_semantics())
    want = jprotocol.check_protocol_model(jprotocol.extract_semantics())
    for k in ("protocol_states_explored", "protocol_transitions_explored"):
        assert got.stats[k] == want.stats[k]
    assert got.notes == want.notes
    assert got.ok and want.ok


@pytest.mark.parametrize("name", ["bad_reclaim_race.py",
                                  "bad_double_emit.py"])
def test_protocol_fixtures_match_jax(name):
    got = pprotocol.check_protocol_fixture(fixture(name))
    want = jprotocol.check_protocol_fixture(fixture(name))
    assert got.findings and [f.message for f in got.findings] == [
        f.message for f in want.findings]
    assert ki_checks(got) == ki_checks(want)


def test_port_conformance_binds_every_site():
    rep = pprotocol.check_protocol_conformance()
    assert rep.ok, rep.render()
    assert rep.stats["protocol_sites_bound"] == len(pprotocol.PROTOCOL_SITES)
    assert pprotocol.PROTOCOL_SITES == jprotocol.PROTOCOL_SITES
    assert pprotocol.check_admission_purity().ok


# ---- KI-8 --------------------------------------------------------------

MANIFESTS = {
    "bare": {"stats": {"success_rate": 0.5, "n": 10},
             "cells": [{"overflow_ratio": 0.25}]},
    "estimate": {"stats": {"success_rate": {"rate": 0.5, "lo": 0.2,
                                            "hi": 0.8}}},
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_manifest_findings_match_jax(name):
    got = pmanifests.check_manifest(MANIFESTS[name], label=name)
    want = jmanifests.check_manifest(MANIFESTS[name], label=name)
    assert located(got) == located(want)
    assert got.ok == (name == "estimate")


# ---- KI-11 -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("atlas")
    spec = pcube.CampaignSpec(parties=(4, 5), dishonest=(0.0, 1.0),
                              chunk_trials=32, budget_trials=64,
                              max_escalations=1,
                              target="decide vs 1/3 @ 95%")
    store = patlas.AtlasStore(str(root / "store"))
    summary = patlas.CampaignDriver(
        store, spec, patlas.LocalExecutor(chunk_trials=32, device="cpu"),
        admission=pfleet.AdmissionController(
            chunk_trials=32, hbm_bytes=2**40, device="cpu")).run()
    assert summary["open"] == 0
    return store


def test_atlas_store_findings_match_jax(port_store, tmp_path):
    clean = (patlas_lint.check_atlas_store(port_store.root),
             jatlas_lint.check_atlas_store(port_store.root))
    assert clean[0].ok and clean[1].ok
    assert clean[0].stats == clean[1].stats
    bad = str(tmp_path / "bad")
    shutil.copytree(port_store.root, bad)
    store = patlas.AtlasStore(bad)
    keys = sorted(json.load(open(store.ledger_path))["cells"])
    os.unlink(store.cell_path(keys[0]))
    rec = json.load(open(store.cell_path(keys[1])))
    os.unlink(store.cell_path(keys[1]))
    rec["cell_key"] = keys[0]  # filed under another cell's address
    with open(store.cell_path(keys[0]), "w") as f:
        json.dump(rec, f)
    got = patlas_lint.check_atlas_store(bad)
    want = jatlas_lint.check_atlas_store(bad)
    assert not got.ok and ki_checks(got) == ki_checks(want)
    assert [f.message for f in got.findings] == [
        f.message for f in want.findings]


# ---- KI-12 and KI-6 ----------------------------------------------------


@pytest.mark.parametrize("name", ["bad_unregistered_metric.py",
                                  "bad_orphan_span.py"])
def test_obs_fixtures_match_jax(name):
    got = pobs.check_obs_fixture(fixture(name))
    want = jobs.check_obs_fixture(fixture(name))
    assert len(got.findings) == 1 and located(got) == located(want)


def test_unfenced_sync_fixture_matches_jax():
    got, want = Report(), JReport()
    stats = dict(sync_sites_checked=0, sync_sites_fenced=0,
                 sync_sites_allowlisted=0)
    ptransfers.audit_module(fixture("bad_unfenced_sync.py"), got,
                            dict(stats))
    jtransfers.audit_module(fixture("bad_unfenced_sync.py"), want,
                            dict(stats))
    assert len(got.findings) == 1 and located(got) == located(want)


def test_port_tree_is_clean():
    transfers = ptransfers.check_transfers()
    for rep in (pobs.check_obs(), transfers, pdots.check_dot_sites()):
        assert rep.ok, rep.render()
    assert transfers.stats["sync_sites_checked"] > 0
    assert transfers.stats["dispatch_proof_obligations"] == 4


# ---- launches ----------------------------------------------------------


def test_launch_model_is_the_jax_table():
    assert set(plaunches.LAUNCH_MODEL) == set(jlaunches.LAUNCH_MODEL)
    for kw in (dict(n_parties=5, size_l=16, n_dishonest=2),
               dict(n_parties=33, size_l=64, n_dishonest=10)):
        for engine, model in plaunches.LAUNCH_MODEL.items():
            assert model(QBAConfig(**kw)) == jlaunches.LAUNCH_MODEL[engine](
                JConfig(**kw))


@pytest.mark.parametrize("engine", ["pallas_fused", "pallas_tiled",
                                    "pallas_mega"])
def test_seams_count_jax_launches_per_trial(engine):
    kw = dict(n_parties=5, size_l=16, n_dishonest=2)
    with jax.threefry_partitionable(True):
        want = jlaunches.launches_per_trial(JConfig(**kw), engine)
    rec = ptrace.trace_batch("5p", QBAConfig(**kw), engine, "cpu")
    kernels = {k: v for k, v in rec.seams.items() if k != "attack_draws"}
    assert sum(kernels.values()) == want
    assert dict(rec.seams) == plaunches.batch_launch_model(
        QBAConfig(**kw), engine, "cpu")


def test_trace_batch_enters_its_context_around_the_batch():
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    seen = []

    @contextlib.contextmanager
    def within():
        seen.append("in")
        yield
        seen.append("out")

    ptrace.reset()
    first = ptrace.trace_batch("5p", cfg, "pallas_fused", "cpu", 4)
    again = ptrace.trace_batch("5p", cfg, "pallas_fused", "cpu", 4,
                               within=within())
    assert again is not first and seen == ["in", "out"]
    assert again.seams == first.seams
    assert ptrace.trace_batch("5p", cfg, "pallas_fused", "cpu", 4) is again


def test_a_batch_that_raises_is_one_finding(monkeypatch):
    from qba_tpu_torch.analysis.driver import run_lint
    from qba_tpu_torch.rounds import engine

    def broken(cfg, keys):
        raise RuntimeError("seeded")

    monkeypatch.setattr(engine, "run_trial", broken)
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    want = ["traced-batch"]
    ptrace.reset()
    for rep in (peffects.check_effects("5p", cfg, ["pallas_fused"], "cpu", 4),
                plaunches.check_launches("5p", cfg, ["pallas_fused"], "cpu",
                                         4)):
        assert [f.check for f in rep.findings] == want
        assert "seeded" in rep.findings[0].message
    rep = run_lint([("5p", cfg)], engines=["pallas_fused"], effects=True,
                   device="cpu")
    assert [f.check for f in rep.findings if f.ki == "KI-5"] == want


# ---- the port's own checks, seeded --------------------------------------


def test_float32_dot_of_large_ids_is_a_finding():
    ones = torch.ones(8, 1)
    for base, bad in ((0, False), (2**24, True)):
        ids = torch.arange(base, base + 8, dtype=torch.float32)[None]
        rec = ptrace.record(lambda: torch.matmul(ids, ones), "ids")
        assert rec.dots[0].integral and rec.dots[0].k == 8
        rep = pdots.check_dots(rec.dots)
        assert [f.check for f in rep.findings] == ["exact-dot"] * bad


def test_gf2_matmul_past_its_tile_is_a_finding(monkeypatch):
    from qba_tpu_torch.gf2 import linalg

    k = 2**24 + 1
    monkeypatch.setattr(linalg, "GF2_TILE_K", k)
    a = torch.ones((1, k), dtype=torch.uint8)
    rec = ptrace.record(lambda: linalg.gf2_matmul(a, a.T, tile_k=k), "gf2")
    rep = pdots.check_dots(rec.dots)
    assert [f.check for f in rep.findings] == ["exact-dot"]
    assert rep.findings[0].where.startswith("qba_tpu_torch/gf2/linalg.py:")
    ok = ptrace.record(lambda: linalg.gf2_matmul(a[:, :4096], a[:, :4096].T),
                       "gf2")
    assert pdots.check_dots(ok.dots).ok


def test_fresh_pool_each_round_is_a_finding(monkeypatch):
    from qba_tpu_torch.rounds import engine

    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    ptrace.reset()
    assert peffects.check_effects("5p", cfg, ["pallas_fused"], "cpu", 4).ok

    def fresh_pools(cfg, round_step, vi, state, spare, lieu_lists, honest,
                    k_rounds, ctx):
        from qba_tpu_torch.ops.round_kernel_tiled import honest_cells

        hc = honest_cells(honest, cfg)
        li = lieu_lists.to(torch.int32).contiguous()

        def round_body(r, vi, cur):
            new, vi, ovf = round_step(r, cur, li, vi, hc, *engine.round_draws(
                cfg, k_rounds, ctx, r))
            return vi, new, ovf

        vi, ovf, counters = engine.scan_rounds(cfg, round_body,
                                               vi.to(torch.int32), state)
        return vi != 0, ovf, counters

    monkeypatch.setattr(engine, "_run_rounds_kernel", fresh_pools)
    ptrace.reset()
    rep = peffects.check_effects("5p", cfg, ["pallas_fused"], "cpu", 4)
    ptrace.reset()
    assert [f.check for f in rep.findings] == ["carry-donation"]


def test_hot_path_item_is_a_finding_unless_marked(tmp_path):
    src = tmp_path / "hot.py"
    stats = dict(sync_sites_checked=0, sync_sites_fenced=0,
                 sync_sites_allowlisted=0)
    src.write_text("def f(x):\n    return x.item()\n")
    rep = Report()
    ptransfers.audit_module(str(src), rep, dict(stats))
    assert [f.check for f in rep.findings] == ["host-sync"]
    src.write_text("def f(x):\n"
                   "    return x.item()  # qba-lint: sync-ok (host data)\n")
    rep = Report()
    ptransfers.audit_module(str(src), rep, dict(stats))
    assert rep.ok and len(rep.notes) == 1


def test_smem_plan_over_budget_is_a_finding(monkeypatch):
    from qba_tpu_torch.ops import trial_megakernel as tm

    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    assert pmemory.check_memory(cfg, "cpu").ok
    budget = pmemory.smem_budget("cpu")
    monkeypatch.setattr(tm, "mega_smem_bytes", lambda cfg, n_tp=1, **k:
                        budget + 1 if n_tp == 1 else 0)
    rep = pmemory.check_memory(cfg, "cpu")
    assert [(f.check, f.path) for f in rep.findings] == [
        ("smem-plan", "pallas_mega/trial")]


def test_device_loop_probe_finds_the_dense_path_sync():
    # The dense paths picked each position's family by boolean-mask
    # indexing, a host read (ROADMAP A14); their list generation now has
    # no data-dependent shape, so every chunk the graph loop captures,
    # counters and the dense paths included, reads nothing on the host.
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=1)
    rep = ptransfers.check_device_loop([("5p", cfg)], ["pallas_mega"],
                                       "cpu", 4)
    assert rep.ok, rep.render()
    verdicts = rep.stats["sync_verdicts"]
    assert verdicts == dict.fromkeys(
        ["5p/pallas_mega", "5p/pallas_fused+counters", "3p/dense",
         "3p/dense_pallas"], "no sync")


# ---- the CLI -----------------------------------------------------------

BLOCKED_LINT = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "qba_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from qba_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_lint_cli_runs_clean_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    path = str(tmp_path / "findings.json")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_LINT, "lint", "--device", "cpu",
         "--config", "5,16,1", "--effects", "--protocol", "--obs",
         "--findings-json", path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    payload = json.load(open(path))
    assert set(payload) == {"schema", "ok", "effects", "protocol", "obs",
                            "findings", "notes", "stats"}
    assert payload["ok"] and payload["effects"] and payload["obs"]
    assert payload["stats"]["device"] == "cpu"


def test_lint_cli_exits_1_on_a_finding(tmp_path):
    out = io.StringIO()
    rc = cli.main(["lint", "--device", "cpu", "--config", "5,16,1",
                   "--engines", "xla", "--atlas", str(tmp_path)], out=out)
    assert rc == 1 and "ledger-missing" in out.getvalue()


def test_lint_cli_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["lint", "--config", "5,16,1"], out=io.StringIO())


def test_lint_is_ported():
    assert "lint" not in cli._NOT_PORTED
