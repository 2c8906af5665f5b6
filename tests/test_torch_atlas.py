"""The port's atlas campaign driver answers as the JAX package's does.

The same specs go through ``qba_tpu.atlas`` and ``qba_tpu_torch.atlas``:

* cube: the enumerated cells (keys, coordinates, fingerprints), the
  campaign key, each attempt's trials and request, and the dishonest
  axis' parsing equal JAX's;
* steer: the frontier plan (ranking, tiers, widths, the allocator's
  summary) and the frontier test equal JAX's on the same observations;
* render: ``atlas.json`` of one store equals JAX's rendering of it;
* a local campaign of 2 x 2 cells (the port's server on the CPU) gives
  JAX's store digest, again after an interrupt and a resume; the same
  cube through ``FleetExecutor``, served by a port worker thread and a
  JAX worker thread sharing the queue, gives it too.

JAX's runs are made once, in module-scoped fixtures, under
``jax.threefry_partitionable(True)``.
"""

import dataclasses
import json
import os
import threading

import jax
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import atlas as jatlas
from qba_tpu import serve as jserve
from qba_tpu.atlas import cube as jcube
from qba_tpu.atlas import steer as jsteer
from qba_tpu.serve import fleet as jfleet
from qba_tpu.serve import transport as jtransport
from qba_tpu_torch import atlas as patlas
from qba_tpu_torch import serve as pserve
from qba_tpu_torch.atlas import cube as pcube
from qba_tpu_torch.atlas import steer as psteer
from qba_tpu_torch.serve import fleet as pfleet
from qba_tpu_torch.serve import transport as ptransport

TARGET = "decide vs 1/3 @ 95%"
SPECS = {
    "small": dict(parties=(4, 5), dishonest=(0.0, 1.0)),
    "cube": dict(parties=(4, 7), dishonest=(0.0, 1 / 3, 9.0),
                 strategies=("reference", "split"),
                 noise_points=((0.0, 0.0), (0.05, 0.02))),
}


def _spec(pkg, name="small", **kw):
    cube = pcube if pkg == "torch" else jcube
    args = dict(SPECS[name], chunk_trials=32, budget_trials=64,
                max_escalations=1, target=TARGET)
    args.update(kw)
    return cube.CampaignSpec(**args)


# ---- cube --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SPECS))
def test_cube_equals_jax(name):
    got, want = _spec("torch", name), _spec("jax", name)
    assert got.to_json() == want.to_json()
    assert got.campaign_key() == want.campaign_key()
    assert pcube.CampaignSpec.from_json(want.to_json()) == got
    cells = pcube.enumerate_cells(got)
    jcells = jcube.enumerate_cells(want)
    assert [(c.key, c.coords, c.fingerprint) for c in cells] == [
        (c.key, c.coords, c.fingerprint) for c in jcells]
    assert len({c.key for c in cells}) == len(cells)
    for attempt in (0, 1, 2):
        assert pcube.attempt_trials(got, attempt) == jcube.attempt_trials(
            want, attempt)
        for c, jc in zip(cells, jcells):
            assert pcube.build_request(c, got, attempt).to_json() == (
                jcube.build_request(jc, want, attempt).to_json())


def test_dishonest_axis_parses_as_jax():
    tokens = ["0", "1", "1/3", "0.4", "2.0"]
    assert pcube.parse_dishonest(tokens) == jcube.parse_dishonest(tokens)
    for n in (4, 7, 13):
        assert pcube.resolve_dishonest(n, (1 / 3, 2.0, 9.0)) == (
            jcube.resolve_dishonest(n, (1 / 3, 2.0, 9.0)))
    for bad in (["x"], ["-1"], ["1/0"]):
        with pytest.raises(ValueError):
            pcube.parse_dishonest(bad)


# ---- steer -------------------------------------------------------------


OBSERVED = [
    {},
    {0: (40, 64), 1: (10, 64), 3: (22, 64)},
    {0: (64, 64), 1: (0, 64), 2: (21, 64), 3: (30, 96), 5: (1, 32)},
]


@pytest.mark.parametrize("case", range(len(OBSERVED)))
def test_frontier_plan_equals_jax(case):
    keys = [c.key for c in pcube.enumerate_cells(_spec("torch", "cube"))]
    observed = {keys[i]: kn for i, kn in OBSERVED[case].items()}
    open_keys = [k for i, k in enumerate(keys) if i % 3 != 2]
    got = psteer.frontier_plan(keys, observed, open_keys, TARGET)
    want = jsteer.frontier_plan(keys, observed, open_keys, TARGET)
    assert got[0] == want[0]
    assert json.loads(json.dumps(got[1])) == json.loads(json.dumps(want[1]))
    assert sorted(got[0]) == sorted(open_keys)


@pytest.mark.parametrize("record,target", [
    ({"ci": {"lo": 0.2, "hi": 0.5}}, TARGET),
    ({"ci": {"lo": 0.4, "hi": 0.5}}, TARGET),
    ({"ci": {"lo": 0.4, "hi": 0.5},
      "refusal": {"reason": "budget_exhausted"}}, TARGET),
    ({"ci": {"lo": 0.2, "hi": 0.5}}, "ci_width<=0.05"),
])
def test_is_frontier_equals_jax(record, target):
    assert psteer.is_frontier(record, target) == jsteer.is_frontier(
        record, target)


# ---- campaigns ---------------------------------------------------------


def _j_campaign(root, **kw):
    with jax.threefry_partitionable(True):
        store = jatlas.AtlasStore(str(root))
        return store, jatlas.CampaignDriver(
            store, _spec("jax"),
            jatlas.LocalExecutor(chunk_trials=32), **kw).run()


def _p_campaign(root, **kw):
    store = patlas.AtlasStore(str(root))
    ex = patlas.LocalExecutor(chunk_trials=32, device="cpu")
    return store, patlas.CampaignDriver(
        store, _spec("torch"), ex,
        admission=pfleet.AdmissionController(
            chunk_trials=32, hbm_bytes=2**40, device="cpu"), **kw).run()


@pytest.fixture(scope="module")
def jax_campaign(tmp_path_factory):
    store, summary = _j_campaign(tmp_path_factory.mktemp("jax_atlas"))
    assert summary["open"] == 0
    return store, summary


def test_local_campaign_digest_equals_jax(jax_campaign, tmp_path):
    jstore, want = jax_campaign
    store, got = _p_campaign(tmp_path / "atlas")
    assert got["open"] == 0 and not got["interrupted"]
    assert got["cells"] == 4
    assert got["store_digest"] == want["store_digest"]
    for f in ("certified", "refused", "by_status", "metrics"):
        assert got[f] == want[f], f
    for f in ("decisions", "by_action", "by_reason", "released_trials"):
        assert got["admission"][f] == want["admission"][f], f
    # The rendered atlas is JAX's rendering of the same store.
    with open(store.atlas_path) as f:
        atlas = json.load(f)
    assert atlas == jatlas.render_atlas(jatlas.AtlasStore(store.root))
    assert atlas == patlas.render_atlas(patlas.AtlasStore(jstore.root))
    assert atlas["schema"] == "qba-tpu/atlas/v1" and atlas["ki7_fence"]


def test_campaign_resume_gives_the_same_digest(jax_campaign, tmp_path):
    _jstore, want = jax_campaign
    _store, first = _p_campaign(tmp_path / "b", max_results=1)
    assert first["interrupted"] and first["open"] >= 1
    _store, second = _p_campaign(tmp_path / "b")
    assert second["open"] == 0 and not second["interrupted"]
    assert second["store_digest"] == want["store_digest"]
    with pytest.raises(ValueError, match="campaign"):
        patlas.CampaignDriver(
            patlas.AtlasStore(str(tmp_path / "b")),
            _spec("torch", parties=(5,)),
            patlas.LocalExecutor(device="cpu"),
            admission=pfleet.AdmissionController(
                chunk_trials=32, hbm_bytes=2**40, device="cpu")).run()


def _queue_worker(pkg, qdir, replica):
    serve, transport = ((pserve, ptransport) if pkg == "torch"
                        else (jserve, jtransport))
    kw = {"device": "cpu"} if pkg == "torch" else {}
    with jax.threefry_partitionable(True):
        server = serve.QBAServer(chunk_trials=32, replica_id=replica, **kw)
        transport.serve_file_queue(server, qdir, poll_s=0.01)


def test_fleet_campaign_over_both_packages_workers(jax_campaign, tmp_path):
    _jstore, want = jax_campaign
    qdir = str(tmp_path / "q")
    executor = patlas.FleetExecutor(qdir)
    workers = [threading.Thread(target=_queue_worker, args=(pkg, qdir, rid),
                                daemon=True)
               for pkg, rid in (("torch", "r0"), ("jax", "r1"))]
    for w in workers:
        w.start()
    store = patlas.AtlasStore(str(tmp_path / "atlas"))
    try:
        got = patlas.CampaignDriver(
            store, _spec("torch"), executor,
            admission=pfleet.AdmissionController(
                chunk_trials=32, replicas=2, hbm_bytes=2**40, device="cpu"),
            poll_s=0.01, idle_timeout_s=120.0).run()
    finally:
        open(os.path.join(qdir, "stop"), "w").close()
        for w in workers:
            w.join(timeout=120)
    assert got["open"] == 0
    assert got["store_digest"] == want["store_digest"]
    served = {store.load_cell(k)["provenance"]["replica_id"]
              for k in json.load(open(store.ledger_path))["cells"]}
    assert served <= {"r0", "r1"} and served
    # Every result was acknowledged out of the outbox.
    assert os.listdir(os.path.join(qdir, "outbox")) == []
    summary = pfleet.fleet_summary(qdir)
    assert summary == jfleet.fleet_summary(qdir)
    assert summary["completed"] == 4


def test_render_of_a_tampered_store_equals_jax(jax_campaign, tmp_path):
    jstore, _want = jax_campaign
    store = patlas.AtlasStore(str(tmp_path / "copy"))
    for _name, rec in jatlas.AtlasStore(jstore.root).iter_cells():
        rec = dict(rec, ci=dict(rec["ci"], lo=0.3, hi=0.4))
        store.write_cell(rec)
    got = patlas.render_atlas(store, TARGET)
    want = jatlas.render_atlas(jatlas.AtlasStore(store.root), TARGET)
    assert got == want
    assert all(p["frontier"] for sl in got["slices"] for p in sl["points"])
    assert dataclasses.is_dataclass(patlas.AtlasCell)
