"""The port's serving worker answers as the JAX package's does.

The same request streams go through ``qba_tpu.serve`` and
``qba_tpu_torch.serve`` (``device="cpu"``, the plain versions):

* the mixed three-bucket stream of ``tests/test_serve.py`` plus a
  ``return_decisions`` request, at depth 1 and 2: per-request success,
  decisions, counts, chunks, bucket, stop, ci and error equal JAX's;
* a targeted request (``decide vs 1/3 @ 95%``, 64 trials, chunks of 8)
  stops where JAX's does, its prefix equal to the untargeted twin's; on a
  ``dispatch="device"`` server the plain device loop over the request's
  own keys gives the same result as JAX's ``_run_device`` and the host
  path;
* a device request on the dense path or a per-round engine runs its
  device loop, equal to JAX's device result, the host path and a direct
  run;
* deadline expiry, a bad config and an invalid target give JAX's error
  results; a chunk whose kernel fails gives named error results;
* the JSONL transport's result lines equal JAX's; the file queue
  reclaims a stale claim, dead-letters a poison one and drains before a
  stop sentinel; request, result and ``plans.json`` files cross between
  the packages both ways; every manifest passes both validators;
* ``python -m qba_tpu_torch serve`` runs with ``jax``, ``flax`` and
  ``qba_tpu`` blocked.

Each JAX server run is made once, in a module-scoped fixture.  JAX's
threefry mode is set only inside ``jax.threefry_partitionable(True)``.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import serve as jserve
from qba_tpu.obs.manifest import validate_manifest as j_validate_manifest
from qba_tpu.serve import persist as jpersist
from qba_tpu.serve import queuefs as jqueuefs
from qba_tpu.serve import transport as jtransport
from qba_tpu.serve.request import EvalResult as JEvalResult
from qba_tpu_torch import serve as pserve
from qba_tpu_torch.backends.torch_backend import run_trials, trial_keys
from qba_tpu_torch.obs.manifest import validate_manifest
from qba_tpu_torch.obs.telemetry import span_latency_summary, spans_from_jsonl
from qba_tpu_torch.serve import persist, transport
from qba_tpu_torch.serve.engine import request_keys

COMPARED = ("success", "decisions", "n_trials", "successes", "any_overflow",
            "chunks", "bucket", "stop", "ci", "error")
TARGET = "decide vs 1/3 @ 95%"


def _req(pkg, rid, n=4, L=8, d=1, trials=4, seed=0, **kw):
    return pkg.EvalRequest(request_id=rid, n_parties=n, size_l=L,
                           n_dishonest=d, trials=trials, seed=seed, **kw)


def _mixed_stream(pkg):
    """test_serve.py's three interleaved buckets and a decisions request."""
    return [
        _req(pkg, "a0", n=4, L=8, d=1, trials=5, seed=3),
        _req(pkg, "b0", n=5, L=8, d=1, trials=6, seed=7),
        _req(pkg, "c0", n=4, L=16, d=2, trials=4, seed=1),
        _req(pkg, "a1", n=4, L=8, d=1, trials=11, seed=9),
        _req(pkg, "b1", n=5, L=8, d=1, trials=3, seed=2),
        _req(pkg, "a2", n=4, L=8, d=1, trials=2, seed=5),
        _req(pkg, "dec", n=5, L=8, d=1, trials=6, seed=8,
             return_decisions=True),
    ]


def _targeted_stream(pkg):
    return [_req(pkg, "tgt", trials=64, seed=3, target=TARGET),
            _req(pkg, "full", trials=64, seed=3)]


def _j_serve(requests, **kw):
    with jax.threefry_partitionable(True):
        return {r.request_id: r for r in jserve.serve_batch(
            jserve.QBAServer(**kw), requests)}


def _p_serve(requests, **kw):
    return {r.request_id: r for r in pserve.serve_batch(
        pserve.QBAServer(device="cpu", **kw), requests)}


def _same(got, want):
    """``got`` (the port's) equals ``want`` (JAX's) on every compared
    field; returns ``got`` as JSON."""
    g = got.to_json() if hasattr(got, "to_json") else got
    w = want.to_json() if hasattr(want, "to_json") else want
    for f in COMPARED:
        assert g[f] == w[f], (g["request_id"], f, g[f], w[f])
    return g


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX server run the tests compare with, made once."""
    runs = {f"mixed{d}": _j_serve(_mixed_stream(jserve), chunk_trials=4,
                                  depth=d) for d in (1, 2)}
    runs["targeted"] = _j_serve(_targeted_stream(jserve), chunk_trials=8)
    runs["device"] = _j_serve(_targeted_stream(jserve)[:1], chunk_trials=8,
                              dispatch="device")
    return runs


# ---- served results ----------------------------------------------------


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.QBAServer()


@pytest.mark.parametrize("depth", [1, 2])
def test_served_results_equal_jax(jax_runs, depth):
    got = _p_serve(_mixed_stream(pserve), chunk_trials=4, depth=depth)
    want = jax_runs[f"mixed{depth}"]
    assert set(got) == set(want)
    for rid in want:
        _same(got[rid], want[rid])
        assert got[rid].error is None
    assert got["a1"].chunks >= 2
    assert got["dec"].decisions is not None and got["a0"].decisions is None


def test_served_results_equal_direct_runs():
    reqs = _mixed_stream(pserve)
    got = _p_serve(reqs, chunk_trials=4, depth=2)
    for req in reqs:
        direct = run_trials(req.config(), trial_keys(req.config(), "cpu"),
                            device="cpu").trials
        assert got[req.request_id].success == direct.success.tolist()
    assert got["dec"].decisions == direct.decisions.tolist()


def test_request_keys_equal_jax_key_data():
    cfg = _req(pserve, "k", trials=7, seed=11).config()
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(11), 7)), dtype=np.uint32)
    np.testing.assert_array_equal(request_keys(cfg), want)


def test_spans_latency_and_manifests():
    server = pserve.QBAServer(chunk_trials=4, depth=2, device="cpu")
    results = pserve.serve_batch(server, _mixed_stream(pserve))
    for res in results:
        validate_manifest(res.manifest)
        j_validate_manifest(json.loads(json.dumps(res.manifest)))
        assert res.manifest["request_id"] == res.request_id
        assert res.manifest["plan"]["engine"] == "xla"
        assert res.engine == "xla" and res.latency_s > 0
    summary = server.latency_summary()
    assert summary["count"] == len(results)
    assert summary["p99_s"] >= summary["p50_s"] >= 0
    spans = server.recorder.spans
    readbacks = [s for s in spans if s.name == "serve.readback"]
    dispatches = [s for s in spans if s.name == "serve.dispatch"]
    assert readbacks and all(s.fenced for s in readbacks)
    assert dispatches and not any(s.fenced for s in dispatches)
    assert len(readbacks) == len(dispatches)


# ---- precision targets -------------------------------------------------


def test_targeted_request_finishes_early_like_jax(jax_runs):
    got = _p_serve(_targeted_stream(pserve), chunk_trials=8)
    want = jax_runs["targeted"]
    tgt = _same(got["tgt"], want["tgt"])
    _same(got["full"], want["full"])
    assert tgt["stop"]["reason"] == "decided_above"
    assert tgt["n_trials"] < 64
    assert tgt["success"] == got["full"].success[:tgt["n_trials"]]
    assert got["tgt"].manifest["stats"]["stop"] == tgt["stop"]


def test_device_early_finish_equals_jax_and_host(jax_runs, tmp_path):
    server = pserve.QBAServer(chunk_trials=8, dispatch="device",
                              device="cpu", telemetry_dir=str(tmp_path))
    got = pserve.serve_batch(server, _targeted_stream(pserve)[:1])[0]
    _same(got, jax_runs["device"]["tgt"])
    _same(got, jax_runs["targeted"]["tgt"])
    assert got.manifest["stats"]["dispatch"] == "device"
    spans = spans_from_jsonl(str(tmp_path / "tgt" / "spans.jsonl"))
    (loop,) = [s for s in spans if s.name == "serve.device_loop"]
    assert loop.fenced and loop.args["dispatch"] == "plain"
    assert loop.args["readbacks"] == got.chunks
    assert span_latency_summary(spans, "request")["count"] == 1


@pytest.mark.parametrize("spec,trials", [("ci_width<=0.01", 20),
                                         ("decide vs 0.9", 24)])
def test_device_early_finish_equals_host_path(spec, trials):
    # Budget floor-quantized to whole chunks on the device path; the
    # host path's prefix agrees chunk for chunk.
    reqs = [_req(pserve, "t", trials=trials, seed=5, target=spec)]
    dev = _p_serve(reqs, chunk_trials=8, dispatch="device")["t"]
    host = _p_serve(reqs, chunk_trials=8)["t"]
    assert dev.n_trials == dev.stop["n_trials"] <= trials // 8 * 8
    assert dev.success == host.success[:dev.n_trials]
    if dev.n_trials == host.n_trials:
        assert dev.stop == host.stop


@pytest.mark.parametrize("kw", [dict(n=3, L=8, qsim_path="dense"),
                                dict(round_engine="pallas_fused"),
                                dict(round_engine="pallas")])
def test_device_request_refused_where_graph_cannot_capture(kw, jax_runs):
    # The dense path and the per-round engines were refused at intake
    # (ROADMAP A14); the device loop now runs them: the targeted request
    # of the stream on the fused round and on the dense-mailbox round
    # equals JAX's device result, and a dense request equals the host
    # path and a direct run of its trials.
    if "qsim_path" in kw:
        req = _req(pserve, "dense", trials=16, seed=1, target=TARGET, **kw)
        dev = _p_serve([req], chunk_trials=8, dispatch="device")["dense"]
        host = _p_serve([req], chunk_trials=8)["dense"]
        assert dev.error is None and dev.manifest["stats"]["dispatch"] == \
            "device"
        for f in COMPARED:
            assert getattr(dev, f) == getattr(host, f), f
        direct = run_trials(req.config(), trial_keys(req.config(), "cpu"),
                            device="cpu").trials
        assert dev.success == direct.success[:dev.n_trials].tolist()
        return
    [req] = _targeted_stream(pserve)[:1]
    got = _p_serve([dataclasses.replace(req, **kw)], chunk_trials=8,
                   dispatch="device")["tgt"].to_json()
    want = jax_runs["device"]["tgt"].to_json()
    assert got["manifest"]["stats"]["dispatch"] == "device"
    assert got["bucket"] == want["bucket"].replace(
        "auto", kw["round_engine"])
    for f in COMPARED:
        if f != "bucket":
            assert got[f] == want[f], f


def test_failed_chunk_becomes_named_error_result(monkeypatch):
    # No hidden fallback: a kernel that does not build answers the
    # chunk's requests with an error naming it, and the next chunk is
    # served.
    from qba_tpu_torch.backends import torch_backend
    from qba_tpu_torch.ops._build import KernelBuildError

    real = torch_backend.run_trials

    def broken(cfg, keys=None, *, device=None):
        if cfg.n_parties == 5:
            raise KernelBuildError("CUDA kernel build failed: "
                                   "trial_megakernel (exit 1)")
        return real(cfg, keys, device=device)

    monkeypatch.setattr(torch_backend, "run_trials", broken)
    got = _p_serve(_mixed_stream(pserve), chunk_trials=4, depth=2)
    for rid in ("b0", "b1", "dec"):
        assert "KernelBuildError" in got[rid].error, rid
        assert "trial_megakernel" in got[rid].error, rid
        validate_manifest(got[rid].manifest)
        assert got[rid].manifest["expired"] is False
    assert got["a1"].error is None and got["a1"].n_trials == 11


@pytest.mark.parametrize("stage", ["dispatch", "readback"])
def test_cuda_fault_ends_the_worker(monkeypatch, stage):
    # A fault that ruins the CUDA context, or a bug in the port's own
    # code, is not a request's error: it leaves the server, so the worker
    # exits and its claims are reclaimed.
    from qba_tpu_torch.backends import torch_backend

    real = torch_backend.run_trials
    fault = RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")

    class Faulty(torch.Tensor):
        def cpu(self, *a, **k):
            raise fault

    def broken(cfg, keys=None, *, device=None):
        if stage == "dispatch":
            raise fault
        trials = real(cfg, keys, device=device).trials
        return torch_backend.aggregate(dataclasses.replace(
            trials, success=trials.success.as_subclass(Faulty)))

    monkeypatch.setattr(torch_backend, "run_trials", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _p_serve(_mixed_stream(pserve)[:1], chunk_trials=4)


@pytest.mark.parametrize("sticky", [False, True])
def test_failed_launch_is_named_only_while_the_context_lives(monkeypatch,
                                                             sticky):
    # A refused launch raises KernelLaunchError when a synchronize shows
    # the context intact; after a sticky fault the synchronize raises the
    # CUDA error itself.
    import types

    from qba_tpu_torch.ops import _launch

    def synchronize(device=None):
        if sticky:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)

    def wrapper():
        pass

    wrapper.launches, wrapper.events = 0, None
    stream = types.SimpleNamespace(cuda_stream=0, device=None)
    want = RuntimeError if sticky else _launch.KernelLaunchError
    with pytest.raises(want) as info:
        _launch.timed_launch(wrapper, lambda s: 9, [], stream)
    assert isinstance(info.value, _launch.KernelLaunchError) is not sticky
    assert wrapper.launches == 0


# ---- errors ------------------------------------------------------------


def _errors(pkg, serve):
    bad = serve([_req(pkg, "ok", trials=2), _req(pkg, "bad", n=1, trials=1),
                 _req(pkg, "tgt", trials=4, target="decide maybe")])
    srv = pkg.QBAServer(chunk_trials=4, deadline_s=0.01,
                        **({} if pkg is jserve else {"device": "cpu"}))
    srv.submit(_req(pkg, "dl", trials=4, target="decide vs 1/3"))
    time.sleep(0.05)
    with jax.threefry_partitionable(True):
        [dl] = srv.pump() + srv.flush()
    return bad, dl, srv.stats()


def test_error_results_equal_jax():
    j_bad, j_dl, j_stats = _errors(jserve, lambda r: _j_serve(
        r, chunk_trials=4))
    p_bad, p_dl, p_stats = _errors(pserve, lambda r: _p_serve(
        r, chunk_trials=4))
    for rid in ("ok", "bad", "tgt"):
        _same(p_bad[rid], j_bad[rid])
    assert "n_parties" in p_bad["bad"].error
    assert "unrecognized target" in p_bad["tgt"].error
    _same(p_dl, j_dl)
    assert "deadline exceeded" in p_dl.error
    for key in ("expired", "trials_completed"):
        assert p_dl.manifest[key] == j_dl.manifest[key]
    assert p_dl.manifest["stats"] == j_dl.manifest["stats"]
    assert p_stats["expired"] == j_stats["expired"] == 1


# ---- transports --------------------------------------------------------


def _jsonl_lines(pkg, mod):
    lines = [json.dumps(_req(pkg, "j0", trials=3, seed=2).to_json()),
             "{not json",
             json.dumps(_req(pkg, "j1", n=5, trials=5, seed=4,
                             return_decisions=True).to_json())]
    out = io.StringIO()
    kw = {} if pkg is jserve else {"device": "cpu"}
    with jax.threefry_partitionable(True):
        stats = mod.serve_jsonl(pkg.QBAServer(chunk_trials=4, **kw),
                                io.StringIO("\n".join(lines) + "\n"), out)
    return [json.loads(x) for x in out.getvalue().splitlines()], stats


def test_jsonl_transport_equals_jax():
    got, stats = _jsonl_lines(pserve, transport)
    want, _ = _jsonl_lines(jserve, jtransport)
    assert [g["request_id"] for g in got] == [w["request_id"] for w in want]
    for g, w in zip(got, want):
        _same(g, w)
    assert stats["completed"] == 2 and stats["device"] == "cpu"


def _queue(tmp_path):
    qdir = tmp_path / "q"
    for d in ("inbox", "claimed", "done", "dead", "outbox"):
        os.makedirs(qdir / d)
    return qdir


def _claim(qdir, rid, age_s, **kw):
    req = _req(pserve, rid, **kw)
    path = qdir / "claimed" / f"{rid}.json"
    path.write_text(json.dumps(req.to_json()))
    old = time.time() - age_s
    os.utime(path, (old, old))
    return req


def _result(qdir, rid):
    return JEvalResult.from_json(
        json.loads((qdir / "outbox" / f"{rid}.json").read_text()))


def test_file_queue_reclaims_stale_claim(tmp_path):
    qdir = _queue(tmp_path)
    req = _claim(qdir, "stale0", 3600.0, trials=3, seed=6)
    stats = transport.serve_file_queue(
        pserve.QBAServer(chunk_trials=4, device="cpu"), str(qdir),
        poll_s=0.01, max_requests=1, reclaim_timeout_s=1.0)
    assert stats["reclaimed"] == 1
    res = _result(qdir, "stale0")
    direct = run_trials(req.config(), trial_keys(req.config(), "cpu"),
                        device="cpu")
    assert res.error is None and res.success == direct.trials.success.tolist()
    assert (qdir / "done" / "stale0.json").exists()
    assert not (qdir / "claimed" / "stale0.json").exists()


def test_file_queue_dead_letters_poison_claim(tmp_path):
    qdir = _queue(tmp_path)
    _claim(qdir, "poison0", 3600.0, trials=2)
    (qdir / "stop").touch()
    stats = transport.serve_file_queue(
        pserve.QBAServer(chunk_trials=4, device="cpu"), str(qdir),
        poll_s=0.01, reclaim_timeout_s=1.0, max_reclaims=0)
    assert stats["reclaimed"] == 0
    res = _result(qdir, "poison0")
    assert res.error and "dead-lettered" in res.error
    assert (qdir / "dead" / "poison0.json").exists()
    assert not (qdir / "claimed" / "poison0.json").exists()


def test_file_queue_stop_sentinel_drains_first(tmp_path):
    # The JAX package's producer drops the requests; the port's worker
    # serves them; the JAX package reads the results.
    qdir = _queue(tmp_path)
    for i in range(3):
        req = _req(jserve, f"s{i}", trials=2, seed=i)
        jqueuefs.drop_request(str(qdir / "inbox"), req.to_json(),
                              req.request_id)
    (qdir / "stop").touch()
    server = pserve.QBAServer(chunk_trials=4, device="cpu",
                              replica_id="r0")
    stats = transport.serve_file_queue(server, str(qdir), poll_s=0.01)
    assert stats["completed"] == 3
    for i in range(3):
        res = _result(qdir, f"s{i}")
        assert res.error is None and res.replica_id == "r0"
        j_validate_manifest(res.manifest)
        assert (qdir / "done" / f"s{i}.json").exists()
    assert list((qdir / "inbox").iterdir()) == []
    assert list((qdir / "claimed").iterdir()) == []
    beat = jqueuefs.read_heartbeat(str(qdir), "r0")
    assert beat["phase"] == "readback"  # the last chunk, then the stop
    assert beat["schema"] == "qba-tpu/heartbeat/v1"
    events = [e["event"] for e in jqueuefs.read_flight_recorder(
        str(qdir), "r0")["events"]]
    assert events[0] == "boot" and "compile" in events and "finish" in events
    assert json.loads((qdir / "summary-r0.json").read_text())["completed"] == 3


# ---- plans.json --------------------------------------------------------


def test_plans_cross_between_packages(tmp_path):
    cfgs = [_req(pserve, "x", n=4, L=8).config(),
            _req(pserve, "y", n=5, L=16, d=2, strategy="split").config()]
    jcfgs = [jserve.EvalRequest(**{**dataclasses.asdict(
        _req(pserve, "z", n=5, L=8)), "request_id": "z"}).config()]
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    persist.save_plans(pdir, cfgs, device="cpu")
    jpersist.save_plans(jdir, jcfgs)
    want = [dataclasses.asdict(c) | {"seed": 0, "trials": 1} for c in cfgs]
    got = [dataclasses.asdict(c) | {"seed": 0, "trials": 1}
           for c in jpersist.saved_configs(persist.plans_path(pdir))]
    assert got == want
    assert [dataclasses.asdict(c) for c in persist.saved_configs(
        persist.plans_path(jdir))] == [
        dataclasses.asdict(c) | {"seed": 0, "trials": 1} for c in jcfgs]
    # The port's save over the JAX artifact keeps its shapes; a boot
    # prepares all of them.
    persist.save_plans(jdir, cfgs, device="cpu")
    assert len(jpersist.saved_configs(persist.plans_path(jdir))) == 3
    state = json.loads(open(persist.plans_path(jdir)).read())[
        "resolver_state"]
    assert [v for _, v in state["buckets"]] == [
        {"engine": "xla", "mega_gen": None}] * 3
    assert persist.load_plans(jdir, "cpu") == 3
    assert persist.load_plans(str(tmp_path / "none"), "cpu") == 0


def test_saved_shapes_keep_counters(tmp_path):
    # Counters change the plan on CUDA, so a shape with them is saved
    # with them; a shape without has the JAX package's entry, and a JAX
    # save of it adds no second entry.
    plain = _req(pserve, "x", n=4, L=8).config()
    counted = dataclasses.replace(plain, collect_counters=True)
    cache = str(tmp_path / "p")
    persist.save_plans(cache, [plain, counted], device="cpu")
    jpersist.save_plans(cache, [jserve.EvalRequest(**dataclasses.asdict(
        _req(pserve, "x", n=4, L=8))).config()])
    got = jpersist.saved_configs(persist.plans_path(cache))
    assert [c.collect_counters for c in got] == [False, True]
    assert persist.plan_config_entry(plain) == jpersist.plan_config_entry(
        got[0])
    state = persist.saved_resolutions(cache)
    assert state is None  # the JAX save replaced the port's state
    persist.save_plans(cache, [], device="cpu")
    state = persist.saved_resolutions(cache)
    assert state["backend"] == "cpu" and len(state["buckets"]) == 2


def test_cache_stats_reports_saved_shapes(tmp_path):
    from qba_tpu_torch import cli

    cache = str(tmp_path / "c")
    persist.save_plans(cache, [_req(pserve, "x", n=4, L=8).config()],
                       device="cpu")
    out = io.StringIO()
    assert cli.main(["serve", "--cache-stats", "--cache-dir", cache],
                    out=out) == 0
    stats = json.loads(out.getvalue())
    assert stats["kernels"]["build_dir"]
    art = stats["cache_dir"]
    assert art["saved_shapes"] == 1 and art["resolved_on"] == "cpu"
    assert art["resolved"] == [dict(shape="4p-L8-d1-auto", engine="xla",
                                    mega_gen=None)]


def test_warm_start_restores_saved_shapes(tmp_path):
    cache = str(tmp_path / "cache")
    reqs = [_req(pserve, "w0", trials=3, seed=1, qsim_path="stabilizer")]
    first = pserve.QBAServer(chunk_trials=4, cache_dir=cache, device="cpu")
    [a] = pserve.serve_batch(first, reqs)
    second = pserve.QBAServer(chunk_trials=4, cache_dir=cache, device="cpu")
    assert first.restored_plans == 0 and second.restored_plans == 1
    [b] = pserve.serve_batch(second, reqs)
    assert a.success == b.success and b.manifest["restored_plans"] == 1


# ---- the entry point ---------------------------------------------------

BLOCKED_SERVE = r"""
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "qba_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["qba_tpu_torch"] + sys.argv[1:]
runpy.run_module("qba_tpu_torch", run_name="__main__")
"""


def test_cli_serve_runs_with_jax_blocked():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"
    lines = "".join(json.dumps(_req(pserve, f"c{i}", trials=3, seed=i)
                               .to_json()) + "\n" for i in range(3))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_SERVE, "serve", "--device", "cpu",
         "--transport", "jsonl", "--max-requests", "2", "--chunk-trials",
         "4"], cwd=repo, env=env, input=lines, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    results = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [r["request_id"] for r in results] == ["c0", "c1"]
    assert all(r["error"] is None and r["n_trials"] == 3 for r in results)
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    assert summary["serve_summary"]["completed"] == 2
