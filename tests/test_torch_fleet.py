"""The port's fleet answers as the JAX package's does.

The same inputs go through ``qba_tpu.serve.fleet`` and
``qba_tpu_torch.serve.fleet``; workers are threads running each
package's ``serve_file_queue`` (the port's on ``device="cpu"``), never
subprocesses:

* admission: the decision sequences, priced trials and reasons of the
  JAX package's streams (plain, targets, deferred retries, batch hints,
  benched replicas) are equal wherever the memory ceiling does not bind;
  the port's own ``unservable_shape`` with a small ``hbm_bytes``, its
  byte model against the megakernel's layout, and its refusal of a ``tp``
  mesh (ROADMAP A12b);
* the socket front end end to end: a stream with an assigned id, a
  malformed line, an invalid config and a targeted request gives JAX's
  results through the port's front end and worker, the port's front end
  in front of a JAX worker, and JAX's front end in front of the port's
  worker; HTTP ``GET /metrics``, ``GET /status`` and ``POST``;
* ``fleet_summary``, ``stitch_traces``/``trace_summary`` and ``python -m
  qba_tpu_torch trace`` over one queue directory equal JAX's;
* the supervisor over stub replicas (phase-aware classification, a hung
  worker killed and its claim released, poison quarantine, the breaker,
  respawn backoff, a wedged process) reaches JAX's outcomes; the
  test-only crash hook ends a worker mid-claim and the supervisor's
  crash report names the request;
* ``worker_argv`` and ``make_device_env``.

JAX's worker runs under ``jax.threefry_partitionable(True)``, in
module-scoped fixtures.
"""

import dataclasses
import io
import json
import os
import socket
import threading

import jax
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import cli as jcli
from qba_tpu import serve as jserve
from qba_tpu.obs import tracing as jtracing
from qba_tpu.serve import fleet as jfleet
from qba_tpu.serve import queuefs as jqueuefs
from qba_tpu.serve import transport as jtransport
from qba_tpu_torch import cli as pcli
from qba_tpu_torch import serve as pserve
from qba_tpu_torch.analysis import memory
from qba_tpu_torch.obs import tracing as ptracing
from qba_tpu_torch.obs.metrics import validate_exposition
from qba_tpu_torch.serve import fleet as pfleet
from qba_tpu_torch.serve import queuefs as pqueuefs
from qba_tpu_torch.serve import transport as ptransport

PKGS = {"torch": (pfleet, pserve, pqueuefs, ptransport),
        "jax": (jfleet, jserve, jqueuefs, jtransport)}
TARGET = "decide vs 1/3 @ 95%"
# Far above any tiny config's bytes: the ceiling never binds.
BIG_HBM = 2**40


def _req(serve, rid, n=4, L=4, d=0, trials=4, seed=0, **kw):
    return serve.EvalRequest(request_id=rid, n_parties=n, size_l=L,
                             n_dishonest=d, trials=trials, seed=seed, **kw)


def _controller(fleet, **kw):
    kw.setdefault("chunk_trials", 8)
    kw.setdefault("replicas", 1)
    kw.setdefault("window_chunks", 2)
    if fleet is pfleet:
        kw.setdefault("hbm_bytes", BIG_HBM)
        kw.setdefault("device", "cpu")
    return fleet.AdmissionController(**kw)


# ---- admission ---------------------------------------------------------


def _stream_plain(fleet, serve):
    ac = _controller(fleet)
    for req in (_req(serve, "A", trials=16), _req(serve, "B", trials=8),
                _req(serve, "C", trials=24), _req(serve, "bad", n=0)):
        ac.try_admit(req)
    ac.settle("A", executed_trials=16)
    ac.try_admit(_req(serve, "B", trials=8))
    return ac


def _stream_targets(fleet, serve):
    ac = _controller(fleet, window_chunks=64)
    ac.try_admit(_req(serve, "T", trials=4096, target=TARGET))
    ac.try_admit(_req(serve, "W", trials=2048, target="ci_width<=0.1"))
    ac.try_admit(_req(serve, "U", trials=24))
    ac.try_admit(_req(serve, "V", trials=5, target="decide vs 0.9 +-0.05"))
    return ac


def _stream_retry(fleet, serve):
    ac = _controller(fleet)
    ac.try_admit(_req(serve, "A", trials=16))
    ac.try_admit(_req(serve, "B", trials=8))
    for _ in range(5):
        assert ac.try_admit(_req(serve, "B", trials=8),
                            record=False).action == fleet.DEFER
    ac.settle("A")
    ac.record(ac.try_admit(_req(serve, "B", trials=8), record=False))
    return ac


def _stream_batch(fleet, serve):
    ac = _controller(fleet)
    ac.try_admit(_req(serve, "A", trials=16), batch=True)
    for _ in range(5):
        ac.try_admit(_req(serve, "B", trials=8), batch=True)
    ac.settle("A")
    ac.try_admit(_req(serve, "B", trials=8), batch=True)
    for _ in range(3):
        ac.try_admit(_req(serve, "C", trials=16), batch=True)
    ac.settle("B")
    ac.try_admit(_req(serve, "C", trials=16), batch=True)
    return ac


def _stream_bench(fleet, serve):
    ac = _controller(fleet, replicas=2)
    ac.try_admit(_req(serve, "A", trials=16))
    ac.bench_replica("r0")
    ac.bench_replica("r0")
    ac.try_admit(_req(serve, "B", trials=8, d=1))
    ac.settle("A")
    ac.settle("A")
    ac.settle("never-admitted")
    ac.try_admit(_req(serve, "C", trials=8, n=5))
    return ac


STREAMS = {"plain": _stream_plain, "targets": _stream_targets,
           "retry": _stream_retry, "batch": _stream_batch,
           "bench": _stream_bench}


def _summary(ac):
    """The controller's summary without its per-bucket ceilings (the
    packages price memory differently)."""
    out = ac.summary()
    assert set(out.pop("bucket_ceilings")) == {
        d.bucket for d in ac.decisions if d.bucket}
    return out


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_admission_decisions_equal_jax(stream):
    got = STREAMS[stream](pfleet, pserve)
    want = STREAMS[stream](jfleet, jserve)
    assert [d.to_json() for d in got.decisions] == [
        d.to_json() for d in want.decisions]
    assert _summary(got) == _summary(want)
    assert all(d.reason in pfleet.REASONS for d in got.decisions)
    assert pfleet.REASONS == jfleet.REASONS


def test_admission_plain_stream_actions():
    ac = _stream_plain(pfleet, pserve)
    assert [(d.action, d.reason) for d in ac.decisions] == [
        (pfleet.ADMIT, "capacity_available"), (pfleet.DEFER, "window_full"),
        (pfleet.REJECT, "oversized_request"),
        (pfleet.REJECT, "invalid_request"),
        (pfleet.ADMIT, "capacity_available")]
    assert ac.outstanding_trials == 8


def test_admission_rejects_what_the_device_cannot_hold():
    ac = _controller(pfleet, hbm_bytes=1)
    dec = ac.try_admit(_req(pserve, "huge", trials=8))
    assert (dec.action, dec.reason) == (pfleet.REJECT, "unservable_shape")
    assert "exhausts the 1 B" in dec.detail
    assert ac.outstanding_trials == 0
    # 33p: a 64-trial chunk fits 3 GiB, not the reserve and a few trials.
    req = _req(pserve, "n33", n=33, L=64, d=10, trials=64)
    cfg = req.config()
    room = memory.HBM_RESERVE + memory.batch_bytes(cfg, 64, "cuda")
    assert memory.trial_ceiling(cfg, room, "cuda") == 64
    for hbm, action in ((room, pfleet.ADMIT), (room - 1, pfleet.REJECT)):
        ac = pfleet.AdmissionController(chunk_trials=64, window_chunks=4,
                                        hbm_bytes=hbm)
        assert ac.try_admit(req).action == action


@pytest.mark.parametrize("n,L,d,qsim", [(5, 16, 1, "factorized"),
                                        (11, 64, 3, "factorized"),
                                        (33, 64, 10, "stabilizer")])
def test_byte_model_counts_the_megakernel_pools(n, L, d, qsim):
    from qba_tpu_torch.config import QBAConfig
    from qba_tpu_torch.ops.trial_megakernel import mega_entry_bytes

    cfg = QBAConfig(n_parties=n, size_l=L, n_dishonest=d, qsim_path=qsim)
    terms = memory.trial_bytes(cfg, "cuda")
    assert terms["pools"] == 2 * cfg.n_lieutenants * cfg.slots * (
        mega_entry_bytes(cfg))
    # A per-round engine adds its pool pair, draws and accepted matrix.
    fused = memory.trial_bytes(
        dataclasses.replace(cfg, round_engine="pallas_fused"), "cuda")
    assert sum(fused.values()) > sum(terms.values())
    assert memory.batch_bytes(cfg, 1000, "cuda") > 1000 * sum(terms.values())


@pytest.mark.parametrize("kw,device,engine", [
    ({}, "cuda", "pallas_mega"),
    ({}, "cpu", "xla"),
    ({"collect_counters": True}, "cuda", "pallas_fused"),
    ({"round_engine": "pallas_mega", "collect_counters": True}, "cuda",
     "pallas_fused"),
    ({"n_parties": 70, "n_dishonest": 0}, "cuda", "xla"),
    ({"qsim_path": "stabilizer"}, "cuda", "pallas_mega"),
    ({"qsim_path": "stabilizer", "mega_gen": "host"}, "cuda", "pallas_mega"),
    ({"round_engine": "pallas_tiled"}, "cuda", "pallas_tiled"),
])
def test_byte_model_prices_the_engine_the_worker_resolves(kw, device, engine):
    import warnings

    from qba_tpu_torch.config import QBAConfig
    from qba_tpu_torch.rounds.engine import resolve_round_engine

    cfg = QBAConfig(**{"n_parties": 11, "size_l": 16, "n_dishonest": 3,
                       **kw})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert resolve_round_engine(cfg, device) == engine
    with warnings.catch_warnings():
        # The worker reports a demotion; pricing follows it silently.
        warnings.simplefilter("error")
        terms = memory.trial_bytes(cfg, device)
    assert ("accepted" in terms) == (engine != "pallas_mega")
    plain = dataclasses.replace(cfg, round_engine=engine,
                                collect_counters=False)
    assert terms["pools"] == memory.trial_bytes(plain, "cuda")["pools"]


def test_admission_refuses_a_tp_mesh(tmp_path, capsys):
    with pytest.raises(ValueError, match="A12b"):
        _controller(pfleet, mesh_shape=(1, 2))
    assert _controller(pfleet, mesh_shape=(2, 1)).mesh_shape == (2, 1)
    for flag in (["--mesh-tp", "2"], ["--mesh-dp", "2"],
                 ["--tp-comms", "ring"]):
        assert pcli.main(["fleet", "--queue-dir", str(tmp_path / "q"),
                          "--device", "cpu", *flag]) == 2
        assert "A12b" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "q")


def _fake_smi(tmp_path, monkeypatch, rows):
    """An ``nvidia-smi`` alone on PATH that lists ``rows`` (index, uuid,
    MiB) whatever it is asked."""
    smi = tmp_path / "bin" / "nvidia-smi"
    smi.parent.mkdir()
    body = "".join(f"{i}, {u}, {m}\\n" for i, u, m in rows)
    smi.write_text(f"#!/bin/sh\nprintf '{body}'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", str(smi.parent))


def test_device_memory_bytes_reads_the_visible_cards(tmp_path, monkeypatch):
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert memory.device_memory_bytes("cpu") == host
    with pytest.raises(ValueError, match="device"):
        memory.device_memory_bytes(None)
    # Without nvidia-smi a CUDA fleet has no memory to price against.
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with pytest.raises(ValueError, match="nvidia-smi"):
        memory.device_memory_bytes("cuda")
    _fake_smi(tmp_path, monkeypatch, [(0, "GPU-aa11", 81559),
                                      (1, "GPU-bb22", 40960),
                                      (2, "GPU-cc33", 81559)])
    assert memory.visible_cards() == ["0", "1", "2"]
    assert memory.device_memory_bytes("cuda") == 40960 * 2**20
    # The cards the process was given, by index or by UUID prefix.
    for visible in ("2,0", "GPU-cc,GPU-aa11"):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert memory.device_memory_bytes("cuda") == 81559 * 2**20
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    with pytest.raises(ValueError, match="nvidia-smi"):
        memory.device_memory_bytes("cuda")


# ---- the front end and the workers -------------------------------------


def _stream_lines(serve):
    return [
        json.dumps(_req(serve, "s1", trials=3, seed=5).to_json()),
        json.dumps({"n_parties": 4, "size_l": 4, "trials": 2}),  # no id
        "this is not json",
        json.dumps({"request_id": "bad1", "n_parties": 0, "size_l": 4,
                    "trials": 2}),
        json.dumps(_req(serve, "t1", d=1, trials=16, seed=2,
                        target=TARGET).to_json()),
    ]


def _worker(pkg, qdir, tel, n):
    _fleet, serve, _qfs, transport = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    with jax.threefry_partitionable(True):
        server = serve.QBAServer(chunk_trials=4, replica_id="r0",
                                 telemetry_dir=tel, **kw)
        transport.serve_file_queue(server, qdir, poll_s=0.01,
                                   max_requests=n)


def _fleet_run(root, fe_pkg, worker_pkg):
    """One stream through ``fe_pkg``'s front end (admission on) and one
    ``worker_pkg`` worker thread; returns the results by id, the queue
    and telemetry dirs."""
    qdir, tel = str(root / "q"), str(root / "t")
    fleet = PKGS[fe_pkg][0]
    fe = fleet.FleetFrontend(
        qdir, _controller(fleet, chunk_trials=4, window_chunks=64),
        poll_s=0.01, max_requests=4)
    worker = threading.Thread(target=_worker,
                              args=(worker_pkg, qdir, tel, 3), daemon=True)
    worker.start()
    port = fe.start_in_thread()
    conn = socket.create_connection(("127.0.0.1", port), timeout=120)
    wire = conn.makefile("rw")
    for line in _stream_lines(PKGS[fe_pkg][1]):
        wire.write(line + "\n")
    wire.flush()
    conn.shutdown(socket.SHUT_WR)
    results = {r["request_id"]: r
               for r in (json.loads(ln) for ln in wire if ln.strip())}
    conn.close()
    fe.stop_in_thread()
    worker.join(timeout=120)
    assert not worker.is_alive()
    return results, qdir, tel


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """JAX's front end and worker (the reference), and the port's."""
    return {pair: _fleet_run(tmp_path_factory.mktemp("-".join(pair)), *pair)
            for pair in (("jax", "jax"), ("torch", "torch"))}


SAME = ("request_id", "error", "success", "successes", "n_trials", "chunks",
        "bucket", "stop", "ci", "admission", "replica_id")


@pytest.mark.parametrize("pair", [("torch", "torch"), ("torch", "jax"),
                                  ("jax", "torch")])
def test_frontend_results_equal_jax(fleet_runs, tmp_path, pair):
    want = fleet_runs[("jax", "jax")][0]
    got = (fleet_runs[pair][0] if pair in fleet_runs
           else _fleet_run(tmp_path, *pair)[0])
    assert set(got) == set(want) == {"s1", "fl00000", "<undecoded>", "bad1",
                                     "t1"}
    for rid in want:
        for f in SAME:
            assert got[rid].get(f) == want[rid].get(f), (pair, rid, f)
    assert got["s1"]["admission"]["action"] == pfleet.ADMIT
    assert got["t1"]["stop"]["reason"].startswith("decided")
    assert got["bad1"]["admission"]["reason"] == "invalid_request"


def test_frontend_results_equal_direct_runs(fleet_runs):
    got, qdir, _tel = fleet_runs[("torch", "torch")]
    for rid, kw in (("s1", dict(trials=3, seed=5)),
                    ("t1", dict(d=1, trials=16, seed=2))):
        direct = pserve.serve_batch(pserve.QBAServer(chunk_trials=4,
                                                     device="cpu"),
                                    [_req(pserve, rid, **kw)])[0]
        assert got[rid]["success"] == direct.success[:got[rid]["n_trials"]]
    # Forwarded results are consumed out of outbox/ into consumed/.
    assert os.listdir(os.path.join(qdir, "outbox")) == []
    assert sorted(os.listdir(os.path.join(qdir, "consumed"))) == [
        "fl00000.json", "s1.json", "t1.json"]


def test_http_metrics_status_and_post(tmp_path):
    qdir = str(tmp_path / "q")
    fe = pfleet.FleetFrontend(qdir, None, poll_s=0.01, max_requests=1)
    worker = threading.Thread(target=_worker,
                              args=("torch", qdir, None, 1), daemon=True)
    worker.start()
    port = fe.start_in_thread()

    def http(raw):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
            c.sendall(raw)
            buf = b""
            while chunk := c.recv(65536):
                buf += chunk
        head, _, body = buf.partition(b"\r\n\r\n")
        return int(head.split(b" ")[1]), body

    code, body = http(b"GET /status HTTP/1.1\r\n\r\n")
    assert code == 200 and json.loads(body)["requests_seen"] == 0
    payload = (json.dumps(_req(pserve, "h1", trials=2, seed=3).to_json())
               + "\n").encode()
    code, body = http(b"POST /eval HTTP/1.1\r\nContent-Length: "
                      + str(len(payload)).encode() + b"\r\n\r\n" + payload)
    res = json.loads(body.splitlines()[0])
    assert code == 200 and res["request_id"] == "h1" and res["error"] is None
    worker.join(timeout=120)
    text = fe.metrics.render()
    assert validate_exposition(text) == []
    assert "qba_intake_requests_total 1" in text
    assert 'qba_queue_files{box="consumed"} 1' in text
    fe.stop_in_thread()


# ---- the fleet summary and the stitched traces -------------------------


def _strip_elapsed(summary):
    return {k: v for k, v in summary.items()
            if k not in ("elapsed_s", "requests_per_min")}


@pytest.mark.parametrize("pair", [("torch", "torch"), ("jax", "jax")])
def test_summary_and_traces_equal_jax(fleet_runs, pair):
    _got, qdir, tel = fleet_runs[pair]
    got = pfleet.fleet_summary(qdir, telemetry_dir=tel, elapsed_s=2.0)
    want = jfleet.fleet_summary(qdir, telemetry_dir=tel, elapsed_s=2.0)
    assert got == want
    assert got["completed"] == 3 and got["errored"] == 0
    assert got["schema"] == pfleet.FLEET_SUMMARY_SCHEMA
    stitched = ptracing.stitch_traces(qdir, telemetry_dir=tel)
    assert stitched == jtracing.stitch_traces(qdir, telemetry_dir=tel)
    block = ptracing.trace_summary(stitched)
    assert block == got["traces"]
    # One closed trace per request that reached intake, no orphans.
    assert (block["count"], block["closed"], block["open"],
            block["orphan_spans"]) == (4, 4, 0, 0)
    path = pfleet.write_fleet_summary(qdir, got)
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(got))


@pytest.mark.parametrize("args", [[], ["t1"], ["--out", "trace.json"]])
def test_trace_command_equals_jax(fleet_runs, tmp_path, args):
    _got, qdir, tel = fleet_runs[("torch", "torch")]
    outs = {}
    for name, main in (("torch", pcli.main), ("jax", jcli.main)):
        argv = ["trace", "--queue-dir", qdir, "--telemetry", tel]
        argv += [str(tmp_path / f"{name}-{a}") if a.endswith(".json") else a
                 for a in args]
        out = io.StringIO()
        assert main(argv, out=out) == 0
        outs[name] = json.loads(out.getvalue())
        if "--out" in args:
            with open(tmp_path / f"{name}-trace.json") as f:
                outs[name] = (outs[name]["traces"], json.load(f))
    assert outs["torch"] == outs["jax"]
    if not args:
        assert outs["torch"]["summary"]["closed"] == 4
    assert pcli.main(["trace", "nope", "--queue-dir", qdir]) == 1


# ---- the supervisor over stub replicas ---------------------------------


def _queue_dirs(root):
    for d in ("inbox", "claimed", "done", "dead", "outbox"):
        os.makedirs(root / "q" / d, exist_ok=True)
    return root / "q"


def _write_hb(qfs, qdir, rid, pid, phase, monotonic, request_ids=()):
    qfs.write_json_atomic(qfs.heartbeat_path(str(qdir), rid), {
        "schema": "qba-tpu/heartbeat/v1", "replica_id": rid, "pid": pid,
        "seq": 1, "phase": phase, "request_ids": list(request_ids),
        "monotonic": monotonic, "stamp": 0.0})


class _FakeProc:
    def __init__(self, pid, returncode=None):
        self.pid = pid
        self.returncode = returncode

    def poll(self):
        return self.returncode


class _StubReplica:
    def __init__(self, rid, pid, returncode=None):
        self.replica_id = rid
        self.proc = _FakeProc(pid, returncode)
        self.env = {}
        self.returncode = returncode

    @property
    def alive(self):
        return self.proc.returncode is None


class _StubPool:
    """Duck-typed pool: a real queue dir, fake processes."""

    def __init__(self, queue_dir, replicas):
        self.queue_dir = str(queue_dir)
        self.replicas = replicas
        self.benched = set()
        self.restarted = []
        self.killed = []

    def kill(self, rid):
        for r in self.replicas:
            if r.replica_id == rid and r.alive:
                self.killed.append(rid)
                r.proc.returncode = -9
                return r.proc.pid
        raise ValueError(rid)

    def bench(self, rid):
        if rid in self.benched:
            return False
        self.benched.add(rid)
        return True

    def respawn_dead(self):
        return []


def _classify(pkg, root):
    fleet, _serve, qfs, _t = PKGS[pkg]
    qdir = _queue_dirs(root)
    r0 = _StubReplica("r0", 100)
    now = [1000.0]
    sup = fleet.FleetSupervisor(_StubPool(qdir, [r0]), watchdog_s=10.0,
                                clock=lambda: now[0])
    seen = [sup.classify(r0)]
    now[0] = 1031.0
    seen.append(sup.classify(r0))
    _write_hb(qfs, qdir, "r0", 999, "dispatch", 1030.0)
    seen.append(sup.classify(r0))
    _write_hb(qfs, qdir, "r0", 100, "dispatch", 1031.0, ["w1"])
    for t in (1036.0, 1042.0):
        now[0] = t
        seen.append(sup.classify(r0))
    _write_hb(qfs, qdir, "r0", 100, "compile", 1031.0, ["w1"])
    seen.append(sup.classify(r0))
    now[0] = 1031.0 + 10.0 * fleet.WATCHDOG_PHASE_SCALE["compile"] + 1.0
    seen.append(sup.classify(r0))
    _write_hb(qfs, qdir, "r0", 100, "idle", now[0])
    seen.append(sup.classify(r0))
    r0.proc.returncode = -9
    seen.append(sup.classify(r0))
    return seen


def _hung(pkg, root):
    fleet, serve, qfs, _t = PKGS[pkg]
    qdir = _queue_dirs(root)
    (qdir / "claimed" / "w1.json").write_text(
        json.dumps(_req(serve, "w1", trials=3).to_json()))
    pool = _StubPool(qdir, [_StubReplica("r0", 100), _StubReplica("r1", 101)])
    now = [1000.0]
    sup = fleet.FleetSupervisor(pool, watchdog_s=5.0, clock=lambda: now[0])
    _write_hb(qfs, qdir, "r0", 100, "dispatch", 1000.0, ["w1"])
    _write_hb(qfs, qdir, "r1", 101, "idle", 1000.0)
    health = sup.health()
    now[0] = 1006.0
    _write_hb(qfs, qdir, "r1", 101, "idle", 1005.5)
    step = sup.poll()
    return dict(health={k: v["state"] for k, v in health.items()},
                killed=step["hung_killed"], pool_killed=pool.killed,
                inbox=os.listdir(qdir / "inbox"),
                claimed=os.listdir(qdir / "claimed"),
                ledger=json.loads((qdir / "crash_ledger.json").read_text()))


def _poison(pkg, root):
    fleet, serve, qfs, _t = PKGS[pkg]
    qdir = _queue_dirs(root)
    (qdir / "claimed" / "p1.json").write_text(
        json.dumps(_req(serve, "p1", trials=3).to_json()))
    r1 = _StubReplica("r1", 101)
    pool = _StubPool(qdir, [_StubReplica("r0", 100, returncode=113), r1,
                            _StubReplica("r2", 102, returncode=-9)])
    now = [1000.0]
    sup = fleet.FleetSupervisor(pool, watchdog_s=30.0, poison_threshold=2,
                                clock=lambda: now[0])
    _write_hb(qfs, qdir, "r0", 100, "dispatch", 1000.0, ["p1"])
    _write_hb(qfs, qdir, "r1", 101, "idle", 1000.0)
    _write_hb(qfs, qdir, "r2", 102, "idle", 1000.0)
    sup.poll()
    released = os.listdir(qdir / "inbox")
    r1.proc.returncode = 113
    _write_hb(qfs, qdir, "r1", 101, "claim", 1001.0, ["p1"])
    sup.poll()
    res = json.loads((qdir / "outbox" / "p1.json").read_text())
    summary = fleet.fleet_summary(str(qdir), self_healing=sup.summary())
    return dict(released=released, dead=os.listdir(qdir / "dead"),
                error=res["error"], report=res["crash_report"],
                summary={k: summary[k] for k in ("quarantined",
                                                 "crash_ledger")},
                healing=summary["self_healing"]["releases"])


def _breaker(pkg, root):
    fleet, _serve, _qfs, _t = PKGS[pkg]
    qdir = _queue_dirs(root)
    r0 = _StubReplica("r0", 100, returncode=-9)
    pool = _StubPool(qdir, [r0, _StubReplica("r1", 101)])
    ac = _controller(fleet, replicas=2)
    now = [1000.0]
    sup = fleet.FleetSupervisor(pool, admission=ac, watchdog_s=30.0,
                                breaker_k=2, breaker_window_s=60.0,
                                clock=lambda: now[0])
    first = sup.poll()["benched"]
    r0.proc = _FakeProc(102, returncode=-9)
    now[0] = 1010.0
    second = sup.poll()["benched"]
    return dict(first=first, second=second, benched=sorted(pool.benched),
                capacity=ac.capacity_trials, again=ac.bench_replica("r0"),
                released=sup.bench_events[0]["capacity_released"],
                health=sup.health()["r0"]["benched"],
                summary=sup.summary()["benched"])


SCENARIOS = {"classify": _classify, "hung": _hung, "poison": _poison,
             "breaker": _breaker}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_supervisor_outcomes_equal_jax(tmp_path, scenario):
    got = SCENARIOS[scenario]("torch", tmp_path / "torch")
    want = SCENARIOS[scenario]("jax", tmp_path / "jax")

    def plain(x):  # drop wall clocks and pids of this process
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()
                    if k not in ("at", "wall", "flight_recorder")}
        if isinstance(x, list):
            return [plain(v) for v in x]
        return x

    assert plain(got) == plain(want)
    if scenario == "classify":
        assert [(v["state"], v.get("phase")) for v in got] == [
            ("healthy", "boot"), ("hung", "boot"), ("hung", "boot"),
            ("busy", "dispatch"), ("hung", "dispatch"),
            ("busy", "compile"), ("hung", "compile"),
            ("healthy", "idle"), ("dead", None)]
    elif scenario == "hung":
        assert got["killed"] == ["r0"] and got["inbox"] == ["w1.json"]
        assert got["ledger"]["schema"] == pfleet.CRASH_LEDGER_SCHEMA
    elif scenario == "poison":
        assert got["dead"] == ["p1.json"] and got["released"] == ["p1.json"]
        assert got["report"]["blamed_replicas"] == ["r0", "r1"]
        assert got["report"]["exit_codes"] == [113, 113]
    else:
        assert (got["first"], got["second"], got["capacity"]) == (
            [], ["r0"], 16)


def test_respawn_backoff_and_max_respawns_bench(tmp_path, monkeypatch):
    qdir = _queue_dirs(tmp_path)
    pool = pfleet.ReplicaPool(str(qdir), replicas=1, max_respawns=2,
                              respawn_backoff_s=60.0, device="cpu")
    spawned = []

    def fake_spawn(index):
        r = _StubReplica(f"r{index}", 200 + len(spawned))
        spawned.append(r)
        return r

    monkeypatch.setattr(pool, "_spawn", fake_spawn)
    pool.replicas = [_StubReplica("r0", 100, returncode=-9)]
    assert pool.respawn_dead() == ["r0"]
    spawned[-1].proc.returncode = -9
    assert pool.respawn_dead() == []  # inside the backoff window
    pool._next_respawn_at["r0"] = 0.0
    assert pool.respawn_dead() == ["r0"]
    spawned[-1].proc.returncode = -9
    pool._next_respawn_at["r0"] = 0.0
    assert pool.respawn_dead() == []
    assert pool.benched == {"r0"}
    assert [e["respawns"] for e in pool.restarted] == [1, 2]
    state = json.loads((qdir / "replicas.json").read_text())
    assert state["benched"] == ["r0"] and len(state["restarted"]) == 2


def test_pool_kill_and_stop_survive_a_wedged_process(tmp_path):
    import subprocess

    class _Wedged:
        pid = 4242
        returncode = None

        def poll(self):
            return None

        def send_signal(self, sig):
            pass

        def kill(self):
            pass

        def wait(self, timeout=None):
            raise subprocess.TimeoutExpired(cmd="worker", timeout=timeout)

    pool = pfleet.ReplicaPool(str(_queue_dirs(tmp_path)), replicas=1)
    stub = _StubReplica("r0", 4242)
    stub.proc = _Wedged()
    pool.replicas = [stub]
    assert pool.kill("r0") == 4242
    assert pool.stop(timeout_s=0.2) == {"r0": None}


class _Died(BaseException):
    """What the crash hook's ``os._exit`` raises in the worker thread."""


def test_crash_hook_ends_the_worker_and_the_report_names_it(tmp_path,
                                                            monkeypatch):
    qdir = _queue_dirs(tmp_path)
    req = _req(pserve, "poison-7", trials=3)
    pqueuefs.drop_request(str(qdir / "inbox"), req.to_json(), req.request_id)
    monkeypatch.setenv(ptransport.CRASH_HOOK_ENV, "poison")
    codes = []

    def exit_(code):
        codes.append(code)
        raise _Died

    monkeypatch.setattr(os, "_exit", exit_)
    replica = _StubReplica("r0", os.getpid())

    def worker():
        server = pserve.QBAServer(chunk_trials=4, replica_id="r0",
                                  device="cpu")
        try:
            ptransport.serve_file_queue(server, str(qdir), poll_s=0.01,
                                        max_requests=1)
        except _Died:
            replica.proc.returncode = ptransport.CRASH_HOOK_EXIT

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    thread.join(timeout=60)
    assert codes == [113] == [ptransport.CRASH_HOOK_EXIT]
    # The claim is left for the supervisor; no result was written.
    assert os.listdir(qdir / "claimed") == ["poison-7.json"]
    assert os.listdir(qdir / "outbox") == []
    sup = pfleet.FleetSupervisor(_StubPool(qdir, [replica]),
                                 poison_threshold=1)
    step = sup.poll()
    assert [d["request_ids"] for d in step["deaths"]] == [["poison-7"]]
    assert step["deaths"][0]["phase"] == "claim"
    res = json.loads((qdir / "outbox" / "poison-7.json").read_text())
    assert "quarantined as poison" in res["error"]
    assert res["crash_report"]["blamed_replicas"] == ["r0"]
    assert res["crash_report"]["exit_codes"] == [113]
    assert sup.quarantined["poison-7"]["request_id"] == "poison-7"
    assert os.listdir(qdir / "dead") == ["poison-7.json"]


# ---- spawning ----------------------------------------------------------


def test_worker_argv_runs_the_ports_serve_loop(tmp_path):
    kw = dict(replicas=2, chunk_trials=16, cache_dir="/c",
              reclaim_timeout_s=7.0, telemetry_dir="/t", deadline_s=3.0)
    got = pfleet.ReplicaPool(str(tmp_path / "q"), device="cpu",
                             **kw).worker_argv("r1")
    want = jfleet.ReplicaPool(str(tmp_path / "q"), **kw).worker_argv("r1")
    assert got[1:3] == ["-m", "qba_tpu_torch"] and want[1:3] == [
        "-m", "qba_tpu"]
    i = got.index("--device")
    assert got[i:i + 2] == ["--device", "cpu"]
    # The JAX pool's flags, in its order, plus the port's --device.
    assert got[3:i] + got[i + 2:] == want[3:]
    assert pfleet.ReplicaPool(str(tmp_path / "q")).worker_argv("r0")[
        i + 1] == "cuda"
    with pytest.raises(ValueError, match="device"):
        pfleet.ReplicaPool(str(tmp_path / "q"), device="tpu")


def test_make_device_env_pins_cards(monkeypatch):
    cards = [str(i) for i in range(8)]
    assert pfleet.make_device_env(3, "cuda", cards=cards) == {
        "CUDA_VISIBLE_DEVICES": "3"}
    # Past the last card the replicas share them round-robin: a one-card
    # host puts every worker on card 0.
    assert [pfleet.make_device_env(i, "cuda", cards=["0"])[
        "CUDA_VISIBLE_DEVICES"] for i in range(3)] == ["0", "0", "0"]
    assert pfleet.make_device_env(5, "cuda", cards=["0", "1"]) == {
        "CUDA_VISIBLE_DEVICES": "1"}
    # A fleet given cards 2 and 5 keeps its replicas on them, as the
    # memory it is priced against does; no visible card pins nothing.
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,5")
    assert [pfleet.make_device_env(i)["CUDA_VISIBLE_DEVICES"]
            for i in range(3)] == ["2", "5", "2"]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert pfleet.make_device_env(0) == {}
    cpu = pfleet.make_device_env(3, "cpu")
    assert "CUDA_VISIBLE_DEVICES" not in cpu and not any(
        k.startswith(("TPU_", "XLA_", "JAX_")) for k in cpu)
