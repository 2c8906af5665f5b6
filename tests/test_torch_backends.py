"""The port's message-level backends (``local``, ``native``, ``mp``) and
``python -m qba_tpu_torch run`` against the JAX package.

The port's ``local`` backend against ``qba_tpu``'s ``run_trial_local``
on the same trial keys, result and JSONL trail event for event; the
port's ``native`` and ``mp`` against its ``local`` and its batched runner
(``run_trials(device="cpu")``), trial for trial, with the same trails;
the C codec and consistency predicate against Python; the mp backend's
deadline hazards; the party module's independence of torch; ``run
--device cpu`` on every backend against ``qba_tpu.cli.main(["run",
...])``; ``profile_trace`` on the CPU.  Every output is an integer or a
flag: the tolerance is exact.
"""

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu import cli as j_cli
from qba_tpu.backends.jax_backend import trial_keys as j_trial_keys
from qba_tpu.backends.local_backend import run_trial_local as j_local
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu.obs import EventLog as JEventLog
from qba_tpu.obs import Level as JLevel
from qba_tpu_torch import cli, native
from qba_tpu_torch.adversary import EFFECT_NAMES, adversary_ctx
from qba_tpu_torch.adversary import assign_dishonest, commander_orders
from qba_tpu_torch.backends import local_backend as lb
from qba_tpu_torch.backends import mp_backend, mp_party
from qba_tpu_torch.backends.local_backend import (
    presample_batch,
    run_trial_local,
    run_trials_local,
)
from qba_tpu_torch.backends.mp_backend import party_draws, run_trials_mp
from qba_tpu_torch.backends.native_backend import (
    run_trial_native,
    run_trials_native,
)
from qba_tpu_torch.backends.torch_backend import run_trials, trial_keys
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.convert import config_from_jax_fields
from qba_tpu_torch.obs import EventLog, Level, profile_trace
from qba_tpu_torch.obs.profiling import trace_path, trace_summary
from qba_tpu_torch.ops.attack_draws import attack_draws_reference

_i32p = ctypes.POINTER(ctypes.c_int32)

CASES = {
    "5p": dict(n_parties=5, size_l=16, n_dishonest=2, trials=3, seed=3),
    "5p-racy-defer": dict(n_parties=5, size_l=16, n_dishonest=1, trials=3,
                          seed=5, delivery="racy", p_late=0.25,
                          racy_mode="defer"),
    "5p-slots1": dict(n_parties=5, size_l=16, n_dishonest=2, trials=3,
                      seed=1, max_accepts_per_round=1),
    "7p-split": dict(n_parties=7, size_l=16, n_dishonest=2, trials=2,
                     seed=4, strategy="split"),
    "7p-collude": dict(n_parties=7, size_l=16, n_dishonest=2, trials=2,
                       seed=4, strategy="collude"),
    "7p-adaptive": dict(n_parties=7, size_l=16, n_dishonest=2, trials=2,
                        seed=4, strategy="adaptive"),
    "7p-broadcast": dict(n_parties=7, size_l=16, n_dishonest=2, trials=2,
                         seed=4, attack_scope="broadcast"),
    "5p-dishonest-commander": dict(n_parties=5, size_l=16, n_dishonest=2,
                                   trials=3, seed=6),
}


def port_cfg(case):
    return QBAConfig(**CASES[case])


def trail(events):
    """An event log's JSONL lines, parsed, without their timestamps."""
    rows = [json.loads(line) for line in events.to_jsonl().splitlines()]
    for r in rows:
        r.pop("ts")
    return rows


@pytest.fixture(scope="module")
def jax_local():
    """JAX's message-level results and trail, once per case."""
    cache = {}

    def get(case):
        if case not in cache:
            jcfg = JConfig(**CASES[case])
            log = JEventLog(min_level=JLevel.DEBUG)
            with jax.threefry_partitionable(True):
                keys = j_trial_keys(jcfg)
                res = [j_local(jcfg, keys[i], log=log, trial=i)
                       for i in range(jcfg.trials)]
            cache[case] = res, trail(log)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_local_matches_jax_local_and_its_trail(case, jax_local):
    want, want_trail = jax_local(case)
    cfg = port_cfg(case)
    log = EventLog(min_level=Level.DEBUG)
    got = run_trials_local(cfg, trial_keys(cfg, "cpu"), log=log)
    assert got == want
    assert trail(log) == want_trail
    if case == "5p-slots1":
        assert any(r["overflow"] for r in got)
    if case == "5p-dishonest-commander":
        assert not all(r["honest"][0] for r in got)
    if case == "5p-racy-defer":
        assert any(e["message"] == "late defer" for e in want_trail)
    if case == "7p-split":
        assert any("forge-P" in e.get("action", "") for e in want_trail)


@pytest.mark.parametrize("case", list(CASES))
def test_native_local_and_batched_runner_agree(case):
    # The three-way contract: the C engine, the Python sets and the
    # batched runner on the same keys, trial for trial.
    cfg = port_cfg(case)
    keys = trial_keys(cfg, "cpu")
    nat = run_trials_native(cfg, keys)
    loc = run_trials_local(cfg, keys)
    ref = run_trials(cfg, keys, device="cpu").trials
    for f in ("success", "decisions", "honest", "vi", "overflow"):
        assert np.array_equal(nat[f], getattr(ref, f).numpy()), f
    assert np.array_equal(nat["v_comm"], ref.v_comm.numpy())
    for i, r in enumerate(loc):
        one = run_trial_native(cfg, keys[i])
        assert one == r
        assert r["decisions"] == nat["decisions"][i].tolist()
        assert r["vi"] == [set(np.flatnonzero(v).tolist())
                           for v in nat["vi"][i]]


@pytest.mark.parametrize("case", ["5p-racy-defer", "7p-split",
                                  "5p-slots1"])
def test_native_trail_equals_local(case):
    cfg = port_cfg(case)
    keys = trial_keys(cfg, "cpu")
    a, b = EventLog(min_level=Level.DEBUG), EventLog(min_level=Level.DEBUG)
    for i in range(cfg.trials):
        run_trial_local(cfg, keys[i], log=a, trial=i)
        run_trial_native(cfg, keys[i], log=b, trial=i)
    assert trail(b) == trail(a)


@pytest.mark.parametrize("case", ["5p-racy-defer", "7p-split"])
def test_mp_matches_local_over_one_mesh(case):
    # One party process a party (5 and 7 of them), one mesh for the
    # batch; the parties exit 0.
    cfg = port_cfg(case)
    keys = trial_keys(cfg, "cpu")
    a, b = EventLog(min_level=Level.DEBUG), EventLog(min_level=Level.DEBUG)
    stats, meshes = {}, []
    got = run_trials_mp(cfg, keys, log=b, stats=stats,
                        on_mesh=meshes.append)
    assert got == run_trials_local(cfg, keys, log=a)
    assert trail(b) == trail(a)
    assert len(meshes) == 1 and len(meshes[0]) == cfg.n_parties
    assert stats["exitcodes"] == [0] * cfg.n_parties
    assert stats["mesh_start_s"] > 0


def test_presample_is_the_batched_key_tree_in_every_layout():
    # The draws the message-level backends read equal the plain draws of
    # the batched runner's key tree: the tables (local, native) and each
    # party's columns (mp).
    cfg = port_cfg("7p-split")
    keys = trial_keys(cfg, "cpu")
    pre = presample_batch(cfg, keys)
    from qba_tpu_torch import random as jr

    k = jr.split(keys, 4)
    honest = assign_dishonest(cfg, k[:, 0])
    v_sent, v_comm = commander_orders(cfg, k[:, 2], honest[:, 1])
    k_rounds = k[:, 3].contiguous()
    want = [x.numpy() for x in attack_draws_reference(
        cfg, k_rounds, adversary_ctx(cfg, k_rounds, v_sent))]
    for got, w in zip((pre.attack, pre.rand_v, pre.late), want):
        assert got.dtype == np.uint8 and np.array_equal(got, w)
    assert np.array_equal(pre.honest, honest.numpy())
    assert np.array_equal(pre.v_sent, v_sent.numpy())
    assert np.array_equal(pre.v_comm, v_comm.numpy())
    for t in range(cfg.trials):
        for rank in range(2, cfg.n_parties + 1):
            assert np.array_equal(party_draws(pre, t, rank), np.stack(
                [w[t, :, :, rank - 2] for w in want], axis=-1))


def test_intake_refuses_past_the_uint8_presample():
    cfg = QBAConfig(n_parties=256, size_l=4, n_dishonest=1)
    assert cfg.w == 512
    with pytest.raises(ValueError, match="w <= 256"):
        presample_batch(cfg, trial_keys(cfg, "cpu"))


def test_effect_names_match_the_party_copy():
    assert mp_party._EFFECTS == EFFECT_NAMES


# ----------------------------------------------------------- the wire --


def _encode(lib, p, v, tuples):
    max_len = max((len(t) for t in tuples), default=1) or 1
    nt = len(tuples)
    tm = np.zeros((max(nt, 1), max_len), dtype=np.int32)
    lens = np.zeros(max(nt, 1), dtype=np.int32)
    for i, t in enumerate(tuples):
        lens[i] = len(t)
        tm[i, : len(t)] = t
    cap = 3 + len(p) + nt * (1 + max_len)
    buf = np.zeros(cap, dtype=np.int32)
    p_a = np.ascontiguousarray(p, dtype=np.int32)
    n = lib.qba_encode_pvl(p_a.ctypes.data_as(_i32p), len(p), v,
                           tm.ctypes.data_as(_i32p),
                           lens.ctypes.data_as(_i32p), nt, max_len,
                           buf.ctypes.data_as(_i32p), cap)
    return buf, n


@pytest.mark.parametrize("p,v,tuples", [
    ([1, 4, 9], 3, [(2, 5), (7, 1)]), ([], 0, []), ([0], 7, [(3,)])])
def test_codec_round_trip(p, v, tuples):
    lib = native.load()
    buf, n = _encode(lib, p, v, tuples)
    assert n == 3 + len(p) + sum(1 + len(t) for t in tuples)
    nt, max_len = max(len(tuples), 1), max([len(t) for t in tuples] + [1])
    p_out = np.zeros(max(len(p), 1), dtype=np.int32)
    t_out = np.zeros((nt, max_len), dtype=np.int32)
    l_out = np.zeros(nt, dtype=np.int32)
    hdr = np.zeros(3, dtype=np.int32)
    used = lib.qba_decode_pvl(buf.ctypes.data_as(_i32p), n,
                              p_out.ctypes.data_as(_i32p), len(p),
                              t_out.ctypes.data_as(_i32p),
                              l_out.ctypes.data_as(_i32p), len(tuples),
                              max_len, hdr.ctypes.data_as(_i32p))
    assert used == n and hdr.tolist() == [len(p), v, len(tuples)]
    assert p_out[: len(p)].tolist() == p
    assert {tuple(t_out[i, : l_out[i]].tolist())
            for i in range(len(tuples))} == set(tuples)
    # The party processes' codec object, over the same library.
    codec = mp_party._Codec(str(native.library_path()), 16, 3)
    wire = codec.encode(set(p), v, set(tuples))
    assert np.array_equal(np.frombuffer(wire, dtype=np.int32), buf[:n])
    assert codec.decode(wire) == (set(p), v, set(tuples))


def test_codec_rejects_malformed_input():
    lib = native.load()
    out = np.zeros(8, dtype=np.int32)
    hdr = np.zeros(3, dtype=np.int32)
    for bad in ([100, 1, 2], [1, 5], [0, 3, 2, 9], [-1, 0, 0]):
        bad = np.asarray(bad, dtype=np.int32)
        assert lib.qba_decode_pvl(
            bad.ctypes.data_as(_i32p), len(bad), out.ctypes.data_as(_i32p),
            8, out.ctypes.data_as(_i32p), out.ctypes.data_as(_i32p), 2, 4,
            hdr.ctypes.data_as(_i32p)) == -1
    codec = mp_party._Codec(str(native.library_path()), 8, 3)
    wire = codec.encode({1, 3}, 2, {(0, 5), (4, 1)})
    with pytest.raises(RuntimeError, match="malformed"):
        codec.decode(wire[:4])


def test_c_consistent_matches_python():
    lib = native.load()
    rng = np.random.default_rng(0)
    w = 4
    for _ in range(300):
        nt, n = int(rng.integers(0, 4)), int(rng.integers(1, 4))
        same_len = rng.random() < 0.7
        tuples = set()
        for _t in range(nt):
            ln = n if same_len else int(rng.integers(1, 4))
            tuples.add(tuple(int(x) for x in rng.integers(0, w + 1, ln)))
        v = int(rng.integers(0, w))
        want = lb._consistent(v, tuples, w)
        assert mp_party._consistent(v, tuples, w) == want
        uniq = sorted(tuples)
        max_len = max((len(t) for t in uniq), default=1)
        tm = np.zeros((max(len(uniq), 1), max_len), dtype=np.int32)
        lens = np.zeros(max(len(uniq), 1), dtype=np.int32)
        for i, t in enumerate(uniq):
            lens[i] = len(t)
            tm[i, : len(t)] = t
        got = lib.qba_consistent(v, tm.ctypes.data_as(_i32p),
                                 lens.ctypes.data_as(_i32p), len(uniq),
                                 max_len, w)
        assert bool(got) == want, (v, tuples)


# ------------------------------------------------- the mp deadlines --


def test_recv_deadline_poisons_wedged_conn():
    import multiprocessing as mp

    parent, child = mp.Pipe(duplex=True)
    try:
        with pytest.raises(RuntimeError, match="recv deadline"):
            mp_backend._recv_deadline(parent, 0.05)  # nothing ever written
        assert getattr(parent, "_qba_poisoned", False)
    finally:
        child.close()  # EOFs the abandoned reader thread


def test_recv_deadline_grace_recovers_readable_pipe():
    # remaining <= 0 with the report already in the pipe: the grace join
    # delivers it instead of poisoning a healthy party.
    import multiprocessing as mp

    parent, child = mp.Pipe(duplex=True)
    try:
        child.send(("ok", 42))
        assert mp_backend._recv_deadline(parent, 0.0) == ("ok", 42)
        assert not getattr(parent, "_qba_poisoned", False)
    finally:
        parent.close()
        child.close()


def test_send_deadline_poisons_inflight_conn():
    ev = threading.Event()

    class WedgedConn:
        def send(self, msg):
            ev.wait()  # blocked "in the OS write" until released

    class FineConn:
        def __init__(self):
            self.sent = []

        def send(self, msg):
            self.sent.append(msg)

    pipes = {1: FineConn(), 2: WedgedConn()}
    try:
        with pytest.raises(RuntimeError, match="dispatch timed out"):
            mp_backend._send_with_deadline(
                pipes, [(1, ("work",)), (2, ("work",))], 0.1)
        assert pipes[1].sent == [("work",)]
        assert getattr(pipes[2], "_qba_poisoned", False)
        assert not getattr(pipes[1], "_qba_poisoned", False)
    finally:
        ev.set()


def test_party_module_imports_without_torch():
    # The parties are forks of a server that preloads this module: it
    # must not need torch (nor jax), and the backends package's exports
    # stay lazy.
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('torch', 'jax', 'qba_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import qba_tpu_torch.backends.mp_party as m\n"
        "assert 'torch' not in sys.modules\n"
        "print(m._effect_names(3))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "drop+corrupt-v"
    from qba_tpu_torch.backends import run_trials as lazy

    assert lazy is run_trials


# -------------------------------------------------------------- run --

RUN_ARGS = ["run", "--n-parties", "5", "--size-l", "16", "--n-dishonest",
            "2", "--trials", "6", "--seed", "6", "--max-verdicts", "3"]


def blocks(text):
    """``run``'s output without its timing line."""
    return [ln for ln in text.splitlines()
            if not ln.startswith("throughput:")]


def verdicts(text):
    keep = ("trial ", "Decisions:", "Dishonests:", "Success:", "(mailbox",
            "config:", "trials:", "success rate:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.fixture(scope="module")
def jax_run_output():
    out = io.StringIO()
    with jax.threefry_partitionable(True):
        assert j_cli.main([*RUN_ARGS, "--backend", "local"], out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("backend", ["torch", "local", "native", "mp"])
def test_run_cli_prints_jax_verdicts(backend, jax_run_output):
    out = io.StringIO()
    assert cli.main([*RUN_ARGS, "--backend", backend, "--device", "cpu"],
                    out=out) == 0
    got = out.getvalue()
    assert verdicts(got) == verdicts(jax_run_output)
    assert len(verdicts(got)) == 3 * 4 + 3
    if backend == "local":
        # Every line but the timing, the INFO trail included.
        assert blocks(got) == blocks(jax_run_output)


def test_run_cli_trails_agree(tmp_path):
    # -v --jsonl on every backend: one trail (torch replays its displayed
    # trials through local, with no mismatch).
    trails = {}
    for backend in ("torch", "local", "native", "mp"):
        path = tmp_path / f"{backend}.jsonl"
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main([*RUN_ARGS, "--backend", backend, "--device",
                             "cpu", "-v", "--jsonl", str(path)],
                            out=io.StringIO()) == 0
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        trails[backend] = [{k: v for k, v in r.items() if k != "ts"}
                           for r in rows if r["message"] != "experiment"]
    assert len(trails["local"]) > 100
    for backend in ("torch", "native", "mp"):
        assert trails[backend] == trails["local"], backend


def test_run_cli_native_without_a_compiler(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "qba_native.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    rc = cli.main([*RUN_ARGS, "--backend", "native", "--device", "cpu"],
                  out=io.StringIO())
    assert rc != 0
    assert "NativeUnavailableError" in capsys.readouterr().err


def test_run_cli_default_device_is_cuda():
    # Without a card the default --device cuda raises; nothing falls back
    # to the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*RUN_ARGS, "--backend", "local"], out=io.StringIO())


def test_run_is_ported():
    assert "run" not in cli._NOT_PORTED


def test_port_config_mirrors_the_jax_config():
    # The cases' configs mean the same experiment in both packages.
    jcfg = JConfig(**CASES["5p"])
    assert config_from_jax_fields(dataclasses.asdict(jcfg)) == port_cfg("5p")


# -------------------------------------------------------- profiling --


def test_profile_trace_writes_a_trace_on_the_cpu(tmp_path):
    d = str(tmp_path / "prof")
    with profile_trace(d):
        x = torch.arange(64).reshape(8, 8)
        (x @ x).sum()
    summary = trace_summary(trace_path(d))
    assert os.path.getsize(trace_path(d)) > 0
    assert summary["window_ms"] > 0 and summary["device_busy_ms"] == 0
    with profile_trace(None):
        pass
    assert os.listdir(tmp_path) == ["prof"]
