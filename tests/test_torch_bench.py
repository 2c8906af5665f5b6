"""The port's measurement harness and ``bench`` equal the JAX package's.

``qba_tpu_torch.benchmark.measure_batch`` against
``qba_tpu.benchmark.measure_batch`` on the same recipe (fresh keys every
rep, chunks with a partial last chunk rounded up): the last rep's
per-trial decisions, success, accepted sets and overflow are equal
(exact).  ``measure_resource_gen``'s shot count, ``qsim_description``
and the ``tp`` attribution (``engine_description(..., tp=2)``, the plan's
``tp`` keys) equal JAX's; the device-memory diagnostic names
``--chunk-trials`` and lets every other error through;
``measure_device_batch``'s shapes and validation are JAX's.  ``python
-m qba_tpu_torch bench --device cpu`` prints JAX's JSON keys with JAX's
rates, engine, sampler and config on ``rounds``, ``resource_gen`` and
``adversary_sweep``; ``--preset northstar`` resolves to 33p/L64/d10 x
1000 (nothing runs at that size: the harness is stubbed);
``--profile-dir`` and ``--telemetry`` write their files; and ``bench``
runs with ``jax``, ``flax`` and ``qba_tpu`` blocked.

The JAX references compile at XLA's lowest optimisation level
(``FAST_COMPILE``: every compared output is an integer or a flag), in
the partitionable threefry mode, set only inside
``jax.threefry_partitionable(True)``.
"""

import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

import qba_tpu.backends.jax_backend as jb
from qba_tpu import benchmark as jbench
from qba_tpu import cli as jcli
from qba_tpu import config as jconfig
from qba_tpu import sweep as jsweep
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu_torch import benchmark as pbench
from qba_tpu_torch import cli as pcli
from qba_tpu_torch import config as pconfig
from qba_tpu_torch.backends import torch_backend
from qba_tpu_torch.convert import config_from_jax_fields
from tests.test_torch_draws import fast_jit

FIELDS = ("decisions", "success", "vi", "overflow")
BASE = ["bench", "--n-parties", "3", "--size-l", "4", "--n-dishonest", "1",
        "--trials", "8", "--seed", "2"]
TP_KEYS = ("tp", "tp_engine", "tp_comms", "tp_demoted_from")


def port_cfg(jcfg):
    return config_from_jax_fields(dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def jax_batch(jcfg):
    """JAX's ``batched_trials`` of ``jcfg``, compiled with
    ``FAST_COMPILE`` once a key shape."""
    return fast_jit(functools.partial(jb.batched_trials, jcfg))


def jax_run_trials(jcfg, keys=None):
    """``qba_tpu``'s ``run_trials`` (its unpacked path, the one it takes
    off the TPU) on the ``FAST_COMPILE`` program."""
    if keys is None:
        keys = jb.trial_keys(jcfg)
    return jb.aggregate(jax_batch(jcfg)(keys))


@pytest.fixture
def fast_jax(monkeypatch):
    """Route JAX's harness and surface runner through ``FAST_COMPILE``."""
    monkeypatch.setattr(jb, "run_trials", jax_run_trials)
    monkeypatch.setattr(jsweep, "_default_runner",
                        lambda chunk_trials, log: lambda c, k: jax_batch(c)(k))


def test_measure_batch_equals_jax(fast_jax):
    # 7 trials in chunks of 4: two chunks a rep, the last rounded up.
    jcfg = JConfig(n_parties=3, size_l=4, n_dishonest=1, trials=7, seed=5)
    times, n_run, results = pbench.measure_batch(port_cfg(jcfg), 2, 4,
                                                 device="cpu")
    assert n_run == 8 and len(times) == 2 and len(results) == 2
    assert all(r.trials.decisions.shape == (4, 3) for r in results)
    with jax.threefry_partitionable(True):
        _jt, j_run, j_results = jbench.measure_batch(jcfg, 2, 4)
    assert j_run == n_run
    for f in FIELDS:
        want = torch.cat([torch.from_numpy(np.array(getattr(r.trials, f)))
                          for r in j_results])
        got = torch.cat([getattr(r.trials, f) for r in results])
        assert torch.equal(got, want.to(got.dtype)), f
    with pytest.raises(ValueError, match="reps"):
        pbench.measure_batch(port_cfg(jcfg), 0, device="cpu")


@pytest.mark.parametrize("qsim_path", ["factorized", "stabilizer"])
def test_measure_resource_gen_counts_shots(qsim_path):
    cfg = pconfig.QBAConfig(n_parties=3, size_l=4, n_dishonest=1, trials=6,
                            qsim_path=qsim_path)
    times, shots = pbench.measure_resource_gen(cfg, 2, device="cpu")
    assert shots == 6 * 4 and len(times) == 2
    assert all(t > 0 for t in times)


@pytest.mark.parametrize("qsim_path", ["factorized", "dense", "dense_pallas",
                                       "stabilizer", "past_cap"])
def test_qsim_description_equals_jax(qsim_path, monkeypatch):
    kw = dict(n_parties=3, size_l=4, n_dishonest=1, trials=4)
    if qsim_path == "past_cap":
        # 5 parties hold 18 qubits: with the cap lowered past them,
        # dense_pallas hands the batch to the stabilizer engine.
        jcfg = JConfig(**dict(kw, n_parties=5), qsim_path="dense_pallas")
        cfg = port_cfg(jcfg)
        monkeypatch.setattr(jconfig, "DENSE_QUBIT_CAP", 16)
        monkeypatch.setattr(pconfig, "DENSE_QUBIT_CAP", 16)
        assert pbench.qsim_description(cfg) == "stabilizer/gf2-batched(auto)"
    else:
        jcfg = JConfig(**kw, qsim_path=qsim_path)
        cfg = port_cfg(jcfg)
    assert pbench.qsim_description(cfg) == jbench.qsim_description(jcfg)


@pytest.mark.parametrize("engine", ["auto", "xla", "pallas_mega"])
def test_tp_attribution_equals_jax(engine):
    jcfg = JConfig(n_parties=5, size_l=16, n_dishonest=1, trials=4,
                   round_engine=engine)
    cfg = port_cfg(jcfg)
    assert (pbench.engine_description(cfg, "cpu", tp=2)
            == jbench.engine_description(jcfg, tp=2))
    got, want = pbench.kernel_plan(cfg, "cpu", tp=2), jbench.kernel_plan(
        jcfg, tp=2)
    assert {k: got[k] for k in TP_KEYS} == {k: want[k] for k in TP_KEYS}
    assert "tp" not in pbench.kernel_plan(cfg, "cpu")


def test_out_of_memory_is_named(monkeypatch):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    def run_trials(cfg, keys=None, *, device=None):
        raise oom

    monkeypatch.setattr(torch_backend, "run_trials", run_trials)
    cfg = pconfig.QBAConfig(n_parties=3, size_l=4, trials=8)
    with pytest.raises(RuntimeError, match="--chunk-trials") as info:
        pbench.measure_batch(cfg, 1, device="cpu")
    assert info.value.__cause__ is oom
    assert "a batch of 8 trials" in str(info.value)
    assert "trial_ceiling) admits" in str(info.value)


def test_other_errors_pass_through(monkeypatch):
    other = RuntimeError("some unrelated launch failure")

    def run_trials(cfg, keys=None, *, device=None):
        raise other

    monkeypatch.setattr(torch_backend, "run_trials", run_trials)
    cfg = pconfig.QBAConfig(n_parties=3, size_l=4, trials=8)
    with pytest.raises(RuntimeError) as info:
        pbench.measure_batch(cfg, 1, device="cpu")
    assert info.value is other


def test_measure_device_batch_shapes():
    cfg = pconfig.QBAConfig(n_parties=3, size_l=4, trials=8)
    slopes, n_run = pbench.measure_device_batch(cfg, pairs=2, reps_lo=1,
                                                reps_hi=2, device="cpu")
    assert len(slopes) == 2 and n_run == 8
    assert all(isinstance(s, float) for s in slopes)
    _slopes, n_run = pbench.measure_device_batch(
        cfg, pairs=1, reps_lo=1, reps_hi=2, chunk_trials=3, device="cpu")
    assert n_run == 9


def test_measure_device_batch_validation():
    cfg = pconfig.QBAConfig(n_parties=3, size_l=4, trials=8)
    with pytest.raises(ValueError, match="pairs"):
        pbench.measure_device_batch(cfg, pairs=0, device="cpu")
    with pytest.raises(ValueError, match="reps_lo"):
        pbench.measure_device_batch(cfg, reps_lo=3, reps_hi=2, device="cpu")


def cli_lines(main, argv, jax_side):
    out = io.StringIO()
    if jax_side:
        with jax.threefry_partitionable(True):
            rc = main(argv, out=out)
    else:
        rc = main([*argv, "--device", "cpu"], out=out)
    assert rc == 0
    return [json.loads(ln) for ln in out.getvalue().splitlines()]


# Per scenario: the keys equal across the packages (the rest are wall
# times, or name the package's own plan).
CLI_SCENARIOS = {
    "rounds": ([], ("success_rate", "overflow_rate", "engine", "config",
                    "metric", "unit")),
    "resource_gen": (["--scenario", "resource_gen", "--qsim-path",
                      "stabilizer"],
                     ("shots_per_rep", "qsim", "config", "metric", "unit")),
}


@pytest.mark.parametrize("scenario", sorted(CLI_SCENARIOS))
def test_cli_bench_prints_jax_lines(scenario, fast_jax):
    extra, equal = CLI_SCENARIOS[scenario]
    (got,) = cli_lines(pcli.main, [*BASE, *extra], False)
    (want,) = cli_lines(jcli.main, [*BASE, *extra], True)
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in equal} == {k: want[k] for k in equal}
    assert len(got["rep_seconds"]) == 3 and got["value"] > 0
    assert got["manifest"]["command"] == "bench"
    assert got["manifest"]["environment"]["device_kind"] == "cpu"


def test_cli_adversary_sweep_equals_jax(fast_jax):
    argv = [*BASE, "--scenario", "adversary_sweep"]
    got, want = cli_lines(pcli.main, argv, False), cli_lines(jcli.main, argv,
                                                             True)
    assert len(got) == len(want) == 5  # 4 strategies x 1 noise point
    assert got[-1]["cells"] == want[-1]["cells"] == 4
    for a, b in zip(got[:-1], want[:-1]):
        assert sorted(a) == sorted(b)
        for k in ("strategy", "p_depolarize", "trials", "success_rate",
                  "overflow"):
            assert a[k] == b[k], (a["strategy"], k)
        assert a["engine"] == a["kernel_plan"]["engine"] == "xla"


@pytest.mark.parametrize("chunk", [None, 250])
def test_northstar_preset(chunk, monkeypatch):
    seen = {}

    def measure_batch(cfg, reps, chunk_trials=None, *, warmup=True,
                      device=None):
        seen.update(cfg=cfg, chunk=chunk_trials, device=device)
        flags = torch.zeros(cfg.trials, dtype=torch.bool)
        trials = types.SimpleNamespace(success=~flags, overflow=flags)
        return [2.0] * reps, cfg.trials, [types.SimpleNamespace(trials=trials)]

    monkeypatch.setattr(pbench, "measure_batch", measure_batch)
    argv = ["bench", "--n-parties", "3", "--size-l", "4", "--preset",
            "northstar"] + (["--chunk-trials", str(chunk)] if chunk else [])
    (line,) = cli_lines(pcli.main, argv, False)
    cfg = seen["cfg"]
    assert (cfg.n_parties, cfg.size_l, cfg.n_dishonest, cfg.trials) == (
        33, 64, 10, 1000)
    assert seen["chunk"] == (chunk or pbench.NORTHSTAR_CHUNK)
    assert line["config"] == dict(n_parties=33, size_l=64, n_dishonest=10,
                                  trials=1000, chunk_trials=chunk or 1000)
    assert line["value"] == 1000 * cfg.n_rounds / 2.0
    assert line["success_rate"] == 1.0 and line["overflow_rate"] == 0.0
    assert pbench.NORTHSTAR == jbench.NORTHSTAR
    assert pbench.NORTHSTAR_CHUNK == jbench.NORTHSTAR_CHUNK


def test_bench_profile_and_telemetry(tmp_path):
    argv = [*BASE, "--reps", "2", "--profile-dir", str(tmp_path / "prof"),
            "--telemetry", str(tmp_path / "tel")]
    (line,) = cli_lines(pcli.main, argv, False)
    assert len(line["rep_seconds"]) == 2
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.startswith("trace-") and trace.endswith(".json")
    with open(tmp_path / "tel" / "run_manifest.json") as f:
        written = json.load(f)
    # The session's manifest is the line's, but for when each was taken.
    timed = ("created_unix_s", "phase_totals")
    assert ({k: v for k, v in written.items() if k not in timed}
            == {k: v for k, v in line["manifest"].items() if k not in timed})
    assert {"warmup", "measure"} <= set(written["phase_totals"])
    assert pcli.main([*BASE, "--reps", "0", "--device", "cpu"],
                     out=io.StringIO()) == 2


def test_bench_is_ported():
    assert "bench" not in pcli._NOT_PORTED


BLOCKED_BENCH = r"""
import importlib.abc, io, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "qba_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from qba_tpu_torch.cli import main
base = ["bench", "--n-parties", "3", "--size-l", "4", "--n-dishonest", "1",
        "--trials", "8", "--reps", "2", "--device", "cpu"]
for extra in ([], ["--scenario", "resource_gen", "--qsim-path", "stabilizer"],
              ["--scenario", "adversary_sweep"]):
    out = io.StringIO()
    assert main(base + extra, out=out) == 0, extra
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert lines and all("metric" in ln for ln in lines), extra
print("ok")
"""


def test_bench_runs_with_jax_blocked():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"  # tiny tensors, as in this process
    proc = subprocess.run([sys.executable, "-c", BLOCKED_BENCH], cwd=repo,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    assert summary == {"bench_summary": {"kernel_launches": {}}}
