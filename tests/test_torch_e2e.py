"""The port's trial batches equal the JAX package's, trial for trial.

``qba_tpu_torch.run_trials(cfg, device="cpu")`` against
``qba_tpu.backends.jax_backend.run_trials`` on the same config (same
seed, hence the same keys): per-trial decisions, success, accepted sets,
overflow, honesty and commander order must be equal, for the four
strategies at 5p/L16/d2 and 11p/L64/d3, both attack scopes, noise, racy
delivery and an overflowing slot bound.  Every port engine (``xla``,
and ``pallas_fused``, ``pallas_tiled`` and ``pallas_mega`` on their
kernels' plain versions here) is checked; ``pallas`` has its own file,
tests/test_torch_round_step.py.
Plus: ``device=None`` means CUDA and raises without it, and the port
imports and runs with ``jax``, ``flax`` and ``qba_tpu`` blocked, the
stabilizer path, the megakernel's gen entry (plain version), the
party-sharded ``run_trials_spmd`` on a CPU mesh and ``python -m
qba_tpu_torch sweep --dispatch device`` included.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

import qba_tpu_torch
from qba_tpu.backends.jax_backend import run_trials as j_run_trials
from qba_tpu.config import QBAConfig as JConfig
from qba_tpu_torch.convert import config_from_jax_fields

FIELDS = ("decisions", "success", "vi", "overflow", "honest", "v_comm")
ENGINES = ("xla", "pallas_fused", "pallas_tiled", "pallas_mega")
P5 = dict(n_parties=5, size_l=16, n_dishonest=2, trials=16)
P11 = dict(n_parties=11, size_l=64, n_dishonest=3, trials=3)
CASES = {
    **{f"5p-{s}": dict(P5, strategy=s, seed=3)
       for s in ("reference", "collude", "adaptive", "split")},
    **{f"11p-{s}": dict(P11, strategy=s, seed=1)
       for s in ("reference", "collude", "adaptive", "split")},
    "5p-broadcast": dict(P5, attack_scope="broadcast", seed=4),
    "5p-racy-noise": dict(P5, delivery="racy", p_late=0.2,
                          p_depolarize=0.05, p_measure_flip=0.02, seed=5),
    "5p-overflow": dict(P5, max_accepts_per_round=1, seed=2),
}


def jax_trials(jcfg):
    with jax.threefry_partitionable(True):
        res = j_run_trials(jcfg)
        return {f: np.asarray(getattr(res.trials, f)) for f in FIELDS}


@pytest.mark.parametrize("case", list(CASES))
def test_run_trials_match_jax(case):
    jcfg = JConfig(**CASES[case])
    want = jax_trials(jcfg)
    cfg = config_from_jax_fields(dataclasses.asdict(jcfg))
    for engine in ENGINES:
        res = qba_tpu_torch.run_trials(
            dataclasses.replace(cfg, round_engine=engine), device="cpu"
        )
        for f in FIELDS:
            assert np.array_equal(want[f], getattr(res.trials, f).numpy()), (
                engine, f)
        assert res.success_rate.item() == pytest.approx(
            want["success"].mean())
    if case == "5p-overflow":
        assert want["overflow"].any()
    assert not want["honest"].all()  # Byzantine parties took part


def test_engines_agree_in_port():
    cfg = qba_tpu_torch.QBAConfig(n_parties=7, size_l=32, n_dishonest=3,
                                  trials=12, seed=8, strategy="adaptive")
    a, *rest = (qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine=e), device="cpu").trials
        for e in ENGINES)
    for b in rest:
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_auto_engine_on_cpu_is_xla():
    from qba_tpu_torch.rounds.engine import resolve_round_engine

    cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16)
    assert resolve_round_engine(cfg, torch.device("cpu")) == "xla"
    assert resolve_round_engine(
        cfg, torch.device("cuda")) == "pallas_mega"


# auto on CUDA past the kernels' 64-bit masks: (config, engine, whether
# the resolver records a demotion).  65 parties have w = 128.
P65 = dict(n_parties=65, size_l=8, n_dishonest=1)
P33 = dict(n_parties=33, size_l=64, n_dishonest=10)
MASK_CASES = {
    "65p": (P65, "xla", True),
    "65p-counters": (dict(P65, collect_counters=True), "xla", True),
    "33p": (P33, "pallas_mega", False),
    "33p-counters": (dict(P33, collect_counters=True), "pallas_fused",
                     False),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_auto_on_cuda_past_the_masks_is_xla(case):
    import warnings

    from qba_tpu_torch.diagnostics import QBADemotionWarning
    from qba_tpu_torch.parallel.spmd import _resolve_spmd_engine
    from qba_tpu_torch.rounds.engine import (
        resolve_mega_gen,
        resolve_round_engine,
    )

    kw, engine, demotes = MASK_CASES[case]
    cfg = qba_tpu_torch.QBAConfig(**kw)
    stab = dataclasses.replace(cfg, qsim_path="stabilizer")
    cuda = torch.device("cuda")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert resolve_round_engine(cfg, cuda) == engine
        # The gen entry only where the engine is the megakernel.
        assert resolve_mega_gen(stab, cuda) == (
            "gf2" if engine == "pallas_mega" else "host")
        if demotes:
            # The tp mesh's auto too (its kernels share the masks).
            assert _resolve_spmd_engine(cfg, cfg.n_lieutenants // 4,
                                        cuda) == "xla"
    demotions = [w.message for w in seen
                 if isinstance(w.message, QBADemotionWarning)]
    assert len(demotions) == (2 if demotes else 0), demotions
    for w in demotions:
        assert w.reason == "kernel_masks_64" and "64-bit masks" in str(w)
    assert resolve_round_engine(cfg, torch.device("cpu")) == "xla"


@pytest.mark.parametrize("engine", ["pallas_mega", "pallas_fused",
                                    "pallas_tiled", "pallas"])
def test_forced_kernel_engine_past_the_masks_still_raises(engine):
    import warnings

    from qba_tpu_torch.ops._launch import check_kernel_shapes, masks_fit
    from qba_tpu_torch.rounds.engine import resolve_round_engine

    cfg = qba_tpu_torch.QBAConfig(round_engine=engine, **P65)
    assert not masks_fit(cfg) and masks_fit(qba_tpu_torch.QBAConfig(**P33))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_round_engine(cfg, torch.device("cuda")) == engine
    # The wrapper refuses the launch before it reaches the card.
    with pytest.raises(NotImplementedError, match="64-bit masks"):
        check_kernel_shapes(cfg, engine)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = qba_tpu_torch.QBAConfig(n_parties=3, size_l=4, n_dishonest=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        qba_tpu_torch.run_trials(cfg)


BLOCKED_RUN = r"""
import dataclasses, importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "qba_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import qba_tpu_torch
for mod in pkgutil.walk_packages(qba_tpu_torch.__path__, "qba_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
cfg = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                              trials=8, seed=1)
res = qba_tpu_torch.run_trials(cfg, device="cpu")
assert res.trials.decisions.shape == (8, 5)
for engine in ("pallas", "pallas_fused", "pallas_tiled", "pallas_mega"):
    other = qba_tpu_torch.run_trials(
        dataclasses.replace(cfg, round_engine=engine), device="cpu")
    assert (other.trials.decisions == res.trials.decisions).all(), engine
counted = qba_tpu_torch.run_trials(
    dataclasses.replace(cfg, collect_counters=True), device="cpu")
assert (counted.trials.decisions == res.trials.decisions).all()
assert counted.trials.counters.accepts_per_round.shape == (8, 3)
dense = qba_tpu_torch.run_trials(
    qba_tpu_torch.QBAConfig(n_parties=3, size_l=8, n_dishonest=1, trials=4,
                            seed=1, qsim_path="dense"), device="cpu")
assert dense.trials.decisions.shape == (4, 3)
stab = qba_tpu_torch.QBAConfig(n_parties=5, size_l=16, n_dishonest=2,
                               trials=4, seed=2, qsim_path="stabilizer")
host = qba_tpu_torch.run_trials(stab, device="cpu")
gen = qba_tpu_torch.run_trials(
    dataclasses.replace(stab, round_engine="pallas_mega", mega_gen="gf2"),
    device="cpu")
assert (gen.trials.vi == host.trials.vi).all()
assert (gen.trials.decisions == host.trials.decisions).all()
from qba_tpu_torch.parallel import make_mesh, run_trials_spmd
mesh = make_mesh({"dp": 2, "tp": 2}, devices=["cpu"] * 4)
for engine in ("auto", "xla", "pallas", "pallas_fused", "pallas_tiled",
               "pallas_mega"):
    for comms in ("ring", "all_gather"):
        sharded = run_trials_spmd(
            dataclasses.replace(cfg, round_engine=engine, tp_comms=comms),
            mesh)
        assert (sharded.trials.vi == res.trials.vi).all(), (engine, comms)
        assert (sharded.trials.decisions == res.trials.decisions).all()
from qba_tpu_torch.sweep import run_sweep
sweep = run_sweep(cfg, 2, 8, device="cpu")
assert [c.chunk for c in sweep.chunks] == [0, 1]
for dispatch in ("host", "device"):
    targeted = run_sweep(cfg, 2, 8, target="ci_width<=0.01",
                         dispatch=dispatch, device="cpu")
    assert targeted.chunks == sweep.chunks, dispatch
    assert targeted.stop.reason == "budget_exhausted"
import io
from qba_tpu_torch.cli import main
out = io.StringIO()
assert main(["sweep", "--n-parties", "5", "--size-l", "16", "--n-dishonest",
             "1", "--trials", "8", "--seed", "3", "--n-chunks", "6",
             "--target", "decide vs 0.9 +-0.05", "--dispatch", "device",
             "--device", "cpu"], out=out) == 0
assert out.getvalue().splitlines()[-1].startswith(
    "stop: decided_below after 32 trials"), out.getvalue()
import tempfile
from qba_tpu_torch.atlas import (AtlasStore, CampaignDriver, CampaignSpec,
                                 LocalExecutor)
from qba_tpu_torch.serve.fleet import (AdmissionController, FleetFrontend,
                                       FleetSupervisor, ReplicaPool)
with tempfile.TemporaryDirectory() as d:
    spec = CampaignSpec(parties=(4,), dishonest=(1.0,), chunk_trials=8,
                        budget_trials=16, max_escalations=0)
    atlas = CampaignDriver(
        AtlasStore(d), spec, LocalExecutor(chunk_trials=8, device="cpu"),
        admission=AdmissionController(chunk_trials=8, hbm_bytes=2**34,
                                      device="cpu")).run()
    assert atlas["open"] == 0 and atlas["cells"] == 1, atlas
    assert main(["trace", "--queue-dir", d], out=io.StringIO()) == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "qba_tpu")]
assert not bad, bad
print("ok", float(res.success_rate))
"""


def test_port_runs_with_jax_blocked():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"  # tiny tensors, as in this process
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
