"""The trial keys' entry of the set-up kernel's file, on the CPU.

``keys_at_reference`` (the key entry's own algorithm: a hash a thread
from its own counters, the legacy mode's hash ``t`` giving words ``t``
and ``t + num`` of a table of ``2 num``) and ``keys_kernel``'s plain path are held against JAX's
``jax.random.split(jax.random.fold_in(key(seed), d), num)`` in both
threefry modes (JAX's set only inside ``jax.threefry_partitionable``);
the low-word randint the set-up kernel draws for a power-of-two span
against ``jax.random.randint``; and the call sites that make a batch's
keys (``trial_keys``, ``chunk_keys``, the graph loops' bodies,
``rep_keys``) are shown to pass the key entry's seam once each.  The
kernel itself runs in ``chip_smoke.py`` (``keys_vs_plain``) on the card.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Tiny tensors: PyTorch's intra-op thread pool would only spin on them
# and starve the other test workers.
torch.set_num_threads(1)

from qba_tpu_torch import QBAConfig
from qba_tpu_torch import random as jr
from qba_tpu_torch.analysis import launches as plaunches
from qba_tpu_torch.ops import _launch
from qba_tpu_torch.ops import setup_kernel as sk

MODES = {"partitionable": True, "legacy": False}


def jax_keys(seed, num, fold, p):
    with jax.threefry_partitionable(p):
        k = jax.random.key(seed)
        if fold is not None:
            k = jax.random.fold_in(k, np.int32(fold))
        return np.asarray(jax.random.key_data(jax.random.split(k, num)))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("num", [1, 2, 7, 8, 33])
def test_key_mirror_matches_jax(num, mode):
    p = MODES[mode]
    for seed in (-5, 0, 2026):
        for fold in (None, 3, -7):
            want = jax_keys(seed, num, fold, p)
            folds = [fold] if fold is None else [
                fold, torch.tensor(fold, dtype=torch.int32)]
            for f in folds:
                for got in (sk.keys_at_reference(seed, num, f,
                                                 partitionable=p),
                            sk.keys_kernel(seed, num, f, device="cpu",
                                           partitionable=p),
                            sk.keys_kernel(jr.key(seed), num, f,
                                           partitionable=p)):
                    assert got.dtype == torch.int64
                    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
def test_low_word_randint_matches_jax(mode):
    p = MODES[mode]
    with jax.threefry_partitionable(p):
        key = jax.random.key(11)
        lo = np.asarray(jax.random.bits(jax.random.split(key, 2)[1], (40,)))
        for e in range(12):
            span = 1 << e
            want = np.asarray(jax.random.randint(key, (40,), 0, span))
            got = sk.randint_low(torch.from_numpy(lo.astype(np.int64)), span)
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="power of two"):
        sk.randint_low(torch.zeros(3, dtype=torch.int64), 3)


def test_cpu_keys_take_the_plain_path():
    seen = []
    _launch.seam_observers.append(lambda name, t: seen.append(name))
    before = sk.keys_kernel.launches
    try:
        got = sk.keys_kernel(9, 5, torch.tensor(2, dtype=torch.int32))
    finally:
        _launch.seam_observers.pop()
    assert torch.equal(got, jr.split(jr.fold_in(jr.key(9), 2), 5))
    assert seen == ["trial_keys"] and sk.keys_kernel.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        sk.keys_kernel(jr.key(1).to("meta"), 3)


def test_key_sites_pass_the_key_entry(monkeypatch):
    # Each call site that makes a batch's keys reaches the key entry's seam
    # once and returns the keys the eager split made before.
    from qba_tpu_torch.backends.torch_backend import trial_keys
    from qba_tpu_torch.benchmark import rep_keys
    from qba_tpu_torch.ops import surface_loop as su
    from qba_tpu_torch.ops import sweep_loop as sl
    from qba_tpu_torch.sweep import chunk_keys

    cfg = QBAConfig(n_parties=3, size_l=4, n_dishonest=1, trials=6, seed=4)
    root = jr.key(cfg.seed)
    carry = torch.tensor([2, 0, 0, 0], dtype=torch.int32)  # chunk 2
    s_carry = torch.zeros(5, dtype=torch.int32)
    s_carry[su.I_CUR] = 2
    made = []

    def fake_run_trial(c, keys, **kw):
        made.append(keys)
        raise StopIteration

    from qba_tpu_torch.rounds import engine

    monkeypatch.setattr(engine, "run_trial", fake_run_trial)
    seen = []
    _launch.seam_observers.append(lambda name, t: seen.append(name))
    try:
        got = [trial_keys(cfg, "cpu"), chunk_keys(cfg, 2, 6, "cpu"),
               rep_keys(cfg.seed, 6, "cpu")]
        for step in (lambda: sl.chunk_step(cfg, 6, root, carry, None, None),
                     lambda: su.branch_step(cfg, 6, root, s_carry, None)):
            with pytest.raises(StopIteration):
                step()
    finally:
        _launch.seam_observers.pop()
    assert seen == ["trial_keys"] * 5
    want = [jr.split(jr.key(4), 6), jr.split(jr.fold_in(jr.key(4), 2), 6),
            jr.split(jr.key(4), 6)]
    for a, b in zip(got + made, want + [want[1], want[1]]):
        assert torch.equal(a, b)


def test_launch_model_counts_the_key_entry():
    cfg = QBAConfig(n_parties=5, size_l=16, n_dishonest=2)
    for engine in ("pallas_mega", "pallas_fused", "xla"):
        given = plaunches.batch_launch_model(cfg, engine, "cuda")
        own = plaunches.batch_launch_model(cfg, engine, "cuda",
                                           own_keys=True)
        assert "trial_keys" not in given
        assert own == dict(given, trial_keys=1)
    assert ("trial_keys_kernel", "trial_keys") in plaunches.PROFILER_KERNELS
    assert plaunches.profiler_counts(
        ["void (anonymous namespace)::trial_keys_kernel<false>(...)"]) == {
            "trial_keys": 1}
