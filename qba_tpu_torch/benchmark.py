"""The shared Monte-Carlo measurement harness and its attribution — the
port of :mod:`qba_tpu.benchmark`.

``python -m qba_tpu_torch bench`` times batches through
:func:`measure_batch`, :func:`measure_resource_gen` and
:func:`measure_device_batch`, so the timing recipe exists once: fresh
keys every rep, made on the device and fenced before the clock starts
(so neither the key kernels nor a host-to-device copy fall inside it),
one fence after the batch (``torch.cuda.synchronize()``), and chunked
dispatch with a partial last chunk rounded up.  The keys are the JAX
recipe's own, so the last rep's trials equal the JAX package's trial for
trial in either threefry mode: each measure reads the mode once
(``partitionable``; None: the current mode) and makes every key and
batch in it.

A plan names what a config runs on a device: the round engine
(:func:`~qba_tpu_torch.rounds.engine.resolve_round_engine`), where the
megakernel generates the lists
(:func:`~qba_tpu_torch.rounds.engine.resolve_mega_gen`), the CUDA
libraries (``ops/csrc/<name>.cu``) it launches and how many launches a
batch and a round cost.  The serving worker's manifests and results
carry it.  The plan has the JAX package's keys, so one manifest reader
reads both packages' manifests; the keys that name the TPU's compile
probes (the VMEM block plans) carry the port's own choice: one thread
block (the tiled verdict: one cluster) a trial, ``"trial"``, on a kernel
engine, ``None`` elsewhere.  The port has no probe that can fail, so a
kernel engine is never recorded as demoted to another.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import torch

from qba_tpu_torch.config import QBAConfig

# BASELINE.md config 5 as written (the "north star": nParties=33,
# sizeL=64, nDishonest=10, lossless), 1000 trials in one batch: the
# literal of ``bench --preset northstar``, as in the JAX package.
NORTHSTAR = dict(n_parties=33, size_l=64, n_dishonest=10, trials=1000)
NORTHSTAR_CHUNK = 1000

# The CUDA libraries (``ops/csrc/<name>.cu``) each engine launches on a
# batch; the per-round engines also launch the draws kernel once a round.
_ENGINE_KERNELS = {
    "xla": (),
    "pallas": ("round_step", "attack_draws"),
    "pallas_fused": ("fused_round", "attack_draws"),
    "pallas_tiled": ("tiled_round", "attack_draws"),
    "pallas_mega": ("trial_megakernel",),
}
# Kernel launches a round on the per-round engines, the draws included.
_LAUNCHES_PER_ROUND = {"xla": 0, "pallas": 2, "pallas_fused": 2,
                       "pallas_tiled": 3}


def kernel_plan(cfg: QBAConfig, device, tp: int | None = None) -> dict:
    """The resolved execution plan of ``cfg`` on ``device``:

    - ``engine``: the round engine :func:`resolve_round_engine` picks
      (``xla`` on the CPU);
    - ``mega_gen``: ``"gf2"`` or ``"host"`` on the megakernel, else None;
    - ``variant``: the megakernel's entry (``"keyed"``: it hashes its own
      draws), else None;
    - ``verdict_block``, ``rebuild_block``, ``fused_block``,
      ``mega_block``: ``"trial"`` where that kernel runs on the engine
      (one block, or cluster, a trial), else None;
    - ``trial_pack``: 1 (the CUDA grid already runs a block a trial);
    - ``launches_per_round``: kernel launches a round (the draws kernel
      included), None on the megakernel;
    - ``launches_per_trial``: kernel launches a batch of trials costs on
      the round engine (one grid serves every trial), 0 on ``xla``;
    - ``kernels``: the CUDA libraries the batch launches, list
      generation included (``gf2_sweep``, ``fused_circuit``); none off
      CUDA, where every kernel wrapper runs its plain version.

    With ``tp`` (a party-sharded run on a ``dp x tp`` mesh) the JAX
    package's four comms keys follow: ``tp``; ``tp_engine``, the engine
    :func:`~qba_tpu_torch.parallel.spmd._resolve_spmd_engine` picks for
    the sharded round loop; ``tp_comms``, the transport
    (:func:`~qba_tpu_torch.parallel.ring.resolve_tp_comms`); and
    ``tp_demoted_from``, the forced engine the sharded path demoted away
    from, or None."""
    from qba_tpu_torch.rounds.engine import resolve_mega_gen, resolve_round_engine

    dev = torch.device(device)
    with warnings.catch_warnings():
        # A demotion is announced where the batch runs; here it is
        # attributed, not announced again.
        warnings.simplefilter("ignore")
        engine = resolve_round_engine(cfg, dev)
        gen = resolve_mega_gen(cfg, dev) if engine == "pallas_mega" else None
    kernels = []
    if dev.type == "cuda":
        kernels = list(_ENGINE_KERNELS[engine])
        if cfg.qsim_path == "stabilizer" and gen != "gf2":
            kernels.insert(0, "gf2_sweep")
        if cfg.qsim_path == "dense_pallas":
            kernels.insert(0, "fused_circuit")
    block = "trial" if engine != "xla" else None
    plan = {
        "engine": engine,
        "variant": "keyed" if engine == "pallas_mega" else None,
        "verdict_block": block if engine == "pallas_tiled" else None,
        "rebuild_block": block if engine == "pallas_tiled" else None,
        "fused_block": block if engine == "pallas_fused" else None,
        "mega_block": block if engine == "pallas_mega" else None,
        "mega_gen": gen,
        "trial_pack": 1,
        "launches_per_round": _LAUNCHES_PER_ROUND.get(engine),
        "launches_per_trial": (
            1 if engine == "pallas_mega"
            else _LAUNCHES_PER_ROUND[engine] * cfg.n_rounds),
        "kernels": kernels,
    }
    if tp is not None:
        from qba_tpu_torch.parallel.ring import resolve_tp_comms
        from qba_tpu_torch.parallel.spmd import _resolve_spmd_engine

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tp_engine = _resolve_spmd_engine(cfg, cfg.n_lieutenants // tp,
                                             dev)
        plan.update(
            tp=tp, tp_engine=tp_engine, tp_comms=resolve_tp_comms(cfg),
            tp_demoted_from=(cfg.round_engine
                             if cfg.round_engine not in ("auto", tp_engine)
                             else None))
    return plan


def engine_description(cfg: QBAConfig, device, tp: int | None = None) -> str:
    """Engine attribution string: the resolved round engine, with the
    megakernel's entry and its in-launch generation where they apply
    (``"pallas_mega/keyed"``, ``"pallas_mega/keyed/gen-gf2"``), and the
    megakernel asked for but run as the fused per-round engine
    (``"pallas_fused(from mega, counters)"``).

    With ``tp`` the string names the party-sharded path as the JAX
    package does: ``"spmd[tp=4]/pallas_mega/ring"``, with a demotion of
    the forced engine lifted into it
    (``"spmd[tp=4]/pallas_fused(from mega)/ring"``)."""
    if tp is not None:
        plan = kernel_plan(cfg, device, tp=tp)
        tp_engine = plan["tp_engine"]
        if plan["tp_demoted_from"] is not None:
            short = plan["tp_demoted_from"].removeprefix("pallas_")
            tp_engine = f"{tp_engine}(from {short})"
        return f"spmd[tp={tp}]/{tp_engine}/{plan['tp_comms']}"
    plan = kernel_plan(cfg, device)
    engine = plan["engine"]
    if engine == "pallas_mega":
        desc = f"{engine}/{plan['variant']}"
        return desc + "/gen-gf2" if plan["mega_gen"] == "gf2" else desc
    if cfg.round_engine == "pallas_mega" and engine != cfg.round_engine:
        return f"{engine}(from mega, counters)"
    return engine


def qsim_description(cfg: QBAConfig) -> str:
    """Resource-generation attribution string, the counterpart of
    :func:`engine_description` for list generation: which sampler a
    ``resource_gen`` measurement ran (``"stabilizer/gf2-batched"``,
    ``"factorized/closed-form"``, ...), in the JAX package's words."""
    from qba_tpu_torch import config

    if cfg.qsim_path == "stabilizer":
        return "stabilizer/gf2-batched"
    if cfg.qsim_path == "factorized":
        return "factorized/closed-form"
    if cfg.qsim_path == "dense_pallas":
        if cfg.total_qubits > config.DENSE_QUBIT_CAP:
            # generate_lists_dense(impl="auto") hands off past the cap.
            return "stabilizer/gf2-batched(auto)"
        return "dense/pallas"
    return "dense/xla"


def rep_keys(seed: int, n: int, device, *,
             partitionable: bool | None = None) -> torch.Tensor:
    """The ``n`` keys of one rep, ``split(key(seed), n)``, made on
    ``device`` (on CUDA one launch of the key entry) and fenced, so the
    rep's clock starts after them."""
    from qba_tpu_torch.backends.torch_backend import fence
    from qba_tpu_torch.ops.setup_kernel import keys_kernel

    return fence(keys_kernel(seed, n, device=device,
                             partitionable=partitionable))


def measure_resource_gen(cfg: QBAConfig, reps: int, *, warmup: bool = True,
                         device=None, partitionable: bool | None = None):
    """Time ``reps`` full resource-generation batches: ``cfg.trials``
    list generations of ``cfg.size_l`` positions each, through the
    :func:`~qba_tpu_torch.qsim.generate_lists_for` dispatch the trial
    set-up calls, so the time is the sampler's the trials would run (its
    dispatch takes the batch of keys at once).

    The recipe of :func:`measure_batch`: an untimed warm-up batch (the
    first call builds and loads the kernels and the per-config tables),
    fresh fenced keys every rep, one fence after the batch.

    Returns ``(rep_seconds, shots_per_rep)``, a *shot* being one list
    position (``trials x size_l``).  ``device=None`` means CUDA."""
    from qba_tpu_torch.backends.torch_backend import (
        fence,
        resolve_device,
        trial_keys,
    )
    from qba_tpu_torch import random as jr
    from qba_tpu_torch.qsim import generate_lists_for

    if reps < 1:
        raise ValueError("reps must be >= 1")
    dev = resolve_device(device)
    p = jr.resolve_mode(partitionable)
    if warmup:
        fence(generate_lists_for(cfg, trial_keys(cfg, dev, partitionable=p),
                                 partitionable=p))
    times = []
    for rep in range(reps):
        keys = rep_keys(cfg.seed + 1 + rep, cfg.trials, dev, partitionable=p)
        t0 = time.perf_counter()
        fence(generate_lists_for(cfg, keys, partitionable=p))
        times.append(time.perf_counter() - t0)
    return times, cfg.trials * cfg.size_l


def measure_batch(cfg: QBAConfig, reps: int, chunk_trials: int | None = None,
                  *, warmup: bool = True, device=None,
                  partitionable: bool | None = None):
    """Time ``reps`` full Monte-Carlo batches of ``cfg.trials`` trials.

    ``chunk_trials`` splits each batch into sequential chunks of that
    many trials; a partial last chunk rounds UP, so the trials actually
    run are returned and a rate is computed against them.  Each rep's
    keys are ``split(key(cfg.seed + 1 + rep), n_chunks * chunk)``, made
    on the device and fenced before the clock starts; the clock stops
    after one fence behind the last chunk.

    Returns ``(rep_seconds, n_run, results)``: the wall time of each rep,
    the trials a rep ran, and the last rep's
    :class:`~qba_tpu_torch.backends.torch_backend.MonteCarloResult` of
    each chunk.  ``warmup=False`` skips the untimed warm-up chunk, for a
    caller that warmed up already and keeps it out of a profiler trace
    (``bench --profile-dir``).  ``device=None`` means CUDA."""
    from qba_tpu_torch.backends.torch_backend import (
        fence,
        resolve_device,
        trial_keys,
    )

    from qba_tpu_torch import random as jr

    if reps < 1:
        raise ValueError("reps must be >= 1")
    dev = resolve_device(device)
    p = jr.resolve_mode(partitionable)
    chunk, n_chunks, cfg_chunk = _chunks(cfg, chunk_trials)
    if warmup:
        fence(_run_trials_named(
            cfg_chunk, trial_keys(cfg_chunk, dev, partitionable=p), p))
    times, results = [], None
    for rep in range(reps):
        keys = rep_keys(cfg.seed + 1 + rep, n_chunks * chunk, dev,
                        partitionable=p)
        t0 = time.perf_counter()
        results = [_run_trials_named(cfg_chunk,
                                     keys[i * chunk:(i + 1) * chunk], p)
                   for i in range(n_chunks)]
        fence(results)
        times.append(time.perf_counter() - t0)
    return times, n_chunks * chunk, results


def _chunks(cfg: QBAConfig, chunk_trials: int | None):
    """``(chunk, n_chunks, cfg_chunk)``: a batch of ``cfg.trials`` in
    chunks of ``chunk_trials`` (all of it by default), the last rounded
    up."""
    chunk = chunk_trials or cfg.trials
    return chunk, -(-cfg.trials // chunk), dataclasses.replace(cfg,
                                                               trials=chunk)


def _run_trials_named(cfg_chunk: QBAConfig, keys: torch.Tensor,
                      partitionable: bool):
    """``run_trials`` on ``keys``' device in ``partitionable``'s threefry
    mode, with a device-memory failure
    named: the batch, the ceiling the byte model
    (:func:`~qba_tpu_torch.analysis.memory.trial_ceiling`) gives at the
    device's memory, and the remedy, ``--chunk-trials``.  Every other
    error passes through."""
    from qba_tpu_torch.backends import torch_backend

    from qba_tpu_torch import random as jr

    try:
        with jr.threefry_partitionable(partitionable):
            return torch_backend.run_trials(cfg_chunk, keys,
                                            device=keys.device)
    except torch.cuda.OutOfMemoryError as e:
        from qba_tpu_torch.analysis.memory import (
            device_memory_bytes,
            trial_ceiling,
        )

        dev = keys.device
        if dev.type == "cuda":
            memory = torch.cuda.get_device_properties(dev).total_memory
        else:
            memory = device_memory_bytes("cpu")
        raise RuntimeError(
            f"a batch of {cfg_chunk.trials} trials ran out of {dev.type} "
            f"memory for this config (n_parties={cfg_chunk.n_parties}, "
            f"size_l={cfg_chunk.size_l}, "
            f"n_dishonest={cfg_chunk.n_dishonest}); the byte model "
            "(analysis/memory.py::trial_ceiling) admits "
            f"{trial_ceiling(cfg_chunk, memory, dev.type)} trials in the "
            f"device's {memory} bytes.  If other processes hold device "
            "memory, freeing it may suffice.  Split the batch with "
            "chunk_trials / --chunk-trials."
        ) from e


def measure_device_batch(cfg: QBAConfig, pairs: int = 3, reps_lo: int = 1,
                         reps_hi: int = 5, chunk_trials: int | None = None,
                         *, warmup: bool = True, device=None,
                         partitionable: bool | None = None):
    """Device seconds a batch by the slope method: dispatch ``r``
    same-shape batches back to back with one final fence, for ``r =
    reps_lo`` and ``r = reps_hi``; the difference quotient

        (T(reps_hi) - T(reps_lo)) / (reps_hi - reps_lo)

    cancels the constant costs of a chain (its first dispatch, the final
    synchronize), leaving the sustained time of one batch, the host's
    enqueue overlapping the device's work.  Each of ``pairs`` pairs draws
    fresh keys; a throwaway chain at full depth runs first, since the
    first long chain after a warm-up pays one-off costs.

    Returns ``(device_seconds_per_batch, n_run)``: one slope a pair (the
    caller takes the median and quotes the spread) and the trials a
    batch ran.  ``device=None`` means CUDA."""
    from qba_tpu_torch.backends.torch_backend import (
        fence,
        resolve_device,
        trial_keys,
    )

    from qba_tpu_torch import random as jr

    if pairs < 1:
        raise ValueError("pairs must be >= 1")
    if not 1 <= reps_lo < reps_hi:
        raise ValueError("need 1 <= reps_lo < reps_hi")
    dev = resolve_device(device)
    p = jr.resolve_mode(partitionable)
    chunk, n_chunks, cfg_chunk = _chunks(cfg, chunk_trials)
    if warmup:
        fence(_run_trials_named(
            cfg_chunk, trial_keys(cfg_chunk, dev, partitionable=p), p))

    def timed_chain(r: int, tag: int) -> float:
        keys = rep_keys(cfg.seed + tag, r * n_chunks * chunk, dev,
                        partitionable=p)
        t0 = time.perf_counter()
        for i in range(r * n_chunks):
            _run_trials_named(cfg_chunk, keys[i * chunk:(i + 1) * chunk], p)
        fence(None)  # one stream: the last batch done, all done
        return time.perf_counter() - t0

    timed_chain(reps_hi, 999)
    slopes = []
    for p in range(pairs):
        t_lo = timed_chain(reps_lo, 1001 + 2 * p)
        t_hi = timed_chain(reps_hi, 1002 + 2 * p)
        slopes.append((t_hi - t_lo) / (reps_hi - reps_lo))
    return slopes, n_chunks * chunk
