"""Kernel-plan attribution — the ``kernel_plan`` and
``engine_description`` part of :mod:`qba_tpu.benchmark`, on the port's
resolvers.

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

import warnings

import torch

from qba_tpu_torch.config import QBAConfig

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


def kernel_plan(cfg: QBAConfig, device) -> dict:
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
      CUDA, where every kernel wrapper runs its plain version."""
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
    return {
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


def engine_description(cfg: QBAConfig, device) -> str:
    """Engine attribution string: the resolved round engine, with the
    megakernel's entry and its in-launch generation where they apply
    (``"pallas_mega/keyed"``, ``"pallas_mega/keyed/gen-gf2"``), and the
    megakernel asked for but run as the fused per-round engine
    (``"pallas_fused(from mega, counters)"``)."""
    plan = kernel_plan(cfg, device)
    engine = plan["engine"]
    if engine == "pallas_mega":
        desc = f"{engine}/{plan['variant']}"
        return desc + "/gen-gf2" if plan["mega_gen"] == "gf2" else desc
    if cfg.round_engine == "pallas_mega" and engine != cfg.round_engine:
        return f"{engine}(from mega, counters)"
    return engine
