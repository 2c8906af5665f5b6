"""Lint orchestrator — the counterpart of :mod:`qba_tpu.analysis.driver`,
the entry point of ``python -m qba_tpu_torch lint``.

:func:`run_lint` runs one small batch per (config, engine) on the
device (:mod:`.trace`; the card by default, the plain versions with
``device="cpu"``) and the passes over it, across the JAX package's
matrix, unchanged:

* ``cheap``          — (17, 16, 4): every engine live, an even
  lieutenant count so the sharded variants run;
* ``north-star``     — (33, 64, 10): the flagship config;
* ``f32-gdt``        — (11, 1000, 3): the reference paper's 11-party
  scale at a long list;
* ``stabilizer``     — (11, 16, 3) on ``qsim_path="stabilizer"`` with
  ``mega_gen="gf2"``: the GF(2) path, its float parity dots and the
  gen entry's one launch;
* ``split-strategy`` — (17, 16, 4) with ``strategy="split"``.

Passes, by Known Issue and their JAX counterparts:

* KI-3 (:mod:`.dots`): every dot site's bound marker and ``ops/csrc``'s
  formats (static), each traced dot's values against the exact range
  of the precision in force (dynamic) — for the JAX package's interval
  analysis of jaxprs;
* KI-2 (:mod:`.memory`): shared memory a block of every kernel plan,
  the trial ceiling, the graph loops' carries, the packed tableaux;
* with ``effects=True``: KI-5 launch pins (:mod:`.launches`, and on a
  one-card ``tp`` mesh with ``"spmd"``) and the round loops' ping-pong
  carry (:mod:`.effects`); KI-6 (:mod:`.transfers`): the AST sweep of
  the hot modules, the serve dispatch-order and fleet front-half
  proofs, and the dynamic sync probe of every engine's chunk;
* with ``protocol=True``: KI-10 (:mod:`.protocol`), once a lint.

KI-1 (the JAX package's ``vma.py``) has no counterpart: it audits
``shard_map``'s ``out_vma`` threading, and the port's mesh carries no
such metadata.  ``"spmd"`` runs the ``tp`` launch pin and the sharded
shared-memory plans in its place.  ``check_jit_donation`` has none
either (the port has no ``jit``).  A dynamic check that cannot run is a
finding, never a skipped pass; a kernel's refusal of a config (its
shared memory or 64-bit masks) is a note, and the KI-2 plan audit says
whether the refusal is the plan's.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from qba_tpu_torch.analysis.findings import Report
from qba_tpu_torch.config import QBAConfig

#: (label, config-kwargs) lint matrix: the JAX package's.
LINT_MATRIX = (
    ("cheap", dict(n_parties=17, size_l=16, n_dishonest=4)),
    ("north-star", dict(n_parties=33, size_l=64, n_dishonest=10)),
    ("f32-gdt", dict(n_parties=11, size_l=1000, n_dishonest=3)),
    ("stabilizer", dict(
        n_parties=11, size_l=16, n_dishonest=3, qsim_path="stabilizer",
        mega_gen="gf2",
    )),
    ("split-strategy", dict(
        n_parties=17, size_l=16, n_dishonest=4, strategy="split",
    )),
)

ENGINE_CHOICES = (
    "xla", "pallas", "pallas_tiled", "pallas_fused", "pallas_mega",
    "spmd", "gf2",
)

#: Engines a traced batch runs on.
BATCH_ENGINES = ("xla", "pallas", "pallas_tiled", "pallas_fused",
                 "pallas_mega")

#: Trials a traced batch: 16 on the card, 4 on the CPU's plain versions.
TRIALS = {"cuda": 16, "cpu": 4}


def lint_configs() -> list[tuple[str, QBAConfig]]:
    """The built-in lint matrix, instantiated."""
    return [(label, QBAConfig(**kw)) for label, kw in LINT_MATRIX]


def saved_plan_configs(path: str) -> list[tuple[str, QBAConfig]]:
    """Lint matrix points for every shape recorded in a serve
    warm-start artifact (``plans.json``,
    :mod:`qba_tpu_torch.serve.persist`), so plans restored from disk
    pass the same gates as the built-in matrix."""
    from qba_tpu_torch.serve.persist import saved_configs

    return [
        (f"plan:{cfg.n_parties}p-L{cfg.size_l}-d{cfg.n_dishonest}", cfg)
        for cfg in saved_configs(path)
    ]


def resolve_device(device):
    """``"cuda"`` (or None) -> the current CUDA device, raising without
    one; ``"cpu"`` -> the CPU."""
    import torch

    if device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lint: no CUDA device (the default is the card); pass "
                "--device cpu to lint the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _lint_config(label: str, cfg: QBAConfig, engine_set: set, device,
                 trials: int, effects: bool) -> Report:
    from qba_tpu_torch.analysis.dots import check_dots
    from qba_tpu_torch.analysis.memory import check_gf2_memory, check_memory
    from qba_tpu_torch.analysis.trace import batch_error, trace_batch

    report = Report()
    records = []
    for engine in BATCH_ENGINES:
        if engine in engine_set:
            rec = trace_batch(label, cfg, engine, device, trials)
            records.extend(rec.dots)
            if rec.refused:
                report.notes.append(f"{rec.path}: refused ({rec.refused})")
            if rec.error:
                report.findings.append(batch_error(rec))
    report.extend(check_dots(records))
    if engine_set - {"xla", "gf2"}:
        report.extend(check_memory(cfg, device))
    if "gf2" in engine_set:
        report.extend(check_gf2_memory(cfg, device))
    if effects:
        from qba_tpu_torch.analysis.effects import check_effects
        from qba_tpu_torch.analysis.launches import (
            check_launches,
            check_spmd_launches,
        )

        report.extend(check_effects(label, cfg, engine_set, device, trials))
        report.extend(check_launches(label, cfg, engine_set, device, trials))
        if "spmd" in engine_set:
            report.extend(check_spmd_launches(label, cfg, device, trials))
    return report


def run_lint(
    configs: Sequence[tuple[str, QBAConfig]] | None = None,
    engines: Iterable[str] | None = None,
    effects: bool = False,
    protocol: bool = False,
    device="cuda",
) -> Report:
    """Run every lint pass over ``configs`` (default: the built-in
    matrix) restricted to ``engines`` (default: all), on ``device``
    (``"cuda"``, the default, raises without a card; ``"cpu"`` runs the
    plain versions).  ``effects=True`` adds KI-5 and KI-6,
    ``protocol=True`` KI-10.  Returns one aggregated report;
    ``report.ok`` is the gate."""
    from qba_tpu_torch.analysis import trace
    from qba_tpu_torch.analysis.dots import check_dot_sites

    if engines is not None:
        bad = set(engines) - set(ENGINE_CHOICES)
        if bad:
            raise ValueError(
                f"unknown lint engine(s) {sorted(bad)}; "
                f"choose from {ENGINE_CHOICES}"
            )
    dev = resolve_device(device)
    engine_set = set(engines) if engines is not None else set(ENGINE_CHOICES)
    configs = list(configs) if configs is not None else lint_configs()
    trials = TRIALS[dev.type]
    trace.reset()
    report = Report()
    report.extend(check_dot_sites())
    for label, cfg in configs:
        report.extend(_lint_config(label, cfg, engine_set, dev, trials,
                                   effects))
    if "spmd" in engine_set:
        report.notes.append(
            "KI-1 (vma): no counterpart — the port's mesh carries no "
            "out_vma metadata; spmd runs the tp launch pin and the sharded "
            "shared-memory plans instead")
    if effects:
        from qba_tpu_torch.analysis.transfers import (
            check_device_loop,
            check_transfers,
        )

        report.extend(check_transfers())
        report.extend(check_device_loop(configs, engine_set, dev, trials))
    if protocol:
        from qba_tpu_torch.analysis.protocol import check_protocol

        report.extend(check_protocol())
    # A traced batch that raised is one finding, whichever passes read it.
    report.findings = list(dict.fromkeys(report.findings))
    report.stats.update(trace.stats())
    report.stats["device"] = dev.type
    report.stats["trials_per_batch"] = trials
    if dev.type == "cuda":
        from qba_tpu_torch.ops import kernel_launches

        report.stats["kernel_launches"] = kernel_launches()
    return report
