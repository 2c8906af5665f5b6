"""Launch-count accounting — the counterpart of
:mod:`qba_tpu.analysis.launches`: each engine pinned to its launch
model, counted at the wrappers' seams.

The JAX package counts ``pallas_call`` launches per trial in a traced
jaxpr.  The port launches per batch (a CUDA grid runs every trial), so
:data:`LAUNCH_MODEL` — the JAX package's own table, unchanged — reads
launches per batch here:

========================  =======================================
engine                    launches per batch
========================  =======================================
``xla``                   0 (no kernels)
``pallas``                ``n_rounds`` (``round_step``)
``pallas_tiled``          ``2 * n_rounds`` (verdict + rebuild)
``pallas_fused``          ``n_rounds`` (``fused_round``)
``pallas_mega``           1 (``trial_megakernel_keyed``; with
                          ``mega_gen="gf2"`` the gen entry, which
                          also sweeps and decodes — and no
                          ``gf2_sweep`` launch)
========================  =======================================

On top of the table, :func:`batch_launch_model` adds what the port
launches beside the round kernels: the per-round kernel engines draw
each round's attacks with ``attack_draws`` (one launch a round); the
stabilizer path's host generation sweeps the tableaux with one
``gf2_sweep`` launch a batch; under a ``tp`` mesh of one card the
per-round engines gather each pool or mailbox leaf once a round with
``ring_gather`` (the ``xla`` engine its mailbox's six fields), and
``pallas_mega`` is one launch of the party-sharded megakernel.  Every
batch also sets its trials up with the ``setup_trial`` kernel
(:func:`qba_tpu_torch.rounds.engine.setup_batch`): one launch on the
factorized path (its ``"whole"`` form) and for the megakernel's gen
entry (``"orders"``), two where another path makes the lists
(``dense``, ``dense_pallas``, the stabilizer path's host generation:
``"orders"`` for the lists key, ``"given"`` after the lists).  A batch
that derives its own keys (``run_trials(cfg)`` without keys, a sweep's
chunk, a graph loop's body: ``own_keys=True``) also launches the same
file's key entry, ``trial_keys``, once.

The counts come from the seams (:data:`qba_tpu_torch.ops._launch.
seam_observers`): on CUDA each seam call is a launch, and the wrappers'
``launches`` counts are held equal to them; on the CPU the same seams
run the plain versions.  A drift is a finding tagged KI-5, as in the JAX
package: everything stays bit-identical, so nothing else would see it.
The circuit kernel's launches on the dense paths depend on the batch's
size (one launch a chunk of list positions and one for the shared
not-Q-correlated state) and are not pinned.
"""

from __future__ import annotations

import dataclasses
import warnings

from qba_tpu_torch.analysis.findings import Finding, Report

#: Engine -> expected round-kernel launches per batch (the JAX package's
#: per-trial table, read per batch).
LAUNCH_MODEL = {
    "xla": lambda cfg: 0,
    "pallas": lambda cfg: cfg.n_rounds,
    "pallas_tiled": lambda cfg: 2 * cfg.n_rounds,
    "pallas_fused": lambda cfg: cfg.n_rounds,
    "pallas_mega": lambda cfg: 1,
}

#: The kernels each per-round engine launches every round.
ROUND_KERNELS = {
    "xla": (),
    "pallas": ("round_step",),
    "pallas_tiled": ("tiled_verdict", "tiled_rebuild"),
    "pallas_fused": ("fused_round",),
}

#: Leaves a ``tp`` round gathers with ``ring_gather``: the pool's or the
#: packed mailbox's four, the ``xla`` engine's mailbox's six fields.
RING_LEAVES = {"xla": 6, "pallas": 4, "pallas_tiled": 4, "pallas_fused": 4}

#: Kernel seams whose counts the model does not pin.
UNPINNED = ("fused_circuit",)

#: Stems of the kernels' names in ``torch.profiler``'s records -> the
#: wrapper whose launch each is (the megakernel's entries are one
#: template).
PROFILER_KERNELS = (
    ("fused_round_", "fused_round"),
    ("tiled_verdict_kernel", "tiled_verdict"),
    ("tiled_rebuild_kernel", "tiled_rebuild"),
    ("round_step_kernel", "round_step"),
    ("trial_megakernel", "trial_megakernel"),
    ("attack_draws_kernel", "attack_draws"),
    ("gf2_sweep_kernel", "gf2_sweep"),
    ("ring_gather_kernel", "ring_gather"),
    ("fused_circuit", "fused_circuit"),
    ("sweep_stop_kernel", "sweep_stop"),
    ("surface_pick_kernel", "surface_pick"),
    ("surface_fold_kernel", "surface_fold"),
    ("setup_trial_kernel", "setup_trial"),
    ("trial_keys_kernel", "trial_keys"),
)

_MEGA = ("trial_megakernel_keyed", "trial_megakernel_gen_keyed",
         "sharded_trial_megakernel_keyed", "trial_megakernel",
         "trial_megakernel_gen", "sharded_trial_megakernel")


def resolved_engine(cfg, engine: str, device, tp: int | None = None):
    """The engine ``run_trial`` (or, with ``tp``, the party-sharded
    batch) runs for ``cfg`` with ``round_engine=engine`` on
    ``device``, demotions silenced."""
    cfg = dataclasses.replace(cfg, round_engine=engine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if tp is None:
            from qba_tpu_torch.rounds.engine import resolve_round_engine

            return resolve_round_engine(cfg, device)
        from qba_tpu_torch.parallel.spmd import _resolve_spmd_engine

        return _resolve_spmd_engine(cfg, cfg.n_lieutenants // tp, device)


def batch_launch_model(cfg, engine: str, device, tp: int | None = None,
                       own_keys: bool = False) -> dict[str, int]:
    """Kernel launches one batch of ``cfg`` dispatches with
    ``round_engine=engine`` on ``device`` (``tp``: the party-sharded
    batch on one card; ``own_keys``: a batch that derives its keys, one
    ``trial_keys`` launch), by wrapper name.  The wrappers count a launch
    where they call the kernel, eagerly or into a CUDA graph being
    captured: a graph loop's chunk counts twice (its warm-up and its
    capture), and the graph's replays count nothing."""
    from qba_tpu_torch.parallel.ring import resolve_tp_comms
    from qba_tpu_torch.rounds.engine import resolve_mega_gen

    run = resolved_engine(cfg, engine, device, tp)
    cfg = dataclasses.replace(cfg, round_engine=engine)
    host_gen = cfg.qsim_path == "stabilizer"
    out: dict[str, int] = {}
    if run == "pallas_mega":
        if tp is not None:
            out["sharded_trial_megakernel_keyed"] = LAUNCH_MODEL[run](cfg)
        elif resolve_mega_gen(cfg, device) == "gf2":
            out["trial_megakernel_gen_keyed"] = LAUNCH_MODEL[run](cfg)
            host_gen = False
        else:
            out["trial_megakernel_keyed"] = LAUNCH_MODEL[run](cfg)
    else:
        kernels = ROUND_KERNELS[run]
        for name in kernels:
            out[name] = LAUNCH_MODEL[run](cfg) // len(kernels)
        if run != "xla":
            out["attack_draws"] = cfg.n_rounds
        if tp is not None and resolve_tp_comms(cfg) == "ring":
            out["ring_gather"] = RING_LEAVES[run] * cfg.n_rounds
    if host_gen:
        out["gf2_sweep"] = 1
    gen_entry = cfg.qsim_path == "stabilizer" and not host_gen
    out["setup_trial"] = (1 if cfg.qsim_path == "factorized" or gen_entry
                          else 2)
    if own_keys:
        out["trial_keys"] = 1
    return out


def profiler_counts(names) -> dict[str, int]:
    """Kernel launches by wrapper name from the device kernel records of
    a ``torch.profiler`` trace (``names``: each record's name, demangled
    or not; the first :data:`PROFILER_KERNELS` stem it contains names
    its wrapper; other kernels are PyTorch's own)."""
    out: dict[str, int] = {}
    for name in names:
        for stem, wrapper in PROFILER_KERNELS:
            if stem in name:
                out[wrapper] = out.get(wrapper, 0) + 1
                break
    return out


def fold_mega(counts: dict[str, int]) -> dict[str, int]:
    """``counts`` with the megakernel's entries summed under
    ``trial_megakernel`` (one device kernel template serves them all)."""
    out: dict[str, int] = {}
    for k, v in counts.items():
        key = "trial_megakernel" if k in _MEGA else k
        out[key] = out.get(key, 0) + v
    return out


def _pin(rec, model: dict[str, int], check: str, report: Report) -> None:
    """Hold one traced batch's seams (and on CUDA its wrappers' launches)
    to ``model``."""
    seams = {k: v for k, v in rec.seams.items() if k not in UNPINNED}
    counted = [("seams", seams)]
    if rec.device == "cuda":
        counted.append(("launches", {k: v for k, v in rec.launches.items()
                                     if k not in UNPINNED}))
    for what, got in counted:
        if got != model:
            gen_leak = ("trial_megakernel_gen_keyed" in model
                        and "gf2_sweep" in got)
            report.findings.append(Finding(
                ki="KI-5",
                check="mega-gen-in-kernel" if gen_leak else check,
                path=rec.path,
                message=(
                    f"{what} {dict(sorted(got.items()))} per batch, the "
                    f"engine's launch model says "
                    f"{dict(sorted(model.items()))} — either the dispatch "
                    "grew or lost a launch (a change the results never "
                    "show) or the model in analysis/launches.py needs a "
                    "conscious update"
                ),
            ))
            return
    report.notes.append(f"launches/{rec.path}: "
                        f"{dict(sorted(seams.items()))} per batch (= model)")


def check_launches(label: str, cfg, engines, device, trials: int) -> Report:
    """Pin each requested engine's launches per batch to
    :func:`batch_launch_model`.  A batch that records a demotion is
    noted, not pinned (the demoted engine is pinned under its own
    entry); a kernel's refusal of the config is noted."""
    from qba_tpu_torch.analysis.trace import batch_error, trace_batch

    report = Report()
    checked = 0
    for engine in LAUNCH_MODEL:
        if engine not in engines:
            continue
        rec = trace_batch(label, cfg, engine, device, trials)
        if rec.error:
            report.findings.append(batch_error(rec))
            continue
        if rec.refused:
            report.notes.append(f"launches/{rec.path}: refused ({rec.refused})")
            continue
        if rec.demoted:
            report.notes.append(f"launches/{rec.path}: demotion recorded "
                                f"({rec.demoted}) — pin skipped")
            continue
        checked += 1
        _pin(rec, batch_launch_model(cfg, engine, device), "launches-per-batch",
             report)
    report.stats["launch_engines_checked"] = checked
    return report


#: Engines whose party-sharded batches get launch rows (as in the JAX
#: package: the collective path, the per-round path, the megakernel).
SPMD_CHECK_ENGINES = ("xla", "pallas_fused", "pallas_mega")


def spmd_tp(cfg) -> int | None:
    """The ``tp`` the sharded pin runs at: 4 where it divides the
    lieutenants, else 2, else None."""
    for tp in (4, 2):
        if cfg.n_lieutenants % tp == 0:
            return tp
    return None


def check_spmd_launches(label: str, cfg, device, trials: int) -> Report:
    """Pin the party-sharded batch's launches on a one-card ``{"dp": 1,
    "tp": tp}`` mesh (:func:`spmd_tp`) for :data:`SPMD_CHECK_ENGINES`."""
    from qba_tpu_torch.analysis.trace import trace_batch

    report = Report()
    tp = spmd_tp(cfg)
    if tp is None:
        report.notes.append(f"spmd-launches/{label}: no tp of 2 or 4 divides "
                            f"{cfg.n_lieutenants} lieutenants; pin skipped")
        return report
    checked = 0
    for engine in SPMD_CHECK_ENGINES:
        rec = trace_batch(label, cfg, engine, device, trials, tp=tp)
        if rec.error:
            report.findings.append(Finding(
                ki="KI-5", check="spmd-launches", path=rec.path,
                message=f"the sharded batch could not run: {rec.error}"))
            continue
        if rec.refused or rec.demoted:
            report.notes.append(f"spmd-launches/{rec.path}: "
                                f"{rec.refused or rec.demoted} — pin skipped")
            continue
        checked += 1
        _pin(rec, batch_launch_model(cfg, engine, device, tp),
             "spmd-launches", report)
    report.stats["spmd_launch_engines_checked"] = checked
    return report
