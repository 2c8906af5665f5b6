"""Run manifest: a structured record of what ran — counterpart of
:mod:`qba_tpu.obs.manifest` (its collector, validator, file helpers and
``--telemetry`` session).

A manifest holds the environment (torch, the CUDA runtime, the device),
the config fingerprint, the kernel plan
(:func:`~qba_tpu_torch.benchmark.kernel_plan`), the demotion chain and
the decisions recorded while the run executed
(:func:`~qba_tpu_torch.diagnostics.record_decisions`).  The schema id and
the required keys are the JAX package's (``qba-tpu/run-manifest/v1``),
so one reader validates both packages' manifests.  ``probe_stats`` stays
a required dict of empty dicts: the port has no compile probes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Iterator

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.obs.telemetry import SpanRecorder

MANIFEST_SCHEMA = "qba-tpu/run-manifest/v1"

# Keys validate_manifest requires, with their expected types.
_REQUIRED: dict[str, type | tuple[type, ...]] = {
    "schema": str,
    "environment": dict,
    "config": dict,
    "plan": dict,
    "engine_description": str,
    "demotion_chain": list,
    "decisions": list,
    "probe_stats": dict,
    "counters_enabled": bool,
}

_PLAN_KEYS = (
    "engine", "variant", "verdict_block", "rebuild_block", "fused_block",
    "trial_pack", "launches_per_round",
)


def environment_info(device) -> dict[str, Any]:
    """torch / CUDA runtime / device fingerprint of this process for a
    run on ``device``."""
    import platform as _platform

    import torch

    dev = torch.device(device)
    info: dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "backend": dev.type,
        "device_count": 1,
        "device_kind": "cpu",
        "capability": None,
        "python": _platform.python_version(),
        "host": _platform.platform(),
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        info["device_count"] = torch.cuda.device_count()
        info["device_kind"] = torch.cuda.get_device_name(index)
        info["capability"] = "{}.{}".format(
            *torch.cuda.get_device_capability(index))
    return info


def config_fingerprint(cfg: QBAConfig) -> dict[str, Any]:
    """All explicit fields plus the derived shape parameters the
    engines actually key on — enough to reconstruct the config AND to
    read the manifest without re-deriving w/slots by hand."""
    d = dataclasses.asdict(cfg)
    d["derived"] = {
        "w": cfg.w,
        "slots": cfg.slots,
        "max_l": cfg.max_l,
        "n_rounds": cfg.n_rounds,
        "n_lieutenants": cfg.n_lieutenants,
    }
    return d


def probe_stats_snapshot() -> dict[str, int]:
    """The resolver/probe counters: none in the port (no compile probes),
    kept so a manifest has the JAX package's ``probe_stats`` shape."""
    return {}


def demotion_chain(cfg: QBAConfig, plan: dict[str, Any]) -> list[str]:
    """requested -> actually-run engine names, deduplicated in order
    (``auto`` resolution, or the megakernel giving way to the fused
    round when counters are collected)."""
    chain = [cfg.round_engine]
    if plan["engine"] != chain[-1]:
        chain.append(plan["engine"])
    return chain


def collect_manifest(
    cfg: QBAConfig,
    *,
    device,
    command: str | None = None,
    decisions: list[dict] | None = None,
    probe_stats_before: dict[str, int] | None = None,
    spans: SpanRecorder | None = None,
    extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Assemble the full manifest for ``cfg`` as run on ``device`` in
    this process."""
    from qba_tpu_torch.benchmark import engine_description, kernel_plan

    plan = kernel_plan(cfg, device)
    after = probe_stats_snapshot()
    before = probe_stats_before or {k: 0 for k in after}
    manifest: dict[str, Any] = {
        "schema": MANIFEST_SCHEMA,
        "created_unix_s": time.time(),
        "command": command,
        "environment": environment_info(device),
        "config": config_fingerprint(cfg),
        "plan": plan,
        "engine_description": engine_description(cfg, device),
        "demotion_chain": demotion_chain(cfg, plan),
        "decisions": list(decisions or []),
        "probe_stats": {
            "before": before,
            "after": after,
            "delta": {k: after[k] - before.get(k, 0) for k in after},
        },
        "counters_enabled": bool(cfg.collect_counters),
    }
    if spans is not None:
        manifest["phase_totals"] = spans.totals()
    if extra:
        manifest.update(extra)
    return manifest


def validate_manifest(manifest: dict[str, Any]) -> dict[str, Any]:
    """Schema check (all problems at once); returns the manifest so the
    call composes."""
    problems: list[str] = []
    if not isinstance(manifest, dict):
        raise ValueError(f"manifest must be a dict, got {type(manifest)}")
    if manifest.get("schema") != MANIFEST_SCHEMA:
        problems.append(
            f"schema: expected {MANIFEST_SCHEMA!r}, got {manifest.get('schema')!r}"
        )
    for key, typ in _REQUIRED.items():
        if key not in manifest:
            problems.append(f"missing key: {key}")
        elif not isinstance(manifest[key], typ):
            problems.append(
                f"{key}: expected {typ}, got {type(manifest[key]).__name__}"
            )
    plan = manifest.get("plan")
    if isinstance(plan, dict):
        for key in _PLAN_KEYS:
            if key not in plan:
                problems.append(f"plan missing key: {key}")
    chain = manifest.get("demotion_chain")
    if isinstance(chain, list) and not chain:
        problems.append("demotion_chain must name at least the run engine")
    stats = manifest.get("probe_stats")
    if isinstance(stats, dict):
        for key in ("before", "after", "delta"):
            if not isinstance(stats.get(key), dict):
                problems.append(f"probe_stats.{key} must be a dict")
    if problems:
        raise ValueError("invalid run manifest: " + "; ".join(problems))
    return manifest


def write_manifest(path: str, manifest: dict[str, Any]) -> str:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    return path


def load_manifest(path: str) -> dict[str, Any]:
    with open(path) as f:
        return validate_manifest(json.load(f))


@dataclasses.dataclass
class TelemetrySession:
    """Live handle yielded by :func:`telemetry_session`: the shared span
    recorder (hand it to ``PhaseTimers(spans=...)``), plus mutable
    ``extra`` merged into the manifest at exit."""

    directory: str
    spans: SpanRecorder
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, "run_manifest.json")

    @property
    def trace_path(self) -> str:
        return os.path.join(self.directory, "trace.json")


@contextlib.contextmanager
def telemetry_session(
    directory: str, cfg: QBAConfig, command: str, *, device
) -> Iterator[TelemetrySession]:
    """Everything ``--telemetry DIR`` needs in one context manager for a
    run of ``cfg`` on ``device``:

    * opens a :class:`SpanRecorder` with a root span named ``command``,
    * captures the decisions
      (:func:`~qba_tpu_torch.diagnostics.record_decisions`) across the
      block,
    * on exit writes ``run_manifest.json`` (validated), ``trace.json``
      (Chrome trace events, Perfetto-loadable) and ``spans.jsonl`` into
      ``directory``.

    The files are written even when the block raises: a failed run's
    partial trace is when telemetry is wanted most.
    """
    from qba_tpu_torch.diagnostics import record_decisions

    os.makedirs(directory, exist_ok=True)
    session = TelemetrySession(directory=directory, spans=SpanRecorder())
    before = probe_stats_snapshot()
    try:
        with record_decisions() as decisions:
            with session.spans.span(command, cat="command"):
                yield session
    finally:
        manifest = collect_manifest(
            cfg,
            device=device,
            command=command,
            decisions=decisions,
            probe_stats_before=before,
            spans=session.spans,
            extra=session.extra,
        )
        write_manifest(session.manifest_path, validate_manifest(manifest))
        session.spans.write_chrome_trace(session.trace_path)
        session.spans.write_jsonl(os.path.join(directory, "spans.jsonl"))
