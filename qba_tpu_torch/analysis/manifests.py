"""KI-8 manifest-CI audit: every reported rate carries an interval — the
counterpart of :mod:`qba_tpu.analysis.manifests` over the port's run
manifests (:mod:`qba_tpu_torch.obs.manifest`).

A rate in a run manifest is a dict with ``rate``/``lo``/``hi`` (see
:class:`qba_tpu_torch.stats.estimators.RateEstimate`), never a bare
float: a bare number is a point estimate whose precision the reader
must guess.
This pass walks manifest JSON recursively and flags every numeric value
under a ``*_rate``-shaped key that is not packaged as an estimate.

Scope notes:

* Keys audited: ``*_rate`` and ``*_ratio`` leaves.  Latency/timing
  totals, counts, and probabilities-as-*inputs* (``p_depolarize`` …)
  are configuration, not measurements, and are not rate-shaped.
* An estimate dict is recognized by carrying ``lo`` and ``hi`` keys
  alongside the point value; its *internal* fields are then exempt.
* ``None`` rates (the uniform zero-trial encoding) are fine — the
  estimate dict around them still carries the vacuous [0, 1] interval.

Findings are tagged ``KI-8``.
"""

from __future__ import annotations

import glob as _glob
import json
import os

from qba_tpu_torch.analysis.findings import Finding, Report

#: Key suffixes that denote a measured proportion.
RATE_SUFFIXES = ("_rate", "_ratio")

#: Keys that prove a dict is a packaged estimate (RateEstimate.to_json).
ESTIMATE_KEYS = frozenset({"lo", "hi"})


def _is_estimate(value) -> bool:
    return isinstance(value, dict) and ESTIMATE_KEYS <= set(value)


def _walk(node, path: str, offenders: list[tuple[str, object]]) -> None:
    if isinstance(node, dict):
        for key, value in node.items():
            child = f"{path}.{key}" if path else str(key)
            if isinstance(key, str) and key.endswith(RATE_SUFFIXES):
                if _is_estimate(value):
                    continue  # certified; don't descend into its fields
                if isinstance(value, (int, float)) and not isinstance(
                    value, bool
                ):
                    offenders.append((child, value))
                    continue
            _walk(value, child, offenders)
    elif isinstance(node, list):
        for i, item in enumerate(node):
            _walk(item, f"{path}[{i}]", offenders)


def check_manifest(manifest: dict, label: str = "<manifest>") -> Report:
    """KI-8 audit of one (already-loaded) manifest dict."""
    report = Report()
    offenders: list[tuple[str, object]] = []
    _walk(manifest, "", offenders)
    report.stats["manifest_rate_keys_flagged"] = len(offenders)
    for key_path, value in offenders:
        report.findings.append(Finding(
            ki="KI-8", check="manifest-ci", path=f"manifest:{label}",
            where=key_path,
            message=(
                f"bare rate {key_path} = {value!r} with no confidence "
                "interval: report rates as estimate objects "
                "(rate/lo/hi, qba_tpu_torch.stats.estimators.RateEstimate) "
                "so the manifest states its own precision"
            ),
        ))
    return report


def check_manifest_files(paths) -> Report:
    """KI-8 audit over manifest files; ``paths`` may contain globs.
    A path that matches nothing, fails to parse, or fails the manifest
    schema is itself a finding — a gate that silently skips a missing
    artifact proves nothing."""
    from qba_tpu_torch.obs.manifest import validate_manifest

    report = Report()
    checked = 0
    for pattern in paths:
        matches = sorted(_glob.glob(pattern)) or [pattern]
        for path in matches:
            label = os.path.basename(path)
            if not os.path.exists(path):
                report.findings.append(Finding(
                    ki="KI-8", check="manifest-ci", path=f"manifest:{label}",
                    where=path,
                    message=f"manifest path {path!r} does not exist",
                ))
                continue
            try:
                with open(path) as fh:
                    manifest = json.load(fh)
                validate_manifest(manifest)
            except (ValueError, OSError) as e:
                report.findings.append(Finding(
                    ki="KI-8", check="manifest-ci", path=f"manifest:{label}",
                    where=path,
                    message=f"unreadable/invalid manifest: {e}",
                ))
                continue
            checked += 1
            report.extend(check_manifest(manifest, label=label))
    report.stats["manifests_checked"] = checked
    return report
