"""Content-addressed atlas store (no device code) — a copy of
:mod:`qba_tpu.atlas.store`, so a cell record written by either package
has the same name, schema and digest.

One validated record per (config, strategy, noise) cell, **keyed by the
cell's config fingerprint**.  Filenames are derived from the fingerprint
hash and pass through the injective
:func:`qba_tpu_torch.serve.queuefs.request_slug`, so cell records
produced by independent ``run_surface`` runs merge into one store
directory without renames: identical configs land on identical
filenames, distinct configs cannot collide.

Two schemas live here:

* ``qba-tpu/atlas-cell/v1`` — one cell's certified (or explicitly
  refused) estimate: coords, config fingerprint, target, stop
  decision, anytime-valid CI, attempts, refusal evidence, plus a
  *provenance* block and the run manifest.  Provenance and manifest
  are excluded from the store digest, which covers exactly the
  identity-bearing content (cell set, configs, stop decisions,
  estimates).
* ``qba-tpu/atlas-campaign/v1`` — the campaign ledger: the campaign
  spec and per-cell status (the campaign runner itself waits for
  ROADMAP A15).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Iterator

from qba_tpu_torch.serve.queuefs import request_slug, write_json_atomic

CELL_SCHEMA = "qba-tpu/atlas-cell/v1"
LEDGER_SCHEMA = "qba-tpu/atlas-campaign/v1"

#: Cell record statuses.  ``certified`` — the stopping rule met the
#: target; ``refused`` — an explicit refusal/truncation finding
#: (admission reject, engine error, quarantine, or budget exhausted
#: after every escalation) with the evidence attached; ``uncertified``
#: — a fixed-budget estimate with a CI but no target (``run_surface``
#: without ``target=`` writes these; a campaign never does).
CELL_STATUSES = ("certified", "refused", "uncertified")

#: Cell-ledger statuses a campaign moves through, in order.
LEDGER_STATUSES = ("pending", "submitted", "certified", "refused")

#: Keys of a cell record that carry identity (everything the resume
#: differential compares); the rest — ``manifest``, ``provenance`` —
#: is attribution and may legitimately differ between two runs that
#: produced the same science.
IDENTITY_KEYS = (
    "schema",
    "cell_key",
    "coords",
    "config",
    "target",
    "chunk_trials",
    "status",
    "stop",
    "ci",
    "successes",
    "n_trials",
    "attempts",
    "refusal",
)


def canonical_json(obj: Any) -> str:
    """Deterministic serialization: sorted keys, no whitespace — the
    single recipe behind every hash in this module."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _normalize_fingerprint(fingerprint: dict[str, Any]) -> dict[str, Any]:
    """Drop the non-identity keys both fingerprint dialects may carry:
    ``trials`` is chunk sizing (sweep's checkpoint rule), ``derived``
    is recomputable shape arithmetic (the manifest dialect)."""
    fp = dict(fingerprint)
    fp.pop("trials", None)
    fp.pop("derived", None)
    return fp


def cell_key(fingerprint: dict[str, Any]) -> str:
    """The content address of one cell: a short sha256 of the
    canonicalized config fingerprint (minus ``trials``/``derived``).
    Accepts both the sweep fingerprint (``dataclasses.asdict`` minus
    trials) and the manifest fingerprint (same plus ``derived``) and
    maps them to the same key — a request and its manifest agree on
    identity by construction."""
    return hashlib.sha256(
        canonical_json(_normalize_fingerprint(fingerprint)).encode()
    ).hexdigest()[:16]


def cell_slug(fingerprint: dict[str, Any]) -> str:
    """Filesystem name stem for one cell: ``cell-<key>`` passed through
    the hardened injective :func:`request_slug` (NAME_MAX-safe,
    collision-checked sanitization) — shared by the store, the
    ``run_surface`` checkpoint layout, and campaign request ids."""
    return request_slug(f"cell-{cell_key(fingerprint)}")


def identity_view(record: dict[str, Any]) -> dict[str, Any]:
    """The identity-bearing subset of a cell record (see
    :data:`IDENTITY_KEYS`)."""
    return {k: record.get(k) for k in IDENTITY_KEYS}


def validate_cell_record(record: dict[str, Any]) -> dict[str, Any]:
    """Schema-check one cell record; returns it on success, raises
    ``ValueError`` naming the defect otherwise."""
    if not isinstance(record, dict):
        raise ValueError(f"cell record must be an object, got {type(record)}")
    if record.get("schema") != CELL_SCHEMA:
        raise ValueError(
            f"bad cell schema {record.get('schema')!r}; expected {CELL_SCHEMA}"
        )
    missing = [k for k in IDENTITY_KEYS if k not in record]
    if missing:
        raise ValueError(f"cell record missing keys {missing}")
    status = record["status"]
    if status not in CELL_STATUSES:
        raise ValueError(
            f"unknown cell status {status!r}; one of {CELL_STATUSES}"
        )
    if not isinstance(record["config"], dict):
        raise ValueError("cell 'config' must be the config fingerprint dict")
    want = cell_key(record["config"])
    if record["cell_key"] != want:
        raise ValueError(
            f"content-address violation: cell_key {record['cell_key']!r} "
            f"!= fingerprint key {want!r} — the record does not describe "
            "the config it is filed under"
        )
    if status == "certified":
        stop = record.get("stop")
        if not isinstance(stop, dict):
            raise ValueError("certified cell carries no stop decision")
        if stop.get("reason") not in ("decided_above", "decided_below", "ci_width"):
            raise ValueError(
                f"certified cell stopped with {stop.get('reason')!r} — "
                "only decided_above/decided_below/ci_width certify a target"
            )
    if status == "refused":
        refusal = record.get("refusal")
        if not isinstance(refusal, dict) or not refusal.get("reason"):
            raise ValueError(
                "refused cell carries no refusal evidence (need at least "
                "{'reason': ...})"
            )
    ci = record.get("ci")
    if ci is not None and not {"lo", "hi"} <= set(ci):
        raise ValueError(
            "cell 'ci' lacks lo/hi — a bare rate without its interval "
            "is what the atlas exists to prevent"
        )
    return record


def record_satisfies(record: dict[str, Any], target) -> bool:
    """Does a certified record answer a query at ``target`` (a
    :class:`qba_tpu_torch.stats.Target` or the grammar string)?  This is
    the cache-hit predicate: an estimate certified at >= the
    queried confidence answers any *weaker* question for free —
    a decide query is answered when the CI excludes its threshold, a
    width query when the CI is at least as tight."""
    if record.get("status") != "certified":
        return False
    ci = record.get("ci")
    if not isinstance(ci, dict) or not {"lo", "hi"} <= set(ci):
        return False
    from qba_tpu_torch.stats.targets import parse_target

    want = parse_target(target) if isinstance(target, str) else target
    have_conf = float(ci.get("confidence", 0.0))
    if have_conf + 1e-12 < want.confidence:
        return False
    lo, hi = float(ci["lo"]), float(ci["hi"])
    if want.kind == "decide":
        # The stop decision is the certificate: an e-value rule can
        # decide against a threshold before the (conservative) anytime
        # CI excludes it, so a decided stop at the same threshold
        # answers the question even when the CI straddles it.
        stop = record.get("stop") or {}
        if (
            stop.get("reason") in ("decided_above", "decided_below")
            and abs(float(stop.get("threshold", -1.0)) - want.threshold)
            <= 1e-9
        ):
            return True
        return lo > want.threshold or hi < want.threshold
    return (hi - lo) <= want.width + 1e-12


class AtlasCollision(ValueError):
    """Two distinct config fingerprints mapped to one cell filename —
    content addressing refuses to overwrite one with the other."""


class AtlasStore:
    """One atlas store directory: ``cells/`` of content-addressed
    records, ``ledger.json`` (campaign state), ``atlas.json`` (the
    rendered phase diagram)."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.cells_dir = os.path.join(root, "cells")
        self.ledger_path = os.path.join(root, "ledger.json")
        self.atlas_path = os.path.join(root, "atlas.json")
        os.makedirs(self.cells_dir, exist_ok=True)

    # ---- cells -------------------------------------------------------
    def cell_path(self, key: str) -> str:
        return os.path.join(
            self.cells_dir, request_slug(f"cell-{key}") + ".json"
        )

    def write_cell(self, record: dict[str, Any]) -> str:
        """Validate + atomically publish one cell record; returns the
        path.  Collision-checked: an existing record under the same
        filename must describe the same config fingerprint (same
        campaign re-certifying a cell overwrites it; a *different*
        config under the same name is refused loudly)."""
        validate_cell_record(record)
        path = self.cell_path(record["cell_key"])
        existing = self._read(path)
        if existing is not None:
            theirs = _normalize_fingerprint(existing.get("config") or {})
            ours = _normalize_fingerprint(record["config"])
            if theirs != ours:
                raise AtlasCollision(
                    f"{path} already holds a record for a different config "
                    f"({canonical_json(theirs)[:120]} != "
                    f"{canonical_json(ours)[:120]}) — refusing to overwrite"
                )
        write_json_atomic(path, record)
        return path

    def load_cell(self, key: str) -> dict[str, Any] | None:
        return self._read(self.cell_path(key))

    def lookup(self, fingerprint: dict[str, Any], target=None):
        """The cache-read path: the certified record answering this config fingerprint at
        ``target``, else None.  With no target any certified record
        for the config hits; with one, :func:`record_satisfies`
        decides — a stronger certificate answers a weaker question."""
        rec = self.load_cell(cell_key(fingerprint))
        if rec is None or rec.get("status") != "certified":
            return None
        if target is not None and not record_satisfies(rec, target):
            return None
        return rec

    def iter_cells(self) -> Iterator[tuple[str, dict[str, Any]]]:
        """(filename, record) for every readable cell file, sorted by
        name — deterministic iteration order for digests and renders."""
        if not os.path.isdir(self.cells_dir):
            return
        for name in sorted(os.listdir(self.cells_dir)):
            if not name.endswith(".json"):
                continue
            rec = self._read(os.path.join(self.cells_dir, name))
            if rec is not None:
                yield name, rec

    def digest(self) -> str:
        """sha256 over the identity view of every cell, in filename
        order.  Two stores with the same digest agree on the cell set,
        per-cell configs, stop decisions, and estimates — the
        bit-identity the campaign resume differential asserts.
        Provenance (timestamps, replica attribution, environment
        blocks) is excluded by construction."""
        h = hashlib.sha256()
        for name, rec in self.iter_cells():
            h.update(name.encode())
            h.update(canonical_json(identity_view(rec)).encode())
        return h.hexdigest()

    # ---- ledger ------------------------------------------------------
    def load_ledger(self) -> dict[str, Any] | None:
        led = self._read(self.ledger_path)
        if led is None:
            return None
        if led.get("schema") != LEDGER_SCHEMA:
            raise ValueError(
                f"{self.ledger_path}: bad ledger schema "
                f"{led.get('schema')!r}; expected {LEDGER_SCHEMA}"
            )
        return led

    def save_ledger(self, ledger: dict[str, Any]) -> None:
        assert ledger.get("schema") == LEDGER_SCHEMA, ledger.get("schema")
        write_json_atomic(self.ledger_path, ledger)

    # ---- plumbing ----------------------------------------------------
    @staticmethod
    def _read(path: str) -> dict[str, Any] | None:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        return payload if isinstance(payload, dict) else None


def record_from_surface_cell(
    cell, target, chunk_trials: int
) -> dict[str, Any]:
    """Build a store record from one
    :class:`qba_tpu_torch.sweep.SurfaceCell` — the merge path for
    independently produced ``run_surface`` cells: targeted cells certify
    or refuse exactly like campaign cells; untargeted cells land as
    ``uncertified`` fixed-budget estimates."""
    res = cell.result
    cfg = res.cfg
    import dataclasses as _dc

    fp = _dc.asdict(cfg)
    fp.pop("trials", None)
    stop = res.stop.to_json() if res.stop is not None else None
    est = res.estimators().success.estimate()
    status = "uncertified"
    refusal = None
    target_spec = None
    if target is not None:
        target_spec = target if isinstance(target, str) else target.spec
        if stop is not None and stop["reason"] in (
            "decided_above", "decided_below", "ci_width"
        ):
            status = "certified"
            est_json = stop["estimate"] or est.to_json()
        else:
            status = "refused"
            refusal = {
                "reason": "budget_exhausted",
                "detail": (
                    f"stopping rule unresolved after {res.n_trials} trials"
                ),
            }
            est_json = (stop or {}).get("estimate") or est.to_json()
    else:
        est_json = est.to_json()
    return {
        "schema": CELL_SCHEMA,
        "cell_key": cell_key(fp),
        "coords": {
            "n_parties": cfg.n_parties,
            "n_dishonest": cfg.n_dishonest,
            "strategy": cell.strategy,
            "p_depolarize": cell.p_depolarize,
            "p_measure_flip": cell.p_measure_flip,
            "size_l": cell.size_l,
        },
        "config": fp,
        "target": target_spec,
        "chunk_trials": chunk_trials,
        "status": status,
        "stop": stop,
        "ci": est_json,
        "successes": res.successes,
        "n_trials": res.n_trials,
        "attempts": 1,
        "refusal": refusal,
        "provenance": {"producer": "run_surface"},
        "manifest": cell.manifest,
    }
