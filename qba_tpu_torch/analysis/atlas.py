"""KI-11 — campaign completeness over an atlas store: the counterpart of
:mod:`qba_tpu.analysis.atlas` over the port's ``atlas/store.py``,
``cube.py`` and ``steer.py`` (the same store format).

The atlas's value is the claim "this is the whole cube": every cell of
the enumerated campaign either carries a certified record meeting its
target or an explicit refusal/truncation finding.  A silent gap — a
cell that was enumerated but never certified, refused, or even
admitted — converts the phase diagram from evidence into anecdote, and
nothing at run time notices: the driver exits, the store looks
plausible, the renderer happily draws the cells that exist.

So completeness is a *lint gate* (KI-11):

* the store carries a campaign ledger, the ledger belongs to the spec
  it claims, and **re-enumerating the spec's cube** yields exactly the
  ledger's cell set (the cube is re-derived, never trusted);
* every cell is terminal — ``certified`` or ``refused`` — and its
  store record exists, validates, agrees with the ledger, and is
  filed under the content address its own config hashes to;
* certified records certify honestly: a resolving stop decision and a
  CI with both endpoints (the KI-8 rule, applied to the atlas);
  refused records carry their evidence (``refusal.reason``);
* frontier steering held: per rendered slice, the widest frontier
  cell's CI is no wider than the widest interior cell's — frontier
  cells are the ones the escalation policy promises to tighten first.

Orphan records (cells in the store but not this campaign's ledger) are
notes, not findings — independently produced stores merging into one
directory is the design, and each campaign's completeness is judged
against its own cube.
"""

from __future__ import annotations

from typing import Any

from qba_tpu_torch.analysis.findings import Finding, Report
from qba_tpu_torch.atlas.steer import is_frontier
from qba_tpu_torch.atlas.store import (
    AtlasStore,
    cell_key,
    validate_cell_record,
)

_PASS = "campaign-completeness"


def _finding(check: str, message: str, where: str = "") -> Finding:
    return Finding(
        ki="KI-11", check=check, path="atlas/store", message=message,
        where=where,
    )


def check_atlas_store(store_dir: str) -> Report:
    """Prove one atlas store complete against its campaign ledger;
    every violated invariant is a KI-11 finding."""
    report = Report()
    store = AtlasStore(store_dir)
    try:
        ledger = store.load_ledger()
    except ValueError as e:
        report.add([_finding("ledger-schema", str(e), store.ledger_path)])
        return report
    if ledger is None:
        report.add([
            _finding(
                "ledger-missing",
                "no campaign ledger: completeness is unprovable — a "
                "store without a ledger is a collection, not an atlas",
                store.ledger_path,
            )
        ])
        return report
    target = (ledger.get("campaign") or {}).get("target")
    cells: dict[str, Any] = ledger.get("cells") or {}

    # --- the cube is re-derived, never trusted -----------------------
    spec_json = ledger.get("campaign")
    enumerated: list[str] | None = None
    if isinstance(spec_json, dict):
        try:
            from qba_tpu_torch.atlas.cube import CampaignSpec, enumerate_cells

            spec = CampaignSpec.from_json(spec_json)
            if spec.campaign_key() != ledger.get("campaign_key"):
                report.add([
                    _finding(
                        "campaign-key",
                        f"ledger campaign_key {ledger.get('campaign_key')!r}"
                        f" != spec hash {spec.campaign_key()!r}",
                        store.ledger_path,
                    )
                ])
            enumerated = [c.key for c in enumerate_cells(spec)]
        except (TypeError, ValueError) as e:
            report.add([
                _finding(
                    "campaign-spec",
                    f"ledger campaign spec does not re-enumerate: {e}",
                    store.ledger_path,
                )
            ])
    else:
        report.add([
            _finding(
                "campaign-spec", "ledger carries no campaign spec",
                store.ledger_path,
            )
        ])
    if enumerated is not None:
        missing = [k for k in enumerated if k not in cells]
        extra = [k for k in cells if k not in set(enumerated)]
        for k in missing:
            report.add([
                _finding(
                    _PASS,
                    f"enumerated cell {k} is absent from the ledger — "
                    "a silent gap in the cube",
                    store.ledger_path,
                )
            ])
        for k in extra:
            report.add([
                _finding(
                    _PASS,
                    f"ledger cell {k} is not produced by the campaign "
                    "spec's enumeration — ledger and spec disagree",
                    store.ledger_path,
                )
            ])

    # --- every cell terminal, every record honest --------------------
    n_certified = n_refused = 0
    for key, entry in sorted(cells.items()):
        status = entry.get("status")
        if status not in ("certified", "refused"):
            report.add([
                _finding(
                    _PASS,
                    f"cell {key} ({entry.get('coords')}) is {status!r}: "
                    "neither certified to its target nor explicitly "
                    "refused — the campaign did not finish",
                    store.ledger_path,
                )
            ])
            continue
        rec = store.load_cell(key)
        path = store.cell_path(key)
        if rec is None:
            report.add([
                _finding(
                    "record-missing",
                    f"ledger says {key} is {status} but the store has "
                    "no readable record for it",
                    path,
                )
            ])
            continue
        try:
            validate_cell_record(rec)
        except ValueError as e:
            report.add([_finding("record-invalid", str(e), path)])
            continue
        if rec["status"] != status:
            report.add([
                _finding(
                    "ledger-record-drift",
                    f"ledger calls {key} {status!r} but its record says "
                    f"{rec['status']!r}",
                    path,
                )
            ])
        if rec["status"] == "certified":
            n_certified += 1
            if target is not None and rec.get("target") != target:
                from qba_tpu_torch.atlas.store import record_satisfies

                if not record_satisfies(rec, target):
                    report.add([
                        _finding(
                            "target-mismatch",
                            f"cell {key} certified at {rec.get('target')!r}"
                            f" which does not satisfy the campaign target "
                            f"{target!r}",
                            path,
                        )
                    ])
        else:
            n_refused += 1

    # --- orphans: legitimate (merged stores), but say so -------------
    ledger_keys = set(cells)
    orphans = [
        rec["cell_key"]
        for _name, rec in store.iter_cells()
        if rec.get("cell_key") not in ledger_keys
    ]
    if orphans:
        report.notes.append(
            f"{len(orphans)} store cell(s) outside this campaign's ledger "
            f"(merged store?): {orphans[:4]}"
        )

    # --- filename <-> content address --------------------------------
    for name, rec in store.iter_cells():
        ck = rec.get("cell_key")
        cfg = rec.get("config")
        if isinstance(cfg, dict) and ck is not None:
            want = cell_key(cfg)
            if ck != want or not name.startswith(f"cell-{ck}"):
                report.add([
                    _finding(
                        "content-address",
                        f"{name}: filed key {ck!r} vs config hash "
                        f"{want!r} — record and address disagree",
                        store.cells_dir,
                    )
                ])

    # --- frontier steering held on the rendered slices ---------------
    if target:
        slices: dict[tuple, dict[str, list[float]]] = {}
        for _name, rec in store.iter_cells():
            if rec.get("cell_key") not in ledger_keys:
                continue
            ci = rec.get("ci") or {}
            if ci.get("lo") is None or ci.get("hi") is None:
                continue
            width = float(ci["hi"]) - float(ci["lo"])
            coords = rec.get("coords") or {}
            skey = (
                coords.get("strategy"),
                coords.get("p_depolarize"),
                coords.get("p_measure_flip"),
                coords.get("size_l"),
            )
            side = "frontier" if is_frontier(rec, target) else "interior"
            slices.setdefault(skey, {"frontier": [], "interior": []})[
                side
            ].append(width)
        for skey, widths in sorted(slices.items(), key=str):
            fw, iw = widths["frontier"], widths["interior"]
            if fw and iw and max(fw) > max(iw) + 1e-9:
                report.add([
                    _finding(
                        "frontier-widths",
                        f"slice {skey}: widest frontier CI {max(fw):.4f} "
                        f"> widest interior CI {max(iw):.4f} — the "
                        "steering policy promises frontier cells tighten "
                        "first",
                        store.cells_dir,
                    )
                ])
            elif fw:
                report.notes.append(
                    f"slice {skey}: frontier max width {max(fw):.4f}"
                    + (f" <= interior max {max(iw):.4f}" if iw else "")
                )

    report.stats["atlas_cells"] = len(cells)
    report.stats["atlas_certified"] = n_certified
    report.stats["atlas_refused"] = n_refused
    report.notes.append(
        f"atlas store {store_dir}: {len(cells)} ledger cell(s), "
        f"{n_certified} certified, {n_refused} refused, "
        f"digest {store.digest()[:16]}"
    )
    return report
