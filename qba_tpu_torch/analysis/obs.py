"""KI-12: the "no dark time" observability-plane audit — the counterpart
of :mod:`qba_tpu.analysis.obs` over the port's package, its one metric
table (:data:`qba_tpu_torch.obs.metrics.METRICS`) and its stitched
traces (:func:`qba_tpu_torch.obs.tracing.stitch_traces`).

The fleet's tracing rests on three conventions that nothing at runtime
enforces
per se — a request whose trace id is re-minted mid-flight still
*works*, its spans just become unattributable orphans; a metric
emitted under a free-hand name still renders, it just silently forks
the name table.  This pass makes the conventions load-bearing:

1. **Mint-site closure.**  ``mint_trace_id()`` may be called ONLY at
   the registered request-origin sites (:data:`MINT_SITES`): the
   frontend's ``_intake`` and the atlas campaign's ``_stamp_trace``.
   Everything downstream must *adopt* the id riding the queue file.
   The closure runs both ways, like KI-10's ``PROTOCOL_SITES``: an
   unregistered call site is a finding, and so is a registered site
   that has gone missing (the model and the code must move together).
2. **One metric name table.**  Every emitter call
   (``.inc``/``.set_gauge``/``.observe``) whose first argument is a
   string literal must name a key of
   :data:`qba_tpu_torch.obs.metrics.METRICS`.  (Dynamic first arguments are
   the statistics rules' ``observe()`` — different protocol, exempt.)
3. **Trace-context propagation.**  The modules a request's identity
   must cross (request/engine/transport/frontend/supervisor/campaign)
   each have to reference ``trace_id``, and the engine's ``submit``
   must both adopt ``req.trace_id`` and stamp the ``t0_epoch``
   wall-clock anchor — without the anchor, spans can never be shifted
   onto the fleet's epoch axis and the whole worker segment goes dark.
4. **Coverage floor** (:func:`check_span_coverage`, needs a real run's
   queue dir): stitched request traces must attribute at least
   ``floor`` of their wall time to child spans, and the orphan-span
   count must be zero.

Seeded violation fixtures under ``tests/analysis_fixtures/`` prove the
checker bites.
"""

from __future__ import annotations

import ast
import os

from qba_tpu_torch.analysis.findings import Finding, Report
from qba_tpu_torch.obs.metrics import METRICS

#: Registered trace-id mint sites: (path relative to the qba_tpu_torch
#: package root, enclosing function).  Both-ways closure: a
#: ``mint_trace_id`` call anywhere else in the package is a finding,
#: and so is a registered site with no call left in it.
MINT_SITES = frozenset(
    {
        ("serve/fleet/frontend.py", "_intake"),
        ("atlas/campaign.py", "_stamp_trace"),
    }
)

#: The module that defines the minting helpers — its own code is not a
#: call site.
_MINT_HOME = "obs/tracing.py"

#: Metric emitter method names whose string-literal first argument must
#: be a registered metric name.
_EMITTERS = frozenset({"inc", "set_gauge", "observe"})

#: Modules a request's trace identity must cross.  Each must reference
#: ``trace_id`` somewhere (attribute, keyword, or literal) — a queue
#: hop that stops mentioning it has dropped the context.
PROPAGATING_MODULES = (
    "serve/request.py",
    "serve/engine.py",
    "serve/fleet/frontend.py",
    "serve/fleet/supervisor.py",
    "atlas/campaign.py",
)

#: Default stitched-trace coverage floor (the acceptance bar).
COVERAGE_FLOOR = 0.8


def _pkg_root() -> str:
    import qba_tpu_torch

    return os.path.dirname(os.path.abspath(qba_tpu_torch.__file__))


def _walk_calls(tree: ast.Module):
    """Yield ``(call, enclosing_function_name)`` tracking the innermost
    enclosing def (same idiom as the KI-10 conformance sweep)."""

    def walk(node: ast.AST, fn: str):
        for child in ast.iter_child_nodes(node):
            f = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = child.name
            if isinstance(child, ast.Call):
                yield child, f
            yield from walk(child, f)

    yield from walk(tree, "<module>")


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _iter_package_sources(pkg_root: str):
    for dirpath, _dirnames, filenames in os.walk(pkg_root):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
            try:
                with open(path) as f:
                    src = f.read()
                tree = ast.parse(src)
            except (OSError, SyntaxError):
                continue
            yield rel, src, tree


def _audit_tree(rel: str, tree: ast.Module, report: Report,
                seen_mints: set[tuple[str, str]]) -> int:
    """The per-module static rules (mint closure + metric names);
    returns the number of emitter calls audited."""
    audited = 0
    for call, fn_name in _walk_calls(tree):
        name = _call_name(call)
        if name == "mint_trace_id" and rel != _MINT_HOME:
            site = (rel, fn_name)
            seen_mints.add(site)
            if site not in MINT_SITES:
                report.findings.append(
                    Finding(
                        ki="KI-12",
                        check="mint-site",
                        path=f"qba_tpu_torch/{rel}",
                        message=(
                            f"mint_trace_id() called in {fn_name}() — "
                            "minting a fresh trace id outside the "
                            "registered request-origin sites orphans "
                            "every span recorded under it; adopt the "
                            "id riding the request instead (or "
                            "register the site in analysis/obs.py "
                            "MINT_SITES)"
                        ),
                        where=f"{rel}:{call.lineno}",
                    )
                )
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _EMITTERS
            and call.args
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, str)
        ):
            audited += 1
            metric = call.args[0].value
            if metric not in METRICS:
                report.findings.append(
                    Finding(
                        ki="KI-12",
                        check="metric-name",
                        path=f"qba_tpu_torch/{rel}",
                        message=(
                            f"emission of unregistered metric "
                            f"{metric!r} via .{call.func.attr}() — "
                            "every metric name must be a row of "
                            "qba_tpu_torch.obs.metrics.METRICS (one "
                            "name table, no forks)"
                        ),
                        where=f"{rel}:{call.lineno}",
                    )
                )
    return audited


def _references_trace_id(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "trace_id":
            return True
        if isinstance(node, ast.Name) and node.id == "trace_id":
            return True
        if isinstance(node, ast.keyword) and node.arg == "trace_id":
            return True
        if (
            isinstance(node, ast.Constant)
            and node.value == "trace_id"
        ):
            return True
    return False


def _check_request_fields(pkg_root: str, report: Report) -> None:
    """Trace context must be real EvalRequest/EvalResult fields — the
    strict ``from_json`` rejects unknown keys, so context smuggled any
    other way would be dropped at the first queue hop."""
    path = os.path.join(pkg_root, "serve", "request.py")
    try:
        with open(path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        report.findings.append(
            Finding(
                ki="KI-12",
                check="trace-propagation",
                path="qba_tpu_torch/serve/request.py",
                message="serve/request.py unreadable — no trace fields",
            )
        )
        return
    for cls_name in ("EvalRequest", "EvalResult"):
        cls = next(
            (n for n in ast.walk(tree)
             if isinstance(n, ast.ClassDef) and n.name == cls_name),
            None,
        )
        fields = {
            stmt.target.id
            for stmt in (cls.body if cls else [])
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
        }
        if "trace_id" not in fields:
            report.findings.append(
                Finding(
                    ki="KI-12",
                    check="trace-propagation",
                    path="qba_tpu_torch/serve/request.py",
                    message=(
                        f"{cls_name} has no trace_id field — the "
                        "strict from_json drops unknown keys, so "
                        "trace context cannot ride the queue file"
                    ),
                )
            )


def _check_engine_adoption(pkg_root: str, report: Report) -> None:
    """``submit`` must adopt ``req.trace_id`` into the root span's args
    and stamp ``t0_epoch``; without either, worker spans are dark."""
    path = os.path.join(pkg_root, "serve", "engine.py")
    try:
        with open(path) as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return
    submit = next(
        (n for n in ast.walk(tree)
         if isinstance(n, ast.FunctionDef) and n.name == "submit"),
        None,
    )
    if submit is None:
        report.findings.append(
            Finding(
                ki="KI-12",
                check="trace-adoption",
                path="qba_tpu_torch/serve/engine.py",
                message="engine submit() not found — adoption unproven",
            )
        )
        return
    adopts = any(
        isinstance(n, ast.Attribute)
        and n.attr == "trace_id"
        and isinstance(n.value, ast.Name)
        and n.value.id == "req"
        for n in ast.walk(submit)
    )
    anchors = any(
        (isinstance(n, ast.Constant) and n.value == "t0_epoch")
        or (isinstance(n, ast.keyword) and n.arg == "t0_epoch")
        for n in ast.walk(submit)
    )
    if not adopts:
        report.findings.append(
            Finding(
                ki="KI-12",
                check="trace-adoption",
                path="qba_tpu_torch/serve/engine.py",
                message=(
                    "submit() never reads req.trace_id — the worker "
                    "root span cannot adopt the request's identity "
                    "and its spans will stitch to nothing"
                ),
                where=f"engine.py:{submit.lineno}",
            )
        )
    if not anchors:
        report.findings.append(
            Finding(
                ki="KI-12",
                check="trace-adoption",
                path="qba_tpu_torch/serve/engine.py",
                message=(
                    "submit() never stamps t0_epoch — perf_counter "
                    "spans cannot be shifted onto the wall-clock axis "
                    "and the whole worker segment goes dark"
                ),
                where=f"engine.py:{submit.lineno}",
            )
        )


def check_obs(pkg_root: str | None = None) -> Report:
    """The static KI-12 pass over the shipped package: mint-site
    closure, metric-name registration, trace-context propagation,
    engine adoption.  This is what ``python -m qba_tpu_torch lint --obs``
    runs."""
    root = pkg_root if pkg_root is not None else _pkg_root()
    report = Report()
    seen_mints: set[tuple[str, str]] = set()
    audited = 0
    trees: dict[str, ast.Module] = {}
    for rel, _src, tree in _iter_package_sources(root):
        trees[rel] = tree
        audited += _audit_tree(rel, tree, report, seen_mints)
    for site in sorted(MINT_SITES - seen_mints):
        rel, fn_name = site
        report.findings.append(
            Finding(
                ki="KI-12",
                check="mint-site",
                path=f"qba_tpu_torch/{rel}",
                message=(
                    f"registered mint site lost: {fn_name}() in {rel} "
                    "no longer calls mint_trace_id() — requests born "
                    "there would ride the queue with no trace id; "
                    "update the code AND MINT_SITES together"
                ),
            )
        )
    for rel in PROPAGATING_MODULES:
        tree = trees.get(rel)
        if tree is None or not _references_trace_id(tree):
            report.findings.append(
                Finding(
                    ki="KI-12",
                    check="trace-propagation",
                    path=f"qba_tpu_torch/{rel}",
                    message=(
                        f"{rel} never references trace_id — a queue "
                        "hop through it drops the trace context and "
                        "everything downstream orphans"
                    ),
                )
            )
    _check_request_fields(root, report)
    _check_engine_adoption(root, report)
    report.stats["obs_modules_scanned"] = len(trees)
    report.stats["obs_emitter_calls_audited"] = audited
    report.stats["obs_mint_sites_bound"] = len(seen_mints & MINT_SITES)
    report.notes.append(
        f"obs: {len(trees)} modules scanned, {audited} emitter call(s) "
        f"audited, {len(seen_mints & MINT_SITES)}/{len(MINT_SITES)} "
        "mint sites bound"
    )
    return report


def check_obs_fixture(fixture_path: str) -> Report:
    """Run the same static rules over one seeded violation fixture (the
    file is treated as a package module at its basename).  Used by
    the fixture tests — the checker must kill every fixture."""
    report = Report()
    with open(fixture_path) as f:
        tree = ast.parse(f.read())
    rel = os.path.basename(fixture_path)
    seen: set[tuple[str, str]] = set()
    audited = _audit_tree(rel, tree, report, seen)
    report.stats["obs_emitter_calls_audited"] = audited
    return report


def check_span_coverage(
    queue_dir: str,
    telemetry_dir: str | None = None,
    *,
    floor: float = COVERAGE_FLOOR,
) -> Report:
    """The dynamic half of KI-12, over a real fleet run's artifacts:
    every closed stitched trace must attribute at least ``floor`` of
    its wall time to child spans, and no worker span may be an orphan."""
    from qba_tpu_torch.obs.tracing import stitch_traces

    report = Report()
    stitched = stitch_traces(queue_dir, telemetry_dir=telemetry_dir)
    if stitched["orphan_spans"]:
        report.findings.append(
            Finding(
                ki="KI-12",
                check="span-coverage",
                path=queue_dir,
                message=(
                    f"{stitched['orphan_spans']} orphan span(s): worker "
                    "span files that stitch to no intaken request — "
                    "their trace id was dropped or re-minted somewhere "
                    "on the queue path"
                ),
            )
        )
    below = 0
    for tid, trace in sorted(stitched["traces"].items()):
        cov = trace["coverage"]
        if not trace["closed"] or cov is None:
            continue
        if cov < floor:
            below += 1
            report.findings.append(
                Finding(
                    ki="KI-12",
                    check="span-coverage",
                    path=queue_dir,
                    message=(
                        f"trace {tid[:12]} (request "
                        f"{trace.get('request_id')}) attributes only "
                        f"{cov:.1%} of its {trace['dur']:.3f}s wall "
                        f"time to child spans (floor {floor:.0%}) — "
                        "dark time the trace cannot explain"
                    ),
                )
            )
    n = len(stitched["traces"])
    report.stats["obs_traces_checked"] = n
    report.notes.append(
        f"obs: {n} stitched trace(s), {stitched['orphan_spans']} "
        f"orphan span(s), {below} below the {floor:.0%} coverage floor"
    )
    return report
