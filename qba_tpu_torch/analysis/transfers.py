"""KI-6 host-sync discipline — the counterpart of
:mod:`qba_tpu.analysis.transfers` for PyTorch on CUDA.

A CUDA launch returns before the card runs it; every read of a device
value on the host — ``.item()``, ``int(t)``, a boolean mask's count —
blocks the host until the card drains, and inside a chunk that a CUDA
graph captures it is an error.  The discipline the port lives by: a
host sync is legal only

* inside a telemetry span whose body marks ``<span>.fenced = True`` —
  the span *is* the readback barrier; or
* annotated ``# qba-lint: sync-ok (reason)`` at the call site — for
  host data that never lay on the card, or a read the path needs.

Four checks:

* **AST sweep** over the hot modules (``rounds/``, ``ops/``,
  ``serve/``, ``serve/fleet/``, ``sweep.py``, ``benchmark.py``).  A
  sync site is any of ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray``/``np.array``, ``int()``/``float()``/
  ``bool()`` of a tensor, ``torch.nonzero``/``.nonzero()``/
  ``masked_select``/one-argument ``torch.where``, boolean-mask
  indexing (a subscript by a comparison or an inverted mask) and
  ``synchronize()``.  "Of a tensor" is decided without types: an
  expression that names ``torch``, calls a tensor reduction, or reads a
  local bound to such an expression or a parameter annotated
  ``torch.Tensor``.
* **Dispatch-order proof** over ``QBAServer._dispatch``/``_drain_one``
  (:func:`check_serve_dispatch`), as in the JAX package.
* **Fleet front half** (:func:`check_fleet`): ``frontend.py`` and
  ``supervisor.py`` never import torch, so the front half can open no
  CUDA context; no fleet module calls a device entry point; the pool
  spawns the stock ``serve --transport file-queue`` worker, which alone
  writes heartbeats.
* **Dynamic half** (:func:`check_device_loop`), the counterpart of the
  JAX package's traced device-loop proof: the graph loop's chunk
  (:func:`~qba_tpu_torch.ops.sweep_loop.chunk_step`) on every engine, with
  ``collect_counters`` and on the dense paths, is warmed up, then run
  under ``torch.cuda.set_sync_debug_mode("error")`` on the card — a
  raise is a finding, since a CUDA graph captures every such chunk, and
  its first sync site (``file:line`` inside the package) is named.  On
  the CPU a dispatch mode stands in for the debug mode: it stops at the
  first op that reads a value on the host (``_local_scalar_dense``,
  ``nonzero``, a boolean index, ...) outside a kernel wrapper's plain
  version (on the card that call is one launch).  Uploads from host
  memory show only on the card, where the capture itself refuses them.

Findings are tagged ``KI-6``.
"""

from __future__ import annotations

import ast
import os
import sys
import traceback

from qba_tpu_torch.analysis.findings import Finding, Report

#: Call-site marker demoting a host-sync finding to a note carrying the
#: justification.
SYNC_ALLOW_MARKER = "qba-lint: sync-ok"

#: Host-numpy module aliases whose ``asarray``/``array`` read a device
#: tensor back when fed one.
_HOST_NP_NAMES = ("np", "numpy", "onp")

#: Tensor methods that read the value back to the host.
_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: Tensor methods whose result is a tensor a cast would read back.
_TENSOR_METHODS = frozenset({
    "sum", "any", "all", "max", "min", "amax", "amin", "argmax", "argmin",
    "count_nonzero", "prod", "mean", "abs", "to", "contiguous", "clone",
})


def _pkg_root() -> str:
    import qba_tpu_torch

    return os.path.dirname(os.path.abspath(qba_tpu_torch.__file__))


def hot_module_paths(root: str | None = None) -> list[str]:
    """The audited surface: the modules on the dispatch/readback hot
    path of the port."""
    root = root if root is not None else _pkg_root()
    paths: list[str] = []
    for sub in ("rounds", "ops", "serve", os.path.join("serve", "fleet")):
        d = os.path.join(root, sub)
        for fname in sorted(os.listdir(d)):
            if fname.endswith(".py"):
                paths.append(os.path.join(d, fname))
    for fname in ("sweep.py", "benchmark.py"):
        paths.append(os.path.join(root, fname))
    return paths


def annotation_at(where: str, marker: str) -> str | None:
    """The justification after ``marker`` on the line at ``where``
    ("file:line") or within one line of it (wrapped calls), else
    None."""
    path, _, lineno = where.rpartition(":")
    try:
        num = int(lineno)
        with open(path) as fh:
            lines = fh.readlines()
    except (ValueError, OSError):
        return None
    for i in range(max(0, num - 2), min(len(lines), num + 2)):
        if marker in lines[i]:
            return lines[i].split(marker, 1)[1].strip() or "annotated"
    return None


# ---------------------------------------------------------------------------
# Sync-site detection.


def _names_torch(node) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id == "torch"
               for sub in ast.walk(node))


class _Scope:
    """The names of one function bound to tensor-like values."""

    def __init__(self, fn=None):
        self.tensors: set[str] = set()
        if fn is None:
            return
        for a in fn.args.args + fn.args.kwonlyargs:
            if a.annotation is not None and "Tensor" in ast.unparse(
                    a.annotation):
                self.tensors.add(a.arg)
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        for _ in range(2):  # a binding through one other binding
            for node in assigns:
                if self.tensor_like(node.value):
                    for t in node.targets:
                        for sub in ast.walk(t):
                            if isinstance(sub, ast.Name):
                                self.tensors.add(sub.id)

    def tensor_like(self, node) -> bool:
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and (node.func.attr in _READ_METHODS or (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id in _HOST_NP_NAMES))):
            return False  # read back already: host data
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and isinstance(
                    sub.value, ast.Name) and sub.value.id == "torch":
                return True
            if (isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in _TENSOR_METHODS):
                return True
            if isinstance(sub, ast.Name) and sub.id in self.tensors:
                return True
        return False


def _is_mask(node) -> bool:
    """A boolean-mask index: a comparison, an inverted mask, or ``&``/
    ``|`` of such."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(node.left) or _is_mask(node.right)
    return False


def _sync_kind(node, scope: _Scope) -> str | None:
    """Classify ``node`` as a device->host sync site, or None."""
    if isinstance(node, ast.Subscript):
        idx = node.slice
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        if any(_is_mask(p) for p in parts) and scope.tensor_like(node):
            return "boolean-mask indexing"
        return None
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        owner = fn.value
        if (isinstance(owner, ast.Name) and owner.id in _HOST_NP_NAMES
                and fn.attr in ("asarray", "array")):
            return f"{owner.id}.{fn.attr}"
        if fn.attr in _READ_METHODS and not node.args and not node.keywords:
            return f".{fn.attr}()"
        if fn.attr in ("nonzero", "masked_select"):
            return f".{fn.attr}()" if not _names_torch(owner) else (
                f"torch.{fn.attr}")
        if (fn.attr == "where" and isinstance(owner, ast.Name)
                and owner.id == "torch" and len(node.args) == 1):
            return "torch.where(cond)"
        if fn.attr == "synchronize":
            return "synchronize()"
    elif isinstance(fn, ast.Name) and fn.id in ("bool", "int", "float"):
        if len(node.args) == 1 and scope.tensor_like(node.args[0]):
            return f"{fn.id}() of a tensor"
    return None


class _SyncVisitor(ast.NodeVisitor):
    """Collects sync sites with their enclosing-``with`` fence state and
    the function scope that decides what is a tensor."""

    def __init__(self):
        self.with_stack: list[bool] = []
        self.scopes: list[_Scope] = [_Scope()]
        self.sites: list[tuple[ast.AST, str, bool]] = []

    @staticmethod
    def _is_fencing_with(node: ast.With) -> bool:
        spanlike = any(
            isinstance(item.context_expr, ast.Call)
            and isinstance(item.context_expr.func, ast.Attribute)
            and item.context_expr.func.attr in ("span", "time")
            for item in node.items
        )
        if not spanlike:
            return False
        for stmt in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Attribute)
                and stmt.targets[0].attr == "fenced"
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is True
            ):
                return True
        return False

    def _visit_fn(self, node) -> None:
        self.scopes.append(_Scope(node))
        self.generic_visit(node)
        self.scopes.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_fn

    def visit_With(self, node: ast.With) -> None:
        self.with_stack.append(self._is_fencing_with(node))
        self.generic_visit(node)
        self.with_stack.pop()

    def _site(self, node) -> None:
        kind = _sync_kind(node, self.scopes[-1])
        if kind is not None:
            self.sites.append((node, kind, any(self.with_stack)))
        self.generic_visit(node)

    visit_Call = visit_Subscript = _site


def audit_module(source_path: str, report: Report, stats: dict) -> None:
    """KI-6 AST sweep over one module."""
    with open(source_path) as fh:
        tree = ast.parse(fh.read(), filename=source_path)
    rel = os.path.basename(source_path)
    visitor = _SyncVisitor()
    visitor.visit(tree)
    for node, kind, fenced in visitor.sites:
        stats["sync_sites_checked"] += 1
        where = f"{source_path}:{node.lineno}"
        if fenced:
            stats["sync_sites_fenced"] += 1
            continue
        justification = annotation_at(where, SYNC_ALLOW_MARKER)
        if justification is not None:
            stats["sync_sites_allowlisted"] += 1
            report.notes.append(
                f"transfers: allowlisted host-sync ({kind}) at "
                f"{rel}:{node.lineno}: {justification}"
            )
            continue
        report.findings.append(Finding(
            ki="KI-6", check="host-sync", path=f"module:{rel}",
            where=where,
            message=(
                f"{kind} outside a fenced telemetry span: an implicit "
                "device->host read stalls the launch queue unattributed "
                "— wrap it in a span that sets `<span>.fenced = True`, "
                f"or annotate '# {SYNC_ALLOW_MARKER} (reason)' if the "
                "data never lives on the device"
            ),
        ))


# ---------------------------------------------------------------------------
# Serve dispatch-order proof.


def _calls_named(node, name: str):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            if (isinstance(fn, ast.Attribute) and fn.attr == name) or (
                isinstance(fn, ast.Name) and fn.id == name
            ):
                yield sub


def _stmt_has_sync(stmt, scope: _Scope) -> bool:
    return any(_sync_kind(sub, scope) is not None for sub in ast.walk(stmt))


def _find_method(tree, cls_name: str, meth_name: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            for item in node.body:
                if (
                    isinstance(item, ast.FunctionDef)
                    and item.name == meth_name
                ):
                    return item
    return None


def check_serve_dispatch(source_path: str | None = None) -> Report:
    """Prove the worker's double-buffer invariant on
    ``QBAServer._dispatch``/``_drain_one``: the chunk is enqueued on
    ``_in_flight`` before any drain or host sync, the drain loop is
    bounded by ``self.depth``, the ``serve.dispatch`` span stays
    enqueue-only (never fenced, no sync), and ``_drain_one`` pops the
    oldest chunk (``pop(0)``)."""
    report = Report()
    if source_path is None:
        import qba_tpu_torch.serve.engine as serve_engine

        source_path = serve_engine.__file__
    rel = os.path.basename(source_path)
    path = f"serve:{rel}"
    with open(source_path) as fh:
        tree = ast.parse(fh.read(), filename=source_path)

    dispatch = _find_method(tree, "QBAServer", "_dispatch")
    drain = _find_method(tree, "QBAServer", "_drain_one")
    if dispatch is None or drain is None:
        report.findings.append(Finding(
            ki="KI-6", check="dispatch-order", path=path,
            message=(
                "QBAServer._dispatch/_drain_one not found — the "
                "double-buffer proof no longer matches the module "
                "layout"
            ),
        ))
        return report
    scope = _Scope(dispatch)

    append_at = drain_at = sync_at = None
    for i, stmt in enumerate(dispatch.body):
        if append_at is None:
            for call in _calls_named(stmt, "append"):
                fn = call.func
                if (
                    isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Attribute)
                    and fn.value.attr == "_in_flight"
                ):
                    append_at = i
                    break
        if drain_at is None and any(_calls_named(stmt, "_drain_one")):
            drain_at = i
        if sync_at is None and _stmt_has_sync(stmt, scope):
            sync_at = i
    if append_at is None:
        report.findings.append(Finding(
            ki="KI-6", check="dispatch-order", path=path,
            where=f"{source_path}:{dispatch.lineno}",
            message=(
                "_dispatch never appends to _in_flight — the "
                "double-buffer proof no longer matches the code"
            ),
        ))
    else:
        for label, at in (("a drain", drain_at), ("a host sync", sync_at)):
            if at is not None and at < append_at:
                report.findings.append(Finding(
                    ki="KI-6", check="dispatch-order", path=path,
                    where=f"{source_path}:{dispatch.body[at].lineno}",
                    message=(
                        f"_dispatch performs {label} before enqueuing "
                        "the chunk on _in_flight: chunk k's readback "
                        "would block before chunk k+1's dispatch is "
                        "enqueued, serializing the double buffer"
                    ),
                ))

    depth_bounded = False
    for stmt in ast.walk(dispatch):
        if isinstance(stmt, ast.While) and any(
            _calls_named(stmt, "_drain_one")
        ):
            depth_bounded = any(
                isinstance(sub, ast.Attribute) and sub.attr == "depth"
                for sub in ast.walk(stmt.test)
            )
    if append_at is not None and not depth_bounded:
        report.findings.append(Finding(
            ki="KI-6", check="dispatch-order", path=path,
            where=f"{source_path}:{dispatch.lineno}",
            message=(
                "_dispatch's drain loop is not bounded by self.depth: "
                "the in-flight window no longer matches the "
                "configured double-buffer depth"
            ),
        ))

    for node in ast.walk(dispatch):
        if not isinstance(node, ast.With):
            continue
        names = [
            item.context_expr.args[0].value
            for item in node.items
            if isinstance(item.context_expr, ast.Call)
            and isinstance(item.context_expr.func, ast.Attribute)
            and item.context_expr.func.attr == "span"
            and item.context_expr.args
            and isinstance(item.context_expr.args[0], ast.Constant)
        ]
        if "serve.dispatch" not in names:
            continue
        fenced = _SyncVisitor._is_fencing_with(node)
        synced = any(_stmt_has_sync(s, scope) for s in node.body)
        if fenced or synced:
            report.findings.append(Finding(
                ki="KI-6", check="dispatch-order", path=path,
                where=f"{source_path}:{node.lineno}",
                message=(
                    "the serve.dispatch span must stay enqueue-only "
                    "(no host sync, never fenced) — it measures the "
                    "enqueue, and a sync here serializes dispatch "
                    "against the previous chunk's compute"
                ),
            ))

    fifo = any(
        isinstance(call.func, ast.Attribute)
        and call.func.attr == "pop"
        and call.args
        and isinstance(call.args[0], ast.Constant)
        and call.args[0].value == 0
        for call in _calls_named(drain, "pop")
    )
    if not fifo:
        report.findings.append(Finding(
            ki="KI-6", check="dispatch-order", path=path,
            where=f"{source_path}:{drain.lineno}",
            message=(
                "_drain_one does not pop(0) from _in_flight: readback "
                "order would diverge from dispatch order and the "
                "oldest chunk's results could wait behind newer ones"
            ),
        ))
    report.stats["dispatch_proof_obligations"] = 4
    return report


# ---------------------------------------------------------------------------
# Fleet front-half proof.

#: Call names that enter the device path; none may appear in the fleet
#: front half — replicas, and only replicas, touch the card.
_DEVICE_ENTRY_NAMES = frozenset({
    "run_trials", "run_trial", "trial_keys", "serve_batch", "synchronize",
    "set_device", "current_device",
})


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    return (fn.attr if isinstance(fn, ast.Attribute)
            else fn.id if isinstance(fn, ast.Name) else None)


def check_fleet(fleet_dir: str | None = None) -> Report:
    """Prove the fleet front half does no device work and can open no
    CUDA context: ``frontend.py`` and ``supervisor.py`` never import
    torch, not even lazily; no fleet module calls a device entry point
    or writes a heartbeat; ``ReplicaPool.worker_argv`` spawns the stock
    ``serve --transport file-queue`` worker (whose dispatch order
    :func:`check_serve_dispatch` proves), and the worker's transport
    constructs the ``HeartbeatWriter`` the supervisor reads."""
    report = Report()
    if fleet_dir is None:
        fleet_dir = os.path.join(_pkg_root(), "serve", "fleet")
    if not os.path.isdir(fleet_dir):
        report.findings.append(Finding(
            ki="KI-6", check="fleet-front", path="fleet:*",
            message=(
                "serve/fleet/ not found — the fleet front-half proof "
                "no longer matches the module layout"
            ),
        ))
        return report

    modules_checked = 0
    for fname in sorted(os.listdir(fleet_dir)):
        if not fname.endswith(".py"):
            continue
        modules_checked += 1
        path = os.path.join(fleet_dir, fname)
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        if fname in ("frontend.py", "supervisor.py"):
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                for mod in mods:
                    if mod.split(".")[0] == "torch":
                        report.findings.append(Finding(
                            ki="KI-6", check="fleet-front",
                            path=f"fleet:{fname}",
                            where=f"{path}:{node.lineno}",
                            message=(
                                f"{fname} imports {mod}: the fleet front "
                                "half must stay torch-free so it can "
                                "open no CUDA context and read nothing "
                                "back from the card"
                            ),
                        ))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in ("HeartbeatWriter", "beat"):
                report.findings.append(Finding(
                    ki="KI-6", check="fleet-front", path=f"fleet:{fname}",
                    where=f"{path}:{node.lineno}",
                    message=(
                        f"fleet front-half module calls {name}(): "
                        "heartbeats are written by workers and only "
                        "read here — a front-half write would forge "
                        "the watchdog's evidence"
                    ),
                ))
            elif name in _DEVICE_ENTRY_NAMES:
                report.findings.append(Finding(
                    ki="KI-6", check="fleet-front", path=f"fleet:{fname}",
                    where=f"{path}:{node.lineno}",
                    message=(
                        f"fleet front-half module calls {name}(): "
                        "device work belongs in the replicas' serve "
                        "loops, which the dispatch-order proof covers "
                        "— the front half must stay dispatch-free"
                    ),
                ))

    pool_path = os.path.join(fleet_dir, "pool.py")
    ok_argv = False
    if os.path.isfile(pool_path):
        with open(pool_path) as fh:
            pool_tree = ast.parse(fh.read(), filename=pool_path)
        argv_fn = _find_method(pool_tree, "ReplicaPool", "worker_argv")
        if argv_fn is not None:
            consts = {
                n.value
                for n in ast.walk(argv_fn)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            }
            ok_argv = {"serve", "file-queue", "--transport"} <= consts
    if not ok_argv:
        report.findings.append(Finding(
            ki="KI-6", check="fleet-front", path="fleet:pool.py",
            where=pool_path,
            message=(
                "ReplicaPool.worker_argv does not spawn "
                "'serve --transport file-queue': pool dispatch "
                "ordering no longer inherits the serve double-buffer "
                "proof"
            ),
        ))
    transport_path = os.path.join(os.path.dirname(fleet_dir),
                                  "transport.py")
    writes_heartbeat = False
    if os.path.isfile(transport_path):
        with open(transport_path) as fh:
            transport_tree = ast.parse(fh.read(), filename=transport_path)
        writes_heartbeat = any(
            isinstance(node, ast.Call)
            and _call_name(node) == "HeartbeatWriter"
            for node in ast.walk(transport_tree)
        )
    if not writes_heartbeat:
        report.findings.append(Finding(
            ki="KI-6", check="fleet-front", path="fleet:transport.py",
            where=transport_path,
            message=(
                "serve/transport.py constructs no HeartbeatWriter: "
                "workers have stopped feeding the supervisor's "
                "observation channel — hung workers become "
                "undetectable"
            ),
        ))
    report.stats["fleet_modules_checked"] = modules_checked
    report.stats["fleet_proof_obligations"] = 4
    return report


# ---------------------------------------------------------------------------
# Dynamic half: a chunk run under the sync debug mode.

#: Ops that read a value on the host (on the card each waits for the
#: stream): the CPU stand-in for ``set_sync_debug_mode("error")``.
_SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.nonzero.default",
    "aten.masked_select.default", "aten.is_nonzero.default",
    "aten.equal.default", "aten.repeat_interleave.Tensor",
    "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default",
})
_INDEX_OPS = frozenset({"aten.index.Tensor", "aten.index_put_.default",
                        "aten.index_put.default"})


class HostSync(RuntimeError):
    """The first host read of a probed run: ``what`` and ``site``."""

    def __init__(self, what: str, site: str):
        super().__init__(f"{what} at {site}")
        self.what, self.site = what, site


def package_site(frames) -> str:
    """The innermost ``file:line`` of ``frames`` (``FrameSummary``s,
    outermost first) inside the port's package and outside this
    checker, relative to the package's parent; ``"?"`` where none is."""
    root = _pkg_root()
    mine = os.path.join(root, "analysis")
    for fr in reversed(list(frames)):
        path = os.path.abspath(fr.filename)
        if path.startswith(root + os.sep) and not path.startswith(mine):
            return f"{os.path.relpath(path, os.path.dirname(root))}:{fr.lineno}"
    return "?"


def _wrapper_codes():
    from qba_tpu_torch.ops import kernel_wrappers

    return {fn.__code__ for fn in kernel_wrappers().values()}


def _in_wrapper(codes) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


def _sync_probe(codes):
    """A dispatch mode that raises :class:`HostSync` at the first host
    read outside a kernel wrapper's plain version."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class SyncProbe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            hit = name in _SYNC_OPS or (
                name in _INDEX_OPS and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] if len(args) > 1 else ()) or ()
                    if i is not None))
            if hit and not _in_wrapper(codes):
                raise HostSync(name, package_site(traceback.extract_stack()))
            return func(*args, **(kwargs or {}))

    return SyncProbe()


def first_sync(fn, device) -> tuple[str, str] | None:
    """Run ``fn()`` (warmed up by the caller) and return ``(what,
    site)`` of its first host sync, or None: on CUDA under
    ``torch.cuda.set_sync_debug_mode("error")``, on the CPU under the
    probe mode."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as exc:
            if "synchroniz" not in str(exc):
                raise
            return (str(exc).splitlines()[0][:120],
                    package_site(traceback.extract_tb(exc.__traceback__)))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(device)
        return None
    try:
        with _sync_probe(_wrapper_codes()):
            fn()
    except HostSync as hs:
        return hs.what, hs.site
    return None


#: Engines the dynamic half runs (``xla`` and the four kernel engines).
LOOP_ENGINES = ("xla", "pallas", "pallas_tiled", "pallas_fused",
                "pallas_mega")


def _chunk_fn(cfg, device, trials: int):
    """A zero-argument run of the graph loop's chunk
    (:func:`~qba_tpu_torch.ops.sweep_loop.chunk_step`) of ``cfg`` on
    ``device``, after :func:`~qba_tpu_torch.ops.sweep_loop.
    prepare_capture`, the carry reset before each run."""
    import torch

    from qba_tpu_torch import random as jr
    from qba_tpu_torch.analysis.trace import batch_trials
    from qba_tpu_torch.ops import sweep_loop as sl

    trials = batch_trials(cfg, device, trials)
    root = jr.key(cfg.seed, device)
    mode = jr.partitionable_mode()
    sl.prepare_capture(cfg, device)
    carry = sl.new_carry(4, 0, 0, device)
    lo = torch.full((5,), -1, dtype=torch.int32, device=device)
    hi = torch.full((5,), 4 * trials + 1, dtype=torch.int32, device=device)
    start = carry.clone()

    def step():
        carry.copy_(start)
        sl.chunk_step(cfg, trials, root, carry, lo, hi, partitionable=mode)

    return step


def check_device_loop(configs, engines, device, trials: int = 64) -> Report:
    """The KI-6 dynamic half over ``configs`` (``(label, cfg)``) on
    ``device``: each engine of ``engines`` in :data:`LOOP_ENGINES`, the
    fused round with ``collect_counters`` on each config, and, once, a
    3-party config on ``qsim_path="dense"`` and on ``"dense_pallas"``
    (the dense paths' list generation does not depend on the width past
    its batch).  The graph loop captures every one of these chunks, so a
    chunk that syncs is a finding."""
    import dataclasses

    report = Report()
    verdicts: dict[str, str] = {}
    runs = [(f"{label}/{e}", dataclasses.replace(cfg, round_engine=e))
            for label, cfg in configs for e in LOOP_ENGINES if e in engines]
    runs += [(f"{label}/pallas_fused+counters", dataclasses.replace(
        cfg, round_engine="pallas_fused", collect_counters=True))
        for label, cfg in configs]
    if configs:
        for path in ("dense", "dense_pallas"):
            runs.append((f"3p/{path}", dataclasses.replace(
                configs[0][1], n_parties=3, size_l=8, n_dishonest=1,
                round_engine="auto", collect_counters=False,
                qsim_path=path)))
    for path, cfg in runs:
        try:
            fn = _chunk_fn(cfg, device, trials)
            fn()  # warm-up: kernels built, tables cached
            hit = first_sync(fn, device)
        except Exception as exc:
            if type(exc).__name__ == "KernelUnsupported":
                report.notes.append(f"transfers/device-loop [{path}]: the "
                                    f"kernel refuses this config: {exc}")
                continue
            report.findings.append(Finding(
                ki="KI-6", check="device-loop", path=path,
                message=f"the sync probe could not run ({type(exc).__name__}"
                        f": {exc})",
            ))
            continue
        verdict = "no sync" if hit is None else f"{hit[0]} at {hit[1]}"
        verdicts[path] = verdict
        if hit is not None:
            report.findings.append(Finding(
                ki="KI-6", check="device-loop", path=path, where=hit[1],
                message=(
                    f"the graph loop's chunk reads the card on the host "
                    f"({hit[0]}): a CUDA graph cannot capture a host sync"
                ),
            ))
        else:
            report.notes.append(
                f"transfers/device-loop [{path}]: {verdict}")
    report.stats["device_loop_runs"] = len(verdicts)
    report.stats["sync_verdicts"] = verdicts
    return report


# ---------------------------------------------------------------------------
# Entry point.


def check_transfers(module_paths=None) -> Report:
    """The sitewide static KI-6 audit: the AST sweep over every hot
    module, the serve dispatch-order proof and the fleet front half."""
    report = Report()
    stats = {
        "sync_sites_checked": 0,
        "sync_sites_fenced": 0,
        "sync_sites_allowlisted": 0,
    }
    for path in module_paths or hot_module_paths():
        audit_module(path, report, stats)
    if module_paths is None and stats["sync_sites_checked"] == 0:
        report.findings.append(Finding(
            ki="KI-6", check="host-sync", path="module:*",
            message=(
                "found zero host-sync sites across the hot modules — "
                "the serve/sweep readback pipelines always sync "
                "somewhere, so the audit no longer matches the module "
                "layout"
            ),
        ))
    report.stats.update(stats)
    report.extend(check_serve_dispatch())
    report.extend(check_fleet())
    return report
