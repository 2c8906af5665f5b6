"""Warm-start persistence: the saved-plan artifact — counterpart of
:mod:`qba_tpu.serve.persist` and of the ``plans_path`` /
``plans_lock_path`` helpers of :mod:`qba_tpu.compile_cache`.

A serve cache directory (``--cache-dir``) holds ``plans.json`` in the
JAX package's schema (``qba-tpu/saved-plans/v1``): ``configs``, the
explicit kwargs of every shape the server has dispatched (either
package's :func:`saved_configs` reads the other's), ``mesh`` (read and
written unchanged), and ``resolver_state``, which here records what
each saved shape resolves to on the device of the last save: the round
engine and ``mega_gen`` (``serve --cache-stats`` reports it).  The port
has no XLA cache beside it: its kernels are cached by their build
(``ops/_build.py::build_dir``).

:func:`load_plans` pre-resolves every saved shape at boot: the engine,
the build and load of the kernels its plan launches, and on the
stabilizer path the per-config affine maps, so a second boot's first
request pays none of them.

Concurrency contract (a pool of workers may share ONE cache dir): every
read and write happens under an advisory ``flock`` on
``plans.json.lock``, writes go through a writer-unique temp file +
``os.replace``, and a save MERGES with the artifact already on disk: the
union of config shapes, whose ``resolver_state`` is written anew (one
written by the other package is replaced, as the JAX package replaces
a foreign one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
from typing import Any, Iterator

from qba_tpu_torch.config import QBAConfig

PLANS_SCHEMA = "qba-tpu/saved-plans/v1"
RESOLVER_SCHEMA = "qba-tpu-torch/resolver-state/v1"

# Config fields that do not affect kernel plans; normalized out so the
# saved config list stays one entry per *shape*.
_NON_PLAN_FIELDS = ("seed", "trials")


def default_cache_root() -> str:
    """The per-user artifact root (override with ``QBA_CACHE_ROOT``)."""
    return os.environ.get(
        "QBA_CACHE_ROOT",
        os.path.join(os.path.expanduser("~"), ".cache", "qba_tpu_torch"),
    )


def plans_path(cache_dir: str | None = None) -> str:
    """The saved-plan artifact inside ``cache_dir`` (default: the
    per-user root)."""
    return os.path.join(cache_dir or default_cache_root(), "plans.json")


def plans_lock_path(cache_dir: str | None = None) -> str:
    """The advisory lock file guarding ``plans.json`` reads/writes."""
    return plans_path(cache_dir) + ".lock"


def plan_config_entry(cfg: QBAConfig) -> dict[str, Any]:
    """The explicit (non-derived) kwargs that rebuild ``cfg``'s shape,
    normalized for plan identity."""
    entry = {
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(QBAConfig)
    }
    for name in _NON_PLAN_FIELDS:
        entry.pop(name, None)
    # Counters change the plan on CUDA ("auto" runs the fused round), so
    # they are kept where on; left out where off, the entry is the JAX
    # package's for the same shape.
    if not cfg.collect_counters:
        entry.pop("collect_counters")
    entry["trials"] = 1
    return entry


@contextlib.contextmanager
def plans_lock(cache_dir: str | None) -> Iterator[None]:
    """Exclusive advisory lock over the ``plans.json`` artifact (``flock``
    on a sidecar file: ``os.replace`` swaps the artifact's inode)."""
    lock_file = plans_lock_path(cache_dir)
    os.makedirs(os.path.dirname(lock_file) or ".", exist_ok=True)
    with open(lock_file, "a") as fh:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


def _read_payload(path: str) -> dict[str, Any] | None:
    """Best-effort read of an existing artifact (None on any defect)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(payload, dict) or payload.get("schema") != PLANS_SCHEMA:
        return None
    return payload


def resolver_state(entries: list[dict[str, Any]], device) -> dict[str, Any]:
    """What each saved shape (``configs`` entries) resolves to on
    ``device``: one ``[entry, {"engine", "mega_gen"}]`` pair a shape the
    port can rebuild."""
    import torch

    from qba_tpu_torch.benchmark import kernel_plan

    dev = torch.device(device)
    buckets = []
    for entry in entries:
        try:
            cfg = QBAConfig(**entry)
        except (TypeError, ValueError):
            continue  # a shape this package cannot rebuild
        plan = kernel_plan(cfg, dev)
        buckets.append([entry, {"engine": plan["engine"],
                                "mega_gen": plan["mega_gen"]}])
    return {"schema": RESOLVER_SCHEMA, "torch_version": torch.__version__,
            "backend": dev.type, "buckets": buckets}


def save_plans(
    cache_dir: str | None,
    configs: list[QBAConfig] | None = None,
    mesh: dict[str, Any] | None = None,
    *,
    device=None,
) -> str:
    """Write ``plans.json`` under ``cache_dir``: ``configs``' shapes and
    what they resolve to on ``device`` (default: CUDA), merged with
    whatever is already on disk.  ``mesh`` (e.g. ``{"dp": 2, "tp": 4,
    "tp_comms": "ring"}``) is recorded as given; a save without it keeps
    the artifact's.  Returns the path written."""
    from qba_tpu_torch.backends.torch_backend import resolve_device

    path = plans_path(cache_dir)
    dev = resolve_device(device)
    seen: list[dict[str, Any]] = []
    for cfg in configs or []:
        entry = plan_config_entry(cfg)
        if entry not in seen:
            seen.append(entry)
    with plans_lock(cache_dir):
        prior = _read_payload(path)
        if prior is not None:
            for entry in prior.get("configs", []):
                if entry not in seen:
                    seen.append(entry)
            if mesh is None:
                mesh = prior.get("mesh")
        payload = {
            "schema": PLANS_SCHEMA,
            "resolver_state": resolver_state(seen, dev),
            "configs": seen,
            "mesh": mesh,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def prepare_config(cfg: QBAConfig, device) -> dict[str, Any]:
    """Everything a first dispatch of ``cfg`` on ``device`` would do
    before its kernels run: resolve the plan, build and load its CUDA
    libraries (on CUDA) and, on the stabilizer path, build the per-config
    tables (the affine maps and tableaux) on the device.  Returns the
    plan."""
    import torch

    from qba_tpu_torch.benchmark import kernel_plan

    dev = torch.device(device)
    plan = kernel_plan(cfg, dev)
    if plan["kernels"]:
        from qba_tpu_torch.ops._build import load_library

        for name in plan["kernels"]:
            load_library(name)
    if cfg.qsim_path == "stabilizer":
        from qba_tpu_torch.qsim.protocol_circuits import prepare_tables

        prepare_tables(cfg, dev)
    return plan


def load_plans(cache_dir: str | None, device=None) -> int:
    """Pre-resolve every shape saved in ``cache_dir``'s ``plans.json`` on
    ``device`` (default: CUDA) with :func:`prepare_config`.  Returns the
    number of shapes prepared (0 when the file is absent or unreadable —
    warm start is best-effort, a cold boot is always correct).  Reads
    under the artifact lock so a worker booting mid-save of a peer waits
    for the complete file."""
    from qba_tpu_torch.backends.torch_backend import resolve_device

    with plans_lock(cache_dir):
        payload = _read_payload(plans_path(cache_dir))
    if payload is None:
        return 0
    dev = resolve_device(device)
    n = 0
    for entry in payload.get("configs", []):
        try:
            cfg = QBAConfig(**entry)
        except (TypeError, ValueError):
            continue  # a shape this package cannot rebuild
        prepare_config(cfg, dev)
        n += 1
    return n


def saved_configs(path: str) -> list[QBAConfig]:
    """The dispatched-shape configs recorded in a ``plans.json`` —
    raises ``ValueError`` on a missing/malformed file."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except OSError as e:
        raise ValueError(f"cannot read saved plans {path!r}: {e}") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"malformed saved plans {path!r}: {e}") from None
    if not isinstance(payload, dict) or payload.get("schema") != PLANS_SCHEMA:
        raise ValueError(
            f"{path!r} is not a {PLANS_SCHEMA} artifact "
            f"(schema={payload.get('schema') if isinstance(payload, dict) else None!r})"
        )
    return [QBAConfig(**entry) for entry in payload.get("configs", [])]


def saved_mesh(cache_dir: str | None) -> dict[str, Any] | None:
    """The fleet mesh recorded in ``cache_dir``'s ``plans.json``, or None
    when the artifact is absent, pre-mesh, or unreadable."""
    with plans_lock(cache_dir):
        payload = _read_payload(plans_path(cache_dir))
    if payload is None:
        return None
    mesh = payload.get("mesh")
    return mesh if isinstance(mesh, dict) else None


def saved_resolutions(cache_dir: str | None) -> dict[str, Any] | None:
    """The port's ``resolver_state`` in ``cache_dir``'s ``plans.json``:
    the backend of the last save and each saved shape's engine and
    ``mega_gen`` there; None when the artifact is absent, unreadable or
    last saved by the other package."""
    with plans_lock(cache_dir):
        payload = _read_payload(plans_path(cache_dir))
    state = payload.get("resolver_state") if payload else None
    if not isinstance(state, dict) or state.get("schema") != RESOLVER_SCHEMA:
        return None
    return state
