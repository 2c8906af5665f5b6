"""Warnings the port raises when it runs something other than what was
asked, or refuses a checkpoint — counterpart of
:mod:`qba_tpu.diagnostics` (the warning classes, their ``reason`` and the
decision recorder).

Every warn site may route through :func:`warn_and_record`, which warns
AND hands a structured record to any registered decision hooks
(:func:`record_decisions` collects them for a block), so an event is a
warning for people and a record for the sweep's report.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, Iterator


class QBAWarning(RuntimeWarning):
    """Base class of the port's runtime diagnostics."""


class QBADemotionWarning(QBAWarning):
    """A requested engine gave way to another that computes the same
    results: the megakernel to the fused per-round engine when counters
    are collected or no sharded plan exists, the gen entry to host
    generation under the ``tp`` mesh, or a circuit past the dense cap to
    the stabilizer tableau engine.  ``reason`` is the JAX package's
    recorded reason for the same demotion, where it records one."""

    def __init__(self, message: str = "", reason: str | None = None):
        super().__init__(message)
        self.reason = reason


class QBACheckpointMismatch(QBAWarning, ValueError):
    """A sweep checkpoint does not match the requested run.

    Raised as a ``ValueError``, and a :class:`QBAWarning` so
    ``resume_force`` can warn with the same category when it re-chunks
    instead of refusing.  Carries both fingerprints.  ``kind`` is
    ``"config"`` (never forceable: the checkpointed trials were drawn
    from a different program) or ``"chunk_trials"`` (forceable: same
    config, different chunking; the run re-chunks from scratch and
    overwrites).
    """

    def __init__(
        self,
        message: str,
        *,
        # Optional so ``warnings.warn(msg, QBACheckpointMismatch)`` can
        # instantiate the category from the message alone.
        kind: str = "chunk_trials",
        path: str = "",
        checkpoint_fingerprint: Any = None,
        requested_fingerprint: Any = None,
    ):
        super().__init__(message)
        self.kind = kind
        self.path = path
        self.checkpoint_fingerprint = checkpoint_fingerprint
        self.requested_fingerprint = requested_fingerprint

    @property
    def forceable(self) -> bool:
        return self.kind == "chunk_trials"


# Decision hooks: callables receiving the structured record of every
# warn_and_record call.  A hook's exception is swallowed: telemetry never
# changes what runs.
_DECISION_HOOKS: list[Callable[[dict], None]] = []


@contextlib.contextmanager
def record_decisions() -> Iterator[list[dict]]:
    """Collect every decision :func:`warn_and_record` warns inside the
    block; yields the (live) list of records."""
    records: list[dict] = []
    _DECISION_HOOKS.append(records.append)
    try:
        yield records
    finally:
        _DECISION_HOOKS.remove(records.append)


def warn_and_record(
    message: str,
    category: type[Warning],
    *,
    site: str,
    stacklevel: int = 2,
    **fields: Any,
) -> None:
    """``warnings.warn(message, category)`` plus a structured record
    (``kind``, ``category``, ``site``, ``message`` and ``fields``) for
    every registered hook.  ``stacklevel`` is relative to the caller."""
    record = {
        "kind": (
            "demotion"
            if issubclass(category, QBADemotionWarning)
            else "checkpoint"
            if issubclass(category, QBACheckpointMismatch)
            else "probe"
        ),
        "category": category.__name__,
        "site": site,
        "message": message,
        **fields,
    }
    for hook in list(_DECISION_HOOKS):
        try:
            hook(record)
        except Exception:  # telemetry must never alter dispatch
            pass
    warnings.warn(message, category, stacklevel=stacklevel + 1)


def warn_demotion(message: str, reason: str, stacklevel: int = 2) -> None:
    """Warn :class:`QBADemotionWarning` with ``reason``; ``stacklevel`` is
    relative to the caller."""
    warnings.warn(QBADemotionWarning(message, reason),
                  stacklevel=stacklevel + 1)
