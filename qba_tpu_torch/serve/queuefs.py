"""Atomic JSON writes and injective file slugs — the two helpers of
:mod:`qba_tpu.serve.queuefs` the atlas store and the sweep checkpoints
use, copied (the file queue itself waits for the serving worker, ROADMAP
A10)."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any


def write_json_atomic(path: str, payload: dict[str, Any]) -> None:
    """Temp-file + rename: a concurrent reader sees the old file or the
    new one, never a partial write.  The temp name is writer-unique so
    concurrent writers of the same path don't interleave into one temp
    file before their renames."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str)
    # qba-protocol: publish
    os.replace(tmp, path)


#: Longest id that may map to itself; longer ones are truncated and
#: hash-suffixed so two ids differing only past this point still get
#: distinct (and filesystem-legal, NAME_MAX-safe) queue filenames.
_SLUG_MAX = 100


def request_slug(request_id: str) -> str:
    """Filesystem-safe **injective** slug for a request id (shared by
    result files and per-request telemetry directories).

    A short id that is already filesystem-safe maps to itself;
    anything else maps to its sanitized (and truncated) form plus a
    short hash of the raw id.  Injectivity matters because distinct
    client-supplied ids must never share a queue filename — ``'a/b'``
    and ``'a_b'`` colliding would overwrite one request's inbox file
    with the other's and resolve both pending futures from a single
    result.  The hash suffix is joined with ``~``, a character the
    sanitizer never passes through, so a literal id crafted to look
    like ``<sanitized>~<digest>`` cannot collide with a hashed slug:
    self-mapped slugs never contain ``~``, hashed ones always do.
    """
    safe = "".join(
        c if c.isalnum() or c in "-_." else "_" for c in request_id
    )
    if safe == request_id and safe and len(safe) <= _SLUG_MAX:
        return safe
    digest = hashlib.sha1(
        request_id.encode("utf-8", "surrogatepass")
    ).hexdigest()[:10]
    return f"{safe[:_SLUG_MAX] or 'request'}~{digest}"
