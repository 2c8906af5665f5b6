"""Finding/report data model of the port's invariant checker — a copy
of :mod:`qba_tpu.analysis.findings`, kept inside the port.

A *finding* is one violated invariant, tagged with the Known Issue it
mechanizes (the JAX package's ``docs/KNOWN_ISSUES.md``); the tags are
the JAX package's, so the two checkers' findings compare as ``(ki,
check)`` sets:

* ``KI-1`` — ``out_vma`` threading on ``shard_map``; the port has no
  such metadata and raises no KI-1 finding (:mod:`.driver`).
* ``KI-2`` — a kernel plan over its shared-memory budget, or a batch
  over the card's memory (:mod:`.memory`).
* ``KI-3`` — a float dot on integer data outside the exact range of
  the precision in force, or a dot site without its bound argument
  (:mod:`.dots`).
* ``KI-5`` — a launch count off its engine's model, or a round loop
  whose carry leaves its ping-pong pair (:mod:`.launches`,
  :mod:`.effects`).
* ``KI-6`` — a host sync on a hot module outside a fenced span and
  without ``# qba-lint: sync-ok``, a serve dispatch-order break, a
  fleet front half that could open a CUDA context, or a capturable
  chunk that syncs (:mod:`.transfers`).
* ``KI-8`` — a bare rate in a run manifest (:mod:`.manifests`).
* ``KI-10`` — a file-queue protocol violation (:mod:`.protocol`).
* ``KI-11`` — an incomplete atlas campaign (:mod:`.atlas`).
* ``KI-12`` — dark time in the observability plane (:mod:`.obs`).

A *note* informs (plan numbers, first sync sites, launch counts) and
never fails the gate; a finding always does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

KI_TAGS = (
    "KI-1", "KI-2", "KI-3", "KI-5", "KI-6", "KI-8", "KI-10", "KI-11",
    "KI-12",
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant."""

    ki: str  # one of KI_TAGS
    check: str  # pass name, e.g. "exact-dot", "host-sync"
    path: str  # checked path, e.g. "north-star/pallas_tiled"
    message: str  # human-readable statement of the violation
    where: str = ""  # source location "file:line" when recoverable

    def __post_init__(self) -> None:
        if self.ki not in KI_TAGS:
            raise ValueError(f"unknown KI tag {self.ki!r}")

    def render(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.ki} {self.check} ({self.path}){loc}: {self.message}"


@dataclasses.dataclass
class Report:
    """Aggregated lint result: findings fail the gate, notes inform."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    notes: list[str] = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def extend(self, other: "Report") -> None:
        self.findings.extend(other.findings)
        self.notes.extend(other.notes)
        for k, v in other.stats.items():
            if isinstance(v, (int, float)) and k in self.stats:
                self.stats[k] += v
            elif isinstance(v, (set, frozenset)):
                self.stats[k] = set(self.stats.get(k, set())) | set(v)
            elif isinstance(v, dict) and isinstance(self.stats.get(k), dict):
                self.stats[k] = {**self.stats[k], **v}
            else:
                self.stats[k] = v

    def add(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def render(self, verbose: bool = False) -> str:
        lines: list[str] = []
        for f in self.findings:
            lines.append("FINDING " + f.render())
        if verbose or not self.findings:
            for n in self.notes:
                lines.append("note: " + n)
        lines.append(
            f"{len(self.findings)} finding(s), {len(self.notes)} note(s)"
        )
        return "\n".join(lines)
