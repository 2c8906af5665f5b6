"""Leveled, structured event log — a copy of :mod:`qba_tpu.obs.events`
(the port imports nothing of :mod:`qba_tpu`).

The reference logs by unconditional stdout prints (``tfg.py:10-12``); its
only verbosity control is commenting calls out (SURVEY §5).  Here events
are structured records with a level; sinks decide rendering (stdout for
interactive runs, JSONL for machine consumption).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sys
import time
from typing import Any, Callable, TextIO


class Level(enum.IntEnum):
    DEBUG = 10
    INFO = 20
    WARNING = 30
    ERROR = 40


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured protocol event.

    ``phase`` names the protocol phase (dishonesty / particles / step2 /
    round / decision — the reference's step comments, ``tfg.py:101-363``);
    ``fields`` carries the event payload.
    """

    ts: float
    level: Level
    phase: str
    message: str
    fields: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "ts": round(self.ts, 6),
                "level": self.level.name,
                "phase": self.phase,
                "message": self.message,
                **self.fields,
            },
            default=str,
        )

    def render(self) -> str:
        extra = (
            " " + " ".join(f"{k}={v}" for k, v in self.fields.items())
            if self.fields
            else ""
        )
        return f"[{self.phase}] {self.message}{extra}"


class EventLog:
    """Append-only event collector with a minimum level and optional
    live stream (the ``mpi_print`` role, but leveled and structured)."""

    def __init__(
        self,
        min_level: Level = Level.INFO,
        stream: TextIO | None = None,
        clock: Callable[[], float] = time.monotonic,
        stream_level: Level | None = None,
    ) -> None:
        self.min_level = min_level
        self.stream = stream
        # Collection and live streaming can have different thresholds:
        # ``--jsonl`` without ``-v`` collects the DEBUG trail for export
        # without flooding stdout.
        self.stream_level = min_level if stream_level is None else stream_level
        self.events: list[Event] = []
        self._clock = clock

    def emit(
        self, level: Level, phase: str, message: str, **fields: Any
    ) -> None:
        if level < self.min_level:
            return
        ev = Event(self._clock(), level, phase, message, fields)
        self.events.append(ev)
        if self.stream is not None and level >= self.stream_level:
            # print + flush, as the reference's mpi_print does (tfg.py:10-12)
            print(ev.render(), file=self.stream, flush=True)

    def debug(self, phase: str, message: str, **fields: Any) -> None:
        self.emit(Level.DEBUG, phase, message, **fields)

    def info(self, phase: str, message: str, **fields: Any) -> None:
        self.emit(Level.INFO, phase, message, **fields)

    def warning(self, phase: str, message: str, **fields: Any) -> None:
        self.emit(Level.WARNING, phase, message, **fields)

    def error(self, phase: str, message: str, **fields: Any) -> None:
        self.emit(Level.ERROR, phase, message, **fields)

    def to_jsonl(self) -> str:
        return "\n".join(ev.to_json() for ev in self.events)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl() + ("\n" if self.events else ""))


def stdout_log(min_level: Level = Level.INFO) -> EventLog:
    """An EventLog that also prints live to stdout."""
    return EventLog(min_level=min_level, stream=sys.stdout)
