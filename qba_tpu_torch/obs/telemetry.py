"""Hierarchical run telemetry: nested spans with device-time attribution —
the ``Span``/``SpanRecorder`` part of :mod:`qba_tpu.obs.telemetry`,
copied.

* A span is a named wall-clock interval with a parent (spans nest via a
  context-manager stack), free-form key/value args, and a ``fenced``
  flag.
* ``fenced`` says whether the interval is device time: CUDA launches
  return before the card finishes, so a span's duration is the card's
  only if the span waited for it (a readback, or
  :meth:`SpanRecorder.fence`) before closing.
* Exports: JSONL (one span per line) and Chrome trace-event JSON
  (``ph: "X"`` complete events) loadable in Perfetto or
  ``chrome://tracing``.

No module-level torch import: recording spans stays usable from code
that never touches a device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterator


def _jsonable(v: Any) -> Any:
    """Span args are free-form; exports must never crash on a numpy
    scalar or a config object — degrade to ``str`` past the JSON types."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:  # numpy / torch scalars
        return v.item()
    except (AttributeError, ValueError, TypeError):
        return str(v)


@dataclasses.dataclass
class Span:
    """One named interval.  ``t0``/``dur`` are in the recorder's clock
    units (seconds); ``dur`` is None while the span is still open."""

    name: str
    index: int  # position in the recorder's span list
    parent: int | None  # index of the enclosing span, None at top level
    depth: int  # nesting depth (0 = top level)
    t0: float
    dur: float | None = None
    cat: str = "host"
    fenced: bool = False  # closed after a host readback => device time
    args: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "index": self.index,
            "parent": self.parent,
            "depth": self.depth,
            "t0_s": self.t0,
            "dur_s": self.dur,
            "cat": self.cat,
            "fenced": self.fenced,
            "args": {k: _jsonable(v) for k, v in self.args.items()},
        }


class SpanRecorder:
    """Appending span collector with a nesting stack.

    ``with rec.span("trials", cat="device") as sp: ...`` opens a child
    of the innermost open span; closing it (normally or via exception)
    stamps the duration.  Thread-unsafe by design — one recorder per
    run, like the EventLog.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter) -> None:
        self._clock = clock
        self.spans: list[Span] = []
        self._stack: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args: Any) -> Iterator[Span]:
        sp = Span(
            name=name,
            index=len(self.spans),
            parent=self._stack[-1] if self._stack else None,
            depth=len(self._stack),
            t0=self._clock(),
            cat=cat,
            args=dict(args),
        )
        self.spans.append(sp)
        self._stack.append(sp.index)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.dur = self._clock() - sp.t0

    def fence(self, res: Any, span: Span | None = None) -> Any:
        """Wait for the CUDA work queued so far (``torch.cuda.synchronize``,
        a no-op without a card) and mark the innermost open span (or
        ``span``) as device-fenced: without the wait the span measures
        only the enqueue."""
        from qba_tpu_torch.backends.torch_backend import fence as _fence

        _fence(res)
        target = span if span is not None else (
            self.spans[self._stack[-1]] if self._stack else None
        )
        if target is not None:
            target.fenced = True
        return res

    # ---- aggregation -------------------------------------------------
    def totals(self) -> dict[str, dict[str, float]]:
        """Per-name aggregate over CLOSED spans — the PhaseTimers view."""
        agg: dict[str, dict[str, float]] = {}
        for sp in self.spans:
            if sp.dur is None:
                continue
            d = agg.setdefault(sp.name, {"total_s": 0.0, "count": 0})
            d["total_s"] += sp.dur
            d["count"] += 1
        return agg

    # ---- exports -----------------------------------------------------
    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(sp.to_dict()) for sp in self.spans)

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            content = self.to_jsonl()
            f.write(content + ("\n" if content else ""))
        return path

    def chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON: one complete (``ph: "X"``) event per
        span, microsecond timestamps, all on one pid/tid so Perfetto
        nests them by time containment (the recorder's stack discipline
        guarantees proper containment).  A still-open span is exported
        with its duration up to now — a crash mid-run still yields a
        loadable trace."""
        pid = os.getpid()
        now = self._clock()
        events: list[dict[str, Any]] = [
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": "qba_tpu_torch"},
            }
        ]
        for sp in self.spans:
            dur = sp.dur if sp.dur is not None else now - sp.t0
            args = {k: _jsonable(v) for k, v in sp.args.items()}
            args["fenced"] = sp.fenced
            events.append(
                {
                    "name": sp.name,
                    "cat": sp.cat + (",fenced" if sp.fenced else ""),
                    "ph": "X",
                    "ts": round(sp.t0 * 1e6, 3),
                    "dur": round(dur * 1e6, 3),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path
