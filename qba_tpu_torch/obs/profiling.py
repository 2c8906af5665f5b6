"""Optional profiler hook — counterpart of :mod:`qba_tpu.obs.profiling` on
``torch.profiler``.

``profile_trace(dir)`` wraps a block in ``torch.profiler.profile`` over
the CPU and, where this torch build can trace it, CUDA, and exports the
block's Chrome trace into ``dir`` (``trace-<pid>.json``) when the block
ends; with ``None`` it does nothing, so runners thread a
``--profile-dir`` flag through unconditionally.  :func:`trace_summary`
reads such a trace back: the device's busy time, its kernels by time and
the idle share of the profiled window.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator

# Chrome-trace categories of device work (CUPTI records from Kineto).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(log_dir: str) -> str:
    """The trace :func:`profile_trace` writes into ``log_dir``."""
    return os.path.join(log_dir, f"trace-{os.getpid()}.json")


@contextlib.contextmanager
def profile_trace(log_dir: str | None) -> Iterator[None]:
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(trace_path(log_dir))


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def trace_summary(path: str, top: int = 5) -> dict:
    """A Chrome trace's device account: ``window_ms`` (its first event's
    start to its last event's end), ``device_busy_ms`` (the union of the
    device's kernel, copy and set records), ``idle_share`` (1 - busy /
    window), ``kernels`` (device records counted) and ``top_kernels``
    (``[name, total ms, count]``, largest first)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans, device, per = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        spans.append((a, a + d))
        if e.get("cat") in DEVICE_CATS:
            device.append((a, a + d))
            ms, n = per.get(e["name"], (0.0, 0))
            per[e["name"]] = (ms + d / 1e3, n + 1)
    window = (max(b for _a, b in spans) - min(a for a, _b in spans)
              if spans else 0.0)
    busy = _union_us(device)
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window else None,
        "kernels": len(device),
        "top_kernels": [[name, ms, n] for name, (ms, n) in ranked],
    }
