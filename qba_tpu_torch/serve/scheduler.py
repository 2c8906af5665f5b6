"""Shape-bucketing scheduler: requests -> trial-packed device chunks —
a copy of :mod:`qba_tpu.serve.scheduler`.

Every incoming request is normalized onto a bucket config (seed zeroed,
trials pinned to the server's chunk size) and its trials are packed,
together with other same-bucket requests, into fixed-size chunks.  One
bucket is one kernel plan (engine, list generation) and one shape the
kernels see, regardless of how many distinct (seed, trials) requests
flow through it.

Determinism contract: chunk assembly is a pure function of the enqueue
order — trials are assigned oldest-request first within the
oldest-ready bucket, and the tail of a partial chunk is padded with zero
key rows (computed, then discarded at readback).  No clocks, no hashing
order, no torch: this module is plain numpy on the host, so the policy
is unit-testable without a device.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Deque

import numpy as np

from qba_tpu_torch.config import QBAConfig


def bucket_config(cfg: QBAConfig, chunk_trials: int) -> QBAConfig:
    """The bucket key for ``cfg``: same shape and engine knobs, seed
    zeroed and trials pinned to the chunk size.  Seed and trial count
    only affect *which keys* the host feeds in, so every config in a
    bucket runs the same kernels on the same shapes."""
    return dataclasses.replace(cfg, seed=0, trials=chunk_trials)


def bucket_label(bucket: QBAConfig) -> str:
    """Human-readable bucket id used in spans/results, e.g.
    ``5p-L8-d1-auto`` (non-reference strategies get a suffix: the
    strategy is already part of the bucket *identity* via the config
    object, so the label shows it)."""
    label = (
        f"{bucket.n_parties}p-L{bucket.size_l}-d{bucket.n_dishonest}"
        f"-{bucket.round_engine}"
    )
    if bucket.strategy != "reference":
        label += f"-{bucket.strategy}"
    return label


@dataclasses.dataclass(frozen=True)
class Segment:
    """One request's contiguous slice of a chunk: trials
    ``[req_start, req_start+length)`` of ``request_id`` sit at chunk
    rows ``[chunk_start, chunk_start+length)``."""

    request_id: str
    req_start: int
    chunk_start: int
    length: int


@dataclasses.dataclass
class Chunk:
    """One device dispatch: ``key_data`` is the full ``[chunk_trials, 2]``
    uint32 key material (tail rows past ``used`` are padding)."""

    index: int
    bucket: QBAConfig
    key_data: np.ndarray
    segments: list[Segment]

    @property
    def used(self) -> int:
        return sum(s.length for s in self.segments)


@dataclasses.dataclass
class _Queued:
    request_id: str
    key_data: np.ndarray  # [trials, 2] uint32 (the keys' two words)
    order: int  # global arrival index — the determinism anchor
    cursor: int = 0  # trials already assigned to chunks

    @property
    def remaining(self) -> int:
        return len(self.key_data) - self.cursor


class BucketScheduler:
    """FIFO-fair bucketing: :meth:`next_chunk` always serves the bucket
    whose head request arrived earliest, and fills the chunk from that
    bucket's queue in arrival order (a request larger than a chunk
    spans several; a small one shares its chunk with successors)."""

    def __init__(self, chunk_trials: int = 64) -> None:
        if chunk_trials < 1:
            raise ValueError(f"chunk_trials must be >= 1, got {chunk_trials}")
        self.chunk_trials = chunk_trials
        self._queues: OrderedDict[QBAConfig, Deque[_Queued]] = OrderedDict()
        self._arrivals = 0
        self._chunks = 0

    def bucket_for(self, cfg: QBAConfig) -> QBAConfig:
        return bucket_config(cfg, self.chunk_trials)

    def enqueue(
        self, request_id: str, cfg: QBAConfig, key_data: np.ndarray
    ) -> QBAConfig:
        """Queue ``cfg.trials`` trials (``key_data`` rows) under the
        request's bucket; returns the bucket config."""
        # The key table arrives as host numpy and stays on the host
        # until its chunk is dispatched.
        # qba-lint: sync-ok (host data: the key table arrives from the host)
        key_data = np.asarray(key_data, dtype=np.uint32)
        if key_data.shape != (cfg.trials, 2):
            raise ValueError(
                f"key_data shape {key_data.shape} != ({cfg.trials}, 2)"
            )
        bucket = self.bucket_for(cfg)
        self._queues.setdefault(bucket, deque()).append(
            _Queued(request_id, key_data, self._arrivals)
        )
        self._arrivals += 1
        return bucket

    def pending_trials(self) -> int:
        return sum(q.remaining for dq in self._queues.values() for q in dq)

    def cancel(self, request_id: str) -> int:
        """Drop every still-queued trial of ``request_id`` (deadline
        expiry); returns how many trials were removed.  Trials already
        assembled into chunks are untouched — their readback segments
        are discarded by the server when the request is no longer
        active."""
        removed = 0
        for dq in self._queues.values():
            keep = deque()
            while dq:
                q = dq.popleft()
                if q.request_id == request_id:
                    removed += q.remaining
                else:
                    keep.append(q)
            dq.extend(keep)
        return removed

    def has_full_chunk(self) -> bool:
        return any(
            sum(q.remaining for q in dq) >= self.chunk_trials
            for dq in self._queues.values()
        )

    def next_chunk(self) -> Chunk | None:
        """Assemble the next chunk (padded if the bucket can't fill it),
        or None when nothing is pending."""
        best: QBAConfig | None = None
        best_order: int | None = None
        for bucket, dq in self._queues.items():
            if not dq:
                continue
            if best_order is None or dq[0].order < best_order:
                best, best_order = bucket, dq[0].order
        if best is None:
            return None
        dq = self._queues[best]
        key_data = np.zeros((self.chunk_trials, 2), dtype=np.uint32)
        segments: list[Segment] = []
        filled = 0
        while dq and filled < self.chunk_trials:
            head = dq[0]
            take = min(head.remaining, self.chunk_trials - filled)
            key_data[filled : filled + take] = head.key_data[
                head.cursor : head.cursor + take
            ]
            segments.append(
                Segment(head.request_id, head.cursor, filled, take)
            )
            head.cursor += take
            filled += take
            if head.remaining == 0:
                dq.popleft()
        chunk = Chunk(self._chunks, best, key_data, segments)
        self._chunks += 1
        return chunk
