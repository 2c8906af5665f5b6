"""The replica pool: N worker processes over one shared file queue — a
copy of :mod:`qba_tpu.serve.fleet.pool` whose workers run the port.

Each replica is a separate OS process running the port's serve loop,
``python -m qba_tpu_torch serve --transport file-queue --replica-id rK``
(:func:`qba_tpu_torch.serve.transport.serve_file_queue` driving a
:class:`~qba_tpu_torch.serve.engine.QBAServer`), against the shared
queue directory.  The pool process itself never touches a device; the
multi-process machinery rides on protocols that already exist:

* **work distribution**: the inbox claim is an atomic rename, so N
  pollers never double-serve a request;
* **fault story**: a replica killed mid-request leaves a stale claim
  that a *surviving* replica reclaims (``--reclaim-timeout-s``), or the
  supervisor releases at once, so ``kill -9`` loses no request;
* **warm start**: every replica boots from the shared cache dir; the
  artifact lock (:mod:`qba_tpu_torch.serve.persist`) keeps concurrent
  save/load merges whole;
* **device placement**: :func:`make_device_env` pins replica K to the
  visible card at position ``K mod cards`` with
  ``CUDA_VISIBLE_DEVICES`` (the cards the pool's own process was given,
  else every card), so each worker opens its own context on one card;
  on a one-card host every worker shares it.  A CPU fleet
  (``device="cpu"``) pins nothing.

The pool writes ``replicas.json`` (pids + env) into the queue dir so
out-of-process chaos drivers can pick a victim.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any

from qba_tpu_torch.analysis.memory import visible_cards
from qba_tpu_torch.serve.queuefs import queue_paths, request_slug, write_json_atomic
from qba_tpu_torch.serve.timing import (
    MAX_RECLAIMS,
    MAX_RESPAWNS,
    RECLAIM_TIMEOUT_S,
    RESPAWN_BACKOFF_S,
    WORKER_POLL_S,
)


def make_device_env(index: int, device: str = "cuda",
                    cards: list[str] | None = None) -> dict[str, str]:
    """Per-replica environment overrides pinning worker ``index`` to one
    card: ``CUDA_VISIBLE_DEVICES`` is entry ``index`` modulo the visible
    cards (``cards``, default :func:`~qba_tpu_torch.analysis.memory.
    visible_cards`: the inherited variable's entries, else every card),
    so replicas spread over the cards they were given and share them
    round-robin past the last.  Where no card is visible nothing is
    pinned, and a CUDA worker fails at boot.  A CPU fleet
    (``device="cpu"``) pins nothing: each worker runs the plain versions
    in its own process, its intra-op pool capped at one thread so N
    replicas scale on an N-core host."""
    if device == "cpu":
        return {"OMP_NUM_THREADS": "1"}
    if cards is None:
        cards = visible_cards()
    return {"CUDA_VISIBLE_DEVICES": cards[index % len(cards)]} if cards else {}


@dataclasses.dataclass
class Replica:
    """One pool worker: its id, process handle, and pinned env."""

    replica_id: str
    proc: subprocess.Popen
    env: dict[str, str]
    returncode: int | None = None

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None


class ReplicaPool:
    """Spawn, watch, kill, and stop N serve workers on one queue dir."""

    def __init__(
        self,
        queue_dir: str,
        *,
        replicas: int = 2,
        chunk_trials: int = 64,
        depth: int = 2,
        cache_dir: str | None = None,
        telemetry_dir: str | None = None,
        deadline_s: float | None = None,
        reclaim_timeout_s: float | None = RECLAIM_TIMEOUT_S,
        max_reclaims: int = MAX_RECLAIMS,
        poll_s: float = WORKER_POLL_S,
        device: str = "cuda",
        python: str | None = None,
        max_respawns: int = MAX_RESPAWNS,
        respawn_backoff_s: float = RESPAWN_BACKOFF_S,
    ) -> None:
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.queue_dir = queue_dir
        self.n_replicas = replicas
        self.chunk_trials = chunk_trials
        self.depth = depth
        self.cache_dir = cache_dir
        self.telemetry_dir = telemetry_dir
        self.deadline_s = deadline_s
        self.reclaim_timeout_s = reclaim_timeout_s
        self.max_reclaims = max_reclaims
        self.poll_s = poll_s
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.device = device
        self.python = python or sys.executable
        self.max_respawns = max_respawns
        self.respawn_backoff_s = respawn_backoff_s
        self.replicas: list[Replica] = []
        self._cards: list[str] | None = None
        #: Respawn audit trail: ``{replica_id, at, respawns}`` per
        #: restart (wall-clock timestamp so post-mortems can correlate
        #: with request latencies and the crash ledger).
        self.restarted: list[dict[str, Any]] = []
        #: Slots withdrawn from service: the crash-loop breaker
        #: (supervisor) or the ``max_respawns`` cap benches a replica
        #: id here; :meth:`respawn_dead` never revives a benched slot.
        self.benched: set[str] = set()
        self._respawns: dict[str, int] = {}  # replica_id -> count
        self._next_respawn_at: dict[str, float] = {}  # monotonic gate

    def worker_argv(self, replica_id: str) -> list[str]:
        """The exact serve invocation a replica runs: the port's
        file-queue loop; the pool adds no dispatch path of its own."""
        argv = [
            self.python, "-m", "qba_tpu_torch", "serve",
            "--transport", "file-queue",
            "--queue-dir", self.queue_dir,
            "--replica-id", replica_id,
            "--chunk-trials", str(self.chunk_trials),
            "--depth", str(self.depth),
            "--poll-s", str(self.poll_s),
            "--max-reclaims", str(self.max_reclaims),
            "--device", self.device,
        ]
        if self.reclaim_timeout_s is not None:
            argv += ["--reclaim-timeout-s", str(self.reclaim_timeout_s)]
        if self.cache_dir is not None:
            argv += ["--cache-dir", self.cache_dir]
        if self.telemetry_dir is not None:
            argv += ["--telemetry", self.telemetry_dir]
        if self.deadline_s is not None:
            argv += ["--deadline-s", str(self.deadline_s)]
        return argv

    def _spawn(self, index: int) -> Replica:
        replica_id = f"r{index}"
        if self._cards is None and self.device == "cuda":
            self._cards = visible_cards()  # asked once, for every respawn
        overrides = make_device_env(index, self.device, self._cards)
        env = {**os.environ, **overrides}
        # Workers run `-m qba_tpu_torch` from whatever cwd the pool owner
        # has; make the package importable even when it isn't installed
        # and the cwd is not the repo root.
        import qba_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(qba_tpu_torch.__file__)))
        parts = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join([pkg_root] + [p for p in parts if p])
        proc = subprocess.Popen(self.worker_argv(replica_id), env=env)
        return Replica(replica_id=replica_id, proc=proc, env=overrides)

    def start(self) -> list[str]:
        """Boot every replica; returns their ids.  Boot order is not
        serialized — the plans.json artifact lock makes concurrent
        warm starts safe."""
        if self.replicas:
            raise RuntimeError("pool already started")
        os.makedirs(self.queue_dir, exist_ok=True)
        self.replicas = [self._spawn(i) for i in range(self.n_replicas)]
        self._write_state()
        return [r.replica_id for r in self.replicas]

    def _write_state(self) -> None:
        write_json_atomic(
            os.path.join(self.queue_dir, "replicas.json"),
            {
                "replicas": [
                    {
                        "replica_id": r.replica_id,
                        "pid": r.proc.pid,
                        "alive": r.alive,
                        "env": r.env,
                    }
                    for r in self.replicas
                ],
                "restarted": self.restarted,
                "benched": sorted(self.benched),
            },
        )

    def alive(self) -> list[str]:
        return [r.replica_id for r in self.replicas if r.alive]

    def kill(self, replica_id: str, sig: int = signal.SIGKILL) -> int:
        """Chaos hook: send ``sig`` (default ``kill -9``) to one
        replica; returns its pid.  The victim's in-flight claims are
        reclaimed by the survivors."""
        for r in self.replicas:
            if r.replica_id == replica_id and r.alive:
                r.proc.send_signal(sig)
                try:
                    r.proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    # A wedged zombie (e.g. stuck in an uninterruptible
                    # device ioctl) must not raise out of a chaos/
                    # supervisor kill — record what we know and move on.
                    pass
                r.returncode = r.proc.returncode
                self._write_state()
                return r.proc.pid
        raise ValueError(f"no live replica {replica_id!r}")

    def bench(self, replica_id: str) -> bool:
        """Withdraw one slot from service permanently (crash-loop
        breaker): its dead process is never respawned again.  Returns
        True if the slot was newly benched."""
        if replica_id in self.benched:
            return False
        self.benched.add(replica_id)
        self._write_state()
        return True

    def respawn_dead(self) -> list[str]:
        """Replace dead replicas with fresh processes under the same
        id/env slot (the supervision loop for long-lived fleets; chaos
        tests leave this off to prove reclaim alone suffices).

        Guard rails against a bad device becoming a hot respawn loop:
        the k-th respawn of a slot waits ``respawn_backoff_s * 2**(k-1)``
        after the previous one (exponential backoff), and a slot that
        has burned ``max_respawns`` respawns is benched for good.
        Returns the ids actually respawned this call."""
        respawned = []
        now = time.monotonic()
        for i, r in enumerate(self.replicas):
            rid = r.replica_id
            if r.alive or rid in respawned or rid in self.benched:
                continue
            k = self._respawns.get(rid, 0)
            if k >= self.max_respawns:
                self.bench(rid)
                continue
            if now < self._next_respawn_at.get(rid, 0.0):
                continue  # still inside the backoff window
            self.replicas[i] = self._spawn(i)
            self._respawns[rid] = k + 1
            self._next_respawn_at[rid] = (
                now + self.respawn_backoff_s * (2 ** k)
            )
            self.restarted.append(
                {"replica_id": rid, "at": time.time(), "respawns": k + 1}
            )
            respawned.append(rid)
        if respawned:
            self._write_state()
        return respawned

    def stop(self, timeout_s: float = 300.0) -> dict[str, int | None]:
        """Drop the stop sentinel and wait for every live replica to
        drain and exit; returns ``{replica_id: returncode}``."""
        paths = queue_paths(self.queue_dir)
        with open(paths["stop"], "w"):
            pass
        deadline = time.monotonic() + timeout_s
        codes: dict[str, int | None] = {}
        for r in self.replicas:
            budget = max(0.1, deadline - time.monotonic())
            try:
                r.proc.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                r.proc.kill()
                try:
                    r.proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass  # zombie outlived SIGKILL; don't leak the rest
            codes[r.replica_id] = r.proc.returncode
        self._write_state()
        return codes

    def summaries(self) -> dict[str, dict[str, Any]]:
        """Per-replica exit summaries (``summary-<id>.json`` written by
        each worker's serve loop)."""
        out: dict[str, dict[str, Any]] = {}
        for r in self.replicas:
            path = os.path.join(
                self.queue_dir,
                f"summary-{request_slug(r.replica_id)}.json",
            )
            try:
                with open(path) as f:
                    out[r.replica_id] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
        return out
