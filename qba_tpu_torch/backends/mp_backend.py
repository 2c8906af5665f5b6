"""Multi-process message-level backend (``backend="mp"``) — counterpart of
:mod:`qba_tpu.backends.mp_backend`.

The reference's only runtime is one OS process per party exchanging
tagged MPI messages (``mpiexec -n <nParties+1> python tfg.py``,
``tfg.py:310-314``).  This backend reproduces that shape: the
coordinator (this process, the QSD/rank-0 role, ``tfg.py:103-104,
351-363``) presamples a batch's randomness with the key tree every other
backend consumes (:func:`~qba_tpu_torch.backends.local_backend.
presample_batch`, on the keys' device), then starts one OS process per
protocol party (:mod:`qba_tpu_torch.backends.mp_party`, torch-free).
The parties assemble a full point-to-point Unix-socket mesh and run the
protocol for real: every packet crosses a process boundary through the
C++ PvL wire codec, rounds synchronize by message completion, and each
lieutenant decides locally before reporting back; the coordinator then
prints the verdict as rank 0 does in the reference.

:func:`run_trials_mp` starts the mesh once a batch and streams the
batch's trials over it.  Decisions, accepted sets and overflow equal the
other backends' for the same trial key, and the event trail
(reassembled from the parties' event streams by a deterministic sort)
equals the local backend's event for event.

Party processes start from a ``forkserver`` preloaded with the
torch-free party module (:func:`_party_context`): the coordinator holds
a CUDA context by then, and a plain ``fork`` would hand every party its
open ``/dev/nvidia*`` files and torch's at-fork state.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mp_conn
import tempfile
import threading
import time
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from qba_tpu_torch.backends.local_backend import (
    Presample,
    emit_host_phases,
    emit_verdict,
    presample_batch,
)
from qba_tpu_torch.config import QBAConfig

if TYPE_CHECKING:  # pragma: no cover - typing only
    from qba_tpu_torch.obs import EventLog

PARTY_MODULE = "qba_tpu_torch.backends.mp_party"


def _native_so_path() -> str:
    """Build (if needed) and return the native library's path, in the
    coordinator, so party processes never compile."""
    from qba_tpu_torch import native

    native.load()
    return str(native.library_path())


def _party_context():
    """The multiprocessing context party processes start from: a
    ``forkserver`` (one fresh interpreter, started once a coordinator
    process, holding none of the coordinator's files) preloaded with the
    torch-free party module, so a party is a fork of a process that never
    imported torch nor opened a CUDA device."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([PARTY_MODULE])
    return ctx


def _recv_deadline(conn, remaining: float):
    """``conn.recv()`` with a hard deadline.  ``Connection.recv`` has no
    timeout and ``poll`` only reports readability — a party wedged
    mid-send (partial multi-chunk payload written, then stuck) would
    make a bare ``recv`` block forever.  The recv runs in a daemon
    thread; on timeout the thread is abandoned (it dies with the
    process) and the caller raises."""
    out: dict = {}

    def _r():
        try:
            out["value"] = conn.recv()
        except BaseException as e:  # pragma: no cover - re-raised below
            out["error"] = e

    t = threading.Thread(target=_r, daemon=True)
    t.start()
    t.join(max(0.0, remaining))
    if t.is_alive():
        # Grace join before declaring a wedge: the caller may reach
        # here with remaining <= 0 for a pipe wait() just reported
        # readable (budget consumed by a sibling recv in the same
        # batch) — that recv completes in microseconds, and poisoning
        # it would cost the healthy child its graceful stop.
        t.join(0.1)
    if t.is_alive():
        # The abandoned thread is still blocked in conn.recv(); closing
        # the fd from another thread while it reads can raise unraisable
        # errors or, worse, hand a reused fd number to the blocked read.
        # Poison the connection so cleanup leaks it instead of closing
        # (the fd dies with the process; the daemon thread with it).
        conn._qba_poisoned = True
        raise RuntimeError("party wedged mid-report (recv deadline)")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _send_with_deadline(pipes, messages, timeout: float) -> None:
    """Send one message per rank without ever blocking indefinitely:
    ``Connection.send`` blocks when the pipe buffer is full (a child
    wedged before its recv loop + a large work payload), which would
    hang the coordinator before the collection deadline ever runs.  All
    sends run on one daemon thread with a hard join deadline."""
    box: dict = {}

    def _s():
        rank = None
        try:
            for rank, msg in messages:
                if box.get("cancel"):  # timeout fired: stop cleanly so
                    return  # a later unblock can't race cleanup sends
                box["inflight"] = rank
                pipes[rank].send(msg)
            box.pop("inflight", None)
        except BaseException as e:  # pragma: no cover - re-raised below
            box["error"], box["rank"] = e, rank

    t = threading.Thread(target=_s, daemon=True)
    t.start()
    t.join(max(0.0, timeout))
    if t.is_alive():
        # Same hazard as _recv_deadline, send side: the abandoned
        # thread is still blocked in conn.send() on the in-flight rank.
        # Poison that connection so cleanup neither writes a second
        # interleaved frame on it nor closes the fd under the blocked
        # write (leak it; it dies with the process).  The cancel flag
        # keeps the abandoned thread from ever touching the ranks it
        # had not reached if the wedged send later unblocks — those
        # connections stay clean for the graceful stop path.
        box["cancel"] = True
        inflight = box.get("inflight")
        if inflight is not None:
            pipes[inflight]._qba_poisoned = True
        raise RuntimeError(
            f"mp work dispatch timed out after {timeout:.0f}s "
            "(party wedged before draining its work pipe?)"
        )
    if "error" in box:
        if isinstance(box["error"], (BrokenPipeError, OSError)):
            # A closed work pipe means the party process is gone —
            # surface the same diagnostic shape as the collection path.
            raise RuntimeError(
                f"mp party rank {box['rank']} closed its work pipe "
                f"without reporting (died during startup?)"
            ) from box["error"]
        raise box["error"]


def _collect_results(procs, pipes, timeout: float,
                     expect: str = "ok") -> dict:
    """Drain every party's report pipe without ever blocking
    indefinitely: waits on the pipes AND the process sentinels with a
    shared deadline, so a party that dies without writing its pipe (hard
    kill, native-codec crash) — or wedges mid-send — raises instead of
    hanging the trial.  Each report must carry the status ``expect``."""
    deadline = time.monotonic() + timeout
    pending = set(pipes)  # ranks still owing a report
    results = {}
    while pending:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise RuntimeError(
                f"mp trial timed out after {timeout:.0f}s; ranks still "
                f"pending: {sorted(pending)}"
            )
        conns = {pipes[r]: r for r in pending}
        sentinels = {procs[r - 1].sentinel: r for r in pending}
        ready = mp_conn.wait(
            list(conns) + list(sentinels), timeout=remaining
        )
        for obj in ready:
            rank = conns.get(obj)
            if rank is None:  # a sentinel: the party process exited
                rank = sentinels[obj]
                if rank not in pending:
                    continue  # its report arrived in this same batch
                # Exit is fine iff the report was already written.
                if not pipes[rank].poll(0.1):
                    procs[rank - 1].join(timeout=1)  # reap -> exitcode
                    raise RuntimeError(
                        f"mp party rank {rank} exited (code "
                        f"{procs[rank - 1].exitcode}) without reporting"
                    )
            if rank not in pending:
                continue
            try:
                status, payload = _recv_deadline(
                    pipes[rank], deadline - time.monotonic()
                )
            except EOFError:
                procs[rank - 1].join(timeout=1)  # reap -> exitcode
                raise RuntimeError(
                    f"mp party rank {rank} closed its pipe without "
                    f"reporting (exit code {procs[rank - 1].exitcode})"
                ) from None
            if status != expect:
                raise RuntimeError(f"mp party rank {rank} failed: {payload}")
            results[rank] = payload
            pending.discard(rank)
    return results


def run_trial_mp(
    cfg: QBAConfig,
    key: torch.Tensor,
    log: "EventLog | None" = None,
    trial: int = 0,
    timeout: float = 300.0,
) -> dict:
    """One protocol execution across real OS processes for trial key
    ``[2]``; returns the rank-0 summary dict (the shape of
    ``run_trial_local``): a one-trial :func:`run_trials_mp` batch."""
    return run_trials_mp(cfg, key[None], log=log, first_trial=trial,
                         timeout=timeout)[0]


def run_trials_mp(
    cfg: QBAConfig,
    keys: torch.Tensor,
    log: "EventLog | None" = None,
    first_trial: int = 0,
    timeout: float = 300.0,
    log_limit: int | None = None,
    pre: Presample | None = None,
    stats: dict | None = None,
    on_mesh: Callable[[list[int]], None] | None = None,
    *,
    partitionable: bool | None = None,
) -> list[dict]:
    """A batch of protocol executions (trial keys ``[T, 2]``, or the
    presample ``pre`` of them) over ONE party mesh.

    The coordinator presamples the batch once, starts ``n_parties``
    processes once, streams each trial's share of the presample over the
    per-party work pipes, and the parties run every trial over the same
    Unix-socket mesh (trials are complete BSP exchanges, so the streams
    stay aligned).  ``log_limit`` bounds the trail to the first trials.

    ``timeout`` bounds the mesh's start and each trial's collection: a
    party that dies without reporting (or a wedged mesh) raises a
    ``RuntimeError`` instead of blocking forever (:func:`_collect_results`).
    ``on_mesh``, when given, is called with the parties' pids once every
    party reports its mesh up; ``stats``, when a dict, receives
    ``mesh_start_s`` (process start to every party up) and the parties'
    ``exitcodes`` after the batch.  ``partitionable``: JAX's threefry
    mode of the presample (None: the current mode)."""
    if pre is None:
        pre = presample_batch(cfg, keys, partitionable=partitionable)
    so_path = _native_so_path()
    ctx = _party_context()
    static = dict(
        n_parties=cfg.n_parties,
        size_l=cfg.size_l,
        n_dishonest=cfg.n_dishonest,
        w=cfg.w,
        slots=cfg.slots,
        n_rounds=cfg.n_rounds,
        max_l=cfg.max_l,
        racy_defer=cfg.racy_mode == "defer",
    )

    from qba_tpu_torch.backends import mp_party

    summaries: list[dict] = []
    with tempfile.TemporaryDirectory(prefix="qba_mp_") as sock_dir:
        procs, pipes = [], {}
        try:
            t0 = time.perf_counter()
            for rank in range(1, cfg.n_parties + 1):
                parent_conn, child_conn = ctx.Pipe(duplex=True)
                target = (mp_party.commander_main if rank == 1
                          else mp_party.lieutenant_main)
                p = ctx.Process(
                    target=target,
                    args=(rank, sock_dir, so_path, child_conn, dict(static)),
                    daemon=True,
                )
                p.start()
                child_conn.close()
                procs.append(p)
                pipes[rank] = parent_conn
            pids = _collect_results(procs, pipes, timeout, expect="ready")
            if stats is not None:
                stats["mesh_start_s"] = time.perf_counter() - t0
            if on_mesh is not None:
                on_mesh([pids[r] for r in sorted(pids)])

            for i in range(len(pre)):
                trail = log if log_limit is None or i < log_limit else None
                summaries.append(_dispatch_trial(
                    cfg, pre, i, procs, pipes, trail, first_trial + i,
                    timeout))
        finally:
            # Shutdown runs in the finally: after a failed trial the
            # HEALTHY parties still sit in conn.recv() awaiting more
            # work — without the stop they would burn the whole join
            # budget and end in SIGTERM.  The stop sends are
            # deadline-bounded (tiny messages, but a wedged child's
            # full buffer must not hang the cleanup), and closing the
            # parent pipe ends afterwards EOFs any child that missed
            # its stop (the party mains treat EOF as stop).
            try:
                _send_with_deadline(
                    pipes,
                    [
                        (r, ("stop",))
                        for r in pipes
                        if not getattr(pipes[r], "_qba_poisoned", False)
                    ],
                    5.0,
                )
            except Exception:  # pragma: no cover - cleanup best-effort
                pass
            for conn in pipes.values():
                if getattr(conn, "_qba_poisoned", False):
                    # A recv-deadline thread may still be blocked in
                    # conn.recv(); leak the fd (see _recv_deadline).
                    continue
                try:
                    conn.close()
                except OSError:  # pragma: no cover
                    pass
            # Bounded cleanup: 30 s TOTAL for graceful exits (not per
            # process — a wedged 33-party mesh must not stack another
            # n_parties * 30 s of joins on top of the collection
            # timeout), then terminate whatever is left.
            stop = time.monotonic() + 30
            for p in procs:
                p.join(timeout=max(0.0, stop - time.monotonic()))
            for p in procs:
                if p.is_alive():  # pragma: no cover - hang safety
                    p.terminate()
                    p.join(timeout=5)
            if stats is not None:
                stats["exitcodes"] = [p.exitcode for p in procs]
    return summaries


def party_draws(pre: Presample, i: int, rank: int) -> np.ndarray:
    """Lieutenant ``rank``'s draws of trial ``i``, as its party reads them:
    its receiver column of every round's tables, uint8 ``[n_rounds,
    n_cells, 3]`` holding ``(attack, rand_v, late)``."""
    return np.stack([x[i, :, :, rank - 2] for x in (
        pre.attack, pre.rand_v, pre.late)], axis=-1)


def _dispatch_trial(cfg, pre, i, procs, pipes, log, trial, timeout) -> dict:
    """Stream trial ``i``'s share of the presample over the pipes, collect
    and assemble the rank-0 summary."""
    honest, lists, v_sent, v_comm = pre.trial(i)
    works = []
    for rank in range(1, cfg.n_parties + 1):
        if rank == 1:
            work = dict(
                list0=[int(x) for x in lists[0]],
                list1=[int(x) for x in lists[1]],
                v_sent=v_sent,
            )
        else:
            work = dict(
                honest=tuple(bool(h) for h in honest),
                list=[int(x) for x in lists[rank]],
                attacks=party_draws(pre, i, rank),
            )
        works.append((rank, ("trial", work)))
    _send_with_deadline(pipes, works, timeout)

    results = _collect_results(procs, pipes, timeout)

    decisions = [v_comm] + [
        results[r]["decision"] for r in range(2, cfg.n_parties + 1)
    ]
    vi = [set(results[r]["vi"]) for r in range(2, cfg.n_parties + 1)]
    overflow = any(
        results[r]["overflow"] for r in range(2, cfg.n_parties + 1)
    )
    honest_parties = [bool(h) for h in honest[1:]]
    filtered = {d for d, h in zip(decisions, honest_parties) if h}
    success = len(filtered) == 1

    if log is not None:
        _emit_trail(
            cfg, log, trial, honest, lists, v_comm, v_sent, results,
            decisions, honest_parties, success,
        )

    return {
        "success": success,
        "decisions": decisions,
        "honest": honest_parties,
        "v_comm": v_comm,
        "vi": vi,
        "overflow": overflow,
    }


def _emit_trail(cfg, log, trial, honest, lists, v_comm, v_sent, results,
                decisions, honest_parties, success) -> None:
    """Reassemble the per-party event streams into the local backend's
    exact event order: host-side phases, then the (round, stage,
    receiver, sequence)-sorted protocol events, then the verdict.  The
    sort is deterministic because each party's per-(round, stage) order
    is — concurrency cannot reorder the rendered trail."""
    emit_host_phases(cfg, log, trial, honest, lists, v_comm, v_sent)
    merged = []
    for payload in results.values():
        merged.extend(payload["events"])
    merged.sort(key=lambda e: e[0])
    for _key, phase, message, fields in merged:
        log.debug(phase, message, trial=trial, **fields)
    emit_verdict(log, trial, decisions, honest_parties, success)
