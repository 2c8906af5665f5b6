"""Per-party process logic for the multi-process backend — the port's
copy of :mod:`qba_tpu.backends.mp_party`.

This module is imported by the party processes (one per protocol party,
forked from a server that preloads it) and must stay **torch-free**:
torch would cost every party its import, and a party must never touch the
coordinator's CUDA context — the reference's per-rank processes run plain
host code over MPI (``tfg.py:310-314``).  It imports only the standard
library and numpy.

Transport: every party listens on a Unix-domain socket under a run-
private directory and dials its lower-ranked peers (rank sent as a
4-byte hello), building the same full point-to-point mesh ``mpiexec``
gives the reference.  Every packet crosses a real process boundary
through the C++ PvL wire codec (the port's ``native/src/qba_native.cc``,
``qba_encode_pvl`` /
``qba_decode_pvl`` — the ``send_pvl``/``recv_pvl`` format of
``tfg.py:199-263``), length-framed; the wire format is load-bearing, not
decorative.

Synchronization is message-driven BSP, like the reference's
barrier-separated rounds (``tfg.py:335,348``) but race-free by
construction: each lieutenant sends exactly one batch per peer per
round and blocks reading exactly one batch per peer per round, so a
round cannot start before the previous one's traffic is drained.  Sends
run on a helper thread so the all-send-then-all-receive pattern cannot
deadlock on full socket buffers.

Protocol semantics mirror the message-level local backend exactly
(``lieu_receive``, ``tfg.py:289-300``; delivery-time corruption from the
presampled per-cell draws; ``racy_mode`` loss/defer) — the differential
tests pin decision- and trail-equality across the port's backends.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import threading
import time

import numpy as np

_i32p = ctypes.POINTER(ctypes.c_int32)

# Attack-edit bits (qba_tpu_torch.adversary; redeclared to stay torch-free;
# tests/test_torch_backends.py asserts the table matches EFFECT_NAMES).
_DROP, _FORGE, _CLEAR_P, _CLEAR_L, _FORGE_P = 1, 2, 4, 8, 16
_EFFECTS = ((_DROP, "drop"), (_FORGE, "corrupt-v"),
            (_CLEAR_P, "clear-P"), (_CLEAR_L, "clear-L"),
            (_FORGE_P, "forge-P"))


def _effect_names(bits: int) -> str:
    names = [n for b, n in _EFFECTS if bits & b]
    return "+".join(names) if names else "none"


class _Codec:
    """ctypes bindings to the already-built native library (the parent
    guarantees the .so exists; children never run the build)."""

    def __init__(self, so_path: str, size_l: int, max_l: int):
        lib = ctypes.CDLL(so_path)
        lib.qba_encode_pvl.restype = ctypes.c_int
        lib.qba_encode_pvl.argtypes = [
            _i32p, ctypes.c_int, ctypes.c_int32, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, _i32p, ctypes.c_int,
        ]
        lib.qba_decode_pvl.restype = ctypes.c_int
        lib.qba_decode_pvl.argtypes = [
            _i32p, ctypes.c_int, _i32p, ctypes.c_int, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, _i32p,
        ]
        self.lib = lib
        self.size_l = size_l
        self.nt_cap = max_l + 1
        self.cap = 3 + size_l + self.nt_cap * (1 + size_l)

    def encode(self, p: set, v: int, L: set) -> bytes:
        p_a = np.asarray(sorted(p), dtype=np.int32)
        tuples = np.zeros((self.nt_cap, self.size_l), dtype=np.int32)
        lens = np.zeros((self.nt_cap,), dtype=np.int32)
        for t_i, t in enumerate(L):
            lens[t_i] = len(t)
            tuples[t_i, : len(t)] = t
        out = np.zeros((self.cap,), dtype=np.int32)
        n = self.lib.qba_encode_pvl(
            p_a.ctypes.data_as(_i32p), len(p_a), v,
            tuples.ctypes.data_as(_i32p), lens.ctypes.data_as(_i32p),
            len(L), self.size_l, out.ctypes.data_as(_i32p), self.cap,
        )
        if n < 0:
            raise RuntimeError("PvL encode overflow")
        return out[:n].tobytes()

    def decode(self, data: bytes):
        buf = np.frombuffer(data, dtype=np.int32)
        p_out = np.zeros((self.size_l,), dtype=np.int32)
        tuples = np.zeros((self.nt_cap, self.size_l), dtype=np.int32)
        lens = np.zeros((self.nt_cap,), dtype=np.int32)
        header = np.zeros((3,), dtype=np.int32)
        used = self.lib.qba_decode_pvl(
            buf.ctypes.data_as(_i32p), len(buf),
            p_out.ctypes.data_as(_i32p), self.size_l,
            tuples.ctypes.data_as(_i32p), lens.ctypes.data_as(_i32p),
            self.nt_cap, self.size_l, header.ctypes.data_as(_i32p),
        )
        if used < 0:
            raise RuntimeError("malformed PvL wire buffer")
        n_p, v, n_t = (int(x) for x in header)
        p = {int(x) for x in p_out[:n_p]}
        L = {
            tuple(int(x) for x in tuples[t_i, : lens[t_i]])
            for t_i in range(n_t)
        }
        return p, v, L


def _consistent(v: int, L: set, w: int) -> bool:
    """The reference predicate (``tfg.py:87-98``) over sets of tuples —
    same shape as the local backend's (independent implementations,
    differentially pinned)."""
    if not L:
        return True
    lens = {len(t) for t in L}
    if len(lens) != 1:
        return False
    if not all(0 <= x <= w and x != v for t in L for x in t):
        return False
    n = next(iter(lens))
    return all(
        all(a[k] != b[k] for k in range(n))
        for a in L for b in L if a < b
    )


# ---------------------------------------------------------------------------
# Socket plumbing.

def _sock_path(sock_dir: str, rank: int) -> str:
    return os.path.join(sock_dir, f"party{rank}.sock")


def _send_msg(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
    return _recv_exact(sock, n)


def _build_mesh(rank: int, peers: list[int], sock_dir: str,
                timeout: float = 30.0) -> dict[int, socket.socket]:
    """Full p2p mesh: listen on own path; dial every lower-ranked peer
    (hello = our rank), accept from every higher-ranked one."""
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(_sock_path(sock_dir, rank))
    lower = [p for p in peers if p < rank]
    higher = [p for p in peers if p > rank]
    listener.listen(len(higher) + 1)
    conns: dict[int, socket.socket] = {}
    for p in lower:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        deadline = time.monotonic() + timeout
        while True:
            try:
                s.connect(_sock_path(sock_dir, p))
                break
            except (FileNotFoundError, ConnectionRefusedError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        _send_msg(s, struct.pack("<I", rank))
        conns[p] = s
    for _ in higher:
        s, _addr = listener.accept()
        (r,) = struct.unpack("<I", _recv_msg(s))
        conns[r] = s
    listener.close()
    return conns


# ---------------------------------------------------------------------------
# Party mains (Process targets — spawn-safe, torch-free).
#
# Batch mode: a party process builds its socket mesh ONCE, reports
# ("ready", pid), and then serves a stream of trials — the coordinator
# sends ("trial", per-trial params) over the duplex work pipe, the party
# runs the protocol over the persistent mesh and replies ("ok", result),
# until ("stop",).  This amortizes the n_parties process starts across a
# whole Monte-Carlo batch, matching the
# runtime shape of the reference's single mpiexec launch
# (``tfg.py:310-314``) rather than one launch per trial.  Stream
# alignment needs no per-trial framing: every trial is a complete BSP
# exchange (each party reads exactly the messages the trial defines), so
# consecutive trials cannot interleave on the sockets.

def commander_main(rank, sock_dir, so_path, conn, params):
    """Rank 1 (``tfg.py:166-184``): per trial, compute each
    lieutenant's packet from the recovered Q-correlated set and send it
    over the wire; the equivocation split is already folded into
    ``v_sent``."""
    try:
        size_l = params["size_l"]
        codec = _Codec(so_path, size_l, params["max_l"])
        lieu_ranks = list(range(2, params["n_parties"] + 1))
        conns = _build_mesh(rank, lieu_ranks, sock_dir)
        conn.send(("ready", os.getpid()))
        while True:
            try:
                msg = conn.recv()
            except EOFError:  # coordinator closed the pipe = stop
                break
            if msg[0] != "trial":
                break
            work = msg[1]
            row0, row1 = work["list0"], work["list1"]
            isq = {k for k in range(size_l) if row0[k] != row1[k]}
            events = []
            for i, r in enumerate(lieu_ranks):
                v = work["v_sent"][i]
                p = {k for k in isq if row1[k] == v}
                events.append(
                    ((0, 0, i, 0), "step2", "send",
                     dict(sender=1, dest=r, v=v, p_size=len(p), l_size=0))
                )
                _send_msg(conns[r], codec.encode(p, v, set()))
            conn.send(("ok", {"events": events}))
        for s in conns.values():
            s.close()
    except Exception as e:  # pragma: no cover - surfaced by the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


def lieutenant_main(rank, sock_dir, so_path, conn, params):
    """One lieutenant (rank 2..n_parties): per trial, step 3a on the
    commander's wire packet, then the synchronous voting rounds against
    every peer (``tfg.py:185-300,337-348``), decision at the end."""
    try:
        codec = _Codec(so_path, params["size_l"], params["max_l"])
        peers = [
            r for r in range(1, params["n_parties"] + 1) if r != rank
        ]
        conns = _build_mesh(rank, peers, sock_dir)
        conn.send(("ready", os.getpid()))
        while True:
            try:
                msg = conn.recv()
            except EOFError:  # coordinator closed the pipe = stop
                break
            if msg[0] != "trial":
                break
            conn.send(_run_lieutenant(rank, codec, conns, params, msg[1]))
        for s in conns.values():
            s.close()
    except Exception as e:  # pragma: no cover - surfaced by the parent
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


def _run_lieutenant(rank, codec, conns, params, work):
    n_parties = params["n_parties"]
    w, slots = params["w"], params["slots"]
    n_dis, n_rounds = params["n_dishonest"], params["n_rounds"]
    racy_defer = params["racy_defer"]
    honest = work["honest"]  # rank-indexed tuple[bool]
    li = work["list"]  # own particle list (ints)
    attacks = np.asarray(work["attacks"])  # [n_rounds, n_cells, 3]
    me = rank - 2  # lieutenant index
    peers = [r for r in range(1, n_parties + 1) if r != rank]
    lieu_peers = [r for r in peers if r >= 2]

    events: list = []
    vi: set = set()
    overflow = False

    def emit(key, phase, message, **fields):
        events.append((key, phase, message, fields))

    # Step 3a (tfg.py:185-196): the commander's packet over the wire.
    p0, v0, L0 = codec.decode(_recv_msg(conns[1]))
    ell = set(L0)
    ell.add(tuple(li[j] for j in sorted(p0)))
    ok = _consistent(v0, ell, w)
    emit((0, 0, me, 1), "step3a", "receive", rank=rank, v=v0,
         accepted=ok, reason="accepted" if ok else "inconsistent")
    out: list = [(p0, v0, ell)] if ok else []
    if ok:
        vi.add(v0)

    deferred: list = []  # (sender_rank, p2, v2, ell2)
    for rnd in range(1, n_rounds + 1):
        # Ship the previous stage's acceptances to every lieutenant peer
        # from a helper thread (all parties send before reading; the
        # thread keeps full socket buffers from deadlocking the mesh).
        batch = [codec.encode(p, v, ell) for p, v, ell in out]

        def ship():
            payload = struct.pack("<I", len(batch)) + b"".join(
                struct.pack("<I", len(b)) + b for b in batch
            )
            for r in lieu_peers:
                _send_msg(conns[r], payload)

        shipper = threading.Thread(target=ship)
        shipper.start()

        out = []
        next_deferred: list = []
        seq = [0]

        def lieu_receive(sender_rank, p2, v2, ell2, was_deferred=False):
            """tfg.py:289-300 for one delivered packet."""
            nonlocal overflow
            ell2 = set(ell2)
            ell2.add(tuple(li[j] for j in sorted(p2)))
            if not _consistent(v2, ell2, w):
                reason = "inconsistent"
            elif v2 in vi:
                reason = "duplicate-v"
            elif len(ell2) != rnd + 1:
                reason = "wrong-evidence-len"
            else:
                reason = "accepted"
            fields = dict(
                round=rnd, sender=sender_rank, recv=rank, v=v2,
                accepted=reason == "accepted", reason=reason,
            )
            if was_deferred:
                fields["deferred"] = True
            stage = 0 if was_deferred else 1
            emit((rnd, stage, me, seq[0]), "round", "receive", **fields)
            seq[0] += 1
            if reason == "accepted":
                vi.add(v2)
                if rnd <= n_dis:
                    if len(out) < slots:
                        out.append((p2, v2, ell2))
                        emit((rnd, 1, me, seq[0]), "round", "send",
                             round=rnd, sender=rank, v=v2,
                             p_size=len(p2), l_size=len(ell2),
                             broadcast=True)
                        seq[0] += 1
                    else:
                        overflow = True

        # Deferred arrivals drain first (racy_mode="defer", D1).
        for sender_rank, p2, v2, ell2 in deferred:
            lieu_receive(sender_rank, p2, v2, ell2, was_deferred=True)

        # One batch from every lieutenant peer, in sender rank order
        # (D5 packet ordering).
        for r in sorted(lieu_peers):
            data = _recv_msg(conns[r])
            off = 0
            (count,) = struct.unpack_from("<I", data, off)
            off += 4
            sender = r - 2
            for slot in range(count):
                (blen,) = struct.unpack_from("<I", data, off)
                off += 4
                wire = data[off : off + blen]
                off += blen
                if slot >= slots:
                    continue
                p2, v2, ell2 = codec.decode(wire)
                cell = sender * slots + slot
                bits, rand_v, late = (
                    int(x) for x in attacks[rnd - 1, cell]
                )
                if late and not racy_defer:
                    emit((rnd, 1, me, seq[0]), "round", "late loss",
                         round=rnd, sender=r, recv=rank)
                    seq[0] += 1
                    continue
                if not honest[r]:  # tfg.py:271-284
                    emit((rnd, 1, me, seq[0]), "round", "attack",
                         round=rnd, sender=r, recv=rank,
                         action=_effect_names(bits))
                    seq[0] += 1
                    if bits & _DROP:
                        continue
                    if bits & _FORGE:
                        v2 = rand_v
                    if bits & _CLEAR_P:
                        p2 = set()
                    if bits & _CLEAR_L:
                        ell2 = set()
                    if bits & _FORGE_P:
                        # Worst-case P forgery (strategy="split"):
                        # fabricated all-positions mask, wins over clear.
                        p2 = set(range(params["size_l"]))
                if late:  # racy_mode="defer": next round's drain
                    emit((rnd, 1, me, seq[0]), "round", "late defer",
                         round=rnd, sender=r, recv=rank)
                    seq[0] += 1
                    next_deferred.append((r, p2, v2, ell2))
                    continue
                lieu_receive(r, p2, v2, ell2)

        emit((rnd, 2, me, 0), "round", "vi", round=rnd, rank=rank,
             vi=sorted(vi))
        shipper.join()
        deferred = next_deferred

    # Connections stay open — the mesh is persistent across the batch.
    # Decision (tfg.py:303-306; empty-Vi sentinel = w, DIVERGENCES D2).
    decision = min(vi) if vi else w
    return (
        "ok",
        {
            "decision": decision,
            "vi": sorted(vi),
            "overflow": overflow,
            "events": events,
        },
    )

