"""C++ message-level backend (``backend="native"``) — counterpart of
:mod:`qba_tpu.backends.native_backend`.

A third implementation of the protocol beside the batched runner and the
pure-Python local backend: the C++ host runtime in
:mod:`qba_tpu_torch.native` runs a full trial over per-party mailboxes,
every packet passing through the PvL wire codec (the in-process analog of
the reference's tagged MPI transport, ``tfg.py:199-263``).

Randomness is the local backend's batch presample
(:func:`~qba_tpu_torch.backends.local_backend.presample_batch`): drawn on
the keys' device, copied to the host once, and read by the C engine in
the draws kernel's own uint8 layout, so no draw is transposed or
widened.  For any config and trial key the three implementations agree.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qba_tpu_torch.adversary import effect_names
from qba_tpu_torch.backends.local_backend import (
    Presample,
    emit_host_phases,
    emit_verdict,
    presample_batch,
)
from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.native import load

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _i32(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(_i32p)


def _u8(a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    return a, a.ctypes.data_as(_u8p)


# C trace record layout (qba_native.cc, qba_run_trial): 7-int32 records
# {kind, round, sender_rank, recv_rank, v, a, b}.
_TRACE_REC = 7
_REASONS = ("accepted", "inconsistent", "duplicate-v", "wrong-evidence-len")


def _emit_trace(cfg: QBAConfig, log, trial: int, recs: np.ndarray) -> None:
    """Render the C engine's trace records in the local backend's event
    grammar.

    Kind 7 opens a per-(round, rank) accepted-set snapshot expecting
    ``a`` kind-8 value records; a truncated trace can cut the value list
    short, and then the partial snapshot is dropped rather than rendered
    wrong."""
    pending = None  # (round, rank, expected, values)

    def flush_pending():
        nonlocal pending
        if pending is None:
            return
        rnd, rank, expect, vals = pending
        pending = None
        if len(vals) == expect:
            log.debug("round", "vi", trial=trial, round=rnd, rank=rank,
                      vi=sorted(vals))

    for kind, rnd, sender, recv, v, a, b in recs.tolist():
        if kind == 8:
            if pending is not None:
                pending[3].append(v)
                if len(pending[3]) == pending[2]:
                    flush_pending()
            continue
        flush_pending()
        if kind == 7:  # per-round accepted-set snapshot header
            pending = (rnd, sender, a, [])
            if a == 0:
                flush_pending()
            continue
        if kind == 1:  # step2 send (tfg.py:203)
            log.debug("step2", "send", trial=trial, sender=sender,
                      dest=recv, v=v, p_size=a, l_size=0)
        elif kind == 2:  # step3a receive (tfg.py:190)
            log.debug("step3a", "receive", trial=trial, rank=recv, v=v,
                      accepted=bool(a), reason=_REASONS[b])
        elif kind == 3:  # racy late loss
            log.debug("round", "late loss", trial=trial, round=rnd,
                      sender=sender, recv=recv)
        elif kind == 4:  # attack action (tfg.py:275-284)
            log.debug("round", "attack", trial=trial, round=rnd,
                      sender=sender, recv=recv, action=effect_names(a))
        elif kind == 5:  # round receive (tfg.py:294)
            log.debug("round", "receive", trial=trial, round=rnd,
                      sender=sender, recv=recv, v=v, accepted=bool(a),
                      reason=_REASONS[b])
        elif kind == 6:  # rebroadcast (tfg.py:229)
            log.debug("round", "send", trial=trial, round=rnd,
                      sender=sender, v=v, p_size=a, l_size=b,
                      broadcast=True)
        elif kind == 9:  # deferred receive (racy_mode="defer")
            log.debug("round", "receive", trial=trial, round=rnd,
                      sender=sender, recv=recv, v=v, accepted=bool(a),
                      reason=_REASONS[b], deferred=True)
        elif kind == 10:  # packet queued for the next round
            log.debug("round", "late defer", trial=trial, round=rnd,
                      sender=sender, recv=recv)
    flush_pending()


def _trace_capacity(cfg: QBAConfig) -> int:
    """Trace records one trial can need: step 2 and 3a (2 a lieutenant),
    and a round's at most ``n_pk`` deliveries a receiver of at most 4
    records each, the vi snapshot headers and up to ``w`` values a rank."""
    n_lieu = cfg.n_lieutenants
    per_round = n_lieu * (n_lieu * cfg.slots * 4 + 1 + cfg.w)
    return 2 * n_lieu + cfg.n_rounds * per_round


def run_trial_native(cfg: QBAConfig, key: torch.Tensor, log=None,
                     trial: int = 0, *,
                     partitionable: bool | None = None) -> dict:
    """One protocol execution in the C++ runtime for trial key ``[2]``;
    returns the rank-0 summary dict (the shape of
    :func:`~qba_tpu_torch.backends.local_backend.run_trial_local`).

    With ``log`` the C engine records its protocol event trail into a
    trace buffer, decoded here into the local backend's event grammar; the
    host-side phases (dishonesty, particles, commander state, verdict) are
    emitted from the presample.  ``partitionable``: JAX's threefry mode
    (None: the current mode)."""
    return native_trial(cfg, presample_batch(cfg, key[None],
                                             partitionable=partitionable),
                        0, log, trial)


def native_trial(cfg: QBAConfig, pre: Presample, i: int, log=None,
                 trial: int = 0) -> dict:
    """Trial ``i`` of a presample through ``qba_run_trial`` (the body of
    :func:`run_trial_native`)."""
    trace = np.zeros((_trace_capacity(cfg), _TRACE_REC), dtype=np.int32)
    res = _run(cfg, pre, slice(i, i + 1), trace=trace)
    w, n_lieu = cfg.w, cfg.n_lieutenants
    out = {
        "success": bool(res["success"][0]),
        "decisions": [int(x) for x in res["decisions"][0]],
        "honest": [bool(h) for h in res["honest"][0]],
        "v_comm": int(res["v_comm"][0]),
        "vi": [{x for x in range(w) if res["vi"][0, r, x]}
               for r in range(n_lieu)],
        "overflow": bool(res["overflow"][0]),
    }
    if log is not None:
        honest, lists, v_sent, v_comm = pre.trial(i)
        emit_host_phases(cfg, log, trial, honest, lists, v_comm, v_sent)
        n = int(res["trace_len"][0])
        if n >= trace.shape[0]:
            log.warning("round", "trace truncated", trial=trial)
        _emit_trace(cfg, log, trial, trace[:n])
        emit_verdict(log, trial, out["decisions"], out["honest"],
                     out["success"])
    return out


def run_trials_native(cfg: QBAConfig, keys: torch.Tensor,
                      n_threads: int = 0,
                      pre: Presample | None = None, *,
                      partitionable: bool | None = None) -> dict:
    """A Monte-Carlo batch on the C++ runtime's threaded executor.

    The batch's randomness is presampled once (or taken from ``pre``),
    then ``qba_run_trials`` fans the trials out over a host thread pool
    (``n_threads <= 0``: the hardware's concurrency).  Returns stacked
    arrays: ``success [n]``, ``decisions [n, n_parties]``, ``honest [n,
    n_parties]``, ``v_comm [n]``, ``vi [n, n_lieutenants, w]``,
    ``overflow [n]``, and ``success_rate``."""
    if pre is None:
        pre = presample_batch(cfg, keys, partitionable=partitionable)
    return _run(cfg, pre, slice(None), n_threads=n_threads)


def _run(cfg: QBAConfig, pre: Presample, sl: slice, n_threads: int = 1,
         trace: np.ndarray | None = None) -> dict:
    """The C engine over the presample's trials ``sl``; with ``trace``
    (int32 ``[cap, 7]``, one trial) through ``qba_run_trial`` with the
    event trail recorded, else through the threaded ``qba_run_trials``."""
    lib = load()
    honest_a, honest_p = _u8(pre.honest[sl])
    _lists, lists_p = _i32(pre.lists[sl])
    _vs, vs_p = _i32(pre.v_sent[sl])
    vc_a, vc_p = _i32(pre.v_comm[sl])
    draws = [_u8(x[sl]) for x in (pre.attack, pre.rand_v, pre.late)]
    n = honest_a.shape[0]
    n_lieu, w = cfg.n_lieutenants, cfg.w
    decisions = np.zeros((n, cfg.n_parties), dtype=np.int32)
    vi = np.zeros((n, n_lieu, w), dtype=np.uint8)
    flags = np.zeros((n, 2), dtype=np.int32)
    common = (cfg.n_parties, cfg.size_l, cfg.n_dishonest, w, cfg.slots,
              int(cfg.racy_mode == "defer"), honest_p, lists_p, vs_p)
    outs = (decisions.ctypes.data_as(_i32p), vi.ctypes.data_as(_u8p),
            flags.ctypes.data_as(_i32p))
    trace_len = np.zeros((1,), dtype=np.int32)
    if trace is not None:
        if n != 1:
            raise ValueError("trace capture needs a single-trial batch")
        if trace.dtype != np.int32 or trace.ndim != 2 or trace.shape[1] != 7:
            raise ValueError("trace must be int32 [cap, 7]")
        rc = lib.qba_run_trial(*common, int(vc_a[0]),
                               *(p for _a, p in draws), *outs,
                               trace.ctypes.data_as(_i32p), trace.shape[0],
                               trace_len.ctypes.data_as(_i32p))
    else:
        rc = lib.qba_run_trials(n, n_threads, *common, vc_p,
                                *(p for _a, p in draws), *outs)
    if rc != 0:
        raise RuntimeError(f"qba_run_trials failed with rc={rc}")
    return {
        "success": flags[:, 0].astype(bool),
        "decisions": decisions,
        "honest": honest_a[:, 1:].astype(bool),
        "v_comm": vc_a,
        "vi": vi.astype(bool),
        "overflow": flags[:, 1].astype(bool),
        "success_rate": float(flags[:, 0].mean()),
        "trace_len": trace_len,
    }
