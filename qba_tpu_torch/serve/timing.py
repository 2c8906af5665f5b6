"""The file-queue protocol's timing constants — a copy of
:mod:`qba_tpu.serve.timing`, so the port's worker, its CLI defaults and
the JAX package's fleet supervisor agree on every poll period, watchdog
budget and reclaim bound.

The worker's transport (:mod:`qba_tpu_torch.serve.transport`), the
fleet's supervisor and pool (:mod:`qba_tpu_torch.serve.fleet`) and the
CLI's defaults read these constants.
"""

from __future__ import annotations

# ---- worker claim loop (serve/transport.py) -------------------------------

#: File-queue inbox poll period for one serve worker (``--poll-s``).
WORKER_POLL_S = 0.05

#: Base stale-claim timeout (``--reclaim-timeout-s``): the k-th reclaim
#: of a claim file requires age ``RECLAIM_TIMEOUT_S * 2**k`` measured
#: from the claim-instant mtime re-stamp (never from enqueue time: a
#: backlogged request would look stale the moment it was claimed).
RECLAIM_TIMEOUT_S = 5.0

#: Reclaim attempts before a request is dead-lettered (``--max-reclaims``).
MAX_RECLAIMS = 3

#: Idle heartbeat re-beat throttle (queuefs.HeartbeatWriter).
IDLE_REBEAT_S = 1.0

# ---- supervisor (serve/fleet/supervisor.py) -------------------------------

#: Supervision loop period: one :meth:`FleetSupervisor.poll` per this
#: many seconds.  A dead worker's claim is released within ONE such
#: poll (a KI-10 model invariant), so this bounds re-serve latency.
SUPERVISOR_POLL_S = 0.5

#: Base heartbeat-staleness budget before a worker is "hung"
#: (``--watchdog-s``).
WATCHDOG_S = 10.0

#: Multiplier on :data:`WATCHDOG_S` per heartbeat phase.  A bucket's
#: first dispatch (the kernels' build and load on the card) legitimately
#: runs orders of magnitude longer than a dispatch or readback; every
#: phase not listed gets the base budget.
WATCHDOG_PHASE_SCALE = {"compile": 30.0}

#: Boot grace = this many watchdog budgets before a beat-less fresh pid
#: is "hung" (workers importing torch take seconds to boot).
BOOT_GRACE_SCALE = 3.0

#: Worker deaths blamed on one request before it is quarantined as
#: poison (``--poison-threshold``): one poison request costs at most
#: this many workers — the KI-10 model checks exactly that bound.
POISON_THRESHOLD = 2

#: Crash-loop breaker: this many deaths of one slot inside
#: :data:`BREAKER_WINDOW_S` benches it (``--breaker-k``).
BREAKER_K = 3
BREAKER_WINDOW_S = 60.0

# ---- replica pool (serve/fleet/pool.py) -----------------------------------

#: Respawns of one slot before it is benched for good (``--max-respawns``).
MAX_RESPAWNS = 5

#: The k-th respawn of a slot waits ``RESPAWN_BACKOFF_S * 2**(k-1)``
#: after the previous one (``--respawn-backoff-s``).
RESPAWN_BACKOFF_S = 0.5

# ---- fleet front-end (serve/fleet/frontend.py) ----------------------------

#: Outbox poll period for the front-end's result watcher.
FRONTEND_POLL_S = 0.02
