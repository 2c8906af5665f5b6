"""qba_tpu_torch.serve.fleet — network front end, replica pool, admission;
the counterpart of :mod:`qba_tpu.serve.fleet` over the port's worker.

The fleet turns the single-process :class:`QBAServer` into a
multi-replica service without new dispatch machinery:

* :mod:`frontend` — an asyncio socket/HTTP JSONL listener that writes
  admitted requests into the file queue and streams results back;
* :mod:`pool` — N worker processes, each running ``python -m
  qba_tpu_torch serve --transport file-queue`` pinned to one card,
  booting from the shared warm-start artifact behind its file lock;
* :mod:`admission` — target-aware pricing of each request against the
  port's memory model (:mod:`qba_tpu_torch.analysis.memory`) and a
  fleet-wide capacity window, with typed admit/defer/reject decisions
  and release-on-settle;
* :mod:`summary` — cross-replica aggregation: per-replica and
  fleet-wide p50/p99, queue-wait against device-time attribution,
  admission decision counts, one ``fleet_summary.json``;
* :mod:`supervisor` — the self-healing loop: phase-aware heartbeat
  watchdog (SIGKILLs hung workers), blame-attributed crash ledger,
  poison-request quarantine, and a crash-loop breaker that benches
  flapping replicas and releases their admission capacity.

``python -m qba_tpu_torch fleet`` (cli.py) wires them together.  The
front half (everything here but the workers) opens no CUDA context;
the wire formats are the JAX package's, so either package's front end
drives the other's workers.
"""

from qba_tpu_torch.serve.fleet.admission import (
    ADMIT,
    DEFER,
    REASONS,
    REJECT,
    AdmissionController,
    AdmissionDecision,
)
from qba_tpu_torch.serve.fleet.frontend import FleetFrontend
from qba_tpu_torch.serve.fleet.pool import (
    Replica,
    ReplicaPool,
    make_device_env,
)
from qba_tpu_torch.serve.fleet.summary import (
    FLEET_SUMMARY_SCHEMA,
    fleet_summary,
    merge_fleet_spans,
    write_fleet_summary,
)
from qba_tpu_torch.serve.fleet.supervisor import (
    CRASH_LEDGER_SCHEMA,
    WATCHDOG_PHASE_SCALE,
    FleetSupervisor,
)

__all__ = [
    "ADMIT",
    "DEFER",
    "REJECT",
    "REASONS",
    "AdmissionController",
    "AdmissionDecision",
    "FleetFrontend",
    "Replica",
    "ReplicaPool",
    "make_device_env",
    "FLEET_SUMMARY_SCHEMA",
    "fleet_summary",
    "merge_fleet_spans",
    "write_fleet_summary",
    "CRASH_LEDGER_SCHEMA",
    "WATCHDOG_PHASE_SCALE",
    "FleetSupervisor",
]
