"""Run reports: the reference's closing verdict triple, plus sweep
summaries — a copy of :mod:`qba_tpu.obs.report` (the port imports nothing
of :mod:`qba_tpu`).

``render_verdict`` reproduces the rank-0 summary format of the reference
(``tfg.py:360-363``)::

    Decisions:  [3, 3, 3]
    Dishonests: [3]
    Success:    True

``Dishonests`` lists the reference's *ranks* (1 = commander, 2.. =
lieutenants, ``tfg.py:105``), matching the captured logs
(``logs tests/log_d_3.txt``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from qba_tpu_torch.config import QBAConfig


def _dishonest_ranks(honest) -> list[int]:
    """Reference ranks (1..n_parties) of the dishonest parties; index 0 of
    ``honest`` is the commander = rank 1 (TrialResult.honest layout)."""
    return [i + 1 for i, h in enumerate(np.asarray(honest)) if not bool(h)]


def render_verdict(cfg: QBAConfig, trial: Any, index: int | None = None) -> str:
    """One trial's verdict block from TrialResult-shaped fields.

    ``trial`` needs ``decisions``, ``honest``, ``success`` (and optionally
    ``overflow``) as host arrays or CPU tensors: one element of a batched
    result, its fields indexed directly.
    """
    decisions = [int(x) for x in np.asarray(trial.decisions)]
    shown = [d if d != cfg.no_decision else None for d in decisions]
    lines = []
    if index is not None:
        lines.append(f"trial {index}:")
    lines += [
        f"Decisions:  {shown}",
        f"Dishonests: {_dishonest_ranks(trial.honest)}",
        f"Success:    {bool(np.asarray(trial.success))}",
    ]
    if bool(np.asarray(getattr(trial, "overflow", False))):
        lines.append("(mailbox slot overflow occurred — see QBAConfig.slots)")
    return "\n".join(lines)


def render_sweep(
    cfg: QBAConfig,
    success_rate: float,
    n_trials: int,
    seconds: float | None = None,
) -> str:
    """Monte-Carlo aggregate summary (the capability the reference lacks:
    it can only run one trial per ``mpiexec`` invocation)."""
    lines = [
        f"config: n_parties={cfg.n_parties} size_l={cfg.size_l} "
        f"n_dishonest={cfg.n_dishonest} w={cfg.w}",
        f"trials: {n_trials}",
        f"success rate: {success_rate:.4f}",
    ]
    if seconds is not None and seconds > 0:
        rps = n_trials * cfg.n_rounds / seconds
        lines.append(f"throughput: {rps:.1f} protocol rounds/s ({seconds:.3f}s)")
    return "\n".join(lines)
