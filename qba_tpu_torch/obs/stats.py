"""Interval statistics for Monte-Carlo study results — a copy of
:mod:`qba_tpu.obs.stats` (the port imports nothing of :mod:`qba_tpu`).

The reference only ever eyeballed single runs (``log_d_11.txt``); the
``study`` subcommand quantifies the protocol's guarantees, which needs
honest uncertainty: Wilson score intervals (well-behaved near rates of
0/1, where the normal approximation the plots' shaded band uses breaks
down) and the success/validity decomposition.

Terminology (docs/VALIDITY.md): the built-in oracle
(:func:`qba_tpu_torch.core.decide.success_oracle`, ``tfg.py:359-363``) checks
AGREEMENT — all honest parties decide one value.  Because an honest
commander decides its own order (``tfg.py:303-305``), agreement
*conditional on an honest commander* is exactly VALIDITY — honest
lieutenants decide the commander's order.  Under a dishonest commander
validity is vacuous and agreement is the whole guarantee.
"""

from __future__ import annotations

import numpy as np

from qba_tpu_torch.stats.estimators import wilson_ci_z


def wilson_interval(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for ``k`` successes in ``n`` Bernoulli
    trials (default 95%).  ``n == 0`` returns the uninformative (0, 1).

    Thin wrapper over :func:`qba_tpu_torch.stats.estimators.wilson_ci_z` —
    the statistics engine owns the formula now; this name stays for the
    study scripts and their JSON consumers.
    """
    return wilson_ci_z(k, n, z)


def _rate(k: int, n: int) -> dict:
    lo, hi = wilson_interval(k, n)
    return {
        "k": int(k),
        "n": int(n),
        "rate": (k / n) if n else None,
        "lo": lo,
        "hi": hi,
    }


def decision_profile(decisions, honest, v_comm, w: int) -> dict:
    """Outcome classes among honest-commander trials — the detectable-QBA
    decomposition a bare success bit hides.

    A lieutenant decides ``min(Vi)``, or the sentinel ``w`` (abort, D2)
    on an empty accepted-set, so "success | honest commander" conflates
    three different failures.  Per honest-commander trial, over the
    HONEST lieutenants only:

    * ``valid`` — all decide the commander's order (strict validity).
    * ``abort_all`` — all decide the sentinel: unanimous detection.
    * ``mixed_valid_abort`` — every decision is the order or the
      sentinel, both occur.  Detection split the honest set.
    * ``corrupted`` — some honest lieutenant decided a DIFFERENT order
      (a forged value below the commander's won its ``min(Vi)``).

    ``decisions``: int32[trials, n_parties] (index 0 = commander);
    ``honest``: bool[trials, n_parties]; ``v_comm``: int32[trials].
    Returns the four Wilson-bounded rates, conditional on an honest
    commander with >= 1 honest lieutenant.
    """
    dec = np.asarray(decisions)
    hon = np.asarray(honest, dtype=bool)
    vc = np.asarray(v_comm)
    ch = hon[:, 0] & hon[:, 1:].any(axis=1)
    lieu_h = hon[:, 1:]
    d_l = dec[:, 1:]
    is_v = d_l == vc[:, None]
    is_abort = d_l == w
    all_v = np.where(lieu_h, is_v, True).all(axis=1)
    all_abort = np.where(lieu_h, is_abort, True).all(axis=1)
    in_pair = np.where(lieu_h, is_v | is_abort, True).all(axis=1)
    valid = ch & all_v
    abort_all = ch & all_abort & ~all_v
    mixed = ch & in_pair & ~all_v & ~all_abort
    corrupted = ch & ~in_pair
    n = int(ch.sum())
    return {
        "n_honest_commander": n,
        "valid": _rate(int(valid.sum()), n),
        "abort_all": _rate(int(abort_all.sum()), n),
        "mixed_valid_abort": _rate(int(mixed.sum()), n),
        "corrupted": _rate(int(corrupted.sum()), n),
    }


def study_breakdown(success, commander_honest) -> dict:
    """Success decomposed over the commander's honesty.

    ``success``: bool[trials] from the oracle; ``commander_honest``:
    bool[trials] (``trials.honest[:, 0]``).  Returns ``overall``,
    ``validity`` (success | honest commander — the protocol's validity
    property), and ``agreement_dishonest_c`` (success | dishonest
    commander), each with Wilson 95% bounds.
    """
    s = np.asarray(success, dtype=bool)
    ch = np.asarray(commander_honest, dtype=bool)
    return {
        "overall": _rate(int(s.sum()), s.size),
        "validity": _rate(int(s[ch].sum()), int(ch.sum())),
        "agreement_dishonest_c": _rate(int(s[~ch].sum()), int((~ch).sum())),
    }
