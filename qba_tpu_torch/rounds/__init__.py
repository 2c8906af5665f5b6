"""The protocol's round loop — counterpart of :mod:`qba_tpu.rounds`."""

from qba_tpu_torch.rounds.engine import TrialResult, run_trial
from qba_tpu_torch.rounds.mailbox import Mailbox

__all__ = ["Mailbox", "TrialResult", "run_trial"]
