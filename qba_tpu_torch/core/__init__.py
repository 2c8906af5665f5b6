"""Pure protocol functions on batched tensors — counterpart of
:mod:`qba_tpu.core`."""

from qba_tpu_torch.core.consistent import (
    append_own,
    consistent,
    consistent_after_append,
    sublist_row,
)
from qba_tpu_torch.core.decide import decide_order, success_oracle
from qba_tpu_torch.core.decode import measure_to_ints
from qba_tpu_torch.core.types import SENTINEL, Evidence, Packet, empty_evidence

__all__ = [
    "SENTINEL",
    "Evidence",
    "Packet",
    "empty_evidence",
    "consistent",
    "consistent_after_append",
    "append_own",
    "sublist_row",
    "measure_to_ints",
    "decide_order",
    "success_oracle",
]
