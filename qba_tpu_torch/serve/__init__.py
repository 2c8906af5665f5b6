"""qba_tpu_torch.serve — the persistent evaluation service, counterpart
of :mod:`qba_tpu.serve`.

A long-lived worker answers :class:`EvalRequest` s ("n parties, d
traitors — failure probability at sizeL=L?") by bucketing mixed-shape
traffic into fixed-size chunks, double-buffering device chunks against
host readback, and emitting one validated run manifest + span tree per
request.  The wire formats (requests, results, the queue directory,
heartbeats, ``plans.json``) are the JAX package's.

Module map:

* :mod:`~qba_tpu_torch.serve.request` — wire model (EvalRequest/EvalResult).
* :mod:`~qba_tpu_torch.serve.scheduler` — shape buckets, chunk packing.
* :mod:`~qba_tpu_torch.serve.engine` — :class:`QBAServer`, the dispatch loop.
* :mod:`~qba_tpu_torch.serve.transport` — stdin-JSONL and file-queue transports.
* :mod:`~qba_tpu_torch.serve.persist` — the ``plans.json`` warm-start artifact.
* :mod:`~qba_tpu_torch.serve.queuefs` — file-queue paths, atomic writes,
  heartbeats and the flight recorder.
* :mod:`~qba_tpu_torch.serve.timing` — the protocol's timing constants.
* :mod:`~qba_tpu_torch.serve.fleet` — the front end, replica pool,
  admission, supervisor and fleet summary over N workers.
"""

from qba_tpu_torch.serve.engine import QBAServer, serve_batch
from qba_tpu_torch.serve.persist import load_plans, save_plans, saved_configs
from qba_tpu_torch.serve.request import EvalRequest, EvalResult
from qba_tpu_torch.serve.scheduler import BucketScheduler, bucket_config, bucket_label
from qba_tpu_torch.serve.transport import serve_file_queue, serve_jsonl

__all__ = [
    "QBAServer",
    "serve_batch",
    "EvalRequest",
    "EvalResult",
    "BucketScheduler",
    "bucket_config",
    "bucket_label",
    "serve_jsonl",
    "serve_file_queue",
    "load_plans",
    "save_plans",
    "saved_configs",
]
