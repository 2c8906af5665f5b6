"""Command-line interface: ``python -m qba_tpu_torch serve`` — the
``serve`` subcommand of :mod:`qba_tpu.cli`, with its flags, on the port.

* ``serve`` — persistent evaluation service: answers request streams
  (stdin-JSONL or file-queue) with shape-bucketed, double-buffered
  dispatch and per-request run manifests (:mod:`qba_tpu_torch.serve`).
  It runs on CUDA; ``--device cpu`` runs the plain PyTorch versions.

The JAX package's other subcommands are named here and refuse with the
ROADMAP item that ports them: ``fleet`` (A10b); ``run``, ``bench``,
``sweep``, ``study``, ``lint``, ``atlas`` and ``trace`` (A13).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from qba_tpu_torch.serve import timing as _timing

# Subcommands of the JAX package's CLI not ported yet, and their items.
_NOT_PORTED = {"run": "A13", "bench": "A13", "sweep": "A13",
               "study": "A13", "lint": "A13", "fleet": "A10b",
               "atlas": "A13", "trace": "A13"}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qba_tpu_torch",
        description="detectable Quantum Byzantine Agreement on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser(
        "serve",
        help="persistent evaluation service: answer EvalRequest streams "
        "with bucketed, double-buffered dispatch",
    )
    serve.add_argument(
        "--transport", choices=("jsonl", "file-queue"), default="jsonl",
        help="jsonl = one request per stdin line, one result per stdout "
        "line; file-queue = poll <queue-dir>/inbox for request files, "
        "write results to <queue-dir>/outbox (stop via a 'stop' file)",
    )
    serve.add_argument(
        "--queue-dir", metavar="DIR", default=None,
        help="queue directory (required for --transport file-queue)",
    )
    serve.add_argument(
        "--chunk-trials", type=int, default=64,
        help="trials per device chunk; same-bucket requests are packed "
        "into chunks of this size (partial chunks are padded at flush)",
    )
    serve.add_argument(
        "--depth", type=int, default=2,
        help="double-buffer depth: chunks in flight before the host "
        "reads back the trailing one (1 disables the overlap)",
    )
    serve.add_argument(
        "--telemetry", metavar="DIR", default=None,
        help="write one run_manifest.json + spans.jsonl + trace.json "
        "per request under DIR/<request_id>/",
    )
    serve.add_argument(
        "--cache-dir", metavar="DIR", default=None,
        help="warm-start artifact directory: <DIR>/plans.json holds the "
        "saved shapes (prepared at boot: their kernels built and loaded, "
        "their tables made; saved at every flush)",
    )
    serve.add_argument(
        "--no-warm-start", action="store_true",
        help="do not restore plans.json at boot (still saved at flush)",
    )
    serve.add_argument(
        "--max-requests", type=int, default=None,
        help="exit after consuming this many requests",
    )
    serve.add_argument(
        "--poll-s", type=float, default=_timing.WORKER_POLL_S,
        help="file-queue inbox poll interval in seconds",
    )
    serve.add_argument(
        "--reclaim-timeout-s", type=float, default=None,
        help="file-queue crash recovery: claims older than this with no "
        "result are pushed back to the inbox (exponential backoff per "
        "retry); default: no reclaim",
    )
    serve.add_argument(
        "--max-reclaims", type=int, default=_timing.MAX_RECLAIMS,
        help="reclaim attempts per request file before dead-lettering "
        "it to <queue-dir>/dead with an error result",
    )
    serve.add_argument(
        "--deadline-s", type=float, default=None,
        help="per-request wall-clock deadline: an overdue request gets "
        "a structured error result (with manifest) instead of wedging "
        "the stream; requests can override via their deadline_s field",
    )
    serve.add_argument(
        "--cache-stats", action="store_true",
        help="print the kernel build directory and the libraries built "
        "there, plus the cache-dir artifact status, and exit",
    )
    serve.add_argument(
        "--replica-id", metavar="ID", default=None,
        help="fleet replica identity: stamped on every result/manifest "
        "and used to name this worker's exit summary "
        "(summary-<ID>.json) so workers sharing one queue dir never "
        "clobber each other",
    )
    serve.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (the default) runs the kernels and raises without a "
        "card; cpu runs their plain PyTorch versions",
    )
    for name, item in _NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet (ROADMAP {item})",
                       add_help=False, prefix_chars="\0")
    return parser


def _cache_stats(args: argparse.Namespace) -> dict:
    """What the port keeps between runs: its kernels' build directory and
    the libraries built there, and the cache dir's ``plans.json`` with
    what each saved shape resolved to."""
    import os

    from qba_tpu_torch.config import QBAConfig
    from qba_tpu_torch.ops._build import build_dir
    from qba_tpu_torch.serve.persist import (
        plans_path,
        saved_configs,
        saved_resolutions,
    )
    from qba_tpu_torch.serve.scheduler import bucket_label

    root = build_dir()
    built = sorted(p.name for p in root.glob("*.so")) if root.is_dir() else []
    info: dict = {"kernels": {"build_dir": str(root), "built": built}}
    if args.cache_dir:
        plans = plans_path(args.cache_dir)
        artifact: dict = {
            "plans_path": plans,
            "plans_exists": os.path.exists(plans),
        }
        if artifact["plans_exists"]:
            try:
                artifact["saved_shapes"] = len(saved_configs(plans))
            except ValueError as e:
                artifact["plans_error"] = str(e)
        state = saved_resolutions(args.cache_dir)
        if state is not None:
            artifact["resolved_on"] = state["backend"]
            artifact["resolved"] = [
                dict(shape=bucket_label(QBAConfig(**entry)), **plan)
                for entry, plan in state["buckets"]]
        info["cache_dir"] = artifact
    return info


def _cmd_serve(args: argparse.Namespace, out) -> int:
    if args.cache_stats:
        print(json.dumps(_cache_stats(args), indent=1, default=str), file=out)
        return 0

    from qba_tpu_torch.serve import QBAServer, serve_file_queue, serve_jsonl

    if args.transport == "file-queue" and not args.queue_dir:
        raise ValueError(
            "serve: --queue-dir is required with --transport file-queue"
        )
    server = QBAServer(
        chunk_trials=args.chunk_trials,
        depth=args.depth,
        telemetry_dir=args.telemetry,
        cache_dir=args.cache_dir,
        warm_start=not args.no_warm_start,
        deadline_s=args.deadline_s,
        replica_id=args.replica_id,
        device=None if args.device == "cuda" else args.device,
    )
    if args.transport == "file-queue":
        stats = serve_file_queue(
            server,
            args.queue_dir,
            poll_s=args.poll_s,
            max_requests=args.max_requests,
            reclaim_timeout_s=args.reclaim_timeout_s,
            max_reclaims=args.max_reclaims,
        )
    else:
        stats = serve_jsonl(
            server, sys.stdin, out, max_requests=args.max_requests
        )
    # Results went to stdout/outbox; the operator summary goes to
    # stderr so jsonl result streams stay machine-parseable.
    print(json.dumps({"serve_summary": stats}, default=str), file=sys.stderr)
    return 0


def main(argv: Sequence[str] | None = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    args, rest = _parser().parse_known_args(argv)
    if args.command in _NOT_PORTED:
        print(f"error: `{args.command}` is not ported to qba_tpu_torch yet "
              f"(ROADMAP {_NOT_PORTED[args.command]}); run `python -m "
              f"qba_tpu {args.command}`", file=sys.stderr)
        return 2
    if rest:
        _parser().parse_args(argv)  # argparse's own error for the extras
    try:
        return _cmd_serve(args, out)
    except ValueError as e:  # config validation -> clean CLI failure
        print(f"error: {e}", file=sys.stderr)
        return 2
