"""Command-line interface: ``python -m qba_tpu_torch {sweep,study,serve}``
— those subcommands of :mod:`qba_tpu.cli`, with their flags, on the port.

* ``sweep`` — chunked, checkpoint-resumable Monte-Carlo sweep, fixed
  budget or precision-targeted (``--target``); ``--dispatch device`` runs
  the targeted loop as one CUDA graph (:mod:`qba_tpu_torch.sweep`).
* ``study`` — success-rate curve over a swept parameter (e.g. the
  security-parameter study in ``size_l``).
* ``serve`` — persistent evaluation service: answers request streams
  (stdin-JSONL or file-queue) with shape-bucketed, double-buffered
  dispatch and per-request run manifests (:mod:`qba_tpu_torch.serve`).

Each runs on CUDA; ``--device cpu`` runs the plain PyTorch versions.
``--plot`` needs matplotlib, and without it is a clean usage error.

The JAX package's other subcommands are named here and refuse with the
ROADMAP item that ports them: ``fleet`` (A10b); ``run``, ``bench``,
``lint``, ``atlas`` and ``trace`` (A13).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Sequence

from qba_tpu_torch.config import QBAConfig
from qba_tpu_torch.obs.plots import PlottingUnavailableError
from qba_tpu_torch.serve import timing as _timing

# Subcommands of the JAX package's CLI not ported yet, and their items.
_NOT_PORTED = {"run": "A13", "bench": "A13", "lint": "A13",
               "fleet": "A10b", "atlas": "A13", "trace": "A13"}


def _add_config_args(p: argparse.ArgumentParser, trials_default: int) -> None:
    p.add_argument(
        "--n-parties", type=int, required=True,
        help="number of generals incl. the commander (reference: mpiexec "
        "-n = n_parties+1)",
    )
    p.add_argument(
        "--size-l", type=int, required=True,
        help="security parameter: particle-list length (reference argv[1])",
    )
    p.add_argument(
        "--n-dishonest", type=int, default=0,
        help="Byzantine party count (reference argv[2])",
    )
    p.add_argument("--trials", type=int, default=trials_default)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--qsim-path",
        choices=("factorized", "dense", "dense_pallas", "stabilizer"),
        default="factorized",
        help="quantum engine path (dense = joint statevector, validation "
        "only, <=20 qubits; dense_pallas = same on the fused circuit "
        "kernel; stabilizer = Clifford tableau: executes the actual joint "
        "circuits at any party count)",
    )
    p.add_argument(
        "--round-engine",
        choices=(
            "auto", "xla", "pallas", "pallas_tiled", "pallas_fused",
            "pallas_mega",
        ),
        default="auto",
        help="voting-round engine: auto = the trial megakernel on CUDA "
        "(one launch a batch), the plain PyTorch engine on the CPU; the "
        "others name a kernel engine; all engines are bit-identical",
    )
    p.add_argument(
        "--trial-pack", type=int, default=None,
        help="fused engine only: fold this many trials into one kernel "
        "grid (must divide --trials to take effect)",
    )
    p.add_argument(
        "--delivery", choices=("sync", "racy"), default="sync",
        help="racy = model the reference's barrier race as per-delivery "
        "loss with prob --p-late",
    )
    p.add_argument("--p-late", type=float, default=0.0)
    p.add_argument(
        "--racy-mode", choices=("loss", "defer"), default="loss",
        help="defer = deliver late packets one round later where the "
        "evidence-length check rejects them (the reference's race "
        "mechanism)",
    )
    p.add_argument(
        "--attack-scope", choices=("delivery", "broadcast"),
        default="delivery",
        help="broadcast = reproduce the reference's shared-object "
        "mutation leak across a broadcast's recipients (tfg.py:271-284)",
    )
    p.add_argument(
        "--strategy",
        choices=("reference", "collude", "adaptive", "split"),
        default="reference",
        help="Byzantine strategy family: reference = the paper's "
        "independent random 4-action attack; collude = traitors forge one "
        "shared per-trial target; adaptive = action law conditions on "
        "round phase and received value; split = commander equivocation + "
        "worst-case P-set forgery",
    )
    p.add_argument(
        "--p-depolarize", type=float, default=0.0,
        help="per-qubit depolarizing probability before measurement",
    )
    p.add_argument(
        "--p-measure-flip", type=float, default=0.0,
        help="per-qubit classical readout flip probability",
    )
    p.add_argument(
        "--collect-counters", action="store_true",
        help="emit protocol counters (rounds-to-acceptance, per-value "
        "accept counts, slot high-water mark) as an auxiliary per-trial "
        "output; primary outputs are bit-identical either way",
    )
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (the default) runs the kernels and raises without a "
        "card; cpu runs their plain PyTorch versions",
    )


def _device(args: argparse.Namespace):
    """``None`` (CUDA, raising without a card) or ``"cpu"``."""
    return None if args.device == "cuda" else args.device


def _config(args: argparse.Namespace, trials: int | None = None) -> QBAConfig:
    return QBAConfig(
        n_parties=args.n_parties,
        size_l=args.size_l,
        n_dishonest=args.n_dishonest,
        trials=trials if trials is not None else args.trials,
        seed=args.seed,
        qsim_path=args.qsim_path,
        round_engine=args.round_engine,
        trial_pack=args.trial_pack,
        delivery=args.delivery,
        p_late=args.p_late,
        racy_mode=args.racy_mode,
        attack_scope=args.attack_scope,
        strategy=args.strategy,
        p_depolarize=args.p_depolarize,
        p_measure_flip=args.p_measure_flip,
        collect_counters=args.collect_counters,
    )


@contextlib.contextmanager
def _telemetry(args: argparse.Namespace, cfg: QBAConfig, command: str):
    """``--telemetry DIR`` -> a live TelemetrySession (manifest and trace
    written at exit, even on failure), else None."""
    if not getattr(args, "telemetry", None):
        yield None
        return
    from qba_tpu_torch.backends.torch_backend import resolve_device
    from qba_tpu_torch.obs.manifest import telemetry_session

    with telemetry_session(args.telemetry, cfg, command,
                           device=resolve_device(_device(args))) as session:
        yield session


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qba_tpu_torch",
        description="detectable Quantum Byzantine Agreement on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sweep = sub.add_parser("sweep", help="chunked checkpoint-resumable sweep")
    _add_config_args(sweep, trials_default=256)
    sweep.add_argument("--n-chunks", type=int, required=True)
    sweep.add_argument(
        "--checkpoint", metavar="PATH", default=None,
        help="JSON checkpoint; completed chunks are skipped on re-run",
    )
    sweep.add_argument(
        "--plot", metavar="PNG", default=None,
        help="write a Monte-Carlo convergence plot (requires matplotlib)",
    )
    sweep.add_argument(
        "--telemetry", metavar="DIR", default=None,
        help="write run_manifest.json + trace.json + spans.jsonl into "
        "DIR; per-chunk dispatch/readback spans nest under the sweep",
    )
    sweep.add_argument(
        "--target", metavar="SPEC", default=None,
        help="precision target: run chunks until the stopping rule "
        "resolves instead of the fixed --n-chunks budget.  SPEC is "
        "'decide vs <p> [+-d] [@ NN%%]' (SPRT against threshold p, "
        "fractions like 1/3 allowed) or 'ci_width<=<w> [@ NN%%]' "
        "(anytime-valid CI width rule); --n-chunks becomes the budget "
        "ceiling",
    )
    sweep.add_argument(
        "--dispatch", choices=("host", "device"), default="host",
        help="'host': per-chunk dispatch with the stopping rule consulted "
        "between chunks.  'device': the targeted loop on the device, one "
        "CUDA graph launch for the whole run, stopping at the same chunk "
        "boundary as the host loop for identical keys; requires --target",
    )
    sweep.add_argument(
        "--resume-force", action="store_true",
        help="when the checkpoint's chunk_trials disagree with this "
        "run's, discard it (with a QBACheckpointMismatch warning) and "
        "re-chunk from scratch instead of erroring; a config "
        "fingerprint mismatch is never forceable",
    )

    study = sub.add_parser(
        "study", help="success-rate curve over a swept parameter"
    )
    _add_config_args(study, trials_default=256)
    study.add_argument(
        "--param", required=True,
        choices=("size_l", "n_dishonest", "n_parties", "p_late"),
        help="config field to sweep (size_l is the security parameter)",
    )
    study.add_argument(
        "--values", required=True,
        help="comma-separated values, e.g. 1,2,4,8,16,32",
    )
    study.add_argument(
        "--plot", metavar="PNG", default=None,
        help="write the success-rate curve (requires matplotlib)",
    )

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
    _add_device_arg(serve)
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


def _cmd_sweep(args: argparse.Namespace, out) -> int:
    from qba_tpu_torch.obs import EventLog, PhaseTimers, render_sweep
    from qba_tpu_torch.sweep import run_sweep

    cfg = _config(args)
    with _telemetry(args, cfg, "sweep") as session:
        log = EventLog(stream=out)
        timers = PhaseTimers(spans=session.spans if session else None)
        res = run_sweep(
            cfg,
            n_chunks=args.n_chunks,
            chunk_trials=cfg.trials,
            checkpoint=args.checkpoint,
            log=log,
            timers=timers,
            target=args.target,
            resume_force=args.resume_force,
            dispatch=args.dispatch,
            device=_device(args),
        )
        # Wall time for throughput = dispatch + readback (disjoint: the
        # dispatch returns once the chunk is enqueued, the readback
        # waits); a device-loop run has one fenced span end to end.
        seconds = (
            timers.total("dispatch")
            + timers.total("readback")
            + timers.total("device_loop")
        ) or None
        print(
            render_sweep(cfg, res.success_rate, res.n_trials, seconds),
            file=out,
        )
        if res.stop is not None:
            line = (
                f"stop: {res.stop.reason} after {res.stop.n_trials} trials"
            )
            if res.stop.threshold is not None:
                line += f" (threshold {res.stop.threshold:g})"
            est = res.stop.estimate
            if est is not None:
                # The rule's own anytime-valid interval: safe to read at
                # the data-dependent stopping time.
                line += (
                    f"; {100 * est.confidence:g}% CI "
                    f"[{est.lo:.4f}, {est.hi:.4f}]"
                )
            print(line, file=out)
        if session is not None:
            # Certified rates in the telemetry manifest.
            session.extra["stats"] = res.stats_summary()
        if res.any_overflow:
            print("(mailbox slot overflow occurred in some chunks)", file=out)
        if args.plot:
            from qba_tpu_torch.obs.plots import plot_convergence

            print(
                f"convergence plot: {plot_convergence(res, args.plot)}",
                file=out,
            )
    return 0


def _cmd_study(args: argparse.Namespace, out) -> int:
    import dataclasses

    from qba_tpu_torch.backends.torch_backend import run_trials
    from qba_tpu_torch.obs.stats import study_breakdown

    cfg = _config(args)
    is_float = args.param == "p_late"
    if is_float and cfg.delivery != "racy":
        cfg = dataclasses.replace(cfg, delivery="racy")
    values = [
        float(x) if is_float else int(x) for x in args.values.split(",")
    ]
    rates = []
    for v in values:
        cfg_v = dataclasses.replace(cfg, **{args.param: v})
        res = run_trials(cfg_v, device=_device(args))
        rate = float(res.success_rate)
        rates.append(rate)
        print(f"{args.param}={v}: success_rate={rate:.4f} "
              f"({cfg_v.trials} trials)", file=out)
        # Success decomposed over commander honesty (Wilson 95%),
        # printed only when the split is non-trivial.
        if cfg_v.n_dishonest:
            b = study_breakdown(
                res.trials.success.cpu().numpy(),
                res.trials.honest[:, 0].cpu().numpy(),
            )
            va, ag = b["validity"], b["agreement_dishonest_c"]
            if va["n"]:
                print(
                    f"  validity (honest commander):  "
                    f"{va['rate']:.4f} [{va['lo']:.4f}, {va['hi']:.4f}] "
                    f"({va['k']}/{va['n']})",
                    file=out,
                )
            if ag["n"]:
                print(
                    f"  agreement (dishonest cmdr.):  "
                    f"{ag['rate']:.4f} [{ag['lo']:.4f}, {ag['hi']:.4f}] "
                    f"({ag['k']}/{ag['n']})",
                    file=out,
                )
    if args.plot:
        from qba_tpu_torch.obs.plots import plot_param_study

        path = plot_param_study(
            values, rates, cfg.trials, args.param, args.plot,
            log_x=args.param == "size_l" and min(values) > 0,
        )
        print(f"study plot: {path}", file=out)
    return 0


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
        device=_device(args),
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
    command = {"sweep": _cmd_sweep, "study": _cmd_study,
               "serve": _cmd_serve}[args.command]
    try:
        return command(args, out)
    except (ValueError, PlottingUnavailableError) as e:
        # Config validation, or --plot without matplotlib -> a clean CLI
        # failure; other errors keep their tracebacks.
        print(f"error: {e}", file=sys.stderr)
        return 2
