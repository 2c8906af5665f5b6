"""Command-line interface: ``python -m qba_tpu_torch
{sweep,study,serve,fleet,atlas,trace}`` — those subcommands of
:mod:`qba_tpu.cli`, with their flags, on the port.

* ``sweep`` — chunked, checkpoint-resumable Monte-Carlo sweep, fixed
  budget or precision-targeted (``--target``); ``--dispatch device`` runs
  the targeted loop as one CUDA graph (:mod:`qba_tpu_torch.sweep`).
* ``study`` — success-rate curve over a swept parameter (e.g. the
  security-parameter study in ``size_l``).
* ``serve`` — persistent evaluation service: answers request streams
  (stdin-JSONL or file-queue) with shape-bucketed, double-buffered
  dispatch and per-request run manifests (:mod:`qba_tpu_torch.serve`).
* ``fleet`` — N supervised ``serve`` workers behind a socket/HTTP JSONL
  front end with target-aware admission (:mod:`qba_tpu_torch.serve.fleet`).
* ``atlas`` — a (parties x dishonest x strategy x noise) campaign,
  every cell certified to a precision target, locally or through a
  fleet (:mod:`qba_tpu_torch.atlas`).
* ``trace`` — one fleet run's lifecycle events and worker span files
  stitched into per-request traces (:mod:`qba_tpu_torch.obs.tracing`).

Each runs on CUDA; ``--device cpu`` runs the plain PyTorch versions (a
fleet's workers too).  ``--plot`` needs matplotlib, and without it is a
clean usage error.

The JAX package's other subcommands are named here and refuse with the
ROADMAP item that ports them: ``bench`` (A11); ``run`` and ``lint``
(A13).  So do the fleet's mesh flags (A12b): the port's worker serves no
mesh.
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
_NOT_PORTED = {"run": "A13", "bench": "A11", "lint": "A13"}


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
    _add_fleet_parser(sub)
    _add_atlas_parser(sub)
    _add_trace_parser(sub)
    for name, item in _NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet (ROADMAP {item})",
                       add_help=False, prefix_chars="\0")
    return parser


def _add_fleet_parser(sub) -> None:
    fleet = sub.add_parser(
        "fleet",
        help="multi-replica serving: socket/HTTP front end + N card-"
        "pinned serve workers over one shared file queue, with target-"
        "aware admission",
    )
    fleet.add_argument(
        "--queue-dir", metavar="DIR", required=True,
        help="shared queue directory (created if missing); the fleet "
        "summary lands here as fleet_summary.json",
    )
    fleet.add_argument(
        "--replicas", type=int, default=2,
        help="worker processes; each runs the file-queue serve loop "
        "pinned to one card (CUDA_VISIBLE_DEVICES: replica K on card K "
        "modulo the cards)",
    )
    fleet.add_argument("--host", default="127.0.0.1",
                       help="front-end listen address")
    fleet.add_argument(
        "--port", type=int, default=0,
        help="front-end listen port (0 = ephemeral; the bound port is "
        "printed to stderr at boot)",
    )
    fleet.add_argument(
        "--chunk-trials", type=int, default=64,
        help="trials per device chunk (shared by workers and the "
        "admission price quantizer)",
    )
    fleet.add_argument("--depth", type=int, default=2,
                       help="per-replica double-buffer depth")
    fleet.add_argument(
        "--cache-dir", metavar="DIR", default=None,
        help="shared warm-start artifact directory; the plans.json "
        "file lock makes concurrent replica boots/saves safe",
    )
    fleet.add_argument(
        "--telemetry", metavar="DIR", default=None,
        help="per-request telemetry root shared by all replicas (each "
        "request dir carries its replica_id)",
    )
    fleet.add_argument(
        "--deadline-s", type=float, default=None,
        help="per-request wall-clock deadline inside each worker",
    )
    fleet.add_argument(
        "--reclaim-timeout-s", type=float,
        default=_timing.RECLAIM_TIMEOUT_S,
        help="crash recovery: claims older than this with no result "
        "are pushed back to the inbox for a surviving replica",
    )
    fleet.add_argument(
        "--max-reclaims", type=int, default=_timing.MAX_RECLAIMS,
        help="reclaim attempts per request before dead-lettering",
    )
    fleet.add_argument(
        "--max-requests", type=int, default=None,
        help="front end exits after fully answering this many "
        "requests; default: run until SIGINT",
    )
    fleet.add_argument(
        "--no-admission", action="store_true",
        help="disable the admission layer (every request goes straight "
        "to the queue; no pricing, no defer/reject)",
    )
    fleet.add_argument(
        "--capacity-trials", type=int, default=None,
        help="admission window: max priced-but-unsettled trials "
        "fleet-wide (default: replicas * window-chunks * chunk-trials)",
    )
    fleet.add_argument(
        "--window-chunks", type=int, default=8,
        help="per-replica chunks of headroom in the default capacity "
        "window",
    )
    fleet.add_argument(
        "--mesh-dp", type=int, default=None,
        help="not ported (ROADMAP A12b): the port's worker serves no mesh",
    )
    fleet.add_argument(
        "--mesh-tp", type=int, default=None,
        help="not ported (ROADMAP A12b): the port's worker serves no mesh",
    )
    fleet.add_argument(
        "--tp-comms", default=None, choices=("ring", "all_gather"),
        help="not ported (ROADMAP A12b): the port's worker serves no mesh",
    )
    fleet.add_argument(
        "--poll-s", type=float, default=_timing.WORKER_POLL_S,
        help="worker inbox poll interval (the front-end outbox poll "
        "runs at timing.FRONTEND_POLL_S)",
    )
    fleet.add_argument(
        "--supervise", action="store_true",
        help="run the self-healing supervisor: heartbeat watchdog "
        "(SIGKILL hung workers), immediate claim release + poison "
        "quarantine on worker death, crash-loop breaker, respawn "
        "with backoff",
    )
    fleet.add_argument(
        "--watchdog-s", type=float, default=_timing.WATCHDOG_S,
        help="base heartbeat staleness budget; the compile phase (a "
        "bucket's first dispatch: its kernels' build and load) gets "
        "timing.WATCHDOG_PHASE_SCALE x",
    )
    fleet.add_argument(
        "--breaker-k", type=int, default=_timing.BREAKER_K,
        help="crash-loop breaker: deaths of one replica slot inside "
        "--breaker-window-s that bench it for good",
    )
    fleet.add_argument(
        "--breaker-window-s", type=float,
        default=_timing.BREAKER_WINDOW_S,
        help="crash-loop breaker window (seconds)",
    )
    fleet.add_argument(
        "--poison-threshold", type=int, default=_timing.POISON_THRESHOLD,
        help="worker deaths blamed on one request before it is "
        "quarantined (dead-lettered with a crash report)",
    )
    fleet.add_argument(
        "--max-respawns", type=int, default=_timing.MAX_RESPAWNS,
        help="respawns per replica slot before it is benched",
    )
    fleet.add_argument(
        "--respawn-backoff-s", type=float,
        default=_timing.RESPAWN_BACKOFF_S,
        help="base exponential backoff between respawns of one slot",
    )
    _add_device_arg(fleet)


def _add_atlas_parser(sub) -> None:
    atlas = sub.add_parser(
        "atlas",
        help="4-D validity-atlas campaign: enumerate the (parties x "
        "dishonest x strategy x noise) cube, certify every cell to a "
        "precision target, and render the phase diagram",
    )
    atlas.add_argument(
        "--store", metavar="DIR", required=True,
        help="atlas store directory (content-addressed cell records + "
        "campaign ledger + rendered atlas.json); resumable: an "
        "interrupted campaign restarts from the ledger here",
    )
    atlas.add_argument("--parties", type=int, nargs="+", required=True,
                       help="party counts, e.g. --parties 4 7 13")
    atlas.add_argument(
        "--dishonest", nargs="+", required=True,
        help="traitor counts (integers) and/or fractions of n "
        "('1/3', '0.4'), resolved per party count, e.g. "
        "--dishonest 0 1 1/3",
    )
    atlas.add_argument(
        "--strategies", nargs="+", default=["reference"],
        help="adversary strategies (reference collude adaptive split)",
    )
    atlas.add_argument(
        "--noise", nargs="+", default=["0:0"], metavar="P:Q",
        help="noise points as p_depolarize:p_measure_flip pairs, e.g. "
        "--noise 0:0 0.01:0 0:0.02",
    )
    atlas.add_argument("--size-l", type=int, default=4, help="protocol sizeL")
    atlas.add_argument("--seed", type=int, default=0, help="campaign seed")
    atlas.add_argument(
        "--target", default="decide vs 1/3 @ 95%",
        help="per-cell precision target (stats target grammar)",
    )
    atlas.add_argument(
        "--budget-trials", type=int, default=1024,
        help="wave-0 per-cell trial budget; unresolved cells escalate",
    )
    atlas.add_argument(
        "--escalation", type=float, default=4.0,
        help="budget multiplier per escalation wave (frontier cells "
        "only; interior cells resolve on wave 0)",
    )
    atlas.add_argument(
        "--max-escalations", type=int, default=2,
        help="escalation waves before a cell is refused as truncated",
    )
    atlas.add_argument(
        "--chunk-trials", type=int, default=64,
        help="trials per device chunk (shared with admission pricing)",
    )
    atlas.add_argument("--engine", default="auto",
                       help="round engine for every cell")
    atlas.add_argument(
        "--executor", choices=("local", "fleet"), default="local",
        help="local = in-process server; fleet = file-queue replicas "
        "under this driver (needs --queue-dir)",
    )
    atlas.add_argument("--queue-dir", metavar="DIR", default=None,
                       help="fleet executor: shared queue directory")
    atlas.add_argument("--replicas", type=int, default=2,
                       help="fleet executor: worker processes")
    atlas.add_argument(
        "--supervise", action="store_true",
        help="fleet executor: run the self-healing supervisor "
        "(watchdog, claim release, poison quarantine, respawn)",
    )
    atlas.add_argument("--cache-dir", metavar="DIR", default=None,
                       help="shared warm-start artifact directory")
    atlas.add_argument("--telemetry", metavar="DIR", default=None,
                       help="per-request telemetry root")
    atlas.add_argument(
        "--capacity-trials", type=int, default=None,
        help="admission window override (default: replicas * 8 chunks)",
    )
    atlas.add_argument("--window-chunks", type=int, default=8,
                       help="per-replica chunks of admission headroom")
    atlas.add_argument(
        "--chaos-kill", action="store_true",
        help="fleet executor: SIGKILL one worker after the first "
        "result lands (the supervisor + campaign ledger must finish "
        "the cube anyway)",
    )
    atlas.add_argument(
        "--max-results", type=int, default=None,
        help="interrupt the driver after N processed results (exit 3; "
        "re-run with the same spec to resume from the ledger)",
    )
    atlas.add_argument(
        "--plot", metavar="DIR", default=None,
        help="also render per-slice PNGs + the noise fence figure into "
        "DIR (requires matplotlib)",
    )
    _add_device_arg(atlas)


def _add_trace_parser(sub) -> None:
    trace = sub.add_parser(
        "trace",
        help="stitch one fleet run's lifecycle events + worker span "
        "files into causal per-request traces; print the summary or "
        "export Perfetto-loadable trace JSON",
    )
    trace.add_argument(
        "trace_id", nargs="?", default=None,
        help="a trace id (or request id) to select; omitted = all "
        "stitched traces",
    )
    trace.add_argument(
        "--queue-dir", metavar="DIR", required=True,
        help="the fleet queue directory (holds trace-events.jsonl)",
    )
    trace.add_argument(
        "--telemetry", metavar="DIR", default=None,
        help="per-request telemetry root with the worker span files; "
        "without it traces stitch from lifecycle events alone",
    )
    trace.add_argument(
        "--out", metavar="PATH", default=None,
        help="write Chrome/Perfetto trace-event JSON here instead of "
        "printing the stitched summary",
    )


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


def _cmd_trace(args: argparse.Namespace, out) -> int:
    from qba_tpu_torch.obs.tracing import (
        stitch_traces,
        stitched_chrome_trace,
        trace_summary,
    )

    stitched = stitch_traces(args.queue_dir, telemetry_dir=args.telemetry)
    traces = stitched["traces"]
    selected = sorted(traces)
    if args.trace_id is not None:
        selected = [
            tid for tid, t in traces.items()
            if tid == args.trace_id
            or tid.startswith(args.trace_id)
            or t.get("request_id") == args.trace_id
        ]
        if not selected:
            print(
                f"error: no stitched trace matches {args.trace_id!r} "
                f"({len(traces)} trace(s) in {args.queue_dir})",
                file=sys.stderr,
            )
            return 1
    if args.out:
        chrome = stitched_chrome_trace(stitched, trace_ids=selected)
        with open(args.out, "w") as fh:
            json.dump(chrome, fh, indent=1)
        print(json.dumps({"trace_json": args.out, "traces": len(selected),
                          "events": len(chrome["traceEvents"])}), file=out)
        return 0
    payload = {
        "summary": trace_summary(stitched),
        "traces": [
            {
                "trace_id": tid,
                "request_id": traces[tid].get("request_id"),
                "closed": traces[tid]["closed"],
                "dur_s": round(traces[tid]["dur"], 6),
                "coverage": traces[tid]["coverage"],
                "segments": traces[tid]["segments"],
                "events": [e["event"] for e in traces[tid]["events"]],
            }
            for tid in selected
        ],
    }
    print(json.dumps(payload, indent=1, default=str), file=out)
    return 0


def _start_supervisor(supervisor):
    """Run ``supervisor`` on a daemon thread; returns ``(stop_event,
    thread)`` (the thread None without a supervisor)."""
    import threading

    stop = threading.Event()
    if supervisor is None:
        return stop, None
    thread = threading.Thread(target=supervisor.run, args=(stop,),
                              daemon=True)
    thread.start()
    return stop, thread


def _cmd_atlas(args: argparse.Namespace, out) -> int:
    import time

    from qba_tpu_torch.analysis.memory import device_memory_bytes
    from qba_tpu_torch.atlas import (
        AtlasStore,
        CampaignDriver,
        CampaignSpec,
        FleetExecutor,
        LocalExecutor,
    )
    from qba_tpu_torch.atlas.cube import parse_dishonest
    from qba_tpu_torch.serve.fleet import AdmissionController

    noise: list[tuple[float, float]] = []
    for tok in args.noise:
        p, sep, q = tok.partition(":")
        if not sep:
            raise ValueError(
                f"--noise wants p_depolarize:p_measure_flip, got {tok!r}")
        noise.append((float(p), float(q or 0)))
    spec = CampaignSpec(
        parties=tuple(args.parties),
        dishonest=parse_dishonest(args.dishonest),
        strategies=tuple(args.strategies),
        noise_points=tuple(noise),
        size_l=args.size_l,
        seed=args.seed,
        chunk_trials=args.chunk_trials,
        budget_trials=args.budget_trials,
        escalation=args.escalation,
        max_escalations=args.max_escalations,
        target=args.target,
        round_engine=args.engine,
    )
    store = AtlasStore(args.store)
    admission = AdmissionController(
        chunk_trials=args.chunk_trials,
        replicas=args.replicas if args.executor == "fleet" else 1,
        capacity_trials=args.capacity_trials,
        window_chunks=args.window_chunks,
        hbm_bytes=device_memory_bytes(args.device),
        device=args.device,
    )
    pool = supervisor = None
    on_result = None
    t0 = time.monotonic()
    if args.executor == "fleet":
        if not args.queue_dir:
            raise ValueError("--executor fleet requires --queue-dir")
        from qba_tpu_torch.serve.fleet import FleetSupervisor, ReplicaPool

        executor = FleetExecutor(args.queue_dir)
        pool = ReplicaPool(
            args.queue_dir,
            replicas=args.replicas,
            chunk_trials=args.chunk_trials,
            cache_dir=args.cache_dir,
            telemetry_dir=args.telemetry,
            device=args.device,
        )
        if args.supervise:
            supervisor = FleetSupervisor(pool, admission=admission)
        if args.chaos_kill:
            killed = []

            def on_result(count: int, payload: dict) -> None:
                # One SIGKILL, after the first result proves the fleet
                # works: the supervisor + ledger must finish the cube.
                if count == 1 and not killed:
                    alive = pool.alive()
                    if alive:
                        victim = alive[-1]
                        pid = pool.kill(victim)
                        killed.append(victim)
                        print(json.dumps({"chaos": {"killed": victim,
                                                    "pid": pid}}),
                              file=sys.stderr, flush=True)

        pool.start()
    else:
        executor = LocalExecutor(
            chunk_trials=args.chunk_trials,
            cache_dir=args.cache_dir,
            telemetry_dir=args.telemetry,
            device=_device(args),
        )
    sup_stop, sup_thread = _start_supervisor(supervisor)
    driver = CampaignDriver(
        store,
        spec,
        executor,
        admission=admission,
        log=lambda s: print(s, file=sys.stderr, flush=True),
        max_results=args.max_results,
        on_result=on_result,
    )
    try:
        summary = driver.run()
    finally:
        # Stop supervising BEFORE stopping the pool (as `fleet` does: a
        # draining worker must not be watchdogged).
        sup_stop.set()
        if sup_thread is not None:
            sup_thread.join(timeout=30)
        if pool is not None:
            pool.stop()
    summary["elapsed_s"] = time.monotonic() - t0
    if supervisor is not None:
        summary["self_healing"] = supervisor.summary()
    if args.plot:
        from qba_tpu_torch.atlas import plot_slices

        written = plot_slices(store, args.plot)
        if not written:
            raise PlottingUnavailableError(
                "--plot requires matplotlib, which is not importable")
        summary["plots"] = written
    print(json.dumps({"atlas": summary}, indent=1, default=str), file=out)
    if summary.get("interrupted"):
        return 3
    return 0 if summary["open"] == 0 else 1


def _cmd_fleet(args: argparse.Namespace, out) -> int:
    import time

    from qba_tpu_torch.analysis.memory import device_memory_bytes
    from qba_tpu_torch.serve.fleet import (
        AdmissionController,
        FleetFrontend,
        FleetSupervisor,
        ReplicaPool,
        fleet_summary,
        write_fleet_summary,
    )
    from qba_tpu_torch.serve.persist import saved_mesh

    if (args.mesh_dp, args.mesh_tp, args.tp_comms) != (None, None, None):
        raise ValueError("--mesh-dp, --mesh-tp and --tp-comms are not "
                         "ported: the port's worker serves no mesh "
                         "(ROADMAP A12b)")
    # A mesh recorded in the warm-start artifact (by the JAX package's
    # fleet) prices as it does there; the controller refuses tp > 1.
    mesh_shape = None
    recorded = saved_mesh(args.cache_dir) if args.cache_dir else None
    if recorded is not None:
        mesh_shape = (int(recorded.get("dp", 1)), int(recorded.get("tp", 1)))
    admission = None
    if not args.no_admission:
        admission = AdmissionController(
            chunk_trials=args.chunk_trials,
            replicas=args.replicas,
            capacity_trials=args.capacity_trials,
            window_chunks=args.window_chunks,
            hbm_bytes=device_memory_bytes(args.device),
            device=args.device,
            mesh_shape=mesh_shape,
        )
    pool = ReplicaPool(
        args.queue_dir,
        replicas=args.replicas,
        chunk_trials=args.chunk_trials,
        depth=args.depth,
        cache_dir=args.cache_dir,
        telemetry_dir=args.telemetry,
        deadline_s=args.deadline_s,
        reclaim_timeout_s=args.reclaim_timeout_s,
        max_reclaims=args.max_reclaims,
        poll_s=args.poll_s,
        device=args.device,
        max_respawns=args.max_respawns,
        respawn_backoff_s=args.respawn_backoff_s,
    )
    supervisor = None
    if args.supervise:
        supervisor = FleetSupervisor(
            pool,
            admission=admission,
            watchdog_s=args.watchdog_s,
            breaker_k=args.breaker_k,
            breaker_window_s=args.breaker_window_s,
            poison_threshold=args.poison_threshold,
        )
    frontend = FleetFrontend(
        args.queue_dir,
        admission,
        host=args.host,
        port=args.port,
        max_requests=args.max_requests,
        health_provider=supervisor.health if supervisor else None,
    )
    t0 = time.monotonic()
    pool.start()
    sup_stop, sup_thread = _start_supervisor(supervisor)
    try:
        port = frontend.start_in_thread()
        print(json.dumps({"fleet": {
            "listening": f"{args.host}:{port}",
            "replicas": pool.alive(),
            "queue_dir": args.queue_dir,
            "supervised": supervisor is not None,
            "device": args.device,
        }}), file=sys.stderr, flush=True)
        try:
            frontend._thread.join()
        except KeyboardInterrupt:
            frontend.stop_in_thread()
    finally:
        # Stop supervising BEFORE dropping the stop sentinel: workers
        # draining a slow flush must not be watchdogged or "respawned"
        # into a stopping queue.
        sup_stop.set()
        if sup_thread is not None:
            sup_thread.join(timeout=30)
        codes = pool.stop()
    summary = fleet_summary(
        args.queue_dir,
        admission_summary=admission.summary() if admission else None,
        frontend_status=frontend.status(),
        elapsed_s=time.monotonic() - t0,
        telemetry_dir=args.telemetry,
        self_healing=supervisor.summary() if supervisor else None,
    )
    summary["replica_exit_codes"] = codes
    path = write_fleet_summary(args.queue_dir, summary)
    print(json.dumps({"fleet_summary": path}), file=sys.stderr)
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
               "serve": _cmd_serve, "fleet": _cmd_fleet,
               "atlas": _cmd_atlas, "trace": _cmd_trace}[args.command]
    try:
        return command(args, out)
    except (ValueError, PlottingUnavailableError) as e:
        # Config validation, or --plot without matplotlib -> a clean CLI
        # failure; other errors keep their tracebacks.
        print(f"error: {e}", file=sys.stderr)
        return 2
