"""KI-2: the port's memory plans — the counterpart of
:mod:`qba_tpu.analysis.memory`.  Two parts:

* the device-memory price of a trial batch on the port's worker
  (:func:`trial_ceiling`), which the fleet's admission controller prices
  requests with, described below;
* the lint's plan audit (:func:`check_memory`, :func:`check_gf2_memory`):
  every kernel's shared memory a block (the per-round kernels'
  :func:`~qba_tpu_torch.ops.round_kernel_tiled.round_smem_bytes`, which
  ``check_round_smem`` prices, the megakernel's and its sharded entry's,
  the circuit kernel's routes and the sweep's tables) against the
  card's opt-in shared memory a block, read from the device
  (:func:`smem_budget`); the trial ceiling at the card's memory; the
  graph loops' carry bytes (:func:`device_loop_carry_bytes`); and the
  stabilizer path's packed tableaux per shot.

The JAX model prices a trial by the TPU's padded tiled pool against a
fixed HBM size.  Here a trial is priced by the buffers the port's worker
holds on its path, for the engine the worker resolves
(:func:`qba_tpu_torch.rounds.engine.resolve_round_engine` on the fleet's
device, so the two never disagree): on the keyed trial megakernel (one
launch a chunk) the kernel's two ping-pong pools and its outputs; on a
per-round kernel engine (``auto`` with counters, or one named by the
request) its pool and successor, a round's draws and the accepted
matrix; on ``xla`` (``auto`` on the CPU and past the 64-bit masks) the
eager dense mailbox, whose every round gives each receiver a copy of
every packet and compares their rows in pairs.  Both add the set-up's lists (or the gen entry's
operands where :func:`~qba_tpu_torch.rounds.engine.resolve_mega_gen`
picks it), the adversary context and keys, and the set-up's transients:
on the card's factorized path the set-up kernel's outputs (it keeps
its draws in registers and shared memory), elsewhere (the CPU, and the
eager draws of the other list paths) the eager set-up's int64 threefry
draws, several alive at once.

The card's memory is the caller's: :func:`device_memory_bytes` reads it
with ``nvidia-smi`` (or the host's memory for a CPU fleet) without
opening a CUDA context, so the fleet's front half can price requests
while the workers own the card.  :func:`visible_cards` is the one list
of cards the pool pins its replicas to and this module reads the
memory of.  Nothing here touches a device.

``chip_smoke.py``'s ``fleet_path`` holds :func:`batch_bytes` at or
above ``torch.cuda.max_memory_allocated`` (above the memory held before
the batch) for a 64-trial chunk and a 1000-trial batch at 11p/L64/d3
and 33p/L64/d10, for 33p ``stabilizer``, and for 11p batches on the
per-round ``pallas_fused`` and ``xla`` engines.  The sharded ceiling of a ``tp`` mesh waits for
ROADMAP A12b.
"""

from __future__ import annotations

import os
import subprocess
import warnings

from qba_tpu_torch.analysis.findings import Finding, Report

#: Memory a worker holds outside its batches: the CUDA context, the
#: kernels' modules, per-config tables and the caching allocator's
#: slack.
HBM_RESERVE = 2 * 2**30

#: Bytes a batch holds beyond its per-trial terms (the allocator rounds
#: each of a chunk's few hundred tensors up to 512 B).
BATCH_FIXED = 4 * 2**20

#: Safety factor on the per-trial terms: the model counts each buffer
#: once at its exact size, and the eager set-up's live set is bounded
#: by :data:`SETUP_LIVE` rather than traced.
MARGIN = 1.25

#: int64 draw arrays of the widest set-up shape alive at once: threefry
#: keeps its counters, keys and rounds' temporaries live together.
SETUP_LIVE = 12

#: Copies of one round's delivery alive at once on the ``xla`` engine:
#: every receiver's corrupted copy of every packet, its appended copy,
#: and the pairwise row comparison's boolean temporaries.
XLA_LIVE = 3

#: Resolved kernel engines that keep a pool per round on the device (the
#: other kernel engine, ``pallas_mega``, runs the whole trial in one
#: launch; ``xla`` is the eager dense mailbox).
PER_ROUND_ENGINES = ("pallas", "pallas_fused", "pallas_tiled")


def trial_bytes(cfg, device: str) -> dict[str, int]:
    """Bytes one trial of ``cfg`` holds on ``device`` (``"cuda"`` or
    ``"cpu"``), by term, for the engine and list source the worker
    resolves there."""
    from qba_tpu_torch.ops.trial_megakernel import mega_entry_bytes
    from qba_tpu_torch.rounds.engine import resolve_mega_gen, resolve_round_engine

    with warnings.catch_warnings():
        # A demotion is the worker's to report; pricing only follows it.
        warnings.simplefilter("ignore")
        engine = resolve_round_engine(cfg, device)
        gen = resolve_mega_gen(cfg, device)
    n, n_rv, s, w = cfg.n_parties, cfg.n_lieutenants, cfg.size_l, cfg.w
    n_pool = n_rv * cfg.slots
    terms: dict[str, int] = {}
    if device == "cuda" and cfg.qsim_path == "factorized":
        # The set-up kernel's outputs: the lieutenants' int32 lists and
        # their P rows, then the honesty, orders, target and keys; the
        # kernel holds no temporaries in device memory.
        lists = n_rv * s * (4 + 1)
        transient = (n + 1) + n_rv * 4 + 4 + 4 + 2 * 16
    else:
        # The lists (int32, every party), the lieutenants' int32 copy and
        # their P rows; a position's n draws in int64, made eagerly.
        lists = (n + 1) * s * 4 + n_rv * s * (4 + 1)
        transient = SETUP_LIVE * s * (n + 1) * 8
    if cfg.qsim_path == "stabilizer":
        # The gen operands (coins and parities per position and qubit)
        # and their int64 threefry draws; generated on the host side,
        # the lists are made from them as well.
        ops = s * cfg.total_qubits * (4 + 1 + 1)
        ops_transient = SETUP_LIVE * s * cfg.total_qubits * 8
        if gen == "gf2":
            lists, transient = ops, ops_transient
        else:
            lists, transient = lists + ops, max(transient, ops_transient)
    terms["lists"] = lists
    terms["setup_transient"] = transient
    terms["context"] = 16 + 16 + n_pool * 4 + (n + 1) * 4 + 64
    terms["outputs"] = n_rv * w * (4 + 1) + (n + 1) * 4 * 2 + 16
    if engine == "xla":
        # The dense mailbox pair (int32 values), then each round every
        # receiver's copy of every packet and the consistency check's
        # row pairs, bool [receivers, packets, max_l, max_l, size_l].
        cell = cfg.max_l * s * 4 + cfg.max_l * 4 + s + 16
        terms["pools"] = 2 * n_pool * cell
        terms["delivery"] = XLA_LIVE * n_rv * n_pool * cell
        terms["collide"] = XLA_LIVE * n_rv * n_pool * cfg.max_l ** 2 * s
        terms["accepted"] = n_rv * n_pool * (w + 8 + 8 + n_rv)
    elif engine in PER_ROUND_ENGINES:
        pool = n_pool * (cfg.max_l * s + cfg.max_l * 4 + s + 16)
        terms["pools"] = 2 * pool
        terms["draws"] = 3 * n_pool * n_rv
        terms["accepted"] = n_pool * n_rv * 4
        terms["vi"] = n_rv * w * 4
    else:
        terms["pools"] = 2 * n_pool * mega_entry_bytes(cfg)
    return terms


def per_trial_bytes(cfg, device: str) -> int:
    """The priced bytes of one trial: :func:`trial_bytes`'s sum times
    :data:`MARGIN`."""
    return int(MARGIN * sum(trial_bytes(cfg, device).values()))


def batch_bytes(cfg, n_trials: int, device: str) -> int:
    """The priced bytes of a batch of ``n_trials``."""
    return BATCH_FIXED + n_trials * per_trial_bytes(cfg, device)


def trial_ceiling(cfg, hbm_bytes: int, device: str) -> int:
    """Most trials of ``cfg`` a batch may hold on a ``device`` of
    ``hbm_bytes``, after :data:`HBM_RESERVE` and :data:`BATCH_FIXED`
    (0 where not even those fit)."""
    room = hbm_bytes - HBM_RESERVE - BATCH_FIXED
    return max(0, room // per_trial_bytes(cfg, device))


def visible_cards() -> list[str]:
    """The cards this process may hand its workers, as
    ``CUDA_VISIBLE_DEVICES`` entries: the inherited variable's entries
    where it is set (a job given cards 2 and 5 keeps to them), else
    every index ``nvidia-smi`` lists (none where it does not answer).
    Read without opening a CUDA context."""
    inherited = os.environ.get("CUDA_VISIBLE_DEVICES")
    if inherited is not None:
        return [e.strip() for e in inherited.split(",") if e.strip()]
    return [row[0] for row in _smi_cards()]


def _smi_cards() -> list[tuple[str, str, int]]:
    """``(index, uuid, memory bytes)`` of each card ``nvidia-smi``
    lists; empty where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,uuid,memory.total",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    cards = []
    for line in out.stdout.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 3 and fields[2].isdigit():
            cards.append((fields[0], fields[1], int(fields[2]) * 2**20))
    return cards


def device_memory_bytes(device: str) -> int:
    """The memory of one device the workers run on, read without
    opening a CUDA context: for ``"cuda"`` the smallest ``memory.total``
    among :func:`visible_cards` (an entry names a card by index or by a
    prefix of its UUID, as CUDA reads it), for ``"cpu"`` the host's
    physical memory.  Raises ``ValueError`` for ``"cuda"`` where no
    visible card answers ``nvidia-smi``."""
    if device == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    cards = _smi_cards()
    sizes = [mem for entry in visible_cards() for index, uuid, mem in cards
             if entry == index or uuid.startswith(entry)]
    if not sizes:
        raise ValueError("no visible CUDA card answers nvidia-smi: the "
                         "fleet's device memory is unknown (pass --device "
                         "cpu for a CPU fleet)")
    return min(sizes)


# ---------------------------------------------------------------------------
# The lint's plan audit (KI-2).

#: A graph loop's carry is priced at 64 chunks of 1000 trials.
LOOP_CHUNKS, LOOP_CHUNK_TRIALS = 64, 1000


def smem_budget(device) -> int:
    """Shared memory one block may opt in to: read from a CUDA
    ``device``, else the H100's (``SMEM_LIMIT``, which the kernels'
    host checks use)."""
    from qba_tpu_torch.ops.round_kernel_tiled import SMEM_LIMIT

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return SMEM_LIMIT
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def kernel_plans(cfg, budget: int) -> list[tuple[str, int]]:
    """``(plan, shared bytes a block)`` of every kernel that could run
    ``cfg`` (none past the kernels' 64-bit masks, which refuse it): the
    per-round kernels single-device and at each ``tp`` of 2, 4 and 8
    that divides the lieutenants, the megakernel (staged where its
    staged layout fits ``budget``, as the kernel chooses) and its
    sharded entry where a plan admits it, the sweep's shared tables
    and the circuit kernel's block and cluster routes."""
    from qba_tpu_torch.ops import fused_circuit as fc
    from qba_tpu_torch.ops._launch import masks_fit
    from qba_tpu_torch.ops.gf2_sweep import SMEM_TABLES
    from qba_tpu_torch.ops.round_kernel_tiled import (
        round_smem_bytes,
        sharded_mega_plan,
    )
    from qba_tpu_torch.ops.trial_megakernel import (
        mega_smem_bytes,
        mega_staged,
    )

    if not masks_fit(cfg):
        return []
    plans = [
        ("pallas_fused/round", round_smem_bytes(cfg)),  # round_step's too
        ("pallas_tiled/verdict", round_smem_bytes(cfg, slots=False)),
        ("pallas_tiled/rebuild", round_smem_bytes(cfg, verdict=False)),
        ("pallas_mega/trial", mega_smem_bytes(
            cfg, staged=mega_staged(cfg, limit=budget))),
    ]
    for tp in (2, 4, 8):
        if cfg.n_lieutenants % tp:
            continue
        n_local = cfg.n_lieutenants // tp
        plans.append((f"spmd[tp={tp}]/pallas_fused/round",
                      round_smem_bytes(cfg, n_local)))
        if sharded_mega_plan(cfg, tp) is not None:
            plans.append((f"spmd[tp={tp}]/pallas_mega/trial", mega_smem_bytes(
                cfg, tp, staged=mega_staged(cfg, tp, limit=budget))))
    if cfg.qsim_path == "stabilizer":
        plans.append(("gf2_sweep/tables", SMEM_TABLES))
    if cfg.qsim_path == "dense_pallas":
        plans.append(("fused_circuit/block", fc.BLOCK_STATE_BYTES))
        plans.append(("fused_circuit/cluster", fc.BLOCK_STATE_BYTES))
    return plans


def device_loop_carry_bytes(n_chunks: int, chunk_trials: int,
                            n_cells: int = 1,
                            per_trial_bits: bool = False) -> int:
    """Bytes the graph loops keep on the card beside a chunk's own
    working set: the sweep's carry (``sweep_loop.new_carry``) and its
    stop tables; for a surface of ``n_cells`` cells its carry
    (``surface_loop.SurfaceLayout``, ``n_chunks`` a cell and as many
    passes as chunks in all); with ``per_trial_bits`` the serving
    worker's success bits, key table and row offsets."""
    from qba_tpu_torch.ops.surface_loop import SurfaceLayout
    from qba_tpu_torch.ops.sweep_loop import HEAD

    tables = 2 * (n_chunks + 1) * 4
    if n_cells > 1:
        carry = SurfaceLayout(n_cells, n_chunks, n_cells * n_chunks).size * 4
    else:
        carry = (HEAD + 2 * n_chunks) * 4
    if per_trial_bits:
        carry += n_chunks * chunk_trials * (1 + 16) + chunk_trials * 8
    return carry + tables


def check_memory(cfg, device) -> Report:
    """The KI-2 plan audit of one config on ``device`` (``"cuda"`` or
    ``"cpu"``): each kernel plan's shared memory against
    :func:`smem_budget`, the trial ceiling at the device's memory and
    the graph loops' carries."""
    import torch

    report = Report()
    budget = smem_budget(device)
    dev_type = torch.device(device).type
    plans = kernel_plans(cfg, budget)
    if not plans:
        report.notes.append(
            f"memory: {cfg.n_parties} parties pass the kernels' 64-bit "
            "masks; no kernel runs this config")
    for plan, nbytes in plans:
        if nbytes > budget:
            report.findings.append(Finding(
                ki="KI-2", check="smem-plan", path=plan,
                message=(
                    f"{nbytes} B of shared memory a block, over the "
                    f"{budget} B a block may opt in to on this "
                    f"{dev_type} device: the kernel would refuse the "
                    "config at launch"
                ),
            ))
    if plans:
        worst = max(plans, key=lambda p: p[1])
        report.notes.append(
            f"smem: {len(plans)} kernel plans, the largest {worst[0]} "
            f"{worst[1]} B of {budget} B a block")
    hbm = device_memory_bytes(dev_type)
    ceiling = trial_ceiling(cfg, hbm, dev_type)
    report.notes.append(
        f"hbm-ceiling: {per_trial_bytes(cfg, dev_type)} B a trial -> "
        f"{ceiling} trials a batch in {hbm} B")
    if ceiling < 1:
        report.findings.append(Finding(
            ki="KI-2", check="hbm-ceiling", path="batch",
            message=(
                f"one trial ({per_trial_bytes(cfg, dev_type)} B) does not "
                f"fit the device's {hbm} B after the worker's reserve"
            ),
        ))
    loops = {
        "sweep": device_loop_carry_bytes(LOOP_CHUNKS, LOOP_CHUNK_TRIALS),
        "serve": device_loop_carry_bytes(LOOP_CHUNKS, LOOP_CHUNK_TRIALS,
                                         per_trial_bits=True),
        "surface(16 cells)": device_loop_carry_bytes(
            LOOP_CHUNKS, LOOP_CHUNK_TRIALS, 16),
    }
    report.notes.append(
        f"device-loop-carry at {LOOP_CHUNKS} chunks of "
        f"{LOOP_CHUNK_TRIALS}: "
        + ", ".join(f"{k} {v} B" for k, v in loops.items()))
    over = {k: v for k, v in loops.items() if v > hbm - HBM_RESERVE}
    if over:
        report.findings.append(Finding(
            ki="KI-2", check="device-loop-carry", path="sweep/device",
            message=f"graph-loop carries {over} no longer fit the device",
        ))
    report.stats["smem_plans_checked"] = len(plans)
    return report


def gf2_tableau_bytes(cfg) -> dict:
    """Packed-tableau working set of one shot (one list position) of the
    stabilizer path: the x and z word planes ``[2n, W]`` (``W`` words
    of 32 qubits, held in int64), the phase vector, the coins and the
    output bits."""
    from qba_tpu_torch.gf2 import n_words

    n = cfg.total_qubits
    w = n_words(n)
    per_shot = 2 * (2 * n) * w * 8 + (2 * n + 2 * n) * 4 + 2 * n * 4
    return {"n_qubits": n, "words_per_row": w, "per_shot_bytes": per_shot}


def check_gf2_memory(cfg, device) -> Report:
    """KI-2 for the stabilizer path's packed tableaux: the shots
    (trials x list positions) the device's memory holds at once."""
    import torch

    report = Report()
    dev_type = torch.device(device).type
    tb = gf2_tableau_bytes(cfg)
    room = device_memory_bytes(dev_type) - HBM_RESERVE
    shots = max(0, room) // tb["per_shot_bytes"]
    trials = shots // max(cfg.size_l, 1)
    report.notes.append(
        f"gf2-tableau: {tb['n_qubits']} qubits packed to "
        f"{tb['words_per_row']} words a row, {tb['per_shot_bytes']} B a "
        f"shot -> {shots} shots, {trials} trials at size_l={cfg.size_l}")
    if trials < 1:
        report.findings.append(Finding(
            ki="KI-2", check="gf2-tableau", path="gf2/sampler",
            message=(
                f"one trial's packed tableaux ({cfg.size_l} positions x "
                f"{tb['per_shot_bytes']} B) do not fit the device"
            ),
        ))
    return report
