"""Device-memory price of a trial batch on the port's worker — the
counterpart of :func:`qba_tpu.analysis.memory.trial_ceiling` (and only
of it), which the fleet's admission controller prices requests with.

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
picks it), the adversary context and keys, and the transients of the
eager set-up, whose threefry draws are int64 tensors with several alive
at once.

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
    # The lists (int32, every party), the lieutenants' int32 copy and
    # their P rows; a position's n draws in int64.
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
