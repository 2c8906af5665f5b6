"""KI-5 carry audit — the counterpart of :mod:`qba_tpu.analysis.effects`.

The JAX package's per-round engines keep their pool in HBM across the
round scan by donation: each kernel's ``input_output_aliases`` hands
the carried buffer back to the next iteration, and its audit chases
every scan carry through the jaxpr.  The port's per-round engines
(:func:`qba_tpu_torch.rounds.engine._run_rounds_kernel`) allocate the
pool (or packed mailbox) and a spare once a batch and ping-pong between
them: round ``r`` reads one and writes the other through the kernel's
``out=``.  Over a warm batch of each per-round engine
(:func:`~qba_tpu_torch.analysis.trace.trace_batch`) this pass checks

* **the ping-pong pair** — the carry a round's kernel reads alternates
  between two buffers: round 2 reads another than round 1, and every
  later round the one two rounds back (a loop that allocated a fresh
  pool each round reads a new buffer every round);
* **the writes** — every round's carry has the first round's shapes
  and dtypes (a wrapper writes into ``out`` with its input's layout);
* **no pool-sized allocation in a round** — on the card: no tensor
  allocated between the first and the last round as large as the
  carry's largest leaf, and each round's bytes allocated
  (``torch.cuda.memory_stats()["allocated_bytes.all.allocated"]``)
  below the pool's.  The plain versions the CPU runs compute each
  round's pool anew and copy it into ``out``, so there only the first
  two checks run.

The JAX package's ``check_jit_donation`` has no counterpart: the port
has no ``jit``, so no ``donate_argnums`` claim exists to audit.  The
megakernel has no host carry (its pools live in the launch); its
one-launch contract is pinned by :mod:`.launches`.

Findings are tagged ``KI-5``.
"""

from __future__ import annotations

from qba_tpu_torch.analysis.findings import Finding, Report

#: The per-round engines, whose round loops carry a pool or mailbox.
CARRY_ENGINES = ("pallas", "pallas_tiled", "pallas_fused")


def audit_carry(rec, n_rounds: int) -> Report:
    """The ping-pong, write and allocation checks over one traced batch
    (:class:`~qba_tpu_torch.analysis.trace.BatchTrace`)."""
    report = Report()
    ptrs = [c[1] for c in rec.carry]
    layouts = [c[2] for c in rec.carry]

    def finding(check, message):
        report.findings.append(Finding(ki="KI-5", check=check,
                                       path=rec.path, message=message))

    if len(ptrs) != n_rounds:
        finding("carry-donation", f"{len(ptrs)} carried rounds seen, the "
                f"config has {n_rounds}")
        return report
    broken = [r + 1 for r in range(1, len(ptrs))
              if ptrs[r] == ptrs[r - 1]
              or (r >= 2 and ptrs[r] != ptrs[r - 2])]
    if broken:
        finding("carry-donation",
                f"round(s) {broken} read a carry outside the batch's "
                f"ping-pong pair ({len(set(ptrs))} distinct buffers over "
                f"{n_rounds} rounds): a round allocated a fresh pool "
                "instead of writing the spare through out=")
    if any(lay != layouts[0] for lay in layouts):
        finding("carry-layout",
                "a round's carry differs from the first round's shapes or "
                f"dtypes: {sorted(set(layouts))[:2]} — a wrapper wrote its "
                "output in another layout than its input's")
    if rec.device == "cuda" and layouts:
        leaves = [nbytes for _shape, _dtype, nbytes in layouts[0]]
        big = [a for a in rec.allocs
               if 1 <= a[2] <= n_rounds and a[1] >= max(leaves)]
        for op, nbytes, r, site in big[:3]:
            finding("carry-alloc",
                    f"round {r} allocated {nbytes} B ({op} at {site}), as "
                    f"large as the carry's largest leaf ({max(leaves)} B)")
        deltas = [b - a for a, b in zip(rec.round_bytes,
                                        rec.round_bytes[1:])]
        over = [(r + 1, d) for r, d in enumerate(deltas) if d >= sum(leaves)]
        if over:
            finding("carry-alloc",
                    f"rounds {over} allocated at least the pool's "
                    f"{sum(leaves)} B (torch.cuda.memory_stats)")
        report.stats.setdefault("round_alloc_bytes", {})[rec.path] = deltas
    if not report.findings:
        report.notes.append(
            f"effects/{rec.path}: carry ping-pongs between 2 buffers over "
            f"{n_rounds} rounds" + (
                f"; rounds allocate {max(deltas, default=0)} B at most, "
                f"pool {sum(leaves)} B" if rec.device == "cuda" else ""))
    return report


def check_effects(label: str, cfg, engines, device, trials: int) -> Report:
    """The KI-5 carry audit of each per-round engine in ``engines``."""
    from qba_tpu_torch.analysis.trace import batch_error, trace_batch

    report = Report()
    audited = 0
    for engine in CARRY_ENGINES:
        if engine not in engines:
            continue
        rec = trace_batch(label, cfg, engine, device, trials)
        if rec.error:
            report.findings.append(batch_error(rec))
            continue
        if rec.refused or rec.demoted:
            report.notes.append(f"effects/{rec.path}: "
                                f"{rec.refused or rec.demoted} — skipped")
            continue
        audited += 1
        report.extend(audit_carry(rec, cfg.n_rounds))
    report.stats["carry_engines_audited"] = audited
    return report
