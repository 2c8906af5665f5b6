"""KI-10: exhaustive model check of the fleet's file-queue protocol —
the counterpart of :mod:`qba_tpu.analysis.protocol` over the port's
``qba_tpu_torch/serve``.

The claim/reclaim/heartbeat/poison/breaker protocol under
``qba_tpu_torch/serve`` is the transport the atlas campaign rides on.
Its unbounded interleavings are reduced to small bounded
configurations whose every schedule a BFS enumerates
(:mod:`qba_tpu_torch.analysis.fsm`), and a violation is reported as a
*minimal counterexample schedule*.

Three layers make this a static-analysis pass, not a free-floating
model:

1. **Extracted semantics** — the model's behavioral switches (does the
   claim re-stamp the mtime?  does the reclaimer emit only at
   dead-letter?  is the stop sentinel checked after the drain?) are
   read from the AST of ``serve/transport.py`` itself, so the model
   checks the code that ships, and the seeded fixtures under
   ``tests/analysis_fixtures/`` are checked by the *same* extraction
   over their bad function bodies.
2. **Conformance** — every filesystem mutation on a queue path
   (``os.replace``/``rename``/``unlink``/``remove``/``utime``
   anywhere under ``serve/``) must carry a ``# qba-protocol:
   <transition>`` annotation binding it to a model transition, and
   every registered code site must still exist.
3. **Timing constants** — the model's bounds (reclaim ladder, poison
   threshold) are imported from :mod:`qba_tpu_torch.serve.timing`, the
   module the port's worker and supervisor read, so model and fleet
   cannot drift.

Timer/crash nondeterminism is abstracted to before/after-timeout
orderings: ``age_*`` actions flip a boolean per file instead of
modeling clocks.  One ordering assumption is encoded: with the
supervisor running, a dead worker's claim is handled within one poll
(0.5 s), long before the reclaim timeout (5 s), so ``age_claim`` on a
supervised fleet requires the death to have been polled first.  The
``release-within-one-poll`` invariant checks the other side of that
bargain.
"""

from __future__ import annotations

import ast
import os
import re
from collections import namedtuple
from dataclasses import dataclass
from typing import Iterable

from qba_tpu_torch.analysis.findings import Finding, Report
from qba_tpu_torch.analysis.fsm import (
    Action,
    Invariant,
    explore,
    render_schedule,
)
from qba_tpu_torch.serve.timing import MAX_RECLAIMS, POISON_THRESHOLD

# ---------------------------------------------------------------------------
# Registered mutation sites: (file basename, enclosing function,
# annotation marker).  The conformance sweep fails when a site here is
# missing from the code OR a queue mutation in serve/ is not annotated
# with one of these markers.

PROTOCOL_MARKER = "qba-protocol"

#: marker -> the model action it is part of (documentation + closure:
#: every registered marker must belong to a modeled transition).
MARKER_TO_ACTION = {
    "publish": "enqueue/emit",  # write_json_atomic: temp + rename
    "claim": "claim",
    "restamp": "claim",  # mtime := the claim instant
    "settle": "emit",
    "reclaim": "reclaim",
    "dead-letter": "dead-letter",
    "release": "sup_poll",
    "quarantine": "sup_poll",
    "consume": "consume",
}

PROTOCOL_SITES = frozenset(
    {
        ("queuefs.py", "write_json_atomic", "publish"),
        ("transport.py", "serve_file_queue", "claim"),
        ("transport.py", "serve_file_queue", "restamp"),
        ("transport.py", "settle", "settle"),
        ("transport.py", "_reclaim_stale", "reclaim"),
        ("transport.py", "_reclaim_stale", "dead-letter"),
        ("supervisor.py", "_release_claim", "release"),
        ("supervisor.py", "_quarantine", "quarantine"),
        ("frontend.py", "_watch_outbox", "consume"),
    }
)

#: Files where EVERY os-level mutation is a protocol mutation.
_PROTOCOL_MODULES = frozenset(
    {"queuefs.py", "transport.py", "supervisor.py", "pool.py", "frontend.py"}
)

_MUTATORS = frozenset({"replace", "rename", "unlink", "remove", "utime"})

#: Queue-path vocabulary: a mutation in a non-protocol serve/ module is
#: flagged only when its arguments mention the queue layout.
_QUEUE_TOKENS = (
    "inbox",
    "claimed",
    "outbox",
    "consumed",
    "dead",
    "stop",
    "heartbeat",
    "queue_dir",
    "paths[",
)


def _serve_root() -> str:
    import qba_tpu_torch.serve as serve

    return os.path.dirname(os.path.abspath(serve.__file__))


# ---------------------------------------------------------------------------
# Extracted semantics: the behavioral switches the model runs on.


@dataclass(frozen=True)
class ProtocolSemantics:
    """What the claim-loop/reclaim code actually does, per its AST."""

    #: ``os.utime`` re-stamps the claim file to the claim instant right
    #: after the claim rename.  Off = reclaim staleness
    #: is measured from the producer's enqueue mtime.
    restamp_on_claim: bool
    #: The reclaimer writes an outbox result only on the dead-letter
    #: branch (``attempts >= max_reclaims``), never on an ordinary
    #: push-back.  Off = every reclaim also emits (double-emit bug).
    emit_only_at_dead_letter: bool
    #: The stop sentinel is checked AFTER the claimed inbox listing is
    #: drained, so ``stop`` can never overtake queued requests.
    stop_after_drain: bool
    #: Where the claim loop came from (shipped transport.py or a
    #: fixture overlay) — named in findings.
    origin: str


def _functions(tree: ast.Module) -> dict[str, ast.AST]:
    """All function defs in a module, INCLUDING nested ones (the
    transport's ``settle``/``emit`` live inside ``serve_file_queue``)
    and async defs (the frontend's watchers), keyed by bare name;
    outermost wins on duplicates."""
    out: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name not in out
        ):
            out[node.name] = node
    return out


def _calls(fn: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            yield node


def _is_os_call(call: ast.Call, attr: str) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == attr
        and isinstance(f.value, ast.Name)
        and f.value.id == "os"
    )


def _extract_restamp(fn: ast.FunctionDef) -> bool:
    return any(_is_os_call(c, "utime") for c in _calls(fn))


def _extract_emit_discipline(fn: ast.FunctionDef) -> bool:
    """True iff every ``emit(...)`` in the reclaimer is inside an
    ``if`` whose test mentions the dead-letter bound."""

    def emit_calls_outside_dead_letter(node: ast.AST, guarded: bool) -> int:
        n = 0
        for child in ast.iter_child_nodes(node):
            g = guarded
            if isinstance(child, ast.If) and "max_reclaims" in ast.unparse(
                child.test
            ):
                # Both branches: the else of the dead-letter check is
                # NOT dead-letter-guarded.
                n += sum(
                    emit_calls_outside_dead_letter(s, True)
                    for s in child.body
                )
                n += sum(
                    emit_calls_outside_dead_letter(s, guarded)
                    for s in child.orelse
                )
                continue
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Name)
                and child.func.id == "emit"
                and not g
            ):
                n += 1
            n += emit_calls_outside_dead_letter(child, g)
        return n

    return emit_calls_outside_dead_letter(fn, False) == 0


def _extract_stop_after_drain(fn: ast.FunctionDef) -> bool:
    """The inbox-drain ``for`` must precede the stop-sentinel check in
    the claim loop body."""
    drain_line = stop_line = None
    for node in ast.walk(fn):
        if (
            drain_line is None
            and isinstance(node, ast.For)
            and isinstance(node.iter, ast.Name)
            and node.iter.id == "names"
        ):
            drain_line = node.lineno
        if (
            stop_line is None
            and isinstance(node, ast.If)
            and "stop" in ast.unparse(node.test)
        ):
            stop_line = node.lineno
    if drain_line is None or stop_line is None:
        return False  # can't prove the ordering -> treat as violated
    return drain_line < stop_line


def extract_semantics(overlay: str | None = None) -> ProtocolSemantics:
    """Read the behavioral switches from ``serve/transport.py``; when
    ``overlay`` names a fixture module, functions defined there shadow
    the shipped ones (the fixture re-introduces one bad function, the
    rest stays shipped)."""
    shipped = os.path.join(_serve_root(), "transport.py")
    with open(shipped) as f:
        fns = _functions(ast.parse(f.read()))
    origin = "serve/transport.py"
    if overlay is not None:
        with open(overlay) as f:
            for name, fn in _functions(ast.parse(f.read())).items():
                fns[name] = fn
        origin = os.path.basename(overlay)
    claim_loop = fns.get("serve_file_queue")
    reclaimer = fns.get("_reclaim_stale")
    return ProtocolSemantics(
        restamp_on_claim=(
            claim_loop is not None and _extract_restamp(claim_loop)
        ),
        emit_only_at_dead_letter=(
            reclaimer is not None and _extract_emit_discipline(reclaimer)
        ),
        stop_after_drain=(
            claim_loop is not None and _extract_stop_after_drain(claim_loop)
        ),
        origin=origin,
    )


# ---------------------------------------------------------------------------
# The protocol model: state, scenarios, guarded actions, invariants.

# One queue artifact per request:
#   loc      — new | inbox | claimed | done | dead
#   holder   — worker slot index holding the claim file, -1 otherwise
#   aged     — the file's mtime is older than the reclaim timeout
#   attempts — reclaim ladder position (transport's attempts dict)
#   emitted  — outbox results written for this id (capped at 2: the
#              exactly-once invariant fires at 2, higher is the same)
#   blame    — worker deaths the crash ledger charges to this id
#   consumed — the front-end forwarded the result (outbox/->consumed/)
Req = namedtuple(
    "Req", "loc holder aged attempts emitted blame consumed"
)
# One worker slot: st — idle | busy | crashed | exited | benched;
# req — in-flight request index (-1); spawns — respawn count.
Wkr = namedtuple("Wkr", "st req spawns")
St = namedtuple("St", "reqs wkrs stop crashes")


@dataclass(frozen=True)
class Scenario:
    """One bounded configuration the BFS exhausts."""

    name: str
    workers: int = 2
    requests: int = 2
    #: spontaneous worker crashes mid-execution allowed (bounded).
    crashes: bool = False
    max_crashes: int = 0
    #: request indices that kill their claimant (the poison hook).
    poison: tuple[int, ...] = ()
    #: supervisor present (release/quarantine/respawn within one poll).
    supervisor: bool = False
    #: a stop sentinel may be dropped once all requests are enqueued.
    stop: bool = False
    max_respawns: int = 3
    max_reclaims: int = MAX_RECLAIMS
    poison_threshold: int = POISON_THRESHOLD


#: The shipped matrix: every transition of the protocol is live in at
#: least one scenario, and each stays comfortably exhaustive.
DEFAULT_SCENARIOS = (
    # The acceptance-criteria default: crashes under supervision.
    Scenario(
        "2w2r-crash", workers=2, requests=2, crashes=True, max_crashes=2,
        supervisor=True,
    ),
    # Poison quarantine: one request kills every claimant.
    Scenario(
        "2w2r-poison", workers=2, requests=2, poison=(0,), supervisor=True,
    ),
    # Unsupervised chaos: the reclaim ladder is the only recovery, and
    # max_reclaims=1 makes the dead-letter branch reachable in bounds.
    Scenario(
        "3w2r-reclaim", workers=3, requests=2, crashes=True, max_crashes=2,
        supervisor=False, max_reclaims=1,
    ),
    # Clean drain: the stop sentinel must not overtake queued work.
    Scenario("2w2r-stop", workers=2, requests=2, stop=True),
)


def _initial(sc: Scenario) -> St:
    return St(
        reqs=tuple(
            Req("new", -1, False, 0, 0, 0, False)
            for _ in range(sc.requests)
        ),
        wkrs=tuple(Wkr("idle", -1, 0) for _ in range(sc.workers)),
        stop=False,
        crashes=0,
    )


def _set_req(s: St, i: int, r: Req) -> St:
    return s._replace(reqs=s.reqs[:i] + (r,) + s.reqs[i + 1:])


def _set_wkr(s: St, i: int, w: Wkr) -> St:
    return s._replace(wkrs=s.wkrs[:i] + (w,) + s.wkrs[i + 1:])


def build_actions(sem: ProtocolSemantics, sc: Scenario) -> list[Action]:
    """The protocol's guarded transitions under ``sem`` semantics."""

    def enqueue(s: St):
        if s.stop:
            return
        for i, r in enumerate(s.reqs):
            if r.loc == "new":
                yield (
                    f"enqueue(r{i}): frontend drops r{i} into inbox/",
                    _set_req(s, i, r._replace(loc="inbox", aged=False)),
                )

    def age_inbox(s: St):
        for i, r in enumerate(s.reqs):
            if r.loc == "inbox" and not r.aged:
                yield (
                    f"age(r{i}): r{i} waits in the inbox past the "
                    "reclaim timeout (backlog)",
                    _set_req(s, i, r._replace(aged=True)),
                )

    def claim(s: St):
        # sorted(os.listdir(inbox)): workers take the lowest slug first.
        inbox = [i for i, r in enumerate(s.reqs) if r.loc == "inbox"]
        if not inbox:
            return
        i = min(inbox)
        r = s.reqs[i]
        aged = False if sem.restamp_on_claim else r.aged
        stamp = (
            "mtime re-stamped to the claim instant"
            if sem.restamp_on_claim
            else "mtime NOT re-stamped — still the enqueue stamp"
        )
        for wi, w in enumerate(s.wkrs):
            if w.st != "idle":
                continue
            nxt = _set_req(
                s, i, r._replace(loc="claimed", holder=wi, aged=aged)
            )
            if i in sc.poison:
                # The poison hook dies at decode, right after the
                # claim-phase heartbeat named this slug.
                nxt = _set_wkr(nxt, wi, w._replace(st="crashed", req=i))
                yield (
                    f"claim(w{wi},r{i}): w{wi} claims poison r{i} "
                    f"({stamp}) and dies mid-decode",
                    nxt,
                )
            else:
                nxt = _set_wkr(nxt, wi, w._replace(st="busy", req=i))
                yield (
                    f"claim(w{wi},r{i}): w{wi} renames inbox/->claimed/ "
                    f"({stamp})",
                    nxt,
                )

    def emit(s: St):
        for wi, w in enumerate(s.wkrs):
            if w.st != "busy":
                continue
            i = w.req
            r = s.reqs[i]
            nxt = s
            if r.loc == "claimed" and r.holder == wi:
                nxt = _set_req(
                    nxt,
                    i,
                    r._replace(
                        loc="done",
                        holder=-1,
                        emitted=min(r.emitted + 1, 2),
                    ),
                )
                extra = ""
            else:
                # The claim was stolen: settle's rename fails silently
                # ("result wins") but the outbox write still lands.
                nxt = _set_req(
                    nxt, i, r._replace(emitted=min(r.emitted + 1, 2))
                )
                extra = " (claim already stolen; outbox write lands anyway)"
            nxt = _set_wkr(nxt, wi, w._replace(st="idle", req=-1))
            yield (
                f"emit(w{wi},r{i}): w{wi} writes r{i}'s result to "
                f"outbox/ and settles claimed/->done/{extra}",
                nxt,
            )

    def crash(s: St):
        if not sc.crashes or s.crashes >= sc.max_crashes:
            return
        for wi, w in enumerate(s.wkrs):
            if w.st == "busy":
                yield (
                    f"crash(w{wi}): w{wi} dies (SIGKILL/OOM) while "
                    f"executing r{w.req}",
                    _set_wkr(
                        s._replace(crashes=s.crashes + 1),
                        wi,
                        w._replace(st="crashed"),
                    ),
                )

    def age_claim(s: St):
        for i, r in enumerate(s.reqs):
            if r.loc != "claimed" or r.aged or r.holder < 0:
                continue
            holder = s.wkrs[r.holder]
            if holder.st != "crashed":
                # Timer discipline: a live claimant finishes well inside
                # the reclaim timeout (the protocol's stated assumption;
                # enqueue-side aging is modeled separately).
                continue
            if sc.supervisor:
                # Poll period (0.5s) << reclaim timeout (5s): the
                # supervisor always handles a death before the claim
                # ages — sup_poll fires on this state instead.
                continue
            yield (
                f"age(r{i}): r{i}'s claim ages past the reclaim timeout "
                f"(holder w{r.holder} is dead)",
                _set_req(s, i, r._replace(aged=True)),
            )

    def _reclaimable(s: St):
        for i, r in enumerate(s.reqs):
            if r.loc == "claimed" and r.aged:
                for wi, w in enumerate(s.wkrs):
                    if w.st == "idle" and wi != r.holder:
                        yield i, r, wi

    def reclaim(s: St):
        for i, r, wi in _reclaimable(s):
            if r.attempts >= sc.max_reclaims:
                continue  # the dead-letter action owns this case
            emitted = r.emitted
            extra = ""
            if not sem.emit_only_at_dead_letter:
                emitted = min(emitted + 1, 2)
                extra = " AND writes a failure result to outbox/"
            yield (
                f"reclaim(w{wi},r{i}): w{wi} pushes the stale claim "
                f"back claimed/->inbox/ (attempt "
                f"{r.attempts + 1}){extra}",
                _set_req(
                    s,
                    i,
                    r._replace(
                        loc="inbox",
                        holder=-1,
                        aged=False,
                        attempts=r.attempts + 1,
                        emitted=emitted,
                    ),
                ),
            )

    def dead_letter(s: St):
        for i, r, wi in _reclaimable(s):
            if r.attempts < sc.max_reclaims:
                continue
            yield (
                f"dead-letter(w{wi},r{i}): {r.attempts} reclaims burned "
                f"— w{wi} moves r{i} claimed/->dead/ and writes the "
                "failure result",
                _set_req(
                    s,
                    i,
                    r._replace(
                        loc="dead",
                        holder=-1,
                        emitted=min(r.emitted + 1, 2),
                    ),
                ),
            )

    def sup_poll(s: St):
        if not sc.supervisor:
            return
        crashed = [wi for wi, w in enumerate(s.wkrs) if w.st == "crashed"]
        if not crashed:
            return
        nxt = s
        log: list[str] = []
        for wi in crashed:
            w = nxt.wkrs[wi]
            i = w.req
            if i >= 0:
                r = nxt.reqs[i]
                blame = min(r.blame + 1, sc.poison_threshold + 1)
                r = r._replace(blame=blame)
                nxt = _set_req(nxt, i, r)
                if blame >= sc.poison_threshold:
                    # Quarantine: dead-letter NOW with the crash report
                    # (wherever the file sits — claimed or inbox).
                    if r.loc in ("claimed", "inbox"):
                        nxt = _set_req(
                            nxt,
                            i,
                            r._replace(
                                loc="dead",
                                holder=-1,
                                emitted=min(r.emitted + 1, 2),
                            ),
                        )
                        log.append(
                            f"quarantines poison r{i} (blamed for "
                            f"{blame} deaths) -> dead/ + crash report"
                        )
                elif r.loc == "claimed" and r.holder == wi:
                    nxt = _set_req(
                        nxt, i, r._replace(loc="inbox", holder=-1)
                    )
                    log.append(
                        f"blames r{i} for w{wi}'s death and releases "
                        "its claim claimed/->inbox/"
                    )
                else:
                    log.append(f"blames r{i} for w{wi}'s death")
            # Respawn (or bench at the cap) the dead slot.
            if w.spawns >= sc.max_respawns:
                nxt = _set_wkr(nxt, wi, w._replace(st="benched", req=-1))
                log.append(f"benches w{wi} (respawn cap)")
            else:
                nxt = _set_wkr(
                    nxt,
                    wi,
                    w._replace(st="idle", req=-1, spawns=w.spawns + 1),
                )
                log.append(f"respawns w{wi}")
        yield (
            "sup_poll: supervisor " + "; ".join(log),
            nxt,
        )

    def consume(s: St):
        for i, r in enumerate(s.reqs):
            if r.emitted >= 1 and not r.consumed:
                yield (
                    f"consume(r{i}): frontend forwards r{i}'s result "
                    "and moves outbox/->consumed/",
                    _set_req(s, i, r._replace(consumed=True)),
                )

    def drop_stop(s: St):
        if not sc.stop or s.stop:
            return
        if any(r.loc == "new" for r in s.reqs):
            return  # producers stop before pool.stop() drops the sentinel
        yield ("stop: pool.stop() drops the stop sentinel", s._replace(stop=True))

    def wexit(s: St):
        if not s.stop:
            return
        inbox_empty = all(r.loc != "inbox" for r in s.reqs)
        for wi, w in enumerate(s.wkrs):
            if w.st != "idle":
                continue
            if sem.stop_after_drain and not inbox_empty:
                continue  # the claim loop drains its listing first
            note = "" if inbox_empty else " with requests still queued"
            yield (
                f"exit(w{wi}): w{wi} observes the stop sentinel and "
                f"exits{note}",
                _set_wkr(s, wi, w._replace(st="exited")),
            )

    return [
        Action("enqueue", enqueue),
        Action("age_inbox", age_inbox),
        Action("claim", claim),
        Action("emit", emit),
        Action("crash", crash),
        Action("age_claim", age_claim),
        Action("reclaim", reclaim),
        Action("dead-letter", dead_letter),
        Action("sup_poll", sup_poll),
        Action("consume", consume),
        Action("stop", drop_stop),
        Action("exit", wexit),
    ]


def build_invariants(sc: Scenario) -> list[Invariant]:
    def exactly_once(s: St, via: str) -> str | None:
        for i, r in enumerate(s.reqs):
            if r.emitted >= 2:
                return (
                    f"r{i} has {r.emitted} results in the outbox — "
                    "exactly-once settle violated (a client future "
                    "resolves from whichever write raced last)"
                )
        return None

    def single_executor(s: St, via: str) -> str | None:
        for i in range(len(s.reqs)):
            live = [
                wi
                for wi, w in enumerate(s.wkrs)
                if w.st == "busy" and w.req == i
            ]
            if len(live) >= 2:
                pair = " and ".join(f"w{wi}" for wi in live)
                return (
                    f"r{i} is being executed by {pair} concurrently — "
                    "the later claim conflicts with the earlier one "
                    "still live (double execution)"
                )
        return None

    def poison_bound(s: St, via: str) -> str | None:
        for i, r in enumerate(s.reqs):
            if r.blame > sc.poison_threshold:
                return (
                    f"r{i} blamed for {r.blame} worker deaths > "
                    f"poison_threshold={sc.poison_threshold} — "
                    "quarantine failed to bound the blast radius"
                )
        return None

    def release_within_poll(s: St, via: str) -> str | None:
        if via != "sup_poll":
            return None
        for wi, w in enumerate(s.wkrs):
            if w.st == "crashed":
                return (
                    f"w{wi} is still dead-and-unhandled after a "
                    "supervisor poll — release-within-one-poll violated"
                )
        for i, r in enumerate(s.reqs):
            if r.loc == "claimed" and r.holder >= 0:
                h = s.wkrs[r.holder]
                if h.st in ("crashed", "benched") or (
                    h.st == "idle" and h.req != i
                ):
                    return (
                        f"r{i}'s claim is still held by dead slot "
                        f"w{r.holder} after a supervisor poll"
                    )
        return None

    def no_lost_request(s: St, via: str) -> str | None:
        live_slots = [w for w in s.wkrs if w.st not in ("benched",)]
        if not live_slots:
            return None  # fully degraded fleet: admission repriced to 0
        for i, r in enumerate(s.reqs):
            if r.loc != "new" and r.emitted == 0:
                return (
                    f"schedule completed but r{i} (in {r.loc}) never "
                    "produced a result — lost request"
                )
        return None

    return [
        Invariant("exactly-once-settle", exactly_once),
        Invariant("single-executor", single_executor),
        Invariant("poison-bound", poison_bound),
        Invariant("release-within-one-poll", release_within_poll),
        Invariant("no-lost-request", no_lost_request, terminal=True),
    ]


# ---------------------------------------------------------------------------
# Findings assembly.

_CONFLICT_ACTIONS = ("claim", "emit", "reclaim", "dead-letter", "sup_poll")


def _conflict_line(schedule: list[tuple[str, str]]) -> str:
    """Name the two conflicting transitions of a violation: the final
    step plus the last earlier step touching the same request."""
    if not schedule:
        return ""
    last_name, last_detail = schedule[-1]
    m = re.search(r"r\d+", last_detail)
    if m is None:
        return f"conflicting transition: {last_name}"
    token = m.group(0)
    # Prefer the last earlier step that also wrote the outbox (the
    # true partner of an exactly-once violation); fall back to the
    # last protocol transition touching the same request.
    earlier = [
        (name, detail)
        for name, detail in schedule[:-1]
        if name in _CONFLICT_ACTIONS and re.search(rf"\b{token}\b", detail)
    ]
    if "outbox" in last_detail:
        emitters = [s for s in earlier if "outbox" in s[1]]
        earlier = emitters or earlier
    if earlier:
        name, detail = earlier[-1]
        return (
            f"conflicting transitions: [{name}] {detail}  vs  "
            f"[{last_name}] {last_detail}"
        )
    return f"conflicting transition: [{last_name}] {last_detail}"


def check_protocol_model(
    sem: ProtocolSemantics,
    scenarios: Iterable[Scenario] = DEFAULT_SCENARIOS,
    *,
    stop_on_violation: bool = False,
) -> Report:
    """BFS every scenario under ``sem``; violations become KI-10
    findings carrying the minimal counterexample schedule.

    ``stop_on_violation`` (the fixture path) halts each scenario at
    its first — still minimal-depth — counterexample instead of
    exhausting the buggy relation's reachable space; a clean tree
    never halts, so the exhaustiveness note is unaffected there."""
    report = Report()
    states = transitions = 0
    for sc in scenarios:
        ex = explore(
            _initial(sc),
            build_actions(sem, sc),
            build_invariants(sc),
            stop_on_violation=stop_on_violation,
        )
        states += ex.states
        transitions += ex.transitions
        report.notes.append(
            f"protocol/{sc.name}: {ex.states} states, "
            f"{ex.transitions} transitions, diameter {ex.diameter}, "
            f"{ex.terminal_states} terminal state(s) — "
            + (
                "HALTED at first violation"
                if ex.halted
                else ("TRUNCATED" if ex.truncated else "exhaustive")
            )
        )
        if ex.truncated:
            report.findings.append(
                Finding(
                    ki="KI-10",
                    check="protocol-model",
                    path=f"protocol/{sc.name}",
                    message=(
                        "state space truncated before exhaustion — a "
                        "clean result is inconclusive; shrink the "
                        "scenario or raise max_states"
                    ),
                )
            )
        for v in ex.violations:
            report.findings.append(
                Finding(
                    ki="KI-10",
                    check="protocol-model",
                    path=f"protocol/{sc.name}",
                    message=(
                        f"[{sem.origin}] {v.message}\n"
                        f"  minimal counterexample ({v.depth} steps, "
                        f"{sc.workers} workers x {sc.requests} "
                        "requests):\n"
                        + render_schedule(v.schedule, indent="    ")
                        + "\n  " + _conflict_line(v.schedule)
                    ),
                )
            )
    report.stats["protocol_states_explored"] = states
    report.stats["protocol_transitions_explored"] = transitions
    return report


# ---------------------------------------------------------------------------
# Conformance: every queue mutation in serve/ is bound to the model.

_ANNOT_RE = re.compile(rf"#\s*{PROTOCOL_MARKER}:\s*([A-Za-z0-9_-]+)")


def _annotation_near(lines: list[str], lineno: int) -> str | None:
    """The ``# qba-protocol: <marker>`` on the call line or up to two
    lines above it (the repo's annotation idiom)."""
    for ln in range(lineno, max(lineno - 3, 0), -1):
        m = _ANNOT_RE.search(lines[ln - 1])
        if m:
            return m.group(1)
    return None


def _iter_mutations(tree: ast.Module):
    """Yield ``(call, enclosing_function_name)`` for every os-level
    mutation call, tracking the innermost enclosing function."""

    def walk(node: ast.AST, fn: str):
        for child in ast.iter_child_nodes(node):
            f = fn
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                f = child.name
            if isinstance(child, ast.Call):
                func = child.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr in _MUTATORS
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "os"
                ):
                    yield child, f
            yield from walk(child, f)

    yield from walk(tree, "<module>")


def check_protocol_conformance(serve_root: str | None = None) -> Report:
    """AST sweep of ``serve/``: flag any unregistered queue mutation
    and any registered model site that has gone missing."""
    root = serve_root if serve_root is not None else _serve_root()
    report = Report()
    seen_sites: set[tuple[str, str, str]] = set()
    mutations = 0
    for dirpath, _dirnames, filenames in os.walk(root):
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                src = f.read()
            lines = src.splitlines()
            rel = os.path.relpath(path, root)
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue
            strict = fname in _PROTOCOL_MODULES
            for call, fn_name in _iter_mutations(tree):
                arg_src = " ".join(
                    ast.unparse(a) for a in call.args
                )
                queueish = strict or any(
                    t in arg_src for t in _QUEUE_TOKENS
                )
                if not queueish:
                    continue
                mutations += 1
                marker = _annotation_near(lines, call.lineno)
                where = f"{rel}:{call.lineno}"
                mut = ast.unparse(call.func)
                if marker is None:
                    report.findings.append(
                        Finding(
                            ki="KI-10",
                            check="protocol-conformance",
                            path=f"serve/{rel}",
                            message=(
                                f"unmapped queue mutation {mut}(...) in "
                                f"{fn_name}() — every rename/unlink/"
                                "utime on a queue path must carry a "
                                f"'# {PROTOCOL_MARKER}: <transition>' "
                                "annotation binding it to a transition "
                                "modeled in analysis/protocol.py"
                            ),
                            where=where,
                        )
                    )
                    continue
                if marker not in MARKER_TO_ACTION:
                    report.findings.append(
                        Finding(
                            ki="KI-10",
                            check="protocol-conformance",
                            path=f"serve/{rel}",
                            message=(
                                f"unknown protocol transition "
                                f"{marker!r} on {mut}(...) — known: "
                                f"{sorted(MARKER_TO_ACTION)}"
                            ),
                            where=where,
                        )
                    )
                    continue
                seen_sites.add((fname, fn_name, marker))
    for site in sorted(PROTOCOL_SITES - seen_sites):
        fname, fn_name, marker = site
        report.findings.append(
            Finding(
                ki="KI-10",
                check="protocol-conformance",
                path=f"serve/{fname}",
                message=(
                    f"registered model site lost: the {marker!r} "
                    f"transition ({MARKER_TO_ACTION[marker]}) is bound "
                    f"to {fn_name}() in {fname} but no annotated "
                    "mutation was found there — update the model AND "
                    "PROTOCOL_SITES together"
                ),
            )
        )
    report.stats["protocol_mutations_checked"] = mutations
    report.stats["protocol_sites_bound"] = len(
        seen_sites & PROTOCOL_SITES
    )
    return report


def check_admission_purity(frontend_path: str | None = None) -> Report:
    """The admission-ledger purity invariant, statically: the deferred
    retry loop must poll with ``try_admit(..., record=False)`` and
    record only the resolving decision — otherwise the decision ledger
    becomes a function of settle *timing*, not of the request stream
    and settle points."""
    path = (
        frontend_path
        if frontend_path is not None
        else os.path.join(_serve_root(), "fleet", "frontend.py")
    )
    report = Report()
    with open(path) as f:
        tree = ast.parse(f.read())
    fns = _functions(tree)
    retry = fns.get("_retry_deferred")
    if retry is None:
        report.findings.append(
            Finding(
                ki="KI-10",
                check="admission-purity",
                path="serve/fleet/frontend.py",
                message=(
                    "_retry_deferred() not found — the deferred-retry "
                    "purity proof has no anchor"
                ),
            )
        )
        return report
    ok_poll = records = False
    for call in _calls(retry):
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "try_admit":
            ok_poll = any(
                kw.arg == "record"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in call.keywords
            )
            if not ok_poll:
                report.findings.append(
                    Finding(
                        ki="KI-10",
                        check="admission-purity",
                        path="serve/fleet/frontend.py",
                        message=(
                            "deferred-retry try_admit() without "
                            "record=False — a still-full retry would "
                            "append one DEFER per settle event, making "
                            "the admission ledger a function of settle "
                            "timing (purity violated)"
                        ),
                        where=f"frontend.py:{call.lineno}",
                    )
                )
        if isinstance(f, ast.Attribute) and f.attr == "record":
            records = True
    if ok_poll and not records:
        report.findings.append(
            Finding(
                ki="KI-10",
                check="admission-purity",
                path="serve/fleet/frontend.py",
                message=(
                    "deferred retries poll with record=False but never "
                    "record the resolving decision — resolved retries "
                    "would vanish from the admission ledger"
                ),
            )
        )
    report.stats["admission_purity_checked"] = 1
    return report


# ---------------------------------------------------------------------------
# Entry points.


def check_protocol(
    serve_root: str | None = None,
    scenarios: Iterable[Scenario] = DEFAULT_SCENARIOS,
) -> Report:
    """The full KI-10 pass over the shipped tree: extracted-semantics
    model check + conformance sweep + admission purity.  This is what
    ``python -m qba_tpu_torch lint --protocol`` runs."""
    report = Report()
    sem = extract_semantics()
    report.notes.append(
        f"protocol semantics [{sem.origin}]: restamp_on_claim="
        f"{sem.restamp_on_claim}, emit_only_at_dead_letter="
        f"{sem.emit_only_at_dead_letter}, stop_after_drain="
        f"{sem.stop_after_drain}"
    )
    report.extend(check_protocol_model(sem, scenarios))
    report.extend(check_protocol_conformance(serve_root))
    report.extend(check_admission_purity())
    return report


def check_protocol_fixture(
    fixture_path: str,
    scenarios: Iterable[Scenario] = DEFAULT_SCENARIOS,
) -> Report:
    """Model-check a seeded violation fixture: functions defined in
    ``fixture_path`` shadow the shipped transport's, and the SAME
    scenarios/invariants run over the resulting semantics.  Used by
    the fixture tests — the checker must kill every fixture with a
    printed schedule.

    Runs in stop-at-first-counterexample mode: a seeded bug can blow
    the reachable space up ~350x (the no-restamp race reaches 175k
    states under 2w2r-crash vs the clean tree's 495), and the first
    BFS witness is already the minimal schedule we print."""
    sem = extract_semantics(overlay=fixture_path)
    return check_protocol_model(sem, scenarios, stop_on_violation=True)
