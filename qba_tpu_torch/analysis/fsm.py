"""Explicit-state model-checker core for the KI-10 protocol pass — a
copy of :mod:`qba_tpu.analysis.fsm`, kept inside the port.

A deliberately small bounded model checker in the ByMC mold
(PAPERS.md): a protocol is a set of named guarded actions over
hashable states; :func:`explore` runs breadth-first search from the
initial state, checks every safety invariant on every reachable
state (and the terminal-scoped ones on quiescent states), and — the
property ByMC makes a methodology — returns the *minimal* violating
schedule, because BFS reaches every state first along a shortest
path.

The core knows nothing about file queues; the fleet protocol model
lives in :mod:`qba_tpu_torch.analysis.protocol`.  Keeping the search
generic means the seeded violation fixtures and the shipped tree run
through literally identical exploration code — only the transition
semantics differ.

States must be hashable and equality-comparable (the protocol model
uses nested ``namedtuple``s).  Actions are *pure*: they return
successor states and never mutate their argument, so the BFS parent
map stays consistent for schedule reconstruction.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Hashable, Iterable


@dataclasses.dataclass(frozen=True)
class Action:
    """One named guarded transition family.

    ``fire(state)`` yields ``(detail, next_state)`` pairs — one per
    enabled instantiation (e.g. ``claim`` yields one pair per
    (worker, request) whose guard holds).  ``detail`` is the
    human-readable instantiation ("w1 claims r0") used in printed
    counterexample schedules.
    """

    name: str
    fire: Callable[[Any], Iterable[tuple[str, Any]]]


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One safety property.

    ``check(state, via)`` returns ``None`` when the state is fine or
    a violation message; ``via`` is the name of the action that
    produced the state (empty for the initial state) so post-action
    properties ("after a supervisor poll, no dead claim remains") can
    scope themselves.  ``terminal=True`` invariants run only on
    quiescent states (no action enabled) — liveness-flavored safety
    like "no request is lost on complete schedules".
    """

    name: str
    check: Callable[[Any, str], str | None]
    terminal: bool = False


@dataclasses.dataclass
class Violation:
    """A violated invariant plus its minimal witness schedule."""

    invariant: str
    message: str
    #: ``(action_name, detail)`` steps from the initial state.
    schedule: list[tuple[str, str]]

    @property
    def depth(self) -> int:
        return len(self.schedule)


@dataclasses.dataclass
class Exploration:
    """BFS result: the reached state space plus any violations."""

    states: int = 0
    transitions: int = 0
    diameter: int = 0  # depth of the deepest reached state
    terminal_states: int = 0
    truncated: bool = False  # hit max_states before exhausting
    halted: bool = False  # stopped at the first violation (opt-in)
    violations: list[Violation] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def explore(
    initial: Hashable,
    actions: Iterable[Action],
    invariants: Iterable[Invariant],
    *,
    max_states: int = 500_000,
    stop_on_violation: bool = False,
) -> Exploration:
    """Exhaustive BFS from ``initial``; first (= minimal-depth)
    violation per invariant is kept.  ``truncated`` reports a
    ``max_states`` cutoff — callers must treat a truncated clean run
    as *inconclusive*, not verified.

    ``stop_on_violation`` halts the search as soon as any invariant
    has a witness (``halted=True`` in the result).  BFS order makes
    that first witness minimal-depth regardless, so this is the
    classic stop-at-first-counterexample mode — right for seeded
    violation fixtures, where a buggy transition relation can blow
    the reachable space up orders of magnitude past the clean one's.
    A clean protocol never triggers it, so exhaustive verification
    claims are unaffected."""
    actions = list(actions)
    state_checks = [i for i in invariants if not i.terminal]
    terminal_checks = [i for i in invariants if i.terminal]

    result = Exploration()
    # state -> (parent_state, action_name, detail); initial maps to None.
    parents: dict[Hashable, tuple[Hashable, str, str] | None] = {
        initial: None
    }
    depth_of: dict[Hashable, int] = {initial: 0}
    queue: deque[Hashable] = deque([initial])
    violated: set[str] = set()

    def schedule_to(state: Hashable) -> list[tuple[str, str]]:
        steps: list[tuple[str, str]] = []
        cur = state
        while True:
            link = parents[cur]
            if link is None:
                break
            cur, name, detail = link
            steps.append((name, detail))
        steps.reverse()
        return steps

    def note_violation(inv: Invariant, msg: str, state: Hashable) -> None:
        if inv.name in violated:
            return  # BFS order: the first witness is already minimal
        violated.add(inv.name)
        result.violations.append(
            Violation(
                invariant=inv.name,
                message=msg,
                schedule=schedule_to(state),
            )
        )

    while queue:
        state = queue.popleft()
        depth = depth_of[state]
        result.states += 1
        result.diameter = max(result.diameter, depth)
        link = parents[state]
        via = link[1] if link is not None else ""

        for inv in state_checks:
            msg = inv.check(state, via)
            if msg is not None:
                note_violation(inv, msg, state)
        if stop_on_violation and result.violations:
            result.halted = True
            break

        fired = 0
        for action in actions:
            for detail, nxt in action.fire(state):
                fired += 1
                result.transitions += 1
                if nxt in parents:
                    continue
                if len(parents) >= max_states:
                    result.truncated = True
                    continue
                parents[nxt] = (state, action.name, detail)
                depth_of[nxt] = depth + 1
                queue.append(nxt)
        if fired == 0:
            result.terminal_states += 1
            for inv in terminal_checks:
                msg = inv.check(state, via)
                if msg is not None:
                    note_violation(inv, msg, state)
            if stop_on_violation and result.violations:
                result.halted = True
                break
    return result


def render_schedule(
    schedule: list[tuple[str, str]], *, indent: str = "  "
) -> str:
    """The printed minimal counterexample: one numbered line per step."""
    if not schedule:
        return f"{indent}(violated in the initial state)"
    width = len(str(len(schedule)))
    return "\n".join(
        f"{indent}{i + 1:>{width}}. {detail or name}"
        for i, (name, detail) in enumerate(schedule)
    )
