"""Static deadlock detection over ``ActorSpec`` graphs (paper §4).

The actor protocol is a bounded-buffer dataflow network: each actor's out
register pool is a place with capacity ``out_regs``; every fire consumes one
token per input channel and (subject to ``emit_every``) produces one token
into the pool, which is recycled only once *every* consumer has acked it.
Because firing an actor only ever adds tokens downstream and releases
registers upstream, the enabling relation is monotone: greedy saturation is
confluent and reaches a unique quiescent marking.  The plan deadlocks iff
some bounded actor has not exhausted its fires at quiescence.

Nothing here ever calls ``spec.fn`` — only the counters move.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.analysis.report import Violation
from repro_torch.runtime.actor import ActorSpec

# Safety fuse so a malformed graph can never loop the analyzer forever.
_MAX_TOTAL_FIRES = 1_000_000


@dataclasses.dataclass
class DeadlockResult:
    """Outcome of one abstract saturation run."""

    ok: bool
    fired: Dict[str, int]
    required: Dict[str, Optional[int]]
    stuck: Tuple[str, ...]
    cycle: Tuple[str, ...]
    reasons: Tuple[str, ...]
    channels: int


class _Node:
    __slots__ = ("spec", "limit", "fired", "consumers", "consumed")

    def __init__(self, spec: ActorSpec, limit: Optional[int]) -> None:
        self.spec = spec
        self.limit = limit
        self.fired = 0
        self.consumers: List[str] = []
        # tokens each consumer has taken from this actor's output channel
        self.consumed: Dict[str, int] = {}

    @property
    def emit_every(self) -> int:
        return max(1, self.spec.emit_every)

    @property
    def emitted(self) -> int:
        return self.fired // self.emit_every

    def regs_in_use(self) -> int:
        if not self.consumers:
            return 0
        return self.emitted - min(self.consumed[c] for c in self.consumers)

    def out_free(self) -> int:
        return self.spec.out_regs - self.regs_in_use()

    def exhausted(self) -> bool:
        return self.limit is not None and self.fired >= self.limit


def _build_nodes(
    specs: Sequence[ActorSpec], fires: Optional[Mapping[str, int]]
) -> Dict[str, _Node]:
    nodes: Dict[str, _Node] = {}
    for spec in specs:
        limit = spec.max_fires
        if fires is not None and spec.name in fires:
            limit = fires[spec.name]
        nodes[spec.name] = _Node(spec, limit)
    for spec in specs:
        for src in spec.inputs:
            if src not in nodes:
                raise ValueError(
                    f"actor {spec.name!r} consumes unknown producer {src!r}"
                )
            nodes[src].consumers.append(spec.name)
            nodes[src].consumed[spec.name] = 0
    return nodes


def _ready(nodes: Dict[str, _Node], node: _Node) -> bool:
    if node.exhausted():
        return False
    if node.out_free() < 1:
        return False
    for src in node.spec.inputs:
        prod = nodes[src]
        if prod.emitted - prod.consumed[node.spec.name] < 1:
            return False
    return True


def _fire(nodes: Dict[str, _Node], node: _Node) -> None:
    for src in node.spec.inputs:
        nodes[src].consumed[node.spec.name] += 1
    node.fired += 1


def _saturate(nodes: Dict[str, _Node]) -> int:
    """Greedy confluent saturation; returns total fires."""
    total = 0
    pending: List[str] = list(nodes)
    queued: Set[str] = set(pending)
    while pending:
        name = pending.pop()
        queued.discard(name)
        node = nodes[name]
        progressed = False
        while _ready(nodes, node):
            _fire(nodes, node)
            progressed = True
            total += 1
            if total > _MAX_TOTAL_FIRES:
                return total
        if progressed:
            for nxt in node.consumers + list(node.spec.inputs) + [name]:
                if nxt not in queued:
                    queued.add(nxt)
                    pending.append(nxt)
    return total


def _wait_edges(
    nodes: Dict[str, _Node], name: str
) -> List[Tuple[str, str]]:
    """Who is ``name`` waiting on right now?  Returns (target, reason)."""
    node = nodes[name]
    edges: List[Tuple[str, str]] = []
    for src in node.spec.inputs:
        prod = nodes[src]
        if prod.emitted - prod.consumed[name] < 1:
            if prod.exhausted():
                edges.append(
                    (src, f"starved: {src} exhausted after {prod.fired} fires")
                )
            else:
                edges.append((src, f"awaits a token from {src}"))
    if node.out_free() < 1:
        for c in node.consumers:
            if node.consumed[c] < node.emitted:
                edges.append((c, f"awaits an ack from {c}"))
    return edges


def _find_cycle(
    nodes: Dict[str, _Node], roots: Sequence[str]
) -> Tuple[str, ...]:
    """DFS over the waits-for graph; returns the first cycle found."""
    graph = {
        name: [t for t, _ in _wait_edges(nodes, name)]
        for name in nodes
        if not nodes[name].exhausted()
    }
    color: Dict[str, int] = {}
    stack: List[str] = []

    def visit(name: str) -> Optional[Tuple[str, ...]]:
        color[name] = 1
        stack.append(name)
        for nxt in graph.get(name, ()):
            state = color.get(nxt, 0)
            if state == 1:
                i = stack.index(nxt)
                return tuple(stack[i:])
            if state == 0:
                found = visit(nxt)
                if found is not None:
                    return found
        stack.pop()
        color[name] = 2
        return None

    for root in roots:
        if color.get(root, 0) == 0:
            found = visit(root)
            if found is not None:
                return found
    return ()


def check_deadlock(
    specs: Sequence[ActorSpec],
    *,
    fires: Optional[Mapping[str, int]] = None,
) -> DeadlockResult:
    """Run the abstract token-flow simulation to quiescence.

    ``fires`` overrides ``max_fires`` per actor name — used for serve plans
    whose specs carry ``max_fires=0`` (open-ended) to analyze one
    representative round instead.
    """
    nodes = _build_nodes(specs, fires)
    unbounded_sources = [
        n for n, node in nodes.items()
        if node.limit is None and not node.spec.inputs
    ]
    if unbounded_sources:
        raise ValueError(
            "cannot analyze unbounded source actor(s) "
            f"{unbounded_sources}: pass fires= to bound them"
        )
    _saturate(nodes)
    stuck = tuple(
        sorted(n for n, node in nodes.items() if not node.exhausted()
               and node.limit is not None)
    )
    fired = {n: node.fired for n, node in nodes.items()}
    required = {n: node.limit for n, node in nodes.items()}
    channels = sum(len(node.spec.inputs) for node in nodes.values())
    if not stuck:
        return DeadlockResult(True, fired, required, (), (), (), channels)
    cycle = _find_cycle(nodes, stuck)
    reasons = []
    for name in stuck:
        for _, why in _wait_edges(nodes, name):
            reasons.append(f"{name} {why}")
    return DeadlockResult(
        False, fired, required, stuck, cycle, tuple(reasons), channels
    )


def deadlock_violations(result: DeadlockResult) -> List[Violation]:
    if result.ok:
        return []
    if result.cycle:
        subject = " -> ".join(result.cycle + (result.cycle[0],))
        kind = "quota-starved cycle"
    else:
        subject = ", ".join(result.stuck)
        kind = "starvation"
    progress = "; ".join(
        f"{n} fired {result.fired[n]}/{result.required[n]}"
        for n in result.stuck
    )
    detail = "; ".join(result.reasons[:6])
    return [
        Violation(
            "deadlock",
            subject,
            f"{kind}: plan quiesces with unfinished actors ({progress}); "
            f"{detail}",
        )
    ]


def min_feasible_regs(
    specs: Sequence[ActorSpec],
    *,
    fires: Optional[Mapping[str, int]] = None,
    tunable: Optional[Sequence[str]] = None,
    cap: int = 64,
) -> Optional[Dict[str, int]]:
    """Search the smallest per-actor quota vector that makes the plan live.

    Starts every tunable quota at 1, bumps quotas implicated in the failure
    until the abstract simulation completes, then coordinate-descends each
    quota back down.  Returns ``None`` when no quota assignment up to ``cap``
    fixes the plan (a rate mismatch, not a buffering problem).
    """
    by_name = {s.name: s for s in specs}
    has_consumer = {src for s in specs for src in s.inputs}
    if tunable is None:
        names = [s.name for s in specs if s.name in has_consumer]
    else:
        names = [n for n in tunable if n in by_name]
    if not names:
        return None
    quotas = {n: 1 for n in names}

    def attempt() -> DeadlockResult:
        trial = [
            dataclasses.replace(s, out_regs=quotas[s.name])
            if s.name in quotas else s
            for s in specs
        ]
        return check_deadlock(trial, fires=fires)

    result = attempt()
    rounds = 0
    while not result.ok and rounds < cap * len(names):
        rounds += 1
        blamed = set(result.stuck) | set(result.cycle)
        for name in result.stuck:
            # producers of a stuck actor may be the ones short on registers
            blamed.update(by_name[name].inputs)
        bumpable = [n for n in names if n in blamed and quotas[n] < cap]
        if not bumpable:
            return None
        for n in bumpable:
            quotas[n] += 1
        result = attempt()
    if not result.ok:
        return None
    # shrink back down, one coordinate at a time
    for n in sorted(names):
        while quotas[n] > 1:
            quotas[n] -= 1
            if not attempt().ok:
                quotas[n] += 1
                break
    return dict(quotas)


def min_feasible_stage_regs(
    num_stages: int, num_microbatches: Optional[int] = None
) -> List[int]:
    """Minimal per-stage forward quotas for the canonical train pipeline.

    Used by ``runtime.pipeline`` quota-validation errors to tell the caller
    what *would* work instead of merely rejecting what they passed.
    """
    from repro_torch.analysis.skeleton import train_spec_skeleton

    nmb = num_microbatches if num_microbatches is not None else 2
    regs = [1] * num_stages
    specs = train_spec_skeleton(num_stages, nmb, regs)
    found = min_feasible_regs(
        specs, tunable=[f"f{s}" for s in range(num_stages)]
    )
    if found is None:
        # the canonical pipeline is always live at quota 1; be conservative
        return [1] * num_stages
    return [found.get(f"f{s}", 1) for s in range(num_stages)]
