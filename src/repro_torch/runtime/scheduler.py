"""Discrete-event simulator for the actor runtime (paper §4/§5).

Faithful to the paper's execution rules:

* actions fire only when all in counters > 0 and the out counter > 0;
* `ack`s are sent when the consumer has *finished using* the data (action end);
* `req`s are delivered to consumers at action end (+ routing latency);
* actors bound to the same OS thread / hardware queue serialize (Fig 7);
* cross-node messages pay CommNet latency + bandwidth (Fig 7 case 3).

The simulator is what the framework uses for compile-time *resource planning*
(picking register quotas = pipeline depth) before lowering the real program,
and it doubles as the evaluation harness for Figs 2/6 and the pipeline
benchmarks.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.actor import Actor, ActorSpec, build_actors
from repro_torch.runtime.messages import Ack, Req, node_of, thread_of


@dataclasses.dataclass
class CommModel:
    """Message routing cost (Fig 7): local queue, same-node, cross-node."""

    same_thread: float = 0.0
    same_node: float = 1e-3
    cross_node_latency: float = 5e-3
    cross_node_gbps: float = 12.5       # 100 Gbps RoCE, as in the paper

    def latency(self, src_id: int, dst_id: int, nbytes: int) -> float:
        if node_of(src_id) != node_of(dst_id):
            return self.cross_node_latency + nbytes / (self.cross_node_gbps * 1e9)
        if thread_of(src_id) != thread_of(dst_id):
            return self.same_node
        return self.same_thread


@dataclasses.dataclass
class SimResult:
    makespan: float
    history: Dict[str, List[Tuple[float, float]]]    # actor -> action intervals
    peak_regs: Dict[str, int]
    fires: Dict[str, int]
    outputs: List[Any]
    deadlocked: bool = False
    pending_at_deadlock: int = 0

    def utilization(self, actor: str) -> float:
        busy = sum(e - s for s, e in self.history[actor])
        return busy / self.makespan if self.makespan else 0.0


class Simulator:
    def __init__(self, specs: Sequence[ActorSpec], comm: Optional[CommModel] = None,
                 collect_outputs_of: Optional[str] = None):
        self.by_name, self.by_id = build_actors(specs)
        self.comm = comm or CommModel()
        self.collect = collect_outputs_of
        self._seq = itertools.count()
        self.heap: List[Tuple[float, int, str, Any]] = []
        self.thread_free: Dict[Tuple[int, int], float] = {}
        self.busy: Dict[str, bool] = {n: False for n in self.by_name}
        self.outputs: List[Any] = []

    def _push(self, t: float, kind: str, data: Any) -> None:
        heapq.heappush(self.heap, (t, next(self._seq), kind, data))

    def _duration(self, actor: Actor) -> float:
        d = actor.spec.duration
        return d(actor.version) if callable(d) else float(d)

    def _try_fire(self, actor: Actor, now: float) -> None:
        if self.busy[actor.spec.name] or not actor.ready():
            return
        key = (actor.spec.node, actor.spec.thread)
        start = max(now, self.thread_free.get(key, 0.0))
        dur = self._duration(actor)
        end = start + dur
        self.thread_free[key] = end
        self.busy[actor.spec.name] = True
        out, acks, reg_id = actor.fire()
        version = actor.version - 1
        actor.history.append((start, end))
        if self.collect == actor.spec.name and actor.emitted_last_fire:
            self.outputs.append(out)
        self._push(end, "action_end",
                   (actor.spec.name, out, acks, reg_id, version))

    def run(self, max_events: int = 10_000_000) -> SimResult:
        now = 0.0
        for a in self.by_name.values():
            self._try_fire(a, 0.0)
        events = 0
        while self.heap:
            events += 1
            if events > max_events:
                raise RuntimeError("simulator exceeded max_events")
            now, _, kind, data = heapq.heappop(self.heap)
            if kind == "action_end":
                name, out, acks, reg_id, version = data
                actor = self.by_name[name]
                self.busy[name] = False
                for ack in acks:
                    lat = self.comm.latency(ack.src, ack.dst, 64)
                    self._push(now + lat, "deliver_ack", ack)
                if reg_id != -1:
                    for req in actor.emit_reqs(out, reg_id, version):
                        lat = self.comm.latency(req.src, req.dst, req.nbytes)
                        self._push(now + lat, "deliver_req", req)
                self._try_fire(actor, now)
            elif kind == "deliver_req":
                req: Req = data
                actor = self.by_id[req.dst]
                actor.on_req(req)
                self._try_fire(actor, now)
            elif kind == "deliver_ack":
                ack: Ack = data
                actor = self.by_id[ack.dst]
                actor.on_ack(ack)
                self._try_fire(actor, now)

        # detect deadlock / starvation: any actor with pending input that never ran
        pending = sum(
            sum(len(q) for q in a.in_queues.values()) for a in self.by_name.values())
        not_done = [a for a in self.by_name.values()
                    if not a.exhausted and a.spec.max_fires is not None]
        deadlocked = pending > 0 or bool(not_done)
        return SimResult(
            makespan=now,
            history={n: a.history for n, a in self.by_name.items()},
            peak_regs={n: a.peak_regs_in_use for n, a in self.by_name.items()},
            fires={n: a.fired for n, a in self.by_name.items()},
            outputs=self.outputs,
            deadlocked=deadlocked,
            pending_at_deadlock=pending,
        )


def simulate(specs: Sequence[ActorSpec], **kw) -> SimResult:
    return Simulator(specs, **kw).run()
