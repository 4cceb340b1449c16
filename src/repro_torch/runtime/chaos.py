"""Deterministic fault injection on the Runtime seam (port of
``repro/runtime/chaos.py``; the elastic-training gate).

The paper's actor model claims the register/counter protocol -- not timing
luck -- carries correctness: every dependency (data, resources, movement) is
an explicit counter, so a delayed, duplicated or reordered message must
never change *what* is computed, only *when*. A :class:`FaultPlan` rides
into the threads runtime through ``make_runtime(kind, builder,
faults=...)`` and a :class:`FaultInjector` applies it deterministically:

* :class:`KillWorker` -- raise :class:`WorkerKilled` immediately before the
  named actor's Nth fire. The epoch surfaces it as a ``WorkerError`` and
  the snapshot-restore path takes over.
* :class:`DelayEdge` -- deliver one ``Req`` on a named edge late. Sound by
  construction: the producer's register stays referenced until the
  consumer acks, so the epoch cannot conclude under a delayed message.
* :class:`DuplicateReq` -- deliver one ``Req`` twice. The consumer's
  per-channel resequencer (:meth:`repro_torch.runtime.actor.Actor.on_req`)
  drops the second copy *without* acking it, so the producer's reference
  count stays consistent.
* :class:`DropAck` -- swallow one ``Ack``. The producer's register is never
  recycled, so a quota-bound producer wedges and the epoch surfaces as the
  runtime's ``TimeoutError`` naming the stuck actor -- a *detected* fault,
  never silent corruption.

Faults are one-shot: each entry triggers at most once per injector. The
reference's process runtime, where a kill is a real ``os._exit`` of the
stage's worker process, is not ported yet (ROADMAP Queue 1 item 11).

Delayed delivery runs on a daemon ``threading.Timer``. A timer that
outlives its epoch (possible only after the epoch was abandoned by timeout
or error) drops its message instead of poisoning the next epoch: it
captures the epoch counter and the epoch's own mailbox table.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from repro_torch.runtime.base import WorkerError
from repro_torch.runtime.messages import Req


class WorkerKilled(WorkerError):
    """A :class:`KillWorker` fault fired under ``runtime="threads"``.

    Subclasses :class:`WorkerError`, so kill-and-resume callers catch one
    exception type whatever the runtime."""


@dataclasses.dataclass(frozen=True)
class KillWorker:
    """Kill the worker hosting ``actor`` immediately before its Nth fire
    (``fire`` is 1-based and cumulative across epochs and steps)."""

    actor: str
    fire: int = 1


@dataclasses.dataclass(frozen=True)
class DelayEdge:
    """Hold the ``Req`` for ``version`` on edge ``src -> dst`` for
    ``seconds`` before delivering it (``version=None``: the first Req seen
    on the edge)."""

    src: str
    dst: str
    seconds: float = 0.05
    version: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DuplicateReq:
    """Deliver the ``Req`` for ``version`` on edge ``src -> dst`` twice."""

    src: str
    dst: str
    version: int = 0


@dataclasses.dataclass(frozen=True)
class DropAck:
    """Swallow the ``Ack`` for ``version`` on edge ``src -> dst`` (``src``
    is the consumer sending the ack, ``dst`` the producer awaiting it)."""

    src: str
    dst: str
    version: int = 0


Fault = Union[KillWorker, DelayEdge, DuplicateReq, DropAck]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, picklable set of faults to inject into one run."""

    faults: Tuple[Fault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        kinds = (KillWorker, DelayEdge, DuplicateReq, DropAck)
        for f in self.faults:
            if not isinstance(f, kinds):
                raise ValueError(f"unknown fault type: {f!r}")


class FaultInjector:
    """Applies a :class:`FaultPlan` inside one engine.

    The engine calls :meth:`before_fire` on the firing actor's thread and
    :meth:`route` for every outgoing message; both are cheap no-ops once
    every fault has triggered. ``applied`` records each fault as it
    triggers: ``(kind, src or actor, dst or None, version or fire)``.
    """

    def __init__(self, plan: FaultPlan, process_mode: bool = False):
        if process_mode:
            raise NotImplementedError(
                "process-mode fault injection (a KillWorker as os._exit of "
                "a worker process) is not ported yet (ROADMAP Queue 1 item "
                "11)")
        self.plan = plan
        self._fired = {}        # actor name -> cumulative fire attempts
        self._done = set()      # indices of consumed (one-shot) faults
        self._armed = len(plan.faults) > 0
        self.applied: List[Tuple[str, str, Optional[str], Optional[int]]] = []

    def _record(self, fault, msg) -> None:
        self.applied.append((type(fault).__name__, fault.src, fault.dst,
                             getattr(msg, "version", None)))

    # -- fire-path faults --------------------------------------------------------
    def before_fire(self, name: str) -> None:
        """Called immediately before actor ``name`` fires; may not return."""
        if not self._armed:
            return
        n = self._fired.get(name, 0) + 1
        self._fired[name] = n
        for i, f in enumerate(self.plan.faults):
            if i in self._done or not isinstance(f, KillWorker):
                continue
            if f.actor == name and f.fire == n:
                self._done.add(i)
                self.applied.append(("KillWorker", name, None, n))
                raise WorkerKilled(
                    f"fault injection: killed worker at {name} fire {n}",
                    node=None)

    # -- message-path faults -----------------------------------------------------
    def route(self, msg, src_name: str, dst_name: str):
        """Map one outgoing message to ``[(message, delay_seconds), ...]``
        (empty list: dropped)."""
        out = [(msg, 0.0)]
        if not self._armed:
            return out
        is_req = isinstance(msg, Req)
        for i, f in enumerate(self.plan.faults):
            if i in self._done:
                continue
            if isinstance(f, DelayEdge) and is_req:
                if (f.src == src_name and f.dst == dst_name
                        and (f.version is None or f.version == msg.version)):
                    self._done.add(i)
                    self._record(f, msg)
                    out = [(m, d + f.seconds) for m, d in out]
            elif isinstance(f, DuplicateReq) and is_req:
                if (f.src == src_name and f.dst == dst_name
                        and f.version == msg.version):
                    self._done.add(i)
                    self._record(f, msg)
                    out = out + [(msg, 0.0)]
            elif isinstance(f, DropAck) and not is_req:
                # Ack direction: consumer (src) -> producer (dst)
                if (f.src == src_name and f.dst == dst_name
                        and f.version == msg.version):
                    self._done.add(i)
                    self._record(f, msg)
                    out = []
        return out
