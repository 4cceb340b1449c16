"""The Runtime seam: the protocol executors program against.

The executors in :mod:`repro_torch.runtime.pipeline` never name a concrete
runtime class; they hold a *spec builder* (a callable returning ``(specs,
collect_outputs_of)``) and ask :func:`make_runtime` for a :class:`Runtime`.
A runtime is built ONCE per executor and reused across rounds — actors are
resettable state machines (:meth:`repro_torch.runtime.actor.Actor.reset`),
so each :meth:`Runtime.run` starts a fresh *epoch* over the same actor graph:

* per-epoch inputs arrive through ``ctx`` (``{actor name: value}``), applied
  by each actor's ``ActorSpec.on_epoch`` hook before any fire;
* per-epoch fire bounds arrive through ``fires`` (``{actor name: count}``,
  e.g. a serve round's work count), overriding ``ActorSpec.max_fires``;
* persistent per-stage state (placed weights, optimizer state, serve
  caches) lives in the actor closures and never round-trips through the
  executor.

Only ``kind="threads"`` exists in this package so far; the process runtime,
and with it the host encoding of payloads that cross a process boundary, is
still to be ported (ROADMAP Queue 1 item 11). A fault plan
(:mod:`repro_torch.runtime.chaos`) rides into the threads runtime through
``make_runtime(kind, builder, faults=...)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

RUNTIME_KINDS = ("threads",)

#: builder protocol: () -> (List[ActorSpec], collect_outputs_of)
SpecBuilder = Callable[[], Tuple[List[Any], Any]]


class WorkerError(RuntimeError):
    """A worker died or raised (on the threads runtime: an injected
    :class:`repro_torch.runtime.chaos.WorkerKilled`). ``node`` is the
    actor-address node of the worker when known."""

    def __init__(self, message: str, node: Optional[int] = None):
        super().__init__(message)
        self.node = node


class Runtime:
    """What the executors program against (duck-typed base; the concrete
    runtime is :class:`repro_torch.runtime.threaded.ThreadedRuntime`).

    ``run(ctx=, fires=, timeout=)`` executes one epoch and returns the
    collected outputs (a flat list for a single collected actor, else
    ``{name: [outputs...]}``). After each run the instrumentation of the
    epoch is available as ``last_history`` (per-actor action intervals),
    ``last_peak_regs`` (per-actor peak out-registers in use),
    ``last_edge_bytes`` (``{(producer, consumer): bytes}`` traffic) and
    ``last_fired`` (per-actor fire counts). ``close()`` releases workers.
    """

    last_history: Dict[str, List[Tuple[float, float]]]
    last_peak_regs: Dict[str, int]
    last_edge_bytes: Dict[Tuple[str, str], int]
    last_fired: Dict[str, int]

    def run(self, ctx: Optional[Dict[str, Any]] = None,
            fires: Optional[Dict[str, int]] = None,
            timeout: float = 120.0):
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _check_epoch_names(specs, ctx, fires) -> None:
    known = {s.name for s in specs}
    for what, d in (("ctx", ctx), ("fires", fires)):
        for name in (d or {}):
            if name not in known:
                raise ValueError(
                    f"{what} names unknown actor {name!r}; "
                    f"actors: {sorted(known)}")


def make_runtime(kind: str, builder: SpecBuilder,
                 collect_outputs_of=None, faults=None) -> Runtime:
    """Build a runtime of ``kind`` over the actor graph ``builder`` yields.

    ``"threads"`` calls the builder in-process and drives every actor on OS
    threads. ``collect_outputs_of`` overrides the builder's own collect
    choice when given. ``faults`` is an optional
    :class:`repro_torch.runtime.chaos.FaultPlan` injected deterministically
    into the engine (kill-at-fire, delayed or duplicated Reqs, dropped
    Acks). ``"processes"`` is not ported yet."""
    if kind == "processes":
        raise NotImplementedError(
            "runtime='processes' is not ported yet (ROADMAP Queue 1 item 11)")
    if kind not in RUNTIME_KINDS:
        raise ValueError(
            f"unknown runtime {kind!r}; expected one of {RUNTIME_KINDS}")
    from repro_torch.runtime.threaded import ThreadedRuntime
    specs, collect = builder()
    if collect_outputs_of is not None:
        collect = collect_outputs_of
    return ThreadedRuntime(specs, collect_outputs_of=collect, faults=faults)
