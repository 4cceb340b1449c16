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

For ``kind="processes"`` the builder must be picklable: it is shipped to one
worker process per node id (paper Fig 7/8 -- the node field of the 64-bit
actor address becomes a real OS process) and re-lowers its stages there
from a recipe (:mod:`repro_torch.runtime.recipes`). A payload that crosses
a node is rebuilt by :func:`encode_payload`: tensors stay tensors (a CUDA
tensor crosses by CUDA IPC, a CPU tensor by shared memory), so bf16 and
ZeRO states cross bitwise. A fault plan (:mod:`repro_torch.runtime.chaos`)
rides into either runtime through ``make_runtime(kind, builder,
faults=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

RUNTIME_KINDS = ("threads", "processes")

#: builder protocol: () -> (List[ActorSpec], collect_outputs_of)
SpecBuilder = Callable[[], Tuple[List[Any], Any]]


class WorkerError(RuntimeError):
    """A worker died or raised (on the threads runtime: an injected
    :class:`repro_torch.runtime.chaos.WorkerKilled`). ``node`` is the
    actor-address node of the worker when known; ``remote_traceback`` the
    worker process's traceback text, when it could post one."""

    def __init__(self, message: str, node: Optional[int] = None,
                 remote_traceback: Optional[str] = None):
        super().__init__(message)
        self.node = node
        self.remote_traceback = remote_traceback


class RemoteTraceback(Exception):
    """Raised as the ``__cause__`` of a :class:`WorkerError`, so the worker
    process's frames show chained under the driver's raise."""

    def __str__(self):
        return "\n" + self.args[0] if self.args else ""


def encode_payload(payload: Any) -> Any:
    """A register payload made ready to cross a node (process) boundary:
    containers rebuilt around :func:`_encode`'s tensors, and the private
    top-level keys (``"__"``-prefixed: an op tape, a stage's gradient dict,
    ZeRO's flat masters -- contracts between actors of one node) stripped;
    they are never wire format."""
    if isinstance(payload, dict):
        return {k: _encode(v) for k, v in payload.items()
                if not (isinstance(k, str) and k.startswith("__"))}
    return _encode(payload)


def _encode(v: Any) -> Any:
    """``v`` with every tensor leaf made ready for the wire, detached: a
    CUDA tensor as it is (the queue's pickler exports it by CUDA IPC, so the
    receiver gets a view of this process's memory and nothing is copied to
    the host), a CPU tensor as a private copy (the pickler moves a CPU
    storage into shared memory, which must not happen under a tensor
    another thread is using)."""
    return map_tensors(v, _wire_tensor)


def _wire_tensor(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t if t.is_cuda else t.clone()


def map_tensors(v: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """``v`` with ``fn`` applied to every tensor leaf: dicts, lists, tuples,
    NamedTuples (``AdamWState``, ``ZeroState``) and dataclasses (the serve
    work items) are rebuilt, anything else is returned as it is."""
    if isinstance(v, torch.Tensor):
        return fn(v)
    if isinstance(v, dict):
        return {k: map_tensors(x, fn) for k, x in v.items()}
    if isinstance(v, list):
        return [map_tensors(x, fn) for x in v]
    if isinstance(v, tuple) and not isinstance(v, torch.Size):
        items = (map_tensors(x, fn) for x in v)
        return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.replace(v, **{
            f.name: map_tensors(getattr(v, f.name), fn)
            for f in dataclasses.fields(v) if f.init})
    return v


class Runtime:
    """What the executors program against (duck-typed base; the concrete
    runtimes are :class:`repro_torch.runtime.threaded.ThreadedRuntime` and
    :class:`repro_torch.runtime.process.ProcessRuntime`).

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
                 collect_outputs_of=None, faults=None,
                 trace=None) -> Runtime:
    """Build a runtime of ``kind`` over the actor graph ``builder`` yields.

    ``"threads"`` calls the builder in-process and drives every actor on OS
    threads; ``"processes"`` ships the (picklable) builder to one worker
    process per node id. ``collect_outputs_of`` overrides the builder's own
    collect choice when given. ``faults`` is an optional
    :class:`repro_torch.runtime.chaos.FaultPlan` injected deterministically
    into the engines (kill-at-fire, delayed or duplicated Reqs, dropped
    Acks). ``trace`` is an optional :class:`repro_torch.analysis.trace
    .TraceRecorder` capturing every Req delivery (and applied fault) for
    the trace sanitizer -- threads runtime only, since the recorder is
    shared mutable state the worker processes could not see."""
    if kind not in RUNTIME_KINDS:
        raise ValueError(
            f"unknown runtime {kind!r}; expected one of {RUNTIME_KINDS}")
    if kind == "processes":
        if trace is not None:
            raise ValueError(
                "trace= requires runtime='threads' (deliveries happen inside "
                "worker processes the recorder cannot observe)")
        from repro_torch.runtime.process import ProcessRuntime
        return ProcessRuntime(builder, collect_outputs_of=collect_outputs_of,
                              faults=faults)
    from repro_torch.runtime.threaded import ThreadedRuntime
    specs, collect = builder()
    if collect_outputs_of is not None:
        collect = collect_outputs_of
    return ThreadedRuntime(specs, collect_outputs_of=collect, faults=faults,
                           trace=trace)
