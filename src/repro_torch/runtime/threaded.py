"""Real threaded actor runtime — actors on OS threads with FIFO mailboxes.

This is the paper's Fig 7 implementation for the host side of the program:
each (node, thread) key of the actor graph gets one OS thread and a FIFO
mailbox, with the req/ack + register-quota protocol of
:mod:`repro_torch.runtime.actor`. Because the quota is enforced, a fast
producer is back-pressured instead of buffering unboundedly (§4.3).

* :class:`_LocalEngine` — drives the *local subset* of an actor graph on OS
  threads. With every key local it IS the threaded runtime's engine; each
  :class:`repro_torch.runtime.process.ProcessRuntime` worker runs one over
  its own node's keys, with cross-node messages diverted through
  ``send_remote``.
* :class:`ThreadedRuntime` — the :class:`repro_torch.runtime.base.Runtime`
  implementation executors use in-process. Persistent: one instance runs
  many epochs (rounds); actors reset at the *start* of each run so their
  counters stay inspectable afterwards.

Completion is event-driven, not polled. Each engine keeps two lock-protected
counters: ``pending`` (remaining fires of local bounded actors) and ``live``
(local out-register instances not yet fully acked). Both are updated
*before* any ack/req from a fire is posted, so "both zero" (quiescence) can
never be observed while a local actor still owes the graph a message: an
unsent ack means the producer's register is still referenced, which keeps
the producer's ``live`` non-zero. When every key is local, quiescence is
exactly completion; across processes it feeds the termination protocol of
:mod:`repro_torch.runtime.process`.

Worker threads are started afresh every epoch. Thread-local state of the
frameworks underneath (PyTorch's grad mode, current CUDA stream and device)
therefore starts at its default in every round; actor bodies that need a
mode set it themselves. So are the mailboxes: a message a delayed-delivery
timer (:mod:`repro_torch.runtime.chaos`) holds past its epoch lands in that
epoch's abandoned mailbox table, never in the next epoch's.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.runtime.actor import Actor, ActorSpec, build_actors
from repro_torch.runtime.base import Runtime, _check_epoch_names
from repro_torch.runtime.messages import Req, node_of, thread_of


def _no_remote(msg) -> None:
    raise RuntimeError(
        f"message for non-local actor {msg.dst:#x} but no remote transport "
        "is attached (send_remote hook unset)")


class _LocalEngine:
    """Drive the local (node, thread) keys of an actor graph on OS threads.

    All actors are *built* (IDs and consumer wiring need the whole graph)
    but only those on ``local_keys`` (default: every key) are run; a
    message addressed off the node goes through the ``send_remote`` hook.
    Owners attach:

    * ``send_remote(msg)`` — deliver a Req/Ack to a non-local key
    * ``on_output(name, value, version)`` — a collected actor emitted
    * ``on_quiescence(flag)`` — quiescence changed (called under the
      counter lock, so reports are emitted in transition order)
    * ``on_error(exc, key)`` — a worker thread raised
    * ``fault_injector`` — an optional
      :class:`repro_torch.runtime.chaos.FaultInjector`, consulted before
      every fire and for every outgoing message
    * ``trace_recorder`` — an optional
      :class:`repro_torch.analysis.trace.TraceRecorder`, which records
      every Req delivery (the version, what the resequencer released) so
      the trace sanitizer can certify the run restored canonical order
    """

    def __init__(self, specs: Sequence[ActorSpec],
                 local_keys: Optional[Sequence[Tuple[int, int]]] = None):
        self.specs = list(specs)
        self.by_name, self.by_id = build_actors(self.specs)
        all_keys = sorted({(s.node, s.thread) for s in self.specs})
        wanted = set(all_keys if local_keys is None else local_keys)
        self.local_keys = [k for k in all_keys if k in wanted]
        self.local_actors: List[Actor] = [
            a for a in self.by_name.values()
            if (a.spec.node, a.spec.thread) in wanted]
        self.actors_on: Dict[Tuple[int, int], List[Actor]] = \
            collections.defaultdict(list)
        for a in self.local_actors:
            self.actors_on[(a.spec.node, a.spec.thread)].append(a)
        # hooks
        self.send_remote: Callable[[Any], None] = _no_remote
        self.on_output: Optional[Callable[[str, Any, int], None]] = None
        self.on_quiescence: Optional[Callable[[bool], None]] = None
        self.on_error: Optional[Callable[[BaseException, Tuple[int, int]], None]] = None
        self.collect_names: Set[str] = set()
        self.fault_injector = None
        self.trace_recorder = None
        # epoch state
        self._epoch = 0
        self._mailboxes: Dict[Tuple[int, int], queue.Queue] = {}
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._pending = 0
        self._live = 0
        self._quiescent = True
        self._stopping = False
        self._t0 = time.perf_counter()

    # -- epoch lifecycle ---------------------------------------------------------
    def start_epoch(self, ctx: Optional[Dict[str, Any]] = None,
                    fires: Optional[Dict[str, int]] = None) -> None:
        """Reset the local actors and launch one worker thread per local
        key.

        ``fires`` overrides per-actor fire bounds for this epoch only;
        ``ctx`` is routed to each actor's ``on_epoch`` hook (hooks with no
        entry still run with ``None`` so per-epoch state resets happen)."""
        ctx = ctx or {}
        fires = fires or {}
        self._epoch += 1
        if self.trace_recorder is not None:
            # resequencer state resets per epoch; the trace sanitizer
            # checks canonical order per (epoch, consumer, channel)
            self.trace_recorder.current_epoch = self._epoch
        self._stopping = False
        for a in self.local_actors:
            a.reset(max_fires=fires.get(a.spec.name))
        # hooks run after every reset: an on_epoch that seeds an upstream
        # cell must not race a half-reset consumer
        for a in self.local_actors:
            if a.spec.on_epoch is not None:
                a.spec.on_epoch(ctx.get(a.spec.name))
        pending = sum(a.max_fires - a.fired for a in self.local_actors
                      if a.max_fires is not None)
        # fresh mailboxes per epoch: anything a previous (timed-out) epoch
        # left queued is unreachable garbage, not a poisoned message
        self._mailboxes = {k: queue.Queue() for k in self.local_keys}
        self._t0 = time.perf_counter()
        with self._lock:
            self._pending = pending
            self._live = 0
            self._quiescent = (pending == 0)
            if self.on_quiescence is not None:
                self.on_quiescence(self._quiescent)
        self._threads = []
        epoch = self._epoch
        for key in self.local_keys:
            t = threading.Thread(target=self._worker, args=(key, epoch),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop_workers(self) -> None:
        self._stopping = True
        for box in self._mailboxes.values():
            box.put(None)

    def join_workers(self, timeout: float = 2.0) -> None:
        for t in self._threads:
            t.join(timeout=timeout)

    def snapshot(self):
        """(history, peak_regs, edge_bytes, fired) of the local actors."""
        hist = {a.spec.name: list(a.history) for a in self.local_actors}
        peaks = {a.spec.name: a.peak_regs_in_use for a in self.local_actors}
        edges = {(a.spec.name, cname): n for a in self.local_actors
                 for cname, n in a.edge_bytes.items()}
        fired = {a.spec.name: a.fired for a in self.local_actors}
        return hist, peaks, edges, fired

    # -- message routing ---------------------------------------------------------
    def post(self, msg) -> None:
        """Route an *originating* message (the sending engine's side). With
        a fault injector attached it may be delayed, duplicated or dropped
        here; :meth:`deliver` is the fault-free path, which messages from
        another process take (they were routed at their sender)."""
        inj = self.fault_injector
        if inj is None:
            self.deliver(msg)
            return
        src = self.by_id[msg.src].spec.name
        dst = self.by_id[msg.dst].spec.name
        epoch, boxes = self._epoch, self._mailboxes
        for m, delay in inj.route(msg, src, dst):
            if delay > 0:
                t = threading.Timer(delay, self._deliver_late,
                                    args=(m, epoch, boxes))
                t.daemon = True
                t.start()
            else:
                self.deliver(m)

    def deliver(self, msg) -> None:
        box = self._mailboxes.get((node_of(msg.dst), thread_of(msg.dst)))
        if box is not None:
            box.put(msg)
        else:
            self.send_remote(msg)

    def _deliver_late(self, msg, epoch: int, boxes) -> None:
        """Timer callback for a delayed message. A pending delayed Req/Ack
        keeps its producer's register referenced, so the epoch cannot
        conclude before delivery; if the epoch was abandoned nevertheless
        (timeout or error), the message is dropped, or at worst lands in
        the *captured* mailbox table -- a stale epoch's boxes, which no
        worker reads again."""
        if self._epoch != epoch or self._stopping:
            return
        box = boxes.get((node_of(msg.dst), thread_of(msg.dst)))
        if box is not None:
            box.put(msg)
        else:
            self.send_remote(msg)

    # -- counters ----------------------------------------------------------------
    def _bump(self, dpending: int, dlive: int) -> None:
        with self._lock:
            self._pending += dpending
            self._live += dlive
            q = (self._pending == 0 and self._live == 0)
            if q != self._quiescent:
                self._quiescent = q
                if self.on_quiescence is not None:
                    self.on_quiescence(q)

    @property
    def quiescent(self) -> bool:
        with self._lock:
            return self._quiescent

    # -- worker loop -------------------------------------------------------------
    def _worker(self, key: Tuple[int, int], epoch: int) -> None:
        box = self._mailboxes[key]
        try:
            self._fire_ready(key, epoch)
            while True:
                msg = box.get()
                if msg is None or self._epoch != epoch:
                    return
                actor = self.by_id[msg.dst]
                if isinstance(msg, Req):
                    if self.trace_recorder is None:
                        actor.on_req(msg)
                    else:
                        self._traced_on_req(self.trace_recorder, actor, msg)
                elif actor.on_ack(msg):
                    self._bump(0, -1)
                self._fire_ready(key, epoch)
        except BaseException as e:  # surface worker crashes to the owner
            self._stopping = True
            if self.on_error is not None:
                self.on_error(e, key)
            self.stop_workers()

    @staticmethod
    def _traced_on_req(rec, actor: Actor, msg: Req) -> None:
        """Deliver a Req through the resequencer while recording what it
        did: the versions released to the FIFO (empty for a buffered early
        arrival) and whether the message was accepted at all (duplicates
        are dropped without an ack)."""
        ch = msg.channel
        before = actor.in_next.get(ch)
        if before is None:                      # undeclared channel: FIFO
            actor.on_req(msg)
            rec.record_delivery(actor.spec.name, ch, msg.version,
                                (msg.version,), 1)
            return
        pend_before = len(actor.in_pending[ch])
        actor.on_req(msg)
        stride = actor.in_stride[ch]
        released = tuple(range(before, actor.in_next[ch], stride))
        accepted = bool(released) or len(actor.in_pending[ch]) > pend_before
        rec.record_delivery(actor.spec.name, ch, msg.version, released,
                            stride, accepted)

    def _fire_ready(self, key: Tuple[int, int], epoch: int) -> None:
        progressed = True
        while progressed and not self._stopping:
            progressed = False
            for actor in self.actors_on[key]:
                while (actor.ready() and not self._stopping
                       and self._epoch == epoch):
                    if self.fault_injector is not None:
                        # may raise WorkerKilled (threads) or hard-exit the
                        # process (a KillWorker under runtime="processes")
                        self.fault_injector.before_fire(actor.spec.name)
                    start = time.perf_counter() - self._t0
                    out, acks, reg_id = actor.fire()
                    # wall-clock action history, so pipeline overlap can be
                    # observed on real threads
                    actor.history.append((start, time.perf_counter() - self._t0))
                    version = actor.version - 1
                    # outputs report BEFORE the counter bump: the epoch's
                    # last output then provably precedes quiescence
                    if (actor.spec.name in self.collect_names
                            and actor.emitted_last_fire
                            and self.on_output is not None):
                        self.on_output(actor.spec.name, out, version)
                    # counters move BEFORE the fire's messages go out —
                    # completion must be unobservable while acks are unsent
                    self._bump(-1 if actor.max_fires is not None else 0,
                               1 if reg_id != -1 else 0)
                    for ack in acks:
                        self.post(ack)
                    if reg_id != -1:
                        for req in actor.emit_reqs(out, reg_id, version):
                            self.post(req)
                    progressed = True


class ThreadedRuntime(Runtime):
    """Drive a graph of :class:`ActorSpec`s on OS threads, in-process.

    ``collect_outputs_of`` names the actor(s) whose outputs :meth:`run`
    returns: a single name yields a flat list (fire order), a sequence of
    names yields ``{name: [outputs...]}``.

    Persistent: one instance serves many :meth:`run` epochs. Actors reset at
    the *start* of the next run, so ``by_name`` counters (fired, out_counter,
    peak_regs_in_use) remain inspectable after a run.

    ``faults`` is an optional :class:`repro_torch.runtime.chaos.FaultPlan`
    applied by a :class:`~repro_torch.runtime.chaos.FaultInjector`
    (``fault_injector``; its ``applied`` list records what triggered).
    ``trace`` is an optional :class:`repro_torch.analysis.trace
    .TraceRecorder`: the engine records every Req delivery into it, and the
    injector every fault it applies, for
    :func:`repro_torch.analysis.trace.check_trace`.
    """

    def __init__(self, specs: Sequence[ActorSpec],
                 collect_outputs_of=None, faults=None, trace=None):
        self._engine = _LocalEngine(specs)
        self.fault_injector = None
        if faults is not None:
            from repro_torch.runtime.chaos import FaultInjector
            self.fault_injector = FaultInjector(faults)
            self._engine.fault_injector = self.fault_injector
        if trace is not None:
            self._engine.trace_recorder = trace
            if self.fault_injector is not None:
                self.fault_injector.recorder = trace
        self.by_name = self._engine.by_name
        self.by_id = self._engine.by_id
        self._collect_single = (collect_outputs_of is None
                                or isinstance(collect_outputs_of, str))
        names = ([collect_outputs_of] if self._collect_single else
                 list(collect_outputs_of))
        self._collect_names = {n for n in names if n is not None}
        self._engine.collect_names = self._collect_names
        self._engine.on_output = self._on_output
        self._engine.on_quiescence = self._on_quiescence
        self._engine.on_error = self._on_error
        self.outputs: List[Any] = []
        self.outputs_by_name: Dict[str, List[Any]] = {
            n: [] for n in self._collect_names}
        self._outputs_lock = threading.Lock()
        self._wake = threading.Event()
        self._errors: List[Tuple[BaseException, Tuple[int, int]]] = []
        self.last_history: Dict[str, List[Tuple[float, float]]] = {}
        self.last_peak_regs: Dict[str, int] = {}
        self.last_edge_bytes: Dict[Tuple[str, str], int] = {}
        self.last_fired: Dict[str, int] = {}

    # -- engine hooks ------------------------------------------------------------
    def _on_output(self, name: str, value: Any, version: int) -> None:
        with self._outputs_lock:
            self.outputs_by_name[name].append(value)
            if self._collect_single:
                self.outputs.append(value)

    def _on_quiescence(self, q: bool) -> None:
        if q:
            self._wake.set()

    def _on_error(self, exc: BaseException, key: Tuple[int, int]) -> None:
        self._errors.append((exc, key))
        self._wake.set()

    # -- public API --------------------------------------------------------------
    def run(self, ctx: Optional[Dict[str, Any]] = None,
            fires: Optional[Dict[str, int]] = None,
            timeout: float = 120.0):
        """Run one epoch until every bounded actor has exhausted its fires.

        ``ctx`` feeds per-actor ``on_epoch`` hooks (a serve round's work
        list); ``fires`` overrides fire bounds for this epoch. Returns the
        collected outputs: a flat list when a single actor name was given,
        else ``{name: [outputs...]}``.
        """
        _check_epoch_names(self._engine.specs, ctx, fires)
        fires = fires or {}
        effective = {s.name: fires.get(s.name, s.max_fires)
                     for s in self._engine.specs}
        if not any(v is not None for v in effective.values()):
            raise ValueError("threaded runtime needs at least one bounded actor")
        self.outputs = []
        self.outputs_by_name = {n: [] for n in self._collect_names}
        self._errors = []
        self._wake.clear()
        self._engine.start_epoch(ctx, fires)
        deadline = time.monotonic() + timeout
        while True:
            if self._errors or self._engine.quiescent:
                break
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._wake.wait(remaining)
            self._wake.clear()
        self._engine.stop_workers()
        self._engine.join_workers(2.0)
        (self.last_history, self.last_peak_regs,
         self.last_edge_bytes, self.last_fired) = self._engine.snapshot()
        if self._errors:
            exc, key = self._errors[0]
            exc.add_note(f"raised in actor worker thread "
                         f"(node={key[0]}, thread={key[1]})")
            # re-raise with the worker thread's original traceback attached
            raise exc
        bounded = [a for a in self._engine.local_actors
                   if a.max_fires is not None]
        if not all(a.exhausted for a in bounded):
            raise TimeoutError(
                "threaded actor runtime did not complete: "
                + ", ".join(f"{a.spec.name}={a.fired}/{a.max_fires}"
                            for a in bounded if not a.exhausted))
        outs = self.outputs if self._collect_single else self.outputs_by_name
        # keep no reference to what was returned: a train step's collected
        # payloads hold gradients the size of the model
        self.outputs = []
        self.outputs_by_name = {n: [] for n in self._collect_names}
        return outs

    def close(self) -> None:
        self._engine.stop_workers()
        self._engine.join_workers(0.5)
