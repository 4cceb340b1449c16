"""The actor protocol (paper §4): registers, counters, req/ack state machine.

This module is *driver-agnostic*: the same :class:`Actor` logic is advanced by
any driver — in this package the threaded runtime
(:mod:`repro_torch.runtime.threaded`). Drivers deliver messages and ask
``actor.ready()`` / ``actor.fire()``; the actor owns all counter bookkeeping:

* ``in counter``   — per input channel: tensors ready to consume.
* ``out counter``  — free out-register quota (pre-allocated memory budget).
* ``reference counter`` — per out-register instance: active consumers.

An action fires only when every in counter is non-zero AND the out counter is
non-zero — resource availability is an explicit dependency (paper §4.2),
which is what prevents the Fig. 2 OOM/deadlock and gives back-pressure/
pipelining for free (§4.3).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.messages import Ack, Req, make_actor_id, payload_nbytes


@dataclasses.dataclass
class ActorSpec:
    """Static description of one actor (one physical op)."""

    name: str
    fn: Callable[..., Any]                  # action body (real or dummy)
    inputs: Tuple[str, ...] = ()            # producer actor names
    out_regs: int = 2                       # out-register quota (memory budget)
    node: int = 0
    thread: int = 0
    queue: int = 0
    duration: Any = 1.0                     # sim-mode cost (float or fn(version))
    max_fires: Optional[int] = None         # e.g. #batches for source actors
    out_nbytes: int = 0                     # for comm cost in sim mode
    wants_version: bool = False             # fn also receives version= kwarg
    emit_every: int = 1                     # emit output every k-th fire only
    on_epoch: Optional[Callable[[Any], None]] = None
    # ^ per-epoch context hook: a persistent runtime calls it with this
    #   actor's slice of the run() ctx before any fire of the new epoch
    #   (None when the epoch carries nothing for this actor)


_reg_counter = itertools.count(1)


class Actor:
    """Protocol state machine for one actor."""

    def __init__(self, spec: ActorSpec, actor_id: int,
                 consumers: Sequence[Tuple[int, str]]):
        self.spec = spec
        self.actor_id = actor_id
        # consumers: list of (consumer_actor_id, channel_name)
        self.consumers = list(consumers)
        self.consumer_names: Dict[int, str] = {}    # filled by build_actors
        # in-register state: channel -> FIFO of Req (holding payload refs)
        self.in_queues: Dict[str, collections.deque] = {
            ch: collections.deque() for ch in spec.inputs}
        # per-channel resequencer: a producer with emit_every=k emits
        # versions k-1, 2k-1, ... — `in_stride`/`in_next` track the next
        # expected version so duplicated or reordered Req deliveries (a
        # lossy transport, or chaos injection) are deduplicated/reordered
        # here instead of corrupting the FIFO. build_actors fills the real
        # strides from the producers' specs.
        self.in_stride: Dict[str, int] = {ch: 1 for ch in spec.inputs}
        self.in_next: Dict[str, int] = {ch: 0 for ch in spec.inputs}
        self.in_pending: Dict[str, Dict[int, Req]] = {
            ch: {} for ch in spec.inputs}
        # out-register state
        self.out_counter = spec.out_regs
        self.refcount: Dict[int, int] = {}          # reg instance -> refs
        self.reg_payload: Dict[int, Any] = {}
        self.fired = 0
        self.version = 0
        self.epoch = 0
        self.max_fires = spec.max_fires             # per-epoch override target
        self.last_nbytes = 0                        # bytes of the last payload
        # instrumentation
        self.peak_regs_in_use = 0
        self.history: List[Tuple[float, float]] = []   # (start, end) of actions
        self.edge_bytes: Dict[str, int] = {}        # consumer name -> bytes sent

    def reset(self, max_fires: Optional[int] = None) -> None:
        """Start a new epoch: fire/version counters, in-flight registers and
        instrumentation are cleared so a persistent runtime can reuse the
        actor across runs. ``max_fires`` overrides the spec's bound for this
        epoch only (serve rounds vary their work count)."""
        self.in_queues = {ch: collections.deque() for ch in self.spec.inputs}
        self.in_next = {ch: s - 1 for ch, s in self.in_stride.items()}
        self.in_pending = {ch: {} for ch in self.spec.inputs}
        self.out_counter = self.spec.out_regs
        self.refcount.clear()
        self.reg_payload.clear()
        self.fired = 0
        self.version = 0
        self.epoch += 1
        self.max_fires = (self.spec.max_fires if max_fires is None
                          else max_fires)
        self.last_nbytes = 0
        self.peak_regs_in_use = 0
        self.history = []
        self.edge_bytes = {}

    # -- message handling -------------------------------------------------------
    def on_req(self, msg: Req) -> None:
        """Accept a produced register: dedup + resequence per channel.

        A duplicate delivery (version already consumed or already pending)
        is dropped *without* an ack — the first copy acks exactly once when
        consumed, so the producer's reference counter stays consistent. An
        early delivery (a later version overtaking an in-flight one) is
        buffered until the versions before it arrive, preserving the
        in-order FIFO the fire path consumes. In-order delivery — every
        non-chaotic transport — hits the buffer-and-drain path with an
        empty buffer.
        """
        ch = msg.channel
        nxt = self.in_next.get(ch)
        if nxt is None:                      # undeclared channel: legacy FIFO
            self.in_queues[ch].append(msg)
            return
        pend = self.in_pending[ch]
        if msg.version < nxt or msg.version in pend:
            return
        pend[msg.version] = msg
        stride = self.in_stride[ch]
        while nxt in pend:
            self.in_queues[ch].append(pend.pop(nxt))
            nxt += stride
        self.in_next[ch] = nxt

    def on_ack(self, msg: Ack) -> bool:
        """Returns True when the ack recycled the register (last reference)."""
        self.refcount[msg.reg_id] -= 1
        if self.refcount[msg.reg_id] == 0:
            # register recycled: memory quota returns (paper: out counter += 1)
            del self.refcount[msg.reg_id]
            del self.reg_payload[msg.reg_id]
            self.out_counter += 1
            return True
        return False

    # -- firing -------------------------------------------------------------------
    @property
    def exhausted(self) -> bool:
        return self.max_fires is not None and self.fired >= self.max_fires

    @property
    def emitted_last_fire(self) -> bool:
        """Whether the most recent fire emitted its output — false for the
        fires an ``emit_every`` accumulation actor suppressed. Drivers use
        this for output collection (``reg_id == -1`` can't distinguish
        'suppressed' from 'no consumers')."""
        return self.fired % max(1, self.spec.emit_every) == 0

    def ready(self) -> bool:
        if self.exhausted or self.out_counter <= 0:
            return False
        return all(q for q in self.in_queues.values())

    def fire(self) -> Tuple[Any, List[Ack], int]:
        """Execute the action. Returns (output_payload, acks_to_send, reg_id).

        The driver is responsible for sending the returned acks and the reqs
        built by :meth:`emit_reqs`, and for timing/thread serialization.
        """
        assert self.ready()
        ins = []
        acks = []
        for ch in self.spec.inputs:
            req = self.in_queues[ch].popleft()
            ins.append(req.payload)
            acks.append(Ack(src=self.actor_id, dst=req.src,
                            reg_id=req.reg_id, version=req.version))
        if self.spec.wants_version:
            # microbatch-indexed actions (e.g. a pipeline source emitting
            # microbatch k) need to know which firing this is
            out = self.spec.fn(*ins, version=self.version)
        else:
            out = self.spec.fn(*ins)
        self.fired += 1
        # allocate an out register instance
        self.out_counter -= 1
        reg_id = next(_reg_counter)
        nrefs = len(self.consumers)
        # OneFlow-style accumulation actor (`acc`): consumes every firing but
        # emits only each emit_every-th output (e.g. the summed gradient of a
        # whole step). Non-emitting fires recycle their register immediately.
        if not self.emitted_last_fire:
            nrefs = 0
        if nrefs == 0:
            # no consumer: recycle immediately
            self.out_counter += 1
        else:
            self.refcount[reg_id] = nrefs
            self.reg_payload[reg_id] = out
        # real payload size when measurable, the spec's static estimate
        # otherwise (the simulator's dummy payloads carry no arrays)
        self.last_nbytes = payload_nbytes(out) or self.spec.out_nbytes
        in_use = self.spec.out_regs - self.out_counter
        self.peak_regs_in_use = max(self.peak_regs_in_use, in_use)
        v = self.version
        self.version += 1
        return out, acks, reg_id if nrefs else -1

    def emit_reqs(self, out: Any, reg_id: int, version: int) -> List[Req]:
        nbytes = self.last_nbytes
        for cid, _ in self.consumers:
            name = self.consumer_names.get(cid, str(cid))
            self.edge_bytes[name] = self.edge_bytes.get(name, 0) + nbytes
        return [Req(src=self.actor_id, dst=cid, reg_id=reg_id, channel=ch,
                    payload=out, version=version, nbytes=nbytes)
                for cid, ch in self.consumers]


def build_actors(specs: Sequence[ActorSpec]):
    """Wire a graph of ActorSpecs into Actor instances with assigned IDs.

    Returns (actors_by_name, actors_by_id).
    """
    per_key_index: Dict[Tuple[int, int, int], int] = collections.defaultdict(int)
    ids: Dict[str, int] = {}
    for s in specs:
        key = (s.node, s.thread, s.queue)
        idx = per_key_index[key]
        per_key_index[key] += 1
        ids[s.name] = make_actor_id(s.node, s.thread, s.queue, idx)
    # consumer lists: actor A consumes channel named after producer
    consumers: Dict[str, List[Tuple[int, str]]] = collections.defaultdict(list)
    for s in specs:
        for producer_name in s.inputs:
            if producer_name not in ids:
                raise ValueError(f"{s.name} consumes unknown actor {producer_name}")
            consumers[producer_name].append((ids[s.name], producer_name))
    names_by_id = {aid: name for name, aid in ids.items()}
    by_name, by_id = {}, {}
    for s in specs:
        a = Actor(s, ids[s.name], consumers.get(s.name, ()))
        a.consumer_names = {cid: names_by_id[cid] for cid, _ in a.consumers}
        by_name[s.name] = a
        by_id[a.actor_id] = a
    # resequencer strides: a producer with emit_every=k emits versions
    # k-1, 2k-1, ... on its channel
    for s in specs:
        a = by_name[s.name]
        for producer_name in s.inputs:
            stride = max(1, by_name[producer_name].spec.emit_every)
            a.in_stride[producer_name] = stride
            a.in_next[producer_name] = stride - 1
    return by_name, by_id
