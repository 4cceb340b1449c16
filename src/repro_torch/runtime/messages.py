"""Actor messages and hierarchical 64-bit addressing (paper §5, Fig 7/8).

Every actor gets a 64-bit ID encoding (node, thread, hardware queue, actor
index). IDs of the device/thread/node an actor resides on can be parsed back
out of the ID, which is all the message bus needs to route a message — the
receiver's ID *is* the route (paper: "attaching the receiver actor's ID with
the message suffices").
"""
from __future__ import annotations

import dataclasses
from typing import Any

# Field widths (bits). Fig 8 shows node|thread|queue|actor; widths here are
# chosen so the whole address packs into 64 bits with room at every level.
NODE_BITS, THREAD_BITS, QUEUE_BITS, ACTOR_BITS = 12, 12, 8, 32
assert NODE_BITS + THREAD_BITS + QUEUE_BITS + ACTOR_BITS == 64


def make_actor_id(node: int, thread: int, queue: int, index: int) -> int:
    for v, bits, name in ((node, NODE_BITS, "node"), (thread, THREAD_BITS, "thread"),
                          (queue, QUEUE_BITS, "queue"), (index, ACTOR_BITS, "actor")):
        if not 0 <= v < (1 << bits):
            raise ValueError(f"{name} id {v} out of range for {bits} bits")
    return (((node << THREAD_BITS | thread) << QUEUE_BITS | queue)
            << ACTOR_BITS | index)


def parse_actor_id(actor_id: int):
    index = actor_id & ((1 << ACTOR_BITS) - 1)
    rest = actor_id >> ACTOR_BITS
    queue = rest & ((1 << QUEUE_BITS) - 1)
    rest >>= QUEUE_BITS
    thread = rest & ((1 << THREAD_BITS) - 1)
    node = rest >> THREAD_BITS
    return node, thread, queue, index


def node_of(actor_id: int) -> int:
    return parse_actor_id(actor_id)[0]


def thread_of(actor_id: int) -> int:
    return parse_actor_id(actor_id)[1]


def payload_nbytes(payload: Any) -> int:
    """Best-effort byte count of a register payload: array leaves summed
    recursively through dicts/sequences/dataclasses. Non-array leaves
    (closures, ints, None) count as zero — the number feeds instrumentation
    (``Req.nbytes``, per-edge traffic), not allocation."""
    if payload is None:
        return 0
    nb = getattr(payload, "nbytes", None)
    if nb is not None and not callable(nb):
        return int(nb)
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(v) for v in payload)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        return sum(payload_nbytes(getattr(payload, f.name))
                   for f in dataclasses.fields(payload))
    return 0


@dataclasses.dataclass
class Req:
    """Producer -> consumer: a register holds a newly produced tensor."""

    src: int                 # producer actor id
    dst: int                 # consumer actor id
    reg_id: int              # out-register instance being shared
    channel: str             # consumer's input channel name
    payload: Any             # the tensor (by reference: zero-copy on-node)
    version: int             # microbatch / iteration index
    nbytes: int = 0


@dataclasses.dataclass
class Ack:
    """Consumer -> producer: the register is no longer referenced."""

    src: int                 # consumer actor id
    dst: int                 # producer actor id
    reg_id: int
    version: int
