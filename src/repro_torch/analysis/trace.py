"""Trace sanitizer: certify the per-channel resequencer restores causal order.

``Actor.on_req`` dedups and reorders Req deliveries per channel (the
resequencer).  Under chaos faults (``DelayEdge`` reordering a version past
its successor, ``DuplicateReq`` re-delivering one), "the run still produced
bitwise-identical output" is an *observed* outcome; this pass turns it into a
*checked invariant*.  The threaded runtime records every Req delivery — the
version delivered and the versions the resequencer released to the FIFO — and
``check_trace`` verifies:

1. per (consumer, channel), the concatenated released versions are exactly
   the canonical stride sequence ``stride-1, 2*stride-1, ...`` with no gap,
   duplicate, or reorder;
2. a vector-clock happens-before check: fire ``k`` of an actor carries clock
   ``VC(A,k) = join(VC(P, v_k(P)) for each input P) ∪ {A: k+1}``; for every
   observed fire the joined input clocks must not claim a causal *future* of
   the actor itself (no released version can depend on a fire that has not
   happened yet).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.report import Violation
from repro_torch.runtime.actor import ActorSpec


@dataclasses.dataclass(frozen=True)
class DeliveryEvent:
    """One Req delivery at a consumer's mailbox."""

    seq: int
    dst: str
    channel: str
    version: int
    released: Tuple[int, ...]  # versions the resequencer moved to the FIFO
    stride: int
    accepted: bool = True      # False: duplicate, dropped without an ack
    epoch: int = 0             # resequencer state resets at epoch start


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One chaos fault the injector actually applied."""

    seq: int
    kind: str
    src: str
    dst: str
    version: Optional[int]
    epoch: int = 0


class TraceRecorder:
    """Thread-safe sink for delivery/fault events (one per runtime run)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seq = 0
        # the engine stamps this at every start_epoch so events land in the
        # epoch whose resequencer state they belong to
        self.current_epoch = 0
        self.deliveries: List[DeliveryEvent] = []
        self.faults: List[FaultEvent] = []

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def record_delivery(self, dst: str, channel: str, version: int,
                        released: Sequence[int], stride: int,
                        accepted: bool = True) -> None:
        with self._lock:
            self.deliveries.append(DeliveryEvent(
                self._next_seq(), dst, channel, version,
                tuple(released), stride, accepted, self.current_epoch))

    def record_fault(self, kind: str, src: str, dst: str,
                     version: Optional[int]) -> None:
        with self._lock:
            self.faults.append(FaultEvent(
                self._next_seq(), kind, src, dst, version,
                self.current_epoch))

    def clear(self) -> None:
        with self._lock:
            self.deliveries = []
            self.faults = []
            self._seq = 0
            self.current_epoch = 0


@dataclasses.dataclass
class TraceStats:
    """What the resequencer actually absorbed during the run."""

    deliveries: int
    duplicates_dropped: int
    reorders_buffered: int
    faults: int
    channels: int


def _canonical_prefix(stride: int, n: int) -> List[int]:
    return [(i + 1) * stride - 1 for i in range(n)]


def check_trace(
    recorder: TraceRecorder,
    specs: Sequence[ActorSpec],
) -> Tuple[List[Violation], TraceStats]:
    """Verify a recorded run; returns (violations, stats)."""
    by_name = {s.name: s for s in specs}
    stride_of = {name: max(1, s.emit_every) for name, s in by_name.items()}

    consumed: Dict[Tuple[int, str, str], List[int]] = {}
    duplicates = 0
    reorders = 0
    for ev in recorder.deliveries:
        key = (ev.epoch, ev.dst, ev.channel)
        seq = consumed.setdefault(key, [])
        if not ev.accepted:
            duplicates += 1
        elif not ev.released or len(ev.released) > 1 \
                or ev.released[0] != ev.version:
            reorders += 1
        seq.extend(ev.released)

    violations: List[Violation] = []
    for (epoch, dst, ch), seq in sorted(consumed.items()):
        stride = stride_of.get(ch, 1)
        want = _canonical_prefix(stride, len(seq))
        if seq != want:
            violations.append(Violation(
                "trace", f"{ch} -> {dst}",
                f"epoch {epoch}: resequencer released {seq[:12]} but the "
                f"canonical stride-{stride} order is {want[:12]}"))

    # vector-clock happens-before over the canonical consumption pattern
    clocks: Dict[Tuple[str, int], Dict[str, int]] = {}

    def fire_clock(name: str, k: int) -> Dict[str, int]:
        key = (name, k)
        got = clocks.get(key)
        if got is not None:
            return got
        vc: Dict[str, int] = {}
        if k > 0:
            vc.update(fire_clock(name, k - 1))
        for ch in by_name[name].inputs:
            stride = stride_of.get(ch, 1)
            version = (k + 1) * stride - 1
            # version v is produced by the producer's fire v
            for n2, c2 in fire_clock(ch, version).items():
                if c2 > vc.get(n2, 0):
                    vc[n2] = c2
        vc[name] = k + 1
        clocks[key] = vc
        return vc

    fires_observed: Dict[str, int] = {}
    for (epoch, dst, ch), seq in consumed.items():
        n = len(seq)
        cur = fires_observed.get(dst)
        fires_observed[dst] = n if cur is None else min(cur, n)
    for name, fires in sorted(fires_observed.items()):
        if name not in by_name:
            continue
        for k in range(fires):
            joined = 0
            for ch in by_name[name].inputs:
                stride = stride_of.get(ch, 1)
                version = (k + 1) * stride - 1
                joined = max(joined,
                             fire_clock(ch, version).get(name, 0))
            if joined > k:
                violations.append(Violation(
                    "trace", name,
                    f"fire {k} of {name} consumes a token that causally "
                    f"depends on its own fire {joined - 1} — the "
                    f"resequencer released a future version"))
                break

    stats = TraceStats(
        deliveries=len(recorder.deliveries),
        duplicates_dropped=duplicates,
        reorders_buffered=reorders,
        faults=len(recorder.faults),
        channels=len(consumed),
    )
    return violations, stats
