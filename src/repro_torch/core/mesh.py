"""Meshes of ranks, SPMD runs over them, and their collectives.

The port's counterpart of ``jax.sharding.Mesh`` plus ``shard_map``. A
:class:`DeviceMesh` holds one rank per mesh coordinate, in row-major order
with the earlier mesh axis major (the convention of
``repro/core/placement.py:60-93``), and a ``torch.device`` per rank. On one
card every rank is that card: the ranks are *virtual*, so a mesh there
measures correctness and the cost of the substrate, not a speed-up.

:func:`spmd` runs a function once per rank, each on its own thread (rank 0
on the caller's). Inside it, the collectives below work over named mesh
axes. Each is a rendezvous of the ranks that share every other coordinate
(the axis group), with two rules:

* a reduction adds the ranks' tensors **in rank order**, once, so a run is
  bitwise repeatable and every rank gets the same bits;
* each result is a fresh tensor the rank owns, **detached**: no rank's
  autograd graph reaches another rank's tensors, and no two ranks share
  storage (an in-place update on one replica never changes another).

No collective runs inside an autograd backward (it raises
:class:`CollectiveError` there, on the CPU too): a card's backward nodes
all run on one thread. Every wait has a timeout. A collective that times
out, a rank that returns without joining one, or calls that disagree on
the collective raise :class:`CollectiveError` on every rank of the run,
and :func:`spmd` re-raises the first failure. All ranks on one card use the caller's current
stream, so stream order covers the data dependencies between them.

:func:`place` cuts a global tensor into per-rank shards under an NdSbp and
:func:`assemble` rebuilds it (P(sum) summed in rank order).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.sbp import NdSbp, Partial, Split, ndsbp

#: seconds a rank waits at a rendezvous before the run fails
DEFAULT_TIMEOUT = 300.0

Axes = Union[str, Sequence[str]]


class CollectiveError(RuntimeError):
    """A rendezvous that could not complete: a timeout, a rank that left
    without joining, calls that disagree, or another rank's failure."""


class CollectiveStats:
    """What a mesh's collectives did since the last :meth:`reset`: calls
    and bytes by kind, and ``wait_s``, the seconds ranks spent inside them
    (waiting for their peers and, the last to arrive, combining).

    ``bytes`` counts Table 2's same-device volume of each group's
    collective (all-gather and reduce-scatter ``(n - 1) |T|``, all-reduce
    ``2 (n - 1) |T|``, all-to-all ``(n - 1) / n |T|``, with ``|T|`` the
    group's logical tensor), summed over the groups."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.calls: Dict[str, int] = {}
            self.bytes: Dict[str, int] = {}
            self.wait_s = 0.0

    def add(self, kind: str, nbytes: int) -> None:
        with self._lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)

    def add_wait(self, seconds: float) -> None:
        with self._lock:
            self.wait_s += seconds

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self.bytes.values())


class DeviceMesh:
    """One rank per coordinate of ``placement``'s mesh, rank ``r`` at the
    row-major coordinate ``coords(r)``, on ``devices[r]``. ``timeout`` is
    how long a rank waits at a collective."""

    def __init__(self, placement, devices: Sequence, timeout: float =
                 DEFAULT_TIMEOUT):
        devices = [torch.device(d) for d in devices]
        if len(devices) != placement.num_devices:
            raise ValueError(f"{placement} has {placement.num_devices} ranks, "
                             f"got {len(devices)} devices")
        self.placement = placement
        self.axis_names: Tuple[str, ...] = tuple(placement.axis_names)
        self.shape: Tuple[int, ...] = tuple(placement.axis_sizes)
        self.devices: Tuple[torch.device, ...] = tuple(devices)
        self.timeout = float(timeout)
        self.stats = CollectiveStats()

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> Tuple[int, ...]:
        out = []
        for size in reversed(self.shape):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, size in zip(coords, self.shape):
            rank = rank * size + c
        return rank

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"no mesh axis {name!r} in {self.axis_names}")
        return self.axis_names.index(name)

    def axis_index(self, rank: int, axis: str) -> int:
        return self.coords(rank)[self._axis(axis)]

    def group(self, rank: int, axes: Axes) -> Tuple[int, ...]:
        """The ranks that share every coordinate of ``rank`` but those on
        ``axes``, in rank order."""
        ks = {self._axis(a) for a in _as_axes(axes)}
        mine = self.coords(rank)
        return tuple(r for r in range(self.size)
                     if all(c == m for k, (c, m) in
                            enumerate(zip(self.coords(r), mine))
                            if k not in ks))

    def distinct_ranks(self, sbp) -> Tuple[int, ...]:
        """The ranks holding distinct shards under a partial-free ``sbp``:
        index 0 on every broadcast axis."""
        sbp = ndsbp(sbp)
        return tuple(r for r in range(self.size)
                     if all(c == 0 for c, comp in zip(self.coords(r), sbp)
                            if not isinstance(comp, Split)))

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                     self.shape))
        devs = sorted({str(d) for d in self.devices})
        return f"DeviceMesh({dims}; {', '.join(devs)})"


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# ---------------------------------------------------------------------------
# The rendezvous.
# ---------------------------------------------------------------------------

class _Slot:
    """One collective of one group: the ranks' deposits, then the results."""

    def __init__(self, kind: str, axes: Tuple[str, ...]):
        self.kind, self.axes = kind, axes
        self.vals: Dict[int, torch.Tensor] = {}
        self.results: Optional[Dict[int, torch.Tensor]] = None


class _Comm:
    """The rendezvous state of one :func:`spmd` run."""

    def __init__(self, mesh: DeviceMesh, timeout: float):
        self.mesh, self.timeout = mesh, timeout
        self.cv = threading.Condition()
        self.slots: Dict[Tuple, _Slot] = {}
        self.error: Optional[BaseException] = None
        self.left: set = set()

    def fail(self, exc: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()

    def leave(self, rank: int) -> None:
        with self.cv:
            self.left.add(rank)
            self.cv.notify_all()

    def _raise(self, exc: CollectiveError):
        if self.error is None:
            self.error = exc
        self.cv.notify_all()
        raise exc

    def exchange(self, rank: int, seq: int, kind: str, axes: Tuple[str, ...],
                 group: Tuple[int, ...], x: torch.Tensor,
                 combine: Callable[[List[torch.Tensor]], List[torch.Tensor]]
                 ) -> torch.Tensor:
        what = f"{kind} over {axes if len(axes) > 1 else axes[0]!r}"
        deadline = time.monotonic() + self.timeout
        t0 = time.perf_counter()
        with self.cv:
            if self.error is not None:
                raise CollectiveError(f"{what} on rank {rank}: the run "
                                      f"failed already ({self.error})")
            slot = self.slots.setdefault((group, seq), _Slot(kind, axes))
            if (slot.kind, slot.axes) != (kind, axes):
                self._raise(CollectiveError(
                    f"rank {rank} called {what} where ranks "
                    f"{sorted(slot.vals)} called {slot.kind} over "
                    f"{slot.axes} (collective #{seq} of group {group})"))
            slot.vals[rank] = x.detach()
            last = len(slot.vals) == len(group)
            while not last and slot.results is None:
                if self.error is not None:
                    raise CollectiveError(f"{what} on rank {rank}: aborted, "
                                          f"another rank failed "
                                          f"({self.error})")
                gone = sorted(r for r in group
                              if r in self.left and r not in slot.vals)
                if gone:
                    self._raise(CollectiveError(
                        f"{what}: ranks {gone} of group {group} returned "
                        f"without joining it (ranks {sorted(slot.vals)} "
                        "arrived)"))
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._raise(CollectiveError(
                        f"{what} timed out after {self.timeout:g} s on rank "
                        f"{rank}: ranks {sorted(slot.vals)} of group "
                        f"{group} arrived"))
                self.cv.wait(remaining)
        if last:
            try:
                with torch.no_grad():
                    results = combine([slot.vals[r] for r in group])
            except BaseException as exc:
                self.fail(exc)
                raise
            with self.cv:
                slot.results = dict(zip(group, results))
                slot.vals = {}
                self.cv.notify_all()
        with self.cv:
            out = slot.results.pop(rank)
            if not slot.results:
                del self.slots[(group, seq)]
        self.mesh.stats.add_wait(time.perf_counter() - t0)
        return out


class _RankContext:
    def __init__(self, comm: _Comm, rank: int):
        self.comm, self.rank = comm, rank
        self.seq: Dict[Tuple[int, ...], int] = {}


_local = threading.local()


def _ctx() -> _RankContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("mesh collectives run only inside spmd()")
    return ctx


@contextlib.contextmanager
def _as_rank(comm: _Comm, rank: int):
    prev = getattr(_local, "ctx", None)
    _local.ctx = _RankContext(comm, rank)
    try:
        yield
    finally:
        _local.ctx = prev


def current_rank() -> int:
    return _ctx().rank


def axis_index(axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis``."""
    ctx = _ctx()
    return ctx.comm.mesh.axis_index(ctx.rank, axis)


def _collective(kind: str, axes: Axes, x: torch.Tensor, combine,
                volume: Callable[[int, int], float]) -> torch.Tensor:
    """Run ``combine`` (group-ordered inputs -> group-ordered results) over
    the axis group of ``axes``; ``volume(n, nbytes)`` is the group's
    Table 2 bytes for an input of ``nbytes`` on each of ``n`` ranks.

    Refused inside an autograd backward, on every device: the engine runs
    all of a card's backward nodes on one worker thread, so a node waiting
    here for another rank of that card would hang the run. A training
    program keeps its collectives on a tape between ``autograd.grad``
    calls instead (:mod:`repro_torch.core.tape`)."""
    if torch._C._current_graph_task_id() != -1:
        raise CollectiveError(
            f"{kind} inside an autograd backward: a card runs every backward "
            "node on one thread, so a rendezvous there deadlocks; record "
            "the collective on the tape (repro_torch.core.tape) instead")
    ctx = _ctx()
    axes = _as_axes(axes)
    mesh = ctx.comm.mesh
    group = mesh.group(ctx.rank, axes)
    if len(group) == 1:
        with torch.no_grad():
            return combine([x.detach()])[0].clone()
    seq = ctx.seq.get(group, 0)
    ctx.seq[group] = seq + 1
    out = ctx.comm.exchange(ctx.rank, seq, kind, axes, group, x, combine)
    if ctx.rank == group[0]:
        mesh.stats.add(kind, volume(len(group),
                                    x.numel() * x.element_size()))
    return out


def _reduce(vals: List[torch.Tensor], op) -> torch.Tensor:
    total = vals[0]
    for v in vals[1:]:
        total = op(total, v.to(total.device))
    return total


def _replicate(total: torch.Tensor, devices) -> List[torch.Tensor]:
    """One copy of ``total`` per rank: the first rank keeps it."""
    return [total.to(d) if i == 0 else total.to(d, copy=True)
            for i, d in enumerate(devices)]


def _all_reduce(kind: str, op):
    def f(x: torch.Tensor, axes: Axes) -> torch.Tensor:
        return _collective(
            kind, axes, x,
            lambda vals: _replicate(_reduce(vals, op),
                                    [v.device for v in vals]),
            lambda n, b: 2 * (n - 1) * b)
    f.__name__ = kind
    f.__doc__ = (f"The {kind} of ``x`` over the axis group of ``axes``, "
                 "reduced in rank order; every rank gets the same bits.")
    return f


psum = _all_reduce("psum", torch.add)
pmax = _all_reduce("pmax", torch.maximum)
pmin = _all_reduce("pmin", torch.minimum)


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    """The group's shards concatenated along ``dim`` in rank order (tiled)."""
    return _collective(
        "all_gather", axes, x,
        lambda vals: _replicate(
            torch.cat([v.to(vals[0].device) for v in vals], dim),
            [v.device for v in vals]),
        lambda n, b: (n - 1) * n * b)


def psum_scatter(x: torch.Tensor, axes: Axes, dim: int = 0) -> torch.Tensor:
    """The group's sum, split along ``dim``: rank ``i`` of the group gets
    block ``i``, each block summed in rank order (tiled)."""
    def combine(vals):
        n = len(vals)
        if vals[0].shape[dim] % n:
            raise ValueError(f"psum_scatter: dim {dim} of "
                             f"{tuple(vals[0].shape)} not divisible by {n}")
        c = vals[0].shape[dim] // n
        return [_reduce([v.narrow(dim, i * c, c).to(vals[i].device)
                         for v in vals], torch.add).contiguous()
                if n > 1 else vals[0].clone() for i in range(n)]
    return _collective("psum_scatter", axes, x, combine,
                       lambda n, b: (n - 1) * b)


def all_to_all(x: torch.Tensor, axes: Axes, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Rank ``i`` of the group gets block ``i`` (along ``split_dim``) of
    every rank's tensor, concatenated along ``concat_dim`` in rank order."""
    def combine(vals):
        n = len(vals)
        if vals[0].shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(vals[0].shape)} not divisible by {n}")
        c = vals[0].shape[split_dim] // n
        return [torch.cat([v.narrow(split_dim, i * c, c).to(vals[i].device)
                           for v in vals], concat_dim) for i in range(n)]
    return _collective("all_to_all", axes, x, combine,
                       lambda n, b: (n - 1) * b)


# ---------------------------------------------------------------------------
# SPMD runs.
# ---------------------------------------------------------------------------

def _run(mesh: DeviceMesh, fn: Callable[[int], Any]) -> List[Any]:
    """``[fn(0), ..., fn(n - 1)]``, each rank on its own thread inside its
    rank context. A rank thread takes the caller's per-thread torch state:
    grad and inference mode, and the current stream of each card."""
    comm = _Comm(mesh, mesh.timeout)
    if mesh.size == 1:
        with _as_rank(comm, 0):
            return [fn(0)]
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    streams = [torch.cuda.current_stream(d)
               for d in set(mesh.devices) if d.type == "cuda"]
    results: List[Any] = [None] * mesh.size
    errors: Dict[int, BaseException] = {}

    def body(rank: int) -> None:
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                stack.enter_context(_as_rank(comm, rank))
                results[rank] = fn(rank)
            comm.leave(rank)
        except BaseException as exc:    # re-raised by the caller below
            errors[rank] = exc
            comm.fail(exc)

    threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}",
                                daemon=True) for r in range(1, mesh.size)]
    for t in threads:
        t.start()
    body(0)
    for t in threads:
        t.join()
    if errors:
        first = comm.error if comm.error is not None else next(
            iter(errors.values()))
        first.rank_errors = dict(sorted(errors.items()))
        raise first
    return results


def spmd(fn: Callable, mesh: DeviceMesh, in_layouts=None,
         out_layouts=None) -> Callable:
    """``fn`` as an SPMD program over ``mesh`` (``shard_map``'s role).

    With ``in_layouts`` None, each argument of the returned callable is a
    per-rank sequence and rank ``r`` gets element ``r``; otherwise each is
    a global tensor placed by its layout (:func:`place`). With
    ``out_layouts`` None it returns the per-rank results in rank order;
    otherwise each output is assembled by its layout (:func:`assemble`) --
    one NdSbp for a single output, a tuple for a tuple."""
    def run(*args):
        if in_layouts is None:
            per_rank = args
        else:
            layouts = in_layouts if isinstance(in_layouts, (list, tuple)) \
                else (in_layouts,)
            per_rank = [place(a, mesh, lay) for a, lay in zip(args, layouts)]
        for a in per_rank:
            if len(a) != mesh.size:
                raise ValueError(f"spmd over {mesh}: an argument has "
                                 f"{len(a)} shards")
        outs = _run(mesh, lambda r: fn(*[a[r] for a in per_rank]))
        if out_layouts is None:
            return outs
        if isinstance(out_layouts, (list, tuple)):
            return tuple(assemble([o[i] for o in outs], mesh, lay)
                         for i, lay in enumerate(out_layouts))
        return assemble(outs, mesh, out_layouts)
    return run


# ---------------------------------------------------------------------------
# Global tensors <-> per-rank shards.
# ---------------------------------------------------------------------------

def shard_slices(shape: Sequence[int], sbp, mesh_shape: Sequence[int],
                 coords: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a global ``shape`` that the rank at ``coords`` holds
    under ``sbp``; where several mesh axes split one tensor axis, the
    earlier mesh axis is the major block index."""
    index, blocks = [0] * len(shape), [1] * len(shape)
    for comp, size, c in zip(ndsbp(sbp), mesh_shape, coords):
        if isinstance(comp, Split):
            index[comp.axis] = index[comp.axis] * size + c
            blocks[comp.axis] *= size
    out = []
    for dim, i, b in zip(shape, index, blocks):
        n = dim // b
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def _partial_op(sbp: NdSbp) -> Optional[str]:
    ops = {c.op for c in sbp if isinstance(c, Partial)}
    if len(ops) > 1:
        raise ValueError(f"{sbp} mixes partial reductions {sorted(ops)}")
    return next(iter(ops), None)


def place(x, mesh: DeviceMesh, sbp) -> List[torch.Tensor]:
    """Cut a global tensor into per-rank shards under ``sbp``, each on its
    rank's device. Split axes take their block, broadcast axes a copy; a
    P(sum) axis holds the value at index 0 and zeros elsewhere, P(max/min)
    a copy. On a mesh of several ranks every shard is a copy of its own."""
    sbp = ndsbp(sbp)
    x = torch.as_tensor(x)
    sbp.validate_for_shape(tuple(x.shape), mesh.shape)
    if mesh.size == 1:
        return [x.to(mesh.devices[0])]
    out = []
    for r, dev in enumerate(mesh.devices):
        coords = mesh.coords(r)
        piece = x[shard_slices(x.shape, sbp, mesh.shape, coords)]
        if any(isinstance(comp, Partial) and comp.op == "sum" and c != 0
               for comp, c in zip(sbp, coords)):
            out.append(torch.zeros(piece.shape, dtype=piece.dtype,
                                   device=dev))
        else:
            out.append(piece.to(dev, copy=True).contiguous())
    return out


def global_shape(local: Sequence[int], sbp, mesh_shape: Sequence[int]
                 ) -> Tuple[int, ...]:
    out = list(local)
    for comp, size in zip(ndsbp(sbp), mesh_shape):
        if isinstance(comp, Split):
            out[comp.axis] *= size
    return tuple(out)


def assemble(shards: Sequence[torch.Tensor], mesh: DeviceMesh, sbp
             ) -> torch.Tensor:
    """The global tensor from its per-rank shards under ``sbp``, on rank
    0's device: split blocks in place, one copy of each broadcast replica,
    partial values reduced over their axes in rank order."""
    sbp = ndsbp(sbp)
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for {mesh}")
    if mesh.size == 1:
        return shards[0]
    op = _partial_op(sbp)
    first = shards[0]
    shape = global_shape(first.shape, sbp, mesh.shape)
    out = (torch.zeros if op == "sum" else torch.empty)(
        shape, dtype=first.dtype, device=first.device)
    seen = set()
    for r in range(mesh.size):
        coords = mesh.coords(r)
        if any(comp.is_broadcast and c != 0 for comp, c in zip(sbp, coords)):
            continue
        sl = shard_slices(shape, sbp, mesh.shape, coords)
        key = tuple((s.start, s.stop) for s in sl)
        piece = shards[r].to(out.device)
        if op == "sum":
            out[sl] = out[sl] + piece
        elif op is not None and key in seen:
            out[sl] = (torch.maximum if op == "max" else torch.minimum)(
                out[sl], piece)
        else:
            out[sl] = piece
        seen.add(key)
    return out
