"""Boxing — data-routing ops between mismatched SBP signatures (paper §3.2).

Two pieces:

1. :func:`transition_cost` — the *exact* Table 2 communication-cost model for a
   single-axis ``SBP₁ → SBP₂`` transition (same-devices and disjoint-devices
   columns), plus its Nd generalization used by the planner.
2. :func:`boxing_fn` — the physical transform between two layouts. On a mesh
   whose every axis has size 1 each S/B/P transition is the identity (a shard
   is the whole tensor, a replica is the tensor, a one-device partial sum is
   the sum), so that is all it builds here; any larger axis needs the
   collectives of ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.sbp import Broadcast, NdSbp, Partial, Sbp, Split


# ---------------------------------------------------------------------------
# Table 2: communication cost of a single-axis transition.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BoxingCost:
    """Bytes moved per device group + the collective primitive chosen."""

    volume: float           # total bytes transferred (Table 2 entry)
    primitive: str          # name of the collective ("none" when free)


def transition_cost(src: Sbp, dst: Sbp, tensor_bytes: float,
                    p1: int, p2: Optional[int] = None,
                    disjoint: bool = False) -> BoxingCost:
    """Table 2, verbatim.

    ``tensor_bytes`` is |T| (logical tensor size in bytes), ``p1``/``p2`` the
    producer/consumer device counts for this mesh axis. ``disjoint`` selects the
    right-hand column (producer and consumer on disjoint device sets).
    """
    p2 = p1 if p2 is None else p2
    if not disjoint and p2 != p1:
        raise ValueError(
            f"same-device transition requires p2 == p1 (got p1={p1}, p2={p2}); "
            "pass disjoint=True for transitions between distinct device sets")
    T = float(tensor_bytes)
    s, d = src, dst

    if disjoint:
        if isinstance(s, Split) and isinstance(d, Split):
            return BoxingCost(T, "gather+scatter")
        if isinstance(s, Split) and isinstance(d, Broadcast):
            return BoxingCost(p2 * T, "gather+broadcast")
        if isinstance(s, Split) and isinstance(d, Partial):
            return BoxingCost(T, "gather+scatter")
        if isinstance(s, Broadcast) and isinstance(d, Split):
            return BoxingCost(T, "scatter")
        if isinstance(s, Broadcast) and isinstance(d, Broadcast):
            return BoxingCost(p2 * T, "broadcast")
        if isinstance(s, Broadcast) and isinstance(d, Partial):
            return BoxingCost(T, "copy")
        if isinstance(s, Partial) and isinstance(d, Split):
            return BoxingCost(p1 * T, "reduce+scatter")
        if isinstance(s, Partial) and isinstance(d, Broadcast):
            return BoxingCost((p1 + p2 - 1) * T, "reduce+broadcast")
        if isinstance(s, Partial) and isinstance(d, Partial):
            return BoxingCost(p1 * T, "reduce+copy")
        raise ValueError(f"unhandled transition {s} -> {d}")

    # same device set -----------------------------------------------------------
    if isinstance(s, Split) and isinstance(d, Split):
        if s.axis == d.axis:
            return BoxingCost(0.0, "none")
        return BoxingCost((p1 - 1) / p1 * T, "all_to_all")
    if isinstance(s, Split) and isinstance(d, Broadcast):
        return BoxingCost((p1 - 1) * T, "all_gather")
    if isinstance(s, Split) and isinstance(d, Partial):
        # S -> P is free: place the shard in its slice, zeros elsewhere
        return BoxingCost(0.0, "pad_zero")
    if isinstance(s, Broadcast) and isinstance(d, Split):
        return BoxingCost(0.0, "slice")
    if isinstance(s, Broadcast) and isinstance(d, Broadcast):
        return BoxingCost(0.0, "none")
    if isinstance(s, Broadcast) and isinstance(d, Partial):
        return BoxingCost(0.0, "mask_to_partial")
    if isinstance(s, Partial) and isinstance(d, Split):
        return BoxingCost((p1 - 1) * T, "reduce_scatter")
    if isinstance(s, Partial) and isinstance(d, Broadcast):
        return BoxingCost(2 * (p1 - 1) * T, "all_reduce")
    if isinstance(s, Partial) and isinstance(d, Partial):
        if s.op == d.op:
            return BoxingCost(0.0, "none")
        return BoxingCost(2 * (p1 - 1) * T, "all_reduce")  # must materialize
    raise ValueError(f"unhandled transition {s} -> {d}")


def nd_transition_cost(src: NdSbp, dst: NdSbp, tensor_bytes: float,
                       mesh_shape: Sequence[int]) -> float:
    """Generalize Table 2 to NdSbp: sum per-mesh-axis transition costs.

    Axis ``k``'s transition happens over groups of ``mesh_shape[k]`` devices
    while all other axes index independent groups, so the per-axis |T| is the
    tensor's *local* size with respect to the other axes' splits. We use the
    conservative (sequential, axis-by-axis) decomposition, the same one
    OneFlow's compiler uses to decompose an Nd boxing into 1-d primitives.
    """
    total = 0.0
    cur = list(src.components)
    for k in range(len(mesh_shape)):
        if cur[k] == dst[k]:
            continue
        # bytes of the tensor held per group on axis k = |T| / prod(other splits)
        denom = 1
        for j, comp in enumerate(cur):
            if j != k and isinstance(comp, Split):
                denom *= mesh_shape[j]
        axis_T = tensor_bytes / denom
        total += transition_cost(cur[k], dst[k], axis_T, mesh_shape[k]).volume
        cur[k] = dst[k]
    return total


# ---------------------------------------------------------------------------
# Physical boxing: the identity on size-1 axes.
# ---------------------------------------------------------------------------

def boxing_fn(src: Union[str, NdSbp], dst: Union[str, NdSbp],
              axis_names: Sequence[str], mesh_shape: Sequence[int],
              logical_shape: Sequence[int]) -> Callable:
    """Build the ``local -> local`` transform converting ``src`` to ``dst``
    (the reference's signature). Every axis of ``mesh_shape`` must have size
    1, where the transform is the identity."""
    src, dst = NdSbp.parse(src), NdSbp.parse(dst)
    if not (len(src) == len(dst) == len(axis_names) == len(mesh_shape)):
        raise ValueError("rank mismatch in boxing_fn")
    if src != dst and any(size != 1 for size in mesh_shape):
        raise NotImplementedError(
            f"boxing {src} -> {dst} over mesh {tuple(mesh_shape)}: collectives "
            "on axes larger than 1 are not ported yet (ROADMAP Queue 1 item 8)")
    return lambda x: x
