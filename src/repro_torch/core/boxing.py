"""Boxing — data-routing ops between mismatched SBP signatures (paper §3.2).

Two pieces:

1. :func:`transition_cost` — the *exact* Table 2 communication-cost model for a
   single-axis ``SBP₁ → SBP₂`` transition (same-devices and disjoint-devices
   columns), plus its Nd generalization used by the planner.
2. :func:`boxing_fn` — the physical transform: given ``src`` and ``dst``
   NdSbp over named mesh axes, a function usable *inside*
   :func:`repro_torch.core.mesh.spmd` that converts a rank's local shard from
   the src layout to the dst layout with the mesh's collectives (all_gather /
   psum / psum_scatter / all_to_all / slice). This is the compiler-inserted
   "boxing op"; on an axis of size 1 every transition is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import mesh as M
from repro_torch.core.sbp import B, Broadcast, NdSbp, Partial, Sbp, Split


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
# Physical boxing: collective transforms usable inside spmd.
# ---------------------------------------------------------------------------

def _one_axis_boxing(x, src: Sbp, dst: Sbp, axis_name: str, axis_size: int,
                     global_shape: Tuple[int, ...]):
    """Transform a local shard from src to dst layout along one mesh axis."""
    if src == dst or axis_size == 1:
        return x

    if isinstance(src, Split) and isinstance(dst, Split):
        if src.axis == dst.axis:
            return x
        # all_to_all: concat on src.axis, split on dst.axis
        return M.all_to_all(x, axis_name, split_dim=dst.axis,
                            concat_dim=src.axis)
    if isinstance(src, Split) and isinstance(dst, Broadcast):
        return M.all_gather(x, axis_name, dim=src.axis)
    if isinstance(src, Split) and isinstance(dst, Partial):
        if dst.op != "sum":
            raise NotImplementedError("S->P only for sum")
        # free locally: embed shard into zeros at its slice offset
        full = torch.zeros(global_shape, dtype=x.dtype, device=x.device)
        size = x.shape[src.axis]
        full.narrow(src.axis, M.axis_index(axis_name) * size, size).copy_(x)
        return full
    if isinstance(src, Broadcast) and isinstance(dst, Split):
        size = x.shape[dst.axis] // axis_size
        return x.narrow(dst.axis, M.axis_index(axis_name) * size,
                        size).contiguous()
    if isinstance(src, Broadcast) and isinstance(dst, Partial):
        if dst.op == "sum":
            return x if M.axis_index(axis_name) == 0 else torch.zeros_like(x)
        # max/min: identity is fine only if reduce op is idempotent — it is.
        return x
    if isinstance(src, Partial) and isinstance(dst, Split):
        if src.op != "sum":
            raise NotImplementedError("P->S reduce_scatter only for sum")
        return M.psum_scatter(x, axis_name, dim=dst.axis)
    if isinstance(src, Partial) and isinstance(dst, Broadcast):
        return {"sum": M.psum, "max": M.pmax, "min": M.pmin}[src.op](
            x, axis_name)
    if isinstance(src, Partial) and isinstance(dst, Partial):
        # materialize then re-partialize
        red = _one_axis_boxing(x, src, B, axis_name, axis_size, global_shape)
        return _one_axis_boxing(red, B, dst, axis_name, axis_size,
                                global_shape)
    raise ValueError(f"unhandled boxing {src} -> {dst}")


def boxing_is_identity(src: Union[str, NdSbp], dst: Union[str, NdSbp],
                       mesh_shape: Sequence[int]) -> bool:
    """True when every mesh axis whose component changes has size 1, where
    :func:`boxing_fn` moves nothing."""
    src, dst = NdSbp.parse(src), NdSbp.parse(dst)
    return all(size == 1 for a, b, size in zip(src, dst, mesh_shape)
               if a != b)


def boxing_fn(src: Union[str, NdSbp], dst: Union[str, NdSbp],
              axis_names: Sequence[str], mesh_shape: Sequence[int],
              logical_shape: Sequence[int]) -> Callable:
    """Build ``local -> local`` transform converting ``src`` NdSbp to ``dst``.

    The returned function must be called *inside*
    :func:`repro_torch.core.mesh.spmd` over a mesh with ``axis_names``.

    Layout convention: when several mesh axes split the same tensor axis, the
    earlier mesh axis is the MAJOR block index (as
    :func:`repro_torch.core.mesh.shard_slices` lays shards out).

    Algorithm (correct under that convention):

    * *cheap path* — when mesh axis ``k``'s transition touches tensor axes not
      shared with any other mesh axis (in src or dst), emit the direct
      primitive (all_to_all / all_gather / psum_scatter / slice / psum).
    * otherwise, *release phase* (descending mesh order): gather every
      conflicting axis to B — descending order guarantees each release
      concatenates contiguous (minor-most) blocks; then *impose phase*
      (ascending mesh order): slice/mask B into the destination components —
      ascending order makes earlier mesh axes major, as the convention wants.
    """
    src, dst = NdSbp.parse(src), NdSbp.parse(dst)
    n = len(axis_names)
    if not (len(src) == len(dst) == n == len(mesh_shape)):
        raise ValueError("rank mismatch in boxing_fn")

    def split_axis_of(c: Sbp) -> Optional[int]:
        return c.axis if isinstance(c, Split) else None

    # -- plan which mesh axes change, forcing conflicting bystanders ----------
    changing = {k for k in range(n) if src[k] != dst[k]}
    while True:
        touched = set()
        for k in changing:
            for c in (src[k], dst[k]):
                a = split_axis_of(c)
                if a is not None:
                    touched.add(a)
        forced = {
            j for j in range(n) if j not in changing
            and split_axis_of(src[j]) in touched
        }
        if not forced:
            break
        changing |= forced

    # cheap-path eligibility per changing axis: its tensor axes are exclusive
    def exclusive(k: int) -> bool:
        axes_k = {a for a in (split_axis_of(src[k]), split_axis_of(dst[k]))
                  if a is not None}
        if not axes_k:
            return True
        for j in range(n):
            if j == k:
                continue
            for c in (src[j], dst[j]):
                if split_axis_of(c) in axes_k:
                    return False
        return True

    # a bystander (unchanged split, forced into ``changing``) keeps its
    # blocks only while it is the major digit of its tensor axis: once an
    # earlier axis that changes touches that tensor axis, the bystander's
    # blocks must be released and imposed again like the changing axes.
    # (The reference keeps every bystander, which scrambles the blocks of
    # e.g. (S(0), S(0)) -> (B, S(0)).)
    truly = {k for k in range(n) if src[k] != dst[k]}

    def must_release(j: int) -> bool:
        a = split_axis_of(src[j])
        return j not in truly and any(
            k < j and a in (split_axis_of(src[k]), split_axis_of(dst[k]))
            for k in truly)

    def shape_under(components) -> Tuple[int, ...]:
        out = list(logical_shape)
        for comp, size in zip(components, mesh_shape):
            if isinstance(comp, Split):
                out[comp.axis] //= size
        return tuple(out)

    def transform(x):
        cur = list(src.components)

        def gshape_for(k):
            inter = list(cur)
            inter[k] = Broadcast()
            return shape_under(inter)

        # cheap direct transitions first (no shared tensor axes)
        for k in sorted(changing):
            if exclusive(k):
                x = _one_axis_boxing(x, cur[k], dst[k], axis_names[k],
                                     mesh_shape[k], gshape_for(k))
                cur[k] = dst[k]
        remaining = [k for k in changing
                     if cur[k] != dst[k] or must_release(k)]

        # release phase: descending mesh order -> concat minor blocks first
        for k in sorted(remaining, reverse=True):
            if not (cur[k].is_broadcast):
                x = _one_axis_boxing(x, cur[k], B, axis_names[k],
                                     mesh_shape[k], gshape_for(k))
                cur[k] = B
        # impose phase: ascending mesh order -> earlier axes become major
        for k in sorted(remaining):
            if cur[k] != dst[k]:
                x = _one_axis_boxing(x, B, dst[k], axis_names[k],
                                     mesh_shape[k], gshape_for(k))
                cur[k] = dst[k]
        return x

    return transform


def cotangent_sbp(sig: Union[str, NdSbp]) -> NdSbp:
    """The layout of a cotangent of a value laid out as ``sig`` (OneFlow's
    transpose rule): S(i) stays S(i), B becomes P(sum) and P(sum) B."""
    out = []
    for c in NdSbp.parse(sig):
        if c.is_broadcast:
            out.append(Partial("sum"))
        elif c.is_partial:
            if c.op != "sum":
                raise NotImplementedError(
                    f"no transpose of {c}: only P(sum) is differentiable")
            out.append(B)
        else:
            out.append(c)
    return NdSbp(tuple(out))


def transposed_boxing_fn(src: Union[str, NdSbp], dst: Union[str, NdSbp],
                         axis_names: Sequence[str],
                         mesh_shape: Sequence[int],
                         logical_shape: Sequence[int]) -> Callable:
    """The backward of ``boxing_fn(src, dst)``: moves a cotangent from the
    layout of ``dst``'s cotangent to that of ``src``'s. So the backward of
    S->B (all-gather) is P->S (reduce-scatter), of P->B is P->B, of B->S is
    S->P, and of S(i)->S(j) is S(j)->S(i)."""
    return boxing_fn(cotangent_sbp(dst), cotangent_sbp(src), axis_names,
                     mesh_shape, logical_shape)
