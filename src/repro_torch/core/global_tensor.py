"""GlobalTensor -- the user-facing "consistent tensor" API (paper §3.4,
Table 4), port of ``repro/core/global_tensor.py``.

A :class:`GlobalTensor` pairs the per-rank shards of a logical tensor with
its (:class:`~repro_torch.core.placement.Placement`, NdSbp) annotation on a
:class:`~repro_torch.core.mesh.DeviceMesh`. Ops infer the output SBP from
the deduction rules and run the *local* computation on every rank inside
:func:`~repro_torch.core.mesh.spmd`; :meth:`GlobalTensor.to_global` is
OneFlow's ``to_consistent`` -- an explicit boxing op changing the sbp.
Partial-value results stay unreduced shards (deferred reduction, §3.3)
until :func:`reduce_partial` or :meth:`GlobalTensor.numpy`.

This is the eager path: each op runs at once, one spmd program per op.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.boxing import boxing_fn
from repro_torch.core.mesh import DeviceMesh, assemble, place, spmd
from repro_torch.core.placement import Placement
from repro_torch.core.sbp import Broadcast, NdSbp, Partial, Split, ndsbp


@dataclasses.dataclass
class GlobalTensor:
    """A logically-global tensor physically laid out per (placement, sbp):
    ``shards[r]`` is rank ``r``'s piece."""

    shards: List[torch.Tensor]
    placement: Placement
    sbp: NdSbp
    mesh: DeviceMesh
    logical_shape: Tuple[int, ...]

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_global(array, placement: Placement, sbp: Union[str, NdSbp],
                    mesh: DeviceMesh = None) -> "GlobalTensor":
        """Place a host/global array with the given SBP (paper:
        flow.randn(..., placement=..., sbp=...)); ``mesh`` defaults to the
        placement's ranks on the card."""
        sbp = ndsbp(sbp)
        mesh = mesh if mesh is not None else placement.to_mesh()
        if sbp.has_partial:
            raise ValueError("cannot construct a partial-value tensor from a "
                             "global array; partials arise from ops")
        x = torch.as_tensor(array)
        return GlobalTensor(place(x, mesh, sbp), placement, sbp, mesh,
                            tuple(x.shape))

    # -- conversion (to_consistent / boxing) ----------------------------------
    def to_global(self, sbp: Union[str, NdSbp]) -> "GlobalTensor":
        """Explicit boxing: transform to a new SBP on the same placement."""
        dst = ndsbp(sbp)
        if dst == self.sbp:
            return self
        dst.validate_for_shape(self.logical_shape, self.placement.mesh_shape())
        if dst.has_partial:
            raise ValueError("to_global target with partial-value is not "
                             "materializable at the API boundary")
        return self._boxed(dst)

    def _boxed(self, dst: NdSbp) -> "GlobalTensor":
        fn = boxing_fn(self.sbp, dst, self.placement.axis_names,
                       self.placement.mesh_shape(), self.logical_shape)
        return GlobalTensor(spmd(fn, self.mesh)(self.shards), self.placement,
                            dst, self.mesh, self.logical_shape)

    # -- numpy-ish ----------------------------------------------------------
    def numpy(self) -> np.ndarray:
        """Materialize the logical value (partials reduced in rank
        order)."""
        return assemble(self.shards, self.mesh, self.sbp).cpu().numpy()

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.logical_shape

    @property
    def dtype(self):
        return self.shards[0].dtype

    def __repr__(self):
        return (f"GlobalTensor(shape={self.logical_shape}, sbp={self.sbp}, "
                f"placement={self.placement})")


# ---------------------------------------------------------------------------
# Eager consistent ops (enough to express the paper's Table 4 program).
# ---------------------------------------------------------------------------

def _deduce_matmul(sx: NdSbp, sw: NdSbp) -> NdSbp:
    """Apply Table 1 per mesh axis; raises if a (sx,sw) pair has no rule."""
    out = []
    for cx, cw in zip(sx, sw):
        if isinstance(cx, Split) and cx.axis == 0 and cw.is_broadcast:
            out.append(Split(0))
        elif cx.is_broadcast and isinstance(cw, Split) and cw.axis == 1:
            out.append(Split(1))
        elif (isinstance(cx, Split) and cx.axis == 1
              and isinstance(cw, Split) and cw.axis == 0):
            out.append(Partial("sum"))
        elif cx.is_partial and cw.is_broadcast:
            out.append(Partial("sum"))
        elif cx.is_broadcast and cw.is_partial:
            out.append(Partial("sum"))
        elif cx.is_broadcast and cw.is_broadcast:
            out.append(Broadcast())
        else:
            raise ValueError(f"matmul: no Table-1 rule for X:{cx}, W:{cw}")
    return NdSbp(tuple(out))


def matmul(x: GlobalTensor, w: GlobalTensor) -> GlobalTensor:
    """Consistent matmul: output SBP deduced per Table 1, the local product
    on every rank; a partial-value output stays unreduced (deferred
    reduction §3.3)."""
    if x.placement != w.placement or x.mesh is not w.mesh:
        raise ValueError("cross-placement matmul requires boxing via to_global")
    out_sbp = _deduce_matmul(x.sbp, w.sbp)
    out_shape = (x.logical_shape[0], w.logical_shape[1])
    shards = spmd(torch.matmul, x.mesh)(x.shards, w.shards)
    return GlobalTensor(shards, x.placement, out_sbp, x.mesh, out_shape)


def reduce_partial(x: GlobalTensor) -> GlobalTensor:
    """Materialize partial-value axes to broadcast (an all-reduce boxing)."""
    if not x.sbp.has_partial:
        return x
    return x._boxed(NdSbp(tuple(Broadcast() if c.is_partial else c
                                for c in x.sbp)))
