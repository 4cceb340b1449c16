"""SBP (split / broadcast / partial-value) abstraction — OneFlow §3.1, §3.3.

An :class:`Sbp` describes how ONE mesh axis maps a logical tensor to physical
shards:

* ``Split(axis)``  — physical tensors are balanced slices of the logical tensor
  along tensor dimension ``axis``.
* ``Broadcast()``  — each physical tensor is a full replica.
* ``Partial(op)``  — physical tensors have the logical shape; the logical value
  is the elementwise reduction ``op`` (sum/max/min) of all physical tensors.

A :class:`NdSbp` is a tuple of :class:`Sbp`, one per mesh axis (multi-dim SBP,
paper §3.3), e.g. ``NdSbp.parse("S(0),B")`` over a ``(data, model)`` mesh means
"split batch over data axis, replicate over model axis".
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence, Tuple, Union


class Sbp:
    """Base class for a single-axis SBP component."""

    __slots__ = ()

    # -- classification helpers ------------------------------------------------
    @property
    def is_split(self) -> bool:
        return isinstance(self, Split)

    @property
    def is_broadcast(self) -> bool:
        return isinstance(self, Broadcast)

    @property
    def is_partial(self) -> bool:
        return isinstance(self, Partial)

    # -- parsing ----------------------------------------------------------------
    _PAT = re.compile(r"^\s*(?:S\((\d+)\)|B|P(?:\((\w+)\))?)\s*$", re.IGNORECASE)

    @staticmethod
    def parse(text: Union[str, "Sbp"]) -> "Sbp":
        if isinstance(text, Sbp):
            return text
        m = Sbp._PAT.match(text)
        if not m:
            raise ValueError(f"unparsable SBP component: {text!r}")
        if m.group(1) is not None:
            return Split(int(m.group(1)))
        if text.strip().upper().startswith("B"):
            return Broadcast()
        return Partial(m.group(2) or "sum")


@dataclasses.dataclass(frozen=True)
class Split(Sbp):
    """S(axis): balanced split of the logical tensor along ``axis``."""

    axis: int

    def __post_init__(self):
        if self.axis < 0:
            raise ValueError("split axis must be non-negative (logical axes)")

    def __repr__(self) -> str:
        return f"S({self.axis})"


@dataclasses.dataclass(frozen=True)
class Broadcast(Sbp):
    """B: full replica on every device of the axis."""

    def __repr__(self) -> str:
        return "B"


@dataclasses.dataclass(frozen=True)
class Partial(Sbp):
    """P(op): physical tensors reduce elementwise (by ``op``) to the logical one."""

    op: str = "sum"

    _VALID = ("sum", "max", "min")

    def __post_init__(self):
        if self.op not in self._VALID:
            raise ValueError(f"unsupported partial reduction {self.op!r}")

    def __repr__(self) -> str:
        return f"P({self.op})"


# Convenient singletons / constructors
B = Broadcast()
P = Partial("sum")


def S(axis: int) -> Split:
    return Split(axis)


@dataclasses.dataclass(frozen=True)
class NdSbp:
    """Multi-dimensional SBP: one component per mesh axis (paper §3.3)."""

    components: Tuple[Sbp, ...]

    def __post_init__(self):
        object.__setattr__(self, "components", tuple(Sbp.parse(c) for c in self.components))

    # -- construction ----------------------------------------------------------
    @staticmethod
    def of(*components: Union[str, Sbp]) -> "NdSbp":
        return NdSbp(tuple(Sbp.parse(c) for c in components))

    @staticmethod
    def parse(text: Union[str, "NdSbp", Sequence[Union[str, Sbp]]]) -> "NdSbp":
        if isinstance(text, NdSbp):
            return text
        if isinstance(text, (list, tuple)):
            return NdSbp.of(*text)
        # split on commas that are not inside parentheses: "S(0), P(sum)" etc.
        parts = [p for p in re.findall(r"S\(\d+\)|P\(\w+\)|P|B", text, re.I)]
        if not parts:
            raise ValueError(f"unparsable NdSbp: {text!r}")
        return NdSbp.of(*parts)

    @staticmethod
    def broadcast(ndim_mesh: int) -> "NdSbp":
        return NdSbp.of(*(["B"] * ndim_mesh))

    # -- introspection ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.components)

    def __iter__(self):
        return iter(self.components)

    def __getitem__(self, i: int) -> Sbp:
        return self.components[i]

    @property
    def has_partial(self) -> bool:
        return any(c.is_partial for c in self.components)

    @property
    def has_split(self) -> bool:
        return any(c.is_split for c in self.components)

    def split_axes(self) -> Tuple[int, ...]:
        return tuple(c.axis for c in self.components if isinstance(c, Split))

    def replace(self, mesh_axis: int, comp: Union[str, Sbp]) -> "NdSbp":
        comps = list(self.components)
        comps[mesh_axis] = Sbp.parse(comp)
        return NdSbp(tuple(comps))

    def __repr__(self) -> str:
        return "(" + ", ".join(repr(c) for c in self.components) + ")"

    # -- shape logic -------------------------------------------------------------
    def validate_for_shape(self, shape: Sequence[int], mesh_shape: Sequence[int]) -> None:
        """Check this NdSbp is applicable to a logical ``shape`` on ``mesh_shape``.

        Splits must address existing tensor axes and divide evenly (we require
        even division — OneFlow balances uneven splits, we keep the stricter
        contract so physical shards are uniform for shard_map).
        """
        if len(self.components) != len(mesh_shape):
            raise ValueError(
                f"NdSbp rank {len(self.components)} != mesh rank {len(mesh_shape)}")
        # accumulate division per tensor axis (two mesh axes may split the same
        # tensor axis — the division factors multiply)
        divisor = [1] * len(shape)
        for comp, size in zip(self.components, mesh_shape):
            if isinstance(comp, Split):
                if comp.axis >= len(shape):
                    raise ValueError(f"{comp} addresses axis beyond shape {tuple(shape)}")
                divisor[comp.axis] *= size
        for ax, d in enumerate(divisor):
            if shape[ax] % d != 0:
                raise ValueError(
                    f"axis {ax} of shape {tuple(shape)} not divisible by {d} for {self}")

    def local_shape(self, shape: Sequence[int], mesh_shape: Sequence[int]) -> Tuple[int, ...]:
        """The physical (per-device) shard shape of a logical ``shape``."""
        self.validate_for_shape(shape, mesh_shape)
        out = list(shape)
        for comp, size in zip(self.components, mesh_shape):
            if isinstance(comp, Split):
                out[comp.axis] //= size
        return tuple(out)

    def num_replicas(self, mesh_shape: Sequence[int]) -> int:
        """Number of identical copies of each element across the mesh (B axes)."""
        n = 1
        for comp, size in zip(self.components, mesh_shape):
            if comp.is_broadcast:
                n *= size
        return n

    def bytes_per_device(self, shape: Sequence[int], mesh_shape: Sequence[int],
                         itemsize: int) -> int:
        return itemsize * math.prod(self.local_shape(shape, mesh_shape))


def ndsbp(spec: Union[str, NdSbp, Sequence[Union[str, Sbp]]]) -> NdSbp:
    """Public helper: parse anything NdSbp-ish."""
    return NdSbp.parse(spec)
