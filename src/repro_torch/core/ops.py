"""Logical op registry with SBP deduction rules (paper §3.1, Tables 1 & 3).

Each op declares its *1-d* SBP rules: tuples ``(input_sbps, output_sbp)`` valid
on a single mesh axis. The multi-dimensional rule (Table 3) is the per-axis
cartesian product of 1-d rules — e.g. matmul with ``X:(S(0),B)  W:(B,S(1))``
satisfies row-1 of Table 1 on mesh axis 0 and row-2 on mesh axis 1, giving
``Y:(S(0),S(1))`` — exactly the 2-D SUMMA-style signature of Table 3.

Some signatures carry *internal* communication (e.g. softmax split along its
reduction axis performs a local max/sum then a global combine — paper Fig 11b);
ops can price that via ``internal_comm``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.sbp import B, NdSbp, P, Partial, Sbp, Split


@dataclasses.dataclass(frozen=True)
class Rule:
    """One valid 1-d signature: input SBPs -> output SBP (single mesh axis)."""

    ins: Tuple[Sbp, ...]
    out: Sbp
    # fraction of the OUTPUT logical tensor bytes communicated internally by
    # the op itself under this rule, as a function of the axis size p.
    internal_comm: Optional[Callable[[int], float]] = None


@dataclasses.dataclass
class OpDef:
    name: str
    n_in: int
    rules_fn: Callable[["OpSpec"], List[Rule]]
    infer_shape: Callable[["OpSpec", Sequence[Tuple[int, ...]]], Tuple[int, ...]]
    flops: Optional[Callable[["OpSpec", Sequence[Tuple[int, ...]]], float]] = None


def _opspec_from_registry(name: str, attrs: Dict) -> "OpSpec":
    """Pickle reconstructor for :class:`OpSpec` — resolve the op definition
    from :data:`REGISTRY` by name (op defs carry lambdas and cannot cross a
    process boundary; the registry contents are identical in every worker)."""
    return OpSpec(REGISTRY[name], attrs)


@dataclasses.dataclass
class OpSpec:
    """An op instance: definition + static attributes (axes, shapes...)."""

    opdef: OpDef
    attrs: Dict = dataclasses.field(default_factory=dict)

    def __reduce__(self):
        return (_opspec_from_registry, (self.opdef.name, self.attrs))

    @property
    def name(self):
        return self.opdef.name

    def rules(self) -> List[Rule]:
        return self.opdef.rules_fn(self)

    def nd_signatures(self, mesh_ndim: int):
        """All valid Nd signatures = product of 1-d rules over mesh axes.

        Yields ``(in_ndsbps: tuple[NdSbp], out_ndsbp: NdSbp, internal_fns)``.
        """
        rules = self.rules()
        for combo in itertools.product(rules, repeat=mesh_ndim):
            ins = tuple(
                NdSbp(tuple(r.ins[i] for r in combo)) for i in range(self.opdef.n_in))
            out = NdSbp(tuple(r.out for r in combo))
            internal = tuple(r.internal_comm for r in combo)
            yield ins, out, internal


REGISTRY: Dict[str, OpDef] = {}


def register(opdef: OpDef) -> OpDef:
    REGISTRY[opdef.name] = opdef
    return opdef


# ---------------------------------------------------------------------------
# MatMul — Table 1 verbatim.
# ---------------------------------------------------------------------------

def _matmul_rules(spec: OpSpec) -> List[Rule]:
    return [
        Rule((Split(0), B), Split(0)),           # data parallel
        Rule((B, Split(1)), Split(1)),           # model parallel (col)
        Rule((Split(1), Split(0)), P),           # contraction split -> partial
        Rule((P, B), P),                         # defer reduction (§3.3)
        Rule((B, P), P),
        Rule((B, B), B),
    ]


def _matmul_shape(spec: OpSpec, shapes) -> Tuple[int, ...]:
    (m, k), (k2, n) = shapes
    if k != k2:
        raise ValueError(f"matmul inner dims {k} != {k2}")
    return (m, n)


register(OpDef("matmul", 2, _matmul_rules, _matmul_shape,
               flops=lambda spec, shapes: 2.0 * shapes[0][0] * shapes[0][1] * shapes[1][1]))


# ---------------------------------------------------------------------------
# Elementwise ops.
# ---------------------------------------------------------------------------

def _ew_unary_rules(spec: OpSpec) -> List[Rule]:
    ndim = spec.attrs["ndim"]
    rules = [Rule((B,), B)]
    rules += [Rule((Split(i),), Split(i)) for i in range(ndim)]
    if spec.attrs.get("linear", False):
        # linear maps commute with summation -> P passes through
        rules.append(Rule((P,), P))
    return rules


register(OpDef("ew_unary", 1, _ew_unary_rules, lambda spec, shapes: shapes[0]))


def _ew_binary_rules(spec: OpSpec) -> List[Rule]:
    ndim = spec.attrs["ndim"]
    rules = [Rule((B, B), B)]
    rules += [Rule((Split(i), Split(i)), Split(i)) for i in range(ndim)]
    if spec.attrs.get("op", "add") == "add":
        rules.append(Rule((P, P), P))  # (x1+x2)+(y1+y2) == (x1+y1)+(x2+y2)
    return rules


def _ew_binary_shape(spec: OpSpec, shapes):
    if shapes[0] != shapes[1]:
        raise ValueError(f"elementwise shape mismatch {shapes}")
    return shapes[0]


register(OpDef("ew_binary", 2, _ew_binary_rules, _ew_binary_shape))


# bias_add: (M, N) + (N,) — bias must be B (or S(0) matching lhs S(1)).
def _bias_add_rules(spec: OpSpec) -> List[Rule]:
    # NOTE: (P, B) -> P is deliberately absent: adding a broadcast bias to every
    # partial shard would apply the bias p times after reduction.
    return [
        Rule((B, B), B),
        Rule((Split(0), B), Split(0)),
        Rule((Split(1), Split(0)), Split(1)),
    ]


register(OpDef("bias_add", 2, _bias_add_rules,
               lambda spec, shapes: shapes[0]))


# ---------------------------------------------------------------------------
# Reductions.
# ---------------------------------------------------------------------------

def _reduce_rules(spec: OpSpec) -> List[Rule]:
    ndim = spec.attrs["ndim"]
    axis = spec.attrs["axis"]
    red = spec.attrs.get("op", "sum")
    rules = [Rule((B,), B)]
    for i in range(ndim):
        if i == axis:
            # reducing over the split axis -> partial values
            if red in ("sum", "max", "min"):
                rules.append(Rule((Split(i),), Partial(red)))
        else:
            rules.append(Rule((Split(i),), Split(i)))  # keepdims=True contract
    if red == "sum":
        rules.append(Rule((P,), P))
    return rules


def _reduce_shape(spec: OpSpec, shapes):
    out = list(shapes[0])
    out[spec.attrs["axis"]] = 1
    return tuple(out)


register(OpDef("reduce", 1, _reduce_rules, _reduce_shape))


# ---------------------------------------------------------------------------
# Softmax (rowwise over last axis) — Fig 11b hierarchical reduction.
# ---------------------------------------------------------------------------

def _softmax_rules(spec: OpSpec) -> List[Rule]:
    ndim = spec.attrs.get("ndim", 2)
    assert ndim == 2
    return [
        Rule((B,), B),
        Rule((Split(0),), Split(0)),
        # split along the reduced (class) axis: local max/sum + global combine;
        # internal comm = 2 rows-sized all-reduces ~= 2*2*(p-1)/p of a column.
        Rule((Split(1),), Split(1),
             internal_comm=lambda p: 4.0 * (p - 1) / p * spec.attrs.get(
                 "stat_frac", 1e-3)),
    ]


register(OpDef("softmax", 1, _softmax_rules, lambda spec, shapes: shapes[0]))


# sparse softmax cross entropy: logits (N, C), labels (N,) -> loss (N, 1)
def _xent_rules(spec: OpSpec) -> List[Rule]:
    return [
        Rule((B, B), B),
        Rule((Split(0), Split(0)), Split(0)),
        # vocab-split logits, broadcast labels: local max/sum/gather + combine
        Rule((Split(1), B), P,
             internal_comm=lambda p: 0.0),
    ]


register(OpDef("softmax_xent", 2, _xent_rules,
               lambda spec, shapes: (shapes[0][0], 1)))


# ---------------------------------------------------------------------------
# Embedding lookup: table (V, D), ids (N,) -> (N, D)   (HugeCTR case, §6.3.2)
# ---------------------------------------------------------------------------

def _embedding_rules(spec: OpSpec) -> List[Rule]:
    return [
        Rule((B, B), B),
        Rule((B, Split(0)), Split(0)),          # data parallel over ids
        Rule((Split(1), B), Split(1)),          # split hidden dim
        # split vocab: each shard holds its id range, emits zeros elsewhere -> P
        Rule((Split(0), B), P),
    ]


register(OpDef("embedding", 2, _embedding_rules,
               lambda spec, shapes: (shapes[1][0], shapes[0][1])))


def get(name: str) -> OpDef:
    return REGISTRY[name]
