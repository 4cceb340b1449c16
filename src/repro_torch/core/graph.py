"""Logical computation graph IR (paper §2/§3: logical graph -> physical plan).

A :class:`LogicalGraph` is a DAG of :class:`LTensor` values produced by ops
from the registry in :mod:`repro_torch.core.ops`. Tensors may be *pinned* to a
specific NdSbp (the user's annotations, paper Table 4); the planner fills in
the rest minimizing Table-2 boxing cost.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import ops as ops_mod
from repro_torch.core.placement import Placement
from repro_torch.core.sbp import NdSbp, ndsbp


_counter = itertools.count()


@dataclasses.dataclass
class LTensor:
    """A logical tensor: symbolic value in the graph."""

    graph: "LogicalGraph"
    shape: Tuple[int, ...]
    dtype: str
    name: str
    producer: Optional["LOp"] = None
    pinned_sbp: Optional[NdSbp] = None

    @property
    def itemsize(self) -> int:
        return {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "int64": 8, "int8": 1}[self.dtype]

    @property
    def nbytes(self) -> int:
        n = self.itemsize
        for s in self.shape:
            n *= s
        return n

    def pin(self, sbp: Union[str, NdSbp]) -> "LTensor":
        self.pinned_sbp = ndsbp(sbp)
        self.pinned_sbp.validate_for_shape(self.shape, self.graph.placement.mesh_shape())
        return self

    def __repr__(self):
        return f"LTensor({self.name}:{self.dtype}{list(self.shape)})"


@dataclasses.dataclass
class LOp:
    """A logical op instance in the graph."""

    spec: ops_mod.OpSpec
    inputs: Tuple[LTensor, ...]
    output: LTensor
    name: str
    stage: Optional[int] = None             # pipeline-stage annotation (§4.3)

    def __repr__(self):
        ins = ", ".join(t.name for t in self.inputs)
        return f"LOp({self.name}: {self.spec.name}({ins}) -> {self.output.name})"


class LogicalGraph:
    """Builder + container for the logical DAG."""

    def __init__(self, placement: Placement):
        self.placement = placement
        self.tensors: List[LTensor] = []
        self.ops: List[LOp] = []
        self.inputs: List[LTensor] = []
        self._current_stage: Optional[int] = None

    @contextlib.contextmanager
    def stage(self, index: int):
        """Annotate ops built inside the block as pipeline stage ``index``."""
        if index < 0:
            raise ValueError(f"stage index must be >= 0, got {index}")
        prev, self._current_stage = self._current_stage, index
        try:
            yield self
        finally:
            self._current_stage = prev

    # -- construction ------------------------------------------------------
    def input(self, name: str, shape: Sequence[int], dtype: str = "float32",
              sbp: Optional[Union[str, NdSbp]] = None) -> LTensor:
        t = LTensor(self, tuple(shape), dtype, name)
        if sbp is not None:
            t.pin(sbp)
        self.tensors.append(t)
        self.inputs.append(t)
        return t

    def apply(self, op_name: str, inputs: Sequence[LTensor],
              attrs: Optional[Dict] = None, out_dtype: Optional[str] = None,
              name: Optional[str] = None) -> LTensor:
        opdef = ops_mod.get(op_name)
        if len(inputs) != opdef.n_in:
            raise ValueError(f"{op_name} expects {opdef.n_in} inputs")
        spec = ops_mod.OpSpec(opdef, dict(attrs or {}))
        out_shape = opdef.infer_shape(spec, [t.shape for t in inputs])
        idx = next(_counter)
        oname = name or f"{op_name}_{idx}"
        out = LTensor(self, tuple(out_shape), out_dtype or inputs[0].dtype,
                      f"{oname}.out")
        op = LOp(spec, tuple(inputs), out, oname, stage=self._current_stage)
        out.producer = op
        self.tensors.append(out)
        self.ops.append(op)
        return out

    # -- sugar ---------------------------------------------------------------
    def matmul(self, x: LTensor, w: LTensor, name=None) -> LTensor:
        return self.apply("matmul", [x, w], name=name)

    def add(self, a: LTensor, b: LTensor, name=None) -> LTensor:
        return self.apply("ew_binary", [a, b],
                          attrs={"ndim": len(a.shape), "op": "add"}, name=name)

    def unary(self, x: LTensor, fn: str = "relu", linear: bool = False,
              name=None) -> LTensor:
        return self.apply("ew_unary", [x],
                          attrs={"ndim": len(x.shape), "fn": fn, "linear": linear},
                          name=name)

    def bias_add(self, x: LTensor, b: LTensor, name=None) -> LTensor:
        return self.apply("bias_add", [x, b], name=name)

    def softmax(self, x: LTensor, name=None) -> LTensor:
        return self.apply("softmax", [x], attrs={"ndim": len(x.shape)}, name=name)

    def reduce(self, x: LTensor, axis: int, op: str = "sum", name=None) -> LTensor:
        return self.apply("reduce", [x],
                          attrs={"ndim": len(x.shape), "axis": axis, "op": op},
                          name=name)

    def softmax_xent(self, logits: LTensor, labels: LTensor, name=None) -> LTensor:
        return self.apply("softmax_xent", [logits, labels], name=name)

    def embedding(self, table: LTensor, ids: LTensor, name=None) -> LTensor:
        return self.apply("embedding", [table, ids], name=name)

    # -- queries ---------------------------------------------------------------
    def consumers(self, t: LTensor) -> List[LOp]:
        return [op for op in self.ops if t in op.inputs]

    def topo_ops(self) -> List[LOp]:
        return list(self.ops)  # construction order is already topological

    def sinks(self) -> List[LTensor]:
        """Graph outputs: op outputs never consumed by another op."""
        consumed = {t.name for op in self.ops for t in op.inputs}
        return [op.output for op in self.ops if op.output.name not in consumed]

    def downstream_of(self, names) -> set:
        """Names of the given tensors plus every tensor transitively
        computed from them (one forward pass over the topo order)."""
        dep = set(names)
        for op in self.topo_ops():
            if any(t.name in dep for t in op.inputs):
                dep.add(op.output.name)
        return dep

    def ancestors(self, t: LTensor) -> set:
        """Names of ``t`` and every tensor it transitively depends on."""
        seen: set = set()
        stack = [t]
        while stack:
            cur = stack.pop()
            if cur.name in seen:
                continue
            seen.add(cur.name)
            if cur.producer is not None:
                stack.extend(cur.producer.inputs)
        return seen

    # -- compilation -----------------------------------------------------------
    def compile(self, **options):
        """Compile this graph into a runnable :class:`repro_torch.api.Session` —
        shorthand for ``repro_torch.api.compile(graph, **options)``, the single
        frontend over every lowering/executor path (paper §2, §4)."""
        from repro_torch.api import compile as _compile
        return _compile(self, **options)


# ---------------------------------------------------------------------------
# Pipeline-stage partitioning (paper §4.3: the compiler cuts the physical
# graph into stages; the actor protocol's register quotas then pipeline them).
# ---------------------------------------------------------------------------

def op_cost(op: LOp) -> float:
    """Rough FLOP estimate used to balance stages when the user didn't
    annotate. Matmul dominates real graphs; everything else counts its
    output elements once."""
    kind = op.spec.name
    out_elems = 1
    for s in op.output.shape:
        out_elems *= s
    if kind == "matmul":
        k = op.inputs[0].shape[-1]
        return 2.0 * out_elems * k
    if kind == "embedding":
        return float(out_elems)
    return float(out_elems)


@dataclasses.dataclass
class StagePartition:
    """A cut of the logical DAG into ``num_stages`` pipeline stages.

    ``stage_of`` maps op name -> stage index. The assignment is *monotone*:
    every edge goes from a stage to the same or a later stage, so the stage
    graph is acyclic and each stage can be lowered (and executed by an actor)
    independently.
    """

    num_stages: int
    stage_of: Dict[str, int]

    def ops_in(self, graph: "LogicalGraph", stage: int) -> List[LOp]:
        return [op for op in graph.topo_ops() if self.stage_of[op.name] == stage]

    def describe(self, graph: "LogicalGraph",
                 regs: Optional[Sequence[int]] = None) -> str:
        """Report the cut: ops and cost per stage, plus — when ``regs`` is
        given — each stage's out-register quota (the in-flight microbatch
        bound its pipeline schedule emerges from)."""
        lines = [f"=== stage partition ({self.num_stages} stages) ==="]
        for s in range(self.num_stages):
            ops = self.ops_in(graph, s)
            cost = sum(op_cost(op) for op in ops)
            quota = f"  regs={regs[s]}" if regs is not None else ""
            lines.append(f"  stage {s}: {[op.name for op in ops]}"
                         f"  (~{cost:,.0f} flop){quota}")
        return "\n".join(lines)


def _validate_partition(graph: LogicalGraph, stage_of: Dict[str, int],
                        num_stages: int) -> None:
    for op in graph.ops:
        if op.name not in stage_of:
            raise ValueError(f"op {op.name} has no stage assignment")
        s = stage_of[op.name]
        if not 0 <= s < num_stages:
            raise ValueError(f"op {op.name} assigned stage {s}, outside "
                             f"[0, {num_stages})")
        for t in op.inputs:
            if t.producer is not None and stage_of[t.producer.name] > s:
                raise ValueError(
                    f"non-monotone stage assignment: {t.producer.name} "
                    f"(stage {stage_of[t.producer.name]}) feeds {op.name} "
                    f"(stage {s}); producers must not be in a later stage")
    used = {stage_of[op.name] for op in graph.ops}
    for s in range(num_stages):
        if s not in used:
            raise ValueError(f"stage {s} is empty")


def partition_stages(graph: LogicalGraph,
                     num_stages: Optional[int] = None) -> StagePartition:
    """Cut the graph into pipeline stages.

    If any op carries a user annotation (built inside ``graph.stage(k)``),
    every op must be annotated and the annotation is validated for
    monotonicity. Otherwise the topologically ordered op list is split into
    ``num_stages`` contiguous segments of near-equal :func:`op_cost`
    (contiguity in topo order makes monotonicity automatic).
    """
    annotated = [op for op in graph.ops if op.stage is not None]
    if annotated:
        if len(annotated) != len(graph.ops):
            missing = [op.name for op in graph.ops if op.stage is None]
            raise ValueError(
                f"mixed stage annotation: ops {missing} have no stage; "
                "annotate every op or none")
        stage_of = {op.name: op.stage for op in graph.ops}
        n = max(stage_of.values()) + 1
        if num_stages is not None and num_stages != n:
            raise ValueError(f"num_stages={num_stages} but annotations span "
                             f"{n} stages")
        _validate_partition(graph, stage_of, n)
        return StagePartition(n, stage_of)

    if num_stages is None:
        raise ValueError("graph has no stage annotations; pass num_stages")
    ops = graph.topo_ops()
    if not 1 <= num_stages <= len(ops):
        raise ValueError(f"num_stages={num_stages} not in [1, {len(ops)}]")
    costs = [op_cost(op) for op in ops]
    total = sum(costs)
    stage_of: Dict[str, int] = {}
    acc, s, count_in_stage = 0.0, 0, 0
    for i, (op, c) in enumerate(zip(ops, costs)):
        remaining = len(ops) - i         # ops left, including this one
        # cut before this op when the current stage is non-empty and either
        # (a) the stages after s would otherwise run out of ops, or (b) this
        # op crosses the equal-cost boundary by more than half its cost
        if count_in_stage > 0 and s < num_stages - 1 and (
                remaining <= num_stages - s - 1
                or acc + c / 2 > total * (s + 1) / num_stages):
            s += 1
            count_in_stage = 0
        stage_of[op.name] = s
        acc += c
        count_in_stage += 1
    _validate_partition(graph, stage_of, num_stages)
    return StagePartition(num_stages, stage_of)
