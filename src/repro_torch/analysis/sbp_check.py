"""SBP legality pass: every plan edge must be expressible and well-shaped.

Three invariants over a (LogicalGraph, Plan) pair, checked without placing a
single tensor:

1. every stored / required signature validates against the tensor's logical
   shape (split axes in range and dividing the dimension);
2. every producer→consumer edge's (have, need) transition is priced by the
   Table-2 cost model (:func:`repro_torch.core.boxing.nd_transition_cost`) — an
   unpriceable transition means no boxing primitive realizes the edge;
3. partial-sum values never leak: a P signature may feed further ops (the
   planner prices the P→B combine), but it must not escape through a graph
   sink without an epilogue materialization, nor cross a stage boundary
   unmaterialized — at the actor level only the ``norm``-style combiners may
   consume partials sideways.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.report import Violation
from repro_torch.core.boxing import nd_transition_cost
from repro_torch.core.graph import LogicalGraph, StagePartition
from repro_torch.core.planner import Plan
from repro_torch.core.sbp import NdSbp


def check_sbp(
    graph: LogicalGraph,
    plan: Plan,
    partition: Optional[StagePartition] = None,
    boundary_sbp: Optional[Dict[str, NdSbp]] = None,
) -> Tuple[List[Violation], int]:
    """Return (violations, checked_edge_count)."""
    mesh_shape = tuple(graph.placement.mesh_shape())
    tensors = {t.name: t for t in graph.tensors}
    violations: List[Violation] = []
    checked = 0

    for name, sig in plan.tensor_sbp.items():
        t = tensors.get(name)
        if t is None:
            continue
        try:
            sig.validate_for_shape(t.shape, mesh_shape)
        except ValueError as e:
            violations.append(Violation(
                "sbp", name,
                f"signature {sig} is illegal for shape {tuple(t.shape)} "
                f"on mesh {mesh_shape}: {e}"))

    producer_stage: Dict[str, int] = {}
    if partition is not None:
        for op in graph.ops:
            producer_stage[op.output.name] = partition.stage_of[op.name]

    for op in graph.ops:
        need_sigs = plan.op_in_sbp.get(op.name)
        for i, t in enumerate(op.inputs):
            have = plan.tensor_sbp.get(t.name)
            need = need_sigs[i] if need_sigs is not None else None
            if have is None or need is None:
                continue
            checked += 1
            edge = f"{t.name} -> {op.name}"
            try:
                need.validate_for_shape(t.shape, mesh_shape)
            except ValueError as e:
                violations.append(Violation(
                    "sbp", edge,
                    f"required signature {need} is illegal for shape "
                    f"{tuple(t.shape)} on mesh {mesh_shape}: {e}"))
                continue
            try:
                nd_transition_cost(have, need, float(t.nbytes), mesh_shape)
            except (ValueError, TypeError) as e:
                violations.append(Violation(
                    "sbp", edge,
                    f"transition {have} -> {need} (shape {tuple(t.shape)}, "
                    f"mesh {mesh_shape}) is not expressible by any boxing "
                    f"primitive: {e}"))
            if partition is not None:
                src_stage = producer_stage.get(t.name)
                dst_stage = partition.stage_of[op.name]
                if src_stage is not None and dst_stage > src_stage:
                    boundary = (boundary_sbp or {}).get(t.name, have)
                    if boundary.has_partial:
                        violations.append(Violation(
                            "sbp", edge,
                            f"partial value {t.name} ({boundary}) crosses the "
                            f"stage {src_stage} -> {dst_stage} boundary "
                            f"unmaterialized; partials may only reach P->B "
                            f"combiners or an explicit materialization"))

    materialized_sinks = {tname for tname, opname, _, _, _ in plan.boxings
                          if opname == "__epilogue__"}
    for t in graph.sinks():
        sig = plan.tensor_sbp.get(t.name)
        if sig is None:
            continue
        checked += 1
        if sig.has_partial and t.name not in materialized_sinks:
            violations.append(Violation(
                "sbp", t.name,
                f"partial value {t.name} ({sig}, shape {tuple(t.shape)}) "
                f"leaks through a graph sink without a P->B combiner or "
                f"epilogue materialization"))
    return violations, checked
