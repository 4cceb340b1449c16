"""SBP signature planner — the compiler's parallelism-strategy selection.

Given a :class:`LogicalGraph` with some tensors pinned (user annotations,
paper Table 4), choose an NdSbp for every tensor and an op signature for every
op, minimizing total Table-2 boxing cost + per-op internal communication
(paper §3.2: "selecting SBP signatures incurring the lowest communication
costs").

Algorithm: Viterbi-style dynamic programming over the topologically ordered
DAG. Each tensor keeps a table ``{NdSbp: best cumulative cost}``. For an op,
every valid Nd signature (cartesian product of 1-d rules, Table 3) is priced as

    sum_i  min_{s in table(in_i)} [ table(in_i)[s] + boxing(s -> sig_i) ]
    + internal_comm(sig)

For tensors consumed by multiple ops the DP relaxes to a greedy approximation
(each consumer boxes independently from the producer's committed best
signature) — the same decomposition OneFlow's compiler applies when it inserts
one boxing op per mismatched consumer edge.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.boxing import nd_transition_cost
from repro_torch.core.graph import LogicalGraph, LTensor
from repro_torch.core.sbp import Broadcast, NdSbp, Partial, Sbp, Split


@dataclasses.dataclass
class Plan:
    """The chosen physical plan: signatures per tensor + boxing edges.

    ``op_out_sbp`` is the signature the op's rule *produces*; ``tensor_sbp``
    is the signature the tensor is *stored* with. They differ only when the
    planner inserted an epilogue boxing (e.g. materializing a partial-value
    sink via all-reduce / reduce-scatter).
    """

    tensor_sbp: Dict[str, NdSbp]
    op_in_sbp: Dict[str, Tuple[NdSbp, ...]]
    op_out_sbp: Dict[str, NdSbp]
    boxings: List[Tuple[str, str, NdSbp, NdSbp, float]]  # (tensor, consumer_op, src, dst, cost)
    total_cost: float

    def describe(self) -> str:
        lines = ["=== SBP plan ==="]
        for name, sbp in self.tensor_sbp.items():
            lines.append(f"  {name:<28} {sbp}")
        if self.boxings:
            lines.append("--- boxing ops (compiler-inserted collectives) ---")
            for tname, opname, src, dst, cost in self.boxings:
                lines.append(
                    f"  {tname} -> {opname}: {src} => {dst}   cost={cost:,.0f} B")
        lines.append(f"total comm cost = {self.total_cost:,.0f} bytes")
        return "\n".join(lines)


def _candidate_sigs(t: LTensor, mesh_shape: Sequence[int]) -> List[NdSbp]:
    """Enumerate NdSbp candidates valid for this tensor's shape."""
    if t.pinned_sbp is not None:
        return [t.pinned_sbp]
    per_axis: List[Sbp] = [Broadcast(), Partial("sum")]
    per_axis += [Split(i) for i in range(len(t.shape))]
    cands = []
    for combo in itertools.product(per_axis, repeat=len(mesh_shape)):
        sig = NdSbp(tuple(combo))
        try:
            sig.validate_for_shape(t.shape, mesh_shape)
        except ValueError:
            continue
        cands.append(sig)
    return cands


def plan(graph: LogicalGraph, *, forbid_partial_outputs: bool = True) -> Plan:
    mesh_shape = graph.placement.mesh_shape()
    mesh_ndim = len(mesh_shape)

    # DP tables: tensor name -> {NdSbp: (cost, backpointer)}
    table: Dict[str, Dict[NdSbp, float]] = {}
    # committed signature choices filled during backward pass
    chosen: Dict[str, NdSbp] = {}
    op_choice: Dict[str, Tuple[Tuple[NdSbp, ...], NdSbp]] = {}
    back: Dict[str, Dict[NdSbp, Tuple[Tuple[NdSbp, ...], float]]] = {}

    for t in graph.inputs:
        cands = _candidate_sigs(t, mesh_shape)
        table[t.name] = {c: 0.0 for c in cands}

    consumers_count = {t.name: len(graph.consumers(t)) for t in graph.tensors}

    for op in graph.topo_ops():
        out = op.output
        out_table: Dict[NdSbp, float] = {}
        out_back: Dict[NdSbp, Tuple[Tuple[NdSbp, ...], float]] = {}
        allowed_out = None
        if out.pinned_sbp is not None:
            allowed_out = out.pinned_sbp
        for in_sigs, out_sig, internal in op.spec.nd_signatures(mesh_ndim):
            if allowed_out is not None and out_sig != allowed_out:
                continue
            # shape validity for all tensors under this signature
            try:
                out_sig.validate_for_shape(out.shape, mesh_shape)
                for t, s in zip(op.inputs, in_sigs):
                    s.validate_for_shape(t.shape, mesh_shape)
            except ValueError:
                continue
            cost = 0.0
            feasible = True
            for t, s in zip(op.inputs, in_sigs):
                tin = table.get(t.name)
                if not tin:
                    feasible = False
                    break
                best = math.inf
                for src_sig, src_cost in tin.items():
                    c = src_cost + nd_transition_cost(src_sig, s, t.nbytes, mesh_shape)
                    best = min(best, c)
                if math.isinf(best):
                    feasible = False
                    break
                cost += best
            if not feasible:
                continue
            for k, fn in enumerate(internal):
                if fn is not None:
                    cost += fn(mesh_shape[k]) * out.nbytes
            if out_sig not in out_table or cost < out_table[out_sig]:
                out_table[out_sig] = cost
                out_back[out_sig] = (in_sigs, cost)
        if not out_table:
            raise ValueError(f"no feasible SBP signature for op {op}")
        table[out.name] = out_table
        back[out.name] = out_back

    # -- backward pass: commit choices from graph outputs -----------------------
    consumed = set()
    for op in graph.ops:
        for t in op.inputs:
            consumed.add(t.name)
    sink_names = {op.output.name for op in graph.ops if op.output.name not in consumed}

    def _materializations(sig: NdSbp, t: LTensor) -> List[NdSbp]:
        """Candidate partial-free signatures reachable from ``sig``: replace
        every P component by B or by any shape-valid split."""
        axis_opts: List[List] = []
        for comp in sig:
            if comp.is_partial:
                opts = [Broadcast()] + [Split(i) for i in range(len(t.shape))]
            else:
                opts = [comp]
            axis_opts.append(opts)
        outs = []
        for combo in itertools.product(*axis_opts):
            cand = NdSbp(tuple(combo))
            try:
                cand.validate_for_shape(t.shape, mesh_shape)
            except ValueError:
                continue
            outs.append(cand)
        return outs

    epilogue: Dict[str, Tuple[NdSbp, NdSbp, float]] = {}  # out -> (raw, stored, cost)

    for op in reversed(graph.topo_ops()):
        out = op.output
        if out.name not in chosen:
            # sink (or dead output): pick the best signature, pricing the
            # epilogue boxing needed to materialize partial-value results.
            opts = table[out.name]
            best = None  # (total_cost, raw_sig, stored_sig, epi_cost)
            for sig, c in opts.items():
                if sig.has_partial and forbid_partial_outputs and out.name in sink_names:
                    for mat in _materializations(sig, out):
                        epi = nd_transition_cost(sig, mat, out.nbytes, mesh_shape)
                        cand = (c + epi, sig, mat, epi)
                        if best is None or cand[0] < best[0]:
                            best = cand
                else:
                    cand = (c, sig, sig, 0.0)
                    if best is None or cand[0] < best[0]:
                        best = cand
            _, raw, stored, epi = best
            chosen[out.name] = stored
            if raw != stored:
                epilogue[out.name] = (raw, stored, epi)
            op_raw_sig = raw
        else:
            # a consumer already demanded a stored signature; find the best
            # rule output 'raw' such that raw -> stored boxing + rule cost min
            stored = chosen[out.name]
            best = None
            for sig, c in table[out.name].items():
                epi = nd_transition_cost(sig, stored, out.nbytes, mesh_shape)
                cand = (c + epi, sig, epi)
                if best is None or cand[0] < best[0]:
                    best = cand
            _, op_raw_sig, epi = best
            if op_raw_sig != stored:
                epilogue[out.name] = (op_raw_sig, stored, epi)
        in_sigs, _ = back[out.name][op_raw_sig]
        op_choice[op.name] = (in_sigs, op_raw_sig)
        for t, s in zip(op.inputs, in_sigs):
            if t.name not in chosen:
                # choose producer-side signature minimizing (producer cost + box)
                tin = table[t.name]
                best_sig, best_c = None, math.inf
                for src_sig, src_cost in tin.items():
                    c = src_cost + nd_transition_cost(src_sig, s, t.nbytes, mesh_shape)
                    if c < best_c:
                        best_sig, best_c = src_sig, c
                chosen[t.name] = best_sig

    # -- collect boxing edges -----------------------------------------------------
    boxings = []
    grand_total = 0.0
    for op in graph.topo_ops():
        in_sigs, out_raw = op_choice[op.name]
        for t, s in zip(op.inputs, in_sigs):
            src = chosen[t.name]
            if src != s:
                c = nd_transition_cost(src, s, t.nbytes, mesh_shape)
                boxings.append((t.name, op.name, src, s, c))
                grand_total += c
        if op.output.name in epilogue:
            raw, stored, c = epilogue[op.output.name]
            boxings.append((op.output.name, "__epilogue__", raw, stored, c))
            grand_total += c

    return Plan(tensor_sbp=chosen,
                op_in_sbp={name: sigs for name, (sigs, _) in op_choice.items()},
                op_out_sbp={name: raw for name, (_, raw) in op_choice.items()},
                boxings=boxings, total_cost=grand_total)
