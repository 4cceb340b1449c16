"""Lowering: logical graphs and the serve model cut into stage programs.

Port of ``repro/core/lowering.py``, in two halves.

**Graph lowering** (``:41-1230``) turns a (LogicalGraph, Plan) into programs
over torch tensors on a :class:`repro_torch.core.mesh.DeviceMesh`. The
reference runs each (sub)graph as one jitted ``shard_map`` program whose
boxing edges are ``jax.lax`` collectives. Here a program is a list of steps
that every rank runs eagerly on its own shards, inside
:func:`repro_torch.core.mesh.spmd`: local steps (the ops, in topological
order) and collective steps (every boxing edge, and the combines inside
``softmax`` and vocab-split ``softmax_xent``):

* :func:`lower_plan` / :func:`lower_stages` -- inference, the whole graph or
  one program per pipeline stage (``stage_meshes``: each on its own ranks).
* :func:`lower_train_plan` / :func:`lower_train_stages` -- training. Where the
  reference stashes a ``jax.vjp`` closure per microbatch, each rank's
  forward here records its steps on detached leaves (an :class:`OpTape`)
  and the backward walks the tape in reverse on the rank's own thread:
  ``torch.autograd.grad`` step by step for the local steps, the explicit
  transpose for a collective one (S->B goes back as P->S, P->B as P->B, B->S
  as S->P), summing cotangents in that fixed order. No autograd node ever
  waits at a rendezvous. A stage's backward starts each boundary tensor's
  cotangent from what later stages sent, so the staged and the whole-graph
  backward add the same terms in the same order: that is what makes the
  actor pipeline bitwise the monolithic engine. A param's gradient sums are
  boxed to its own signature before the optimizer (P->B for a broadcast
  param).

The ``softmax_xent`` op goes through the xent kernel and its backward on a
CUDA tensor (:func:`repro_torch.kernels.softmax_xent.xent_local_stats`), on
a vocab shard at its offset where the logits are split;
``embedding`` is ``F.embedding``, whose backward on the card is sorted, not
atomic, so it sums in the same order on every run.

**Serve lowering** (``:1233-1503``). Stage ``s`` owns a
contiguous slice of the layer stack, balanced by unit count exactly as the
reference; its KV caches never leave the stage -- they are a persistent
stage-local register stream, updated in place by every decode fire. The
request-admission runtime half lives in :mod:`repro_torch.runtime.pipeline`.

Where the reference jits each serve stage under ``shard_map``, a stage
here is eager PyTorch over the stage's own copy of its weights, cast ONCE
to the compute dtype at construction (the reference casts
``param.astype(x.dtype)`` at every call; a cast is deterministic, so the
numbers are the same). The SSM params the reference reads in float32
(``dt_bias``, ``A_log``, ``D``) stay float32.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as M
from repro_torch.core.boxing import (boxing_fn, boxing_is_identity,
                                    cotangent_sbp, transposed_boxing_fn)
from repro_torch.core.graph import LogicalGraph, LOp, LTensor, StagePartition
from repro_torch.core.mesh import DeviceMesh, assemble, place, spmd
from repro_torch.core.planner import Plan
from repro_torch.core.sbp import Broadcast, NdSbp, Split
from repro_torch.core.tape import (INTERNAL, LocalProgram, Step,
                                   taped_backward, taped_forward)
from repro_torch.kernels.softmax_xent.kernel import xent_local_stats
from repro_torch.models import transformer as T
from repro_torch.models.common import MeshPlan, param
from repro_torch.models.model_zoo import make_decode_caches
from repro_torch.optim.adamw import (AdamWState, adamw_param_update,
                                    clip_scale, global_norm_from_partials,
                                    init_adamw, scale_grad,
                                    sqnorm_partials_sharded)
from repro_torch.optim.zero import (ZeroState, flat_zeros, gather_flat,
                                    init_zero_flat, shard_flat,
                                    zero_stage_update)

# ---------------------------------------------------------------------------
# Graph lowering: per-rank programs of local ops and collective steps.
# ---------------------------------------------------------------------------

_UNARY_FNS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "tanh": torch.tanh,
    "neg": torch.neg,
    "identity": lambda x: x,
    "scale2": lambda x: 2.0 * x,
}


def _matmul(x, w):
    """``x @ w`` in the promoted dtype of the two, as ``jnp.dot``."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w)


def _softmax(x):
    m = torch.amax(x, dim=1, keepdim=True)
    e = torch.exp(x - m)
    return e / torch.sum(e, dim=1, keepdim=True)


def _softmax_xent(logits, labels):
    """Per-row ``-log softmax(logits)[label]`` as (N, 1): the xent kernel's
    local stats at vocab offset 0 (the whole vocabulary on the rank)."""
    m, s, z = xent_local_stats(logits.contiguous(), labels.contiguous(), 0)
    return (torch.log(s) + m - z)[:, None]


def _local_fn(op: LOp) -> Callable:
    """The function of an op whose signatures need no combine across
    ranks: the same on every rank's shards."""
    kind = op.spec.name
    attrs = op.spec.attrs
    if kind == "matmul":
        return _matmul
    if kind == "ew_binary":
        return {"add": torch.add, "mul": torch.mul}[attrs.get("op", "add")]
    if kind == "ew_unary":
        return _UNARY_FNS[attrs.get("fn", "identity")]
    if kind == "bias_add":
        return lambda x, b: x + b[None, :]
    if kind == "reduce":
        axis, red = attrs["axis"], attrs.get("op", "sum")
        tfn = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[red]
        return lambda x: tfn(x, dim=axis, keepdim=True)
    if kind == "softmax":
        return _softmax
    if kind == "softmax_xent":
        return _softmax_xent
    if kind == "embedding":
        return lambda table, ids: F.embedding(ids, table)
    raise NotImplementedError(f"no local lowering for op kind {kind}")


def _split_axes_for(sig: NdSbp, tensor_axis: int, axis_names: Sequence[str],
                    mesh_shape: Sequence[int]) -> Tuple[str, ...]:
    """Mesh axes larger than 1 on which ``tensor_axis`` is split under
    ``sig`` (an axis of size 1 needs no combine)."""
    return tuple(name for comp, name, size in zip(sig, axis_names, mesh_shape)
                 if isinstance(comp, Split) and comp.axis == tensor_axis
                 and size > 1)


def _shard_offset(red: Sequence[str], axis_names: Sequence[str],
                  mesh_shape: Sequence[int], local: int) -> int:
    """Global index of this rank's first element along a tensor axis split
    over the mesh axes ``red`` into blocks of ``local`` (earlier axes
    major)."""
    offset, stride = 0, 1
    for name, size in reversed(list(zip(axis_names, mesh_shape))):
        if name in red:
            offset += M.axis_index(name) * stride * local
            stride *= size
    return offset


def _box_step(have: NdSbp, want: NdSbp, t: LTensor, src: str, dst: str,
              axis_names, mesh_shape) -> Optional[Step]:
    """The boxing step moving ``src`` (laid out ``have``) to ``dst``
    (``want``), or None where nothing moves."""
    if have == want or boxing_is_identity(have, want, mesh_shape):
        return None
    cell: Dict[str, Callable] = {}

    def transpose(g):
        # built on first use: P(max)/P(min) boxings have no transpose
        if "fn" not in cell:
            cell["fn"] = transposed_boxing_fn(have, want, axis_names,
                                              mesh_shape, t.shape)
        return cell["fn"](g)
    return Step(boxing_fn(have, want, axis_names, mesh_shape, t.shape),
                (src,), (dst,), collective=True, transpose=transpose)


def _softmax_steps(name: str, x: str, out: str, red: Tuple[str, ...]):
    """Softmax over a class axis split across ``red`` (paper Fig 11b):
    local max and sum, a pmax and a psum across the shards. The max is
    held fixed (softmax does not depend on it), so only the sum's psum is
    differentiated; its transpose is a psum of the cotangent."""
    m_loc, m, s_loc, s = (f"{name}{INTERNAL}{k}"
                          for k in ("m_loc", "m", "s_loc", "s"))
    return [
        Step(lambda v: torch.amax(v.detach(), dim=1, keepdim=True), (x,),
             (m_loc,)),
        Step(lambda v: M.pmax(v, red), (m_loc,), (m,), collective=True),
        Step(lambda v, mv: torch.sum(torch.exp(v - mv), dim=1, keepdim=True),
             (x, m), (s_loc,)),
        Step(lambda v: M.psum(v, red), (s_loc,), (s,), collective=True,
             transpose=lambda g: M.psum(g, red)),
        Step(lambda v, mv, sv: torch.exp(v - mv) / sv, (x, m, s), (out,)),
    ]


def _xent_steps(op: LOp, ins: Tuple[str, ...], out: str,
                red: Tuple[str, ...], axis_names, mesh_shape):
    """``softmax_xent`` on vocab-split logits, ``(S(1), B) -> P(sum)``.

    Each rank runs the xent kernel on its ``(rows, V / n)`` shard at its
    vocab offset, giving ``(m, s, z)``; ``m`` is combined with a pmax
    (held fixed, as ``local_stats_ref``'s stop-gradient), ``s`` rescaled
    by ``exp(m - m_g)`` and psummed. The output is a true P(sum): the rank
    at index 0 of the split axes adds ``log s_g + m_g`` and every rank
    subtracts its own ``z`` (0 off-shard), so the ranks sum to ``log s_g +
    m_g - z_label``. The rank-0 term is a multiply by 1 or 0, so every rank
    differentiates ``s_g`` and runs the psum's transpose."""
    local_c = op.inputs[0].shape[1] // math.prod(
        size for name, size in zip(axis_names, mesh_shape) if name in red)
    m, s, z, mg, sr, sg = (f"{op.name}{INTERNAL}{k}"
                           for k in ("m", "s", "z", "m_g", "s_r", "s_g"))

    def stats(logits, labels):
        offset = _shard_offset(red, axis_names, mesh_shape, local_c)
        return xent_local_stats(logits.contiguous(), labels.contiguous(),
                                offset)

    def combine(s_g, m_g, z_loc):
        first = float(all(M.axis_index(a) == 0 for a in red))
        return ((torch.log(s_g) + m_g) * first - z_loc)[:, None]

    return [
        Step(stats, ins, (m, s, z)),
        Step(lambda v: M.pmax(v, red), (m,), (mg,), collective=True),
        Step(lambda sv, mv, mgv: sv * torch.exp(mv - mgv), (s, m, mg),
             (sr,)),
        Step(lambda v: M.psum(v, red), (sr,), (sg,), collective=True,
             transpose=lambda g: M.psum(g, red)),
        Step(combine, (sg, mg, z), (out,)),
    ]


def _vocab_embedding(red: Tuple[str, ...], axis_names, mesh_shape):
    """Embedding on a vocab-split table, ``(S(0), B) -> P(sum)``: each rank
    looks up the ids in its row range and gives zeros for the rest."""
    def f(table, ids):
        local_v = table.shape[0]
        local = ids.long() - _shard_offset(red, axis_names, mesh_shape,
                                           local_v)
        in_range = (local >= 0) & (local < local_v)
        out = F.embedding(local.clamp(0, local_v - 1), table)
        return torch.where(in_range[:, None], out, 0.0)
    return f


def _op_steps(op: LOp, ins: Tuple[str, ...], out: str,
              in_sigs: Tuple[NdSbp, ...], axis_names, mesh_shape
              ) -> List[Step]:
    """The steps of one op under its input signatures: one local step, or
    local and collective steps where a split needs a combine across ranks
    (as ``repro/core/lowering.py:61-159``)."""
    kind = op.spec.name
    if kind in ("softmax", "softmax_xent"):
        red = _split_axes_for(in_sigs[0], 1, axis_names, mesh_shape)
        if red and kind == "softmax":
            return _softmax_steps(op.name, ins[0], out, red)
        if red:
            return _xent_steps(op, ins, out, red, axis_names, mesh_shape)
    if kind == "embedding":
        red = _split_axes_for(in_sigs[0], 0, axis_names, mesh_shape)
        if red:
            return [Step(_vocab_embedding(red, axis_names, mesh_shape), ins,
                         (out,))]
    return [Step(_local_fn(op), ins, (out,))]


def _materialized(sig: NdSbp) -> NdSbp:
    """Partial-free storage signature: P components become B. Tensors that
    cross a program boundary (graph outputs, stage boundaries) are stored
    so."""
    return NdSbp(tuple(Broadcast() if c.is_partial else c for c in sig))


def _lower_subgraph(graph: LogicalGraph, plan: Plan, ops: Sequence[LOp],
                    in_tensors: Sequence[LTensor],
                    out_tensors: Sequence[LTensor],
                    in_sbp: Dict[str, NdSbp],
                    out_sbp: Dict[str, NdSbp]) -> LocalProgram:
    """The program running ``ops`` from ``in_tensors`` to ``out_tensors``
    (reference ``:172-229``).

    ``in_sbp``/``out_sbp`` give the *stored* (partial-free) signatures at
    the boundary; inside, tensors follow the plan, partial values
    included, and a boxing step sits at every op input, op epilogue and
    boundary output whose signatures differ."""
    placement = graph.placement
    axis_names = tuple(placement.axis_names)
    mesh_shape = tuple(placement.mesh_shape())
    for t in in_tensors:
        if in_sbp[t.name].has_partial:
            raise ValueError(f"boundary input {t.name} stored as partial-value")
    for t in out_tensors:
        if out_sbp[t.name].has_partial:
            raise ValueError(f"boundary output {t.name} stored as partial-value")

    def box(have, want, t, src, dst):
        return _box_step(have, want, t, src, dst, axis_names, mesh_shape)

    cur_sbp = {t.name: in_sbp[t.name] for t in in_tensors}
    steps: List[Step] = []
    for op in ops:
        in_sigs = plan.op_in_sbp[op.name]
        raw_sig = plan.op_out_sbp[op.name]
        stored_sig = plan.tensor_sbp[op.output.name]
        ins = []
        for i, (t, want) in enumerate(zip(op.inputs, in_sigs)):
            st = box(cur_sbp[t.name], want, t, t.name,
                     f"{t.name}{INTERNAL}{op.name}.{i}")
            if st is not None:
                steps.append(st)
            ins.append(t.name if st is None else st.outs[0])
        out = op.output.name
        epilogue = box(raw_sig, stored_sig, op.output,
                       f"{out}{INTERNAL}raw", out)
        steps += _op_steps(op, tuple(ins),
                           out if epilogue is None else epilogue.ins[0],
                           in_sigs, axis_names, mesh_shape)
        if epilogue is not None:
            steps.append(epilogue)
        cur_sbp[out] = stored_sig
    # boundary boxing (e.g. P -> B materialization)
    out_keys = []
    for t in out_tensors:
        st = box(cur_sbp[t.name], out_sbp[t.name], t, t.name,
                 f"{t.name}{INTERNAL}out")
        if st is not None:
            steps.append(st)
        out_keys.append(t.name if st is None else st.outs[0])
    return LocalProgram(steps, tuple(t.name for t in in_tensors),
                        tuple(t.name for t in out_tensors), tuple(out_keys))


def _resolve_mesh(graph: LogicalGraph, mesh=None, device=None):
    """The mesh a lowering runs on: ``mesh`` as given (its placement must
    be the graph's), else every rank of the graph's placement on
    ``device`` (None: the card)."""
    if mesh is None:
        return graph.placement.to_mesh(device)
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh must be a DeviceMesh (placement.to_mesh()), "
                         f"got {type(mesh).__name__}")
    pl = graph.placement
    if (mesh.axis_names, mesh.shape) != (tuple(pl.axis_names),
                                         tuple(pl.axis_sizes)):
        raise ValueError(f"{mesh} does not match the graph's placement {pl}")
    if device is not None and any(d != torch.device(device)
                                  for d in mesh.devices):
        raise ValueError(f"device={device} contradicts {mesh}")
    return mesh


def _resolve_meshes(graph: LogicalGraph, num_stages: int, mesh=None,
                    stage_meshes: Optional[Sequence] = None, device=None):
    """One mesh per stage: ``stage_meshes`` (the paper's placement of each
    stage on its own ranks), or ``mesh`` (or the default one) shared."""
    if stage_meshes is None:
        return [_resolve_mesh(graph, mesh, device)] * num_stages
    if mesh is not None:
        raise ValueError("pass mesh= or stage_meshes=, not both")
    if len(stage_meshes) != num_stages:
        raise ValueError(f"need {num_stages} stage meshes, "
                         f"got {len(stage_meshes)}")
    return [_resolve_mesh(graph, m, device) for m in stage_meshes]


def relay(shards: Sequence[torch.Tensor], src: DeviceMesh,
          dst: DeviceMesh) -> List[torch.Tensor]:
    """Per-rank values moved from one stage's mesh onto the next one's,
    rank ``r`` to rank ``r`` (the explicit cross-stage send), as copies
    that ``dst`` owns; the values themselves where both stages share a
    mesh."""
    if src is dst:
        return list(shards)
    if src.shape != dst.shape:
        raise ValueError(f"cannot relay between {src} and {dst}")
    return [t.to(d, copy=True) for t, d in zip(shards, dst.devices)]


def run_ranks(mesh: DeviceMesh, fn: Callable, per_rank_args: Sequence,
              n_out: int) -> Tuple[List, ...]:
    """``fn`` once per rank of ``mesh`` over per-rank argument lists; its
    ``n_out`` results regrouped as one per-rank list each."""
    outs = spmd(fn, mesh)(*per_rank_args)
    return tuple([o[i] for o in outs] for i in range(n_out))


def sync_mesh(mesh: DeviceMesh) -> None:
    """Wait for the queued work of the mesh's cards (a no-op on the CPU)."""
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def lower_plan(graph: LogicalGraph, plan: Plan, mesh=None, *,
               device=None) -> "PhysicalProgram":
    """The whole graph as one program (the monolithic inference engine) on
    ``mesh`` (default: the graph's placement, every rank on ``device``)."""
    for t in graph.inputs:
        if plan.tensor_sbp[t.name].has_partial:
            raise ValueError(f"graph input {t.name} planned as partial-value")
    sinks = graph.sinks()
    for t in sinks:
        if plan.tensor_sbp[t.name].has_partial:
            raise ValueError(f"graph output {t.name} planned as partial-value; "
                             "planner should have boxed it")
    boundary = {t.name: plan.tensor_sbp[t.name]
                for t in list(graph.inputs) + sinks}
    program = _lower_subgraph(graph, plan, graph.topo_ops(), graph.inputs,
                              sinks, boundary, boundary)
    return PhysicalProgram(graph, plan, program, sinks,
                           _resolve_mesh(graph, mesh, device))


class PhysicalProgram:
    """Executable physical graph: the lowered program plus metadata.

    Calling it places the global inputs on the mesh by their planned
    signatures, runs the program on every rank without autograd, and
    returns a tuple of global sink values in ``self.sinks`` order (also for
    a single sink)."""

    def __init__(self, graph, plan, program: LocalProgram, sinks,
                 mesh: DeviceMesh):
        self.graph, self.plan = graph, plan
        self.program = program
        self.sinks = sinks
        self.mesh = mesh

    def __call__(self, *global_inputs) -> Tuple:
        sbp = self.plan.tensor_sbp
        with torch.inference_mode():
            args = [place(v, self.mesh, sbp[t.name])
                    for t, v in zip(self.graph.inputs, global_inputs)]
            outs = run_ranks(self.mesh, self.program, args, len(self.sinks))
            return tuple(assemble(o, self.mesh, sbp[t.name])
                         for o, t in zip(outs, self.sinks))


# ---------------------------------------------------------------------------
# Stage-partitioned lowering (paper §4.3): each pipeline stage becomes its
# own program; tensors crossing a stage boundary are stored partial-free.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageProgram:
    """One lowered pipeline stage: a callable plus its interface.

    ``fn(*values)`` takes one per-rank list per ``input_names`` entry
    (graph inputs and/or boundary tensors from earlier stages) and returns
    a tuple with one per-rank list per ``output_names`` entry (boundary
    tensors and/or sinks), running on ``mesh``; ``in_sbp`` holds each
    input's stored signature."""

    index: int
    fn: Callable
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    mesh: DeviceMesh
    in_sbp: Dict[str, NdSbp]

    def place(self, name: str, value) -> List[torch.Tensor]:
        """A global input value as this stage's per-rank shards."""
        return place(value, self.mesh, self.in_sbp[name])


def _stage_fn(program: LocalProgram, mesh: DeviceMesh) -> Callable:
    def fn(*values):
        return run_ranks(mesh, program, values, len(program.output_names))
    return fn


class StagedProgram:
    """A pipeline of stage programs. Sequential execution (``__call__``) is
    the reference semantics; :class:`repro_torch.runtime.pipeline
    .ActorPipelineExecutor` drives the same stage callables concurrently,
    one actor per stage, with register quotas bounding in-flight
    microbatches."""

    def __init__(self, graph: LogicalGraph, plan: Plan,
                 partition: StagePartition, stages: List[StageProgram],
                 sinks: List[LTensor], boundary_sbp: Dict[str, NdSbp]):
        self.graph, self.plan, self.partition = graph, plan, partition
        self.stages = stages
        self.sinks = sinks
        self.boundary_sbp = boundary_sbp

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def input_names(self) -> List[str]:
        return [t.name for t in self.graph.inputs]

    def __call__(self, *global_inputs) -> Tuple:
        if len(global_inputs) != len(self.graph.inputs):
            raise ValueError(f"expected {len(self.graph.inputs)} inputs, "
                             f"got {len(global_inputs)}")
        given = dict(zip(self.input_names, global_inputs))
        env: Dict[str, Tuple[List, DeviceMesh]] = {}
        with torch.inference_mode():
            for stage in self.stages:
                args = [stage.place(n, given[n]) if n in given
                        else relay(env[n][0], env[n][1], stage.mesh)
                        for n in stage.input_names]
                env.update((n, (o, stage.mesh)) for n, o in
                           zip(stage.output_names, stage.fn(*args)))
            return tuple(assemble(env[t.name][0], env[t.name][1],
                                  self.boundary_sbp[t.name])
                         for t in self.sinks)


@dataclasses.dataclass
class _StageInterface:
    """Boundary interface of one pipeline stage: which tensors enter and
    leave it, with their stored (partial-free) signatures."""

    ops: List[LOp]
    in_tensors: List[LTensor]
    out_tensors: List[LTensor]
    in_sbp: Dict[str, NdSbp]
    out_sbp: Dict[str, NdSbp]


def _stage_interfaces(graph: LogicalGraph, plan: Plan,
                      partition: StagePartition):
    """Every stage's boundary: ``(sinks, boundary_sbp, interfaces)``, shared
    by inference and training lowering. ``boundary_sbp`` maps each
    stage-crossing (or sink) tensor to its :func:`_materialized`
    signature: no partial value crosses a stage."""
    sinks = graph.sinks()
    sink_names = {t.name for t in sinks}
    producer_stage = {t.name: partition.stage_of[t.producer.name]
                      for t in graph.tensors if t.producer is not None}

    # tensors leaving each stage: consumed by a later stage, or graph sinks
    stage_out: Dict[int, List[LTensor]] = {
        s: [] for s in range(partition.num_stages)}
    boundary_sbp: Dict[str, NdSbp] = {}
    for op in graph.topo_ops():
        t = op.output
        ps = producer_stage[t.name]
        consumer_stages = {partition.stage_of[c.name]
                           for c in graph.consumers(t)}
        if any(cs > ps for cs in consumer_stages) or t.name in sink_names:
            stage_out[ps].append(t)
            boundary_sbp[t.name] = _materialized(plan.tensor_sbp[t.name])

    for t in graph.inputs:
        if plan.tensor_sbp[t.name].has_partial:
            raise ValueError(f"graph input {t.name} planned as partial-value")

    interfaces: List[_StageInterface] = []
    for s in range(partition.num_stages):
        ops = partition.ops_in(graph, s)
        in_here = {t.name for op in ops for t in op.inputs}
        produced_here = {op.output.name for op in ops}
        # stage inputs in deterministic order: graph inputs first, then
        # boundary tensors in production (topo) order
        in_tensors: List[LTensor] = [
            t for t in graph.inputs if t.name in in_here]
        in_tensors += [
            t for sp in range(s) for t in stage_out[sp]
            if t.name in in_here and t.name not in produced_here]
        in_sbp = {t.name: (plan.tensor_sbp[t.name] if t.producer is None
                           else boundary_sbp[t.name]) for t in in_tensors}
        out_tensors = stage_out[s]
        out_sbp = {t.name: boundary_sbp[t.name] for t in out_tensors}
        interfaces.append(_StageInterface(ops, in_tensors, out_tensors,
                                          in_sbp, out_sbp))
    return sinks, boundary_sbp, interfaces


def lower_stages(graph: LogicalGraph, plan: Plan, partition: StagePartition,
                 mesh=None, stage_meshes: Optional[Sequence] = None, *,
                 device=None) -> StagedProgram:
    """Lower each pipeline stage of ``partition`` independently.

    ``mesh`` lowers every stage onto the same ranks (stages share them;
    pipelining overlaps host work and microbatches); ``stage_meshes`` gives
    one mesh per stage, the same axes on other ranks (the paper's placement
    of one stage per device group), and boundary tensors are relayed onto
    the next stage's ranks. Default: every stage on the graph placement's
    ranks on ``device``."""
    meshes = _resolve_meshes(graph, partition.num_stages, mesh, stage_meshes,
                             device)
    sinks, boundary_sbp, interfaces = _stage_interfaces(graph, plan, partition)
    stages: List[StageProgram] = []
    for s, iface in enumerate(interfaces):
        program = _lower_subgraph(graph, plan, iface.ops, iface.in_tensors,
                                  iface.out_tensors, iface.in_sbp,
                                  iface.out_sbp)
        stages.append(StageProgram(
            index=s, fn=_stage_fn(program, meshes[s]),
            input_names=program.input_names,
            output_names=program.output_names, mesh=meshes[s],
            in_sbp=dict(iface.in_sbp)))
    return StagedProgram(graph, plan, partition, stages, sinks, boundary_sbp)


# ---------------------------------------------------------------------------
# Training lowering (paper §4.3 + the MPMD fwd/bwd decomposition). Each
# rank's forward of a stage records its steps on detached leaves (an
# OpTape per rank); the backward walks that tape in reverse on the rank's
# own thread: autograd for the local steps, the explicit transpose for the
# collective ones, so no autograd node ever waits at a rendezvous.
# Activations stay stage-local (inside the tapes the runtime stashes in the
# forward actor's out register) while cotangents flow backward across stage
# boundaries (the tape itself is repro_torch.core.tape). The runtime half
# lives in repro_torch.runtime.pipeline.
# ---------------------------------------------------------------------------

@torch.no_grad()
def sgd_update(w: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """Plain SGD on one tensor, in place: float32 math, the result cast
    back to the param's dtype. One function for the pipelined and the
    monolithic step, so both apply a bit-identical update."""
    w.copy_((w.float() - lr * g.float()).to(w.dtype))
    return w


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Mixed-precision policy for a training session (paper Fig 14, §6.4).

    ``compute_dtype`` is what forward and backward see: params are cast at
    the forward stage's boundary (the Fig-14 ``cast`` op, once per step, so
    a sharded master crosses the wire at compute width), while the
    optimizer keeps float32 *masters* and float32 moments. ``loss_scale``
    is ``None`` (off), a static float (the backward seed is ``scale``
    instead of ones; the accumulated grads are unscaled by ``1/scale``
    before the norm), or ``"dynamic"``: start at ``init_scale``, multiply
    by ``backoff_factor`` and skip the update when the grad norm goes
    non-finite, multiply by ``growth_factor`` after ``growth_interval``
    consecutive finite steps. Masters are always float32: every bf16 value
    is exactly a float32 one, so bf16 compute round-trips losslessly."""

    compute_dtype: str = "bfloat16"       # "float32" | "bfloat16"
    loss_scale: Any = None                # None | float | "dynamic"
    init_scale: float = 2.0 ** 15         # dynamic mode's starting scale
    growth_interval: int = 2000           # finite steps before scale grows
    growth_factor: float = 2.0
    backoff_factor: float = 0.5

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unsupported compute_dtype {self.compute_dtype!r} "
                "(use 'float32' or 'bfloat16')")
        ls = self.loss_scale
        if ls is not None and ls != "dynamic":
            if not isinstance(ls, (int, float)) or float(ls) <= 0:
                raise ValueError(
                    f"loss_scale must be None, a positive number, or "
                    f"'dynamic'; got {ls!r}")
        if self.growth_interval < 1:
            raise ValueError("growth_interval must be >= 1")


def loss_scale_update(policy: PrecisionPolicy, scale: float, good_steps: int,
                      grads_finite: bool) -> Tuple[bool, float, int]:
    """One dynamic-loss-scale transition: ``(skip, next_scale, next_good)``.
    Shared by the pipelined ``scale`` actor and the monolithic engine, so
    the scale trajectories and the skips are the same on every backend."""
    if not grads_finite:
        return True, float(scale) * float(policy.backoff_factor), 0
    good = int(good_steps) + 1
    if good >= int(policy.growth_interval):
        return False, float(scale) * float(policy.growth_factor), 0
    return False, float(scale), good


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Pluggable optimizer for staged training programs (SGD or AdamW).

    ``lr`` is a float or a step-indexed callable ``lr(step) -> float``
    (``step`` counts optimizer steps from 0). ``grad_clip`` > 0 enables
    *global*-norm clipping: the pipeline wires a ``norm`` actor that sums
    per-stage squared-norm partials (P->B boxing expressed as an actor) and
    broadcasts the clip scale to every ``opt{s}``. AdamW carries an
    :class:`repro_torch.optim.adamw.AdamWState` per stage and rank -- the
    second register stream.

    ``zero=True`` (AdamW only) keeps that stream ZeRO-style (paper §6.4):
    flat ``(dp, 1, chunk)`` float32 master and moment shards
    (:mod:`repro_torch.optim.zero`) instead of dense params and an
    ``AdamWState``, and :meth:`update` takes masters in that layout.
    ``zero_dp`` is the data-axis fold, ``zero_shapes`` the params' global
    shapes (``api.compile`` records both). ``precision`` adds a
    :class:`PrecisionPolicy`: bf16 compute params cast from float32
    masters each step, with optional loss scaling.

    The update runs in place: the params (or masters) and moments handed to
    :meth:`update` are the ones it returns, updated.
    """

    kind: str = "sgd"                     # "sgd" | "adamw"
    lr: Any = 1e-2                        # float or fn(step) -> float
    beta1: float = 0.9                    # adamw only below
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 0.0                # 0 disables global-norm clipping
    zero: bool = False                    # ZeRO-shard masters + moments
    zero_dp: int = 1                      # data-axis fold of the flat shards
    zero_shapes: Any = None               # ((name, shape), ...) for gathers
    precision: Optional[PrecisionPolicy] = None

    def __post_init__(self):
        if self.kind not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer kind {self.kind!r}")
        if self.zero and self.kind != "adamw":
            raise ValueError(
                "zero=True shards AdamW state; it requires kind='adamw'")
        if self.zero and self.zero_dp < 1:
            raise ValueError(f"zero_dp must be >= 1, got {self.zero_dp}")
        if self.precision is not None and not isinstance(self.precision,
                                                         PrecisionPolicy):
            raise ValueError("precision must be a PrecisionPolicy")
        if (self.precision is not None
                and self.precision.loss_scale is not None
                and self.precision.compute_dtype == "float32"):
            raise ValueError(
                "loss_scale requires compute_dtype='bfloat16' (float32 "
                "compute has nothing to rescue from underflow)")

    @classmethod
    def sgd(cls, lr: Any = 1e-2, grad_clip: float = 0.0) -> "OptimizerSpec":
        return cls(kind="sgd", lr=lr, grad_clip=grad_clip)

    @classmethod
    def adamw(cls, lr: Any = 3e-4, beta1: float = 0.9, beta2: float = 0.95,
              eps: float = 1e-8, weight_decay: float = 0.1,
              grad_clip: float = 1.0) -> "OptimizerSpec":
        return cls(kind="adamw", lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                   weight_decay=weight_decay, grad_clip=grad_clip)

    @property
    def stateful(self) -> bool:
        return self.kind == "adamw"

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    # -- mixed precision and ZeRO -------------------------------------------

    @property
    def mixed_precision(self) -> bool:
        """True when the optimizer holds explicit float32 masters (a
        precision policy is set, or ZeRO is on)."""
        return self.precision is not None or self.zero

    @property
    def compute_dtype(self) -> Optional[str]:
        """The dtype forward and backward see params in, or None to keep
        the params' own dtype (no masters)."""
        if self.precision is not None:
            return self.precision.compute_dtype
        return "float32" if self.zero else None

    @property
    def loss_scaling(self) -> Any:
        """None (off), a static float, or ``"dynamic"``."""
        return None if self.precision is None else self.precision.loss_scale

    @property
    def dynamic_scaling(self) -> bool:
        return self.loss_scaling == "dynamic"

    def initial_scale(self) -> float:
        ls = self.loss_scaling
        if ls is None:
            return 1.0
        if ls == "dynamic":
            return float(self.precision.init_scale)
        return float(ls)

    @property
    def zero_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        """Param name -> its global shape, for gathering flat shards."""
        if self.zero_shapes is None:
            raise ValueError(
                "OptimizerSpec.zero_shapes is unset; api.compile records the "
                "param shapes when zero=True")
        items = (self.zero_shapes.items()
                 if isinstance(self.zero_shapes, dict) else self.zero_shapes)
        return {n: tuple(int(d) for d in s) for n, s in items}

    def shard_masters(self, params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Full params -> flat float32 ``(dp, 1, chunk)`` master shards."""
        return {n: shard_flat(v, dp=self.zero_dp) for n, v in params.items()}

    def gather_params(self, masters: Dict[str, torch.Tensor],
                      dtype: str = "float32",
                      shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                      ) -> Dict[str, torch.Tensor]:
        """Flat master shards -> full params in ``dtype`` (the Fig-14 cast
        before the reshape-gather, so a bf16 gather moves half the bytes
        of a float32 one; in float32 views of the masters)."""
        shapes = self.zero_shape_map if shapes is None else shapes
        return {n: gather_flat(m, shape=shapes[n], dtype=dtype)
                for n, m in masters.items()}

    def master_of(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 master of a float32 param (a rank's shard): its
        flat shards under ZeRO, the param itself otherwise (the update
        writes into it)."""
        return shard_flat(x, dp=self.zero_dp) if self.zero else x

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the compute dtype: the Fig-14 ``cast`` op (``x`` itself
        where it has that dtype)."""
        return x.to(getattr(torch, self.compute_dtype))

    def compute_param(self, master: torch.Tensor,
                      shape: Tuple[int, ...]) -> torch.Tensor:
        """What forward and backward see of a master: cast to the compute
        dtype, then gathered to ``shape`` under ZeRO (a view of the master
        where the compute dtype is float32)."""
        if self.zero:
            return gather_flat(master, shape=shape, dtype=self.compute_dtype)
        return self.cast(master)

    def init_state(self, params: Dict[str, torch.Tensor]):
        """Fresh optimizer state for ``params`` (None for stateless SGD).
        With ``zero=True`` ``params`` are the flat master shards and the
        state a flat :class:`repro_torch.optim.zero.ZeroState`."""
        if self.kind == "sgd":
            return None
        if self.zero:
            return init_zero_flat(dict(params))
        return init_adamw(dict(params))

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state, lr_now: float):
        """Apply one optimizer step to ``params`` (in place; the flat
        masters under ZeRO) given already-clipped float32 full-shape
        ``grads``; returns ``(params, new_state)``.

        Per-tensor math is :func:`sgd_update` / :func:`repro_torch.optim
        .adamw.adamw_param_update`, so updating per-stage subsets (the opt
        actors) or the whole dict (the monolithic engine) gives the same
        values tensor by tensor, and so does the flat layout."""
        if self.kind == "sgd":
            for n in params:
                sgd_update(params[n], grads[n], lr_now)
            return params, None
        if state is None:
            state = self.init_state(params)
        if self.zero:
            return params, zero_stage_update(
                params, grads, state, lr_now, dp=self.zero_dp,
                beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                weight_decay=self.weight_decay)
        new_step = state.step + 1
        for n in params:
            adamw_param_update(params[n], grads[n], state.mu[n], state.nu[n],
                               new_step, lr_now, beta1=self.beta1,
                               beta2=self.beta2, eps=self.eps,
                               weight_decay=self.weight_decay)
        return params, AdamWState(new_step, state.mu, state.nu)

    def init_rank_states(self, shards: Dict[str, Sequence[torch.Tensor]],
                         nranks: int) -> Optional[List]:
        """One fresh state per rank over its (full-shape) shards of
        ``shards``: zeroed moments in the flat layout under ZeRO, None for
        a stateless optimizer."""
        if not self.stateful:
            return None
        if self.zero:
            return [init_zero_flat({n: flat_zeros(v[r], self.zero_dp)
                                    for n, v in shards.items()})
                    for r in range(nranks)]
        return [self.init_state({n: v[r] for n, v in shards.items()})
                for r in range(nranks)]

    def update_ranks(self, shards: Dict[str, List[torch.Tensor]],
                     grads: Dict[str, List[torch.Tensor]],
                     states: Optional[List], lr_now: float,
                     nranks: int) -> Optional[List]:
        """:meth:`update` on every rank's shards (or flat masters), in
        place; returns the new per-rank states. Replicas of a broadcast
        param see the same gradient bits, so they stay bitwise equal."""
        new_states = []
        for r in range(nranks):
            _, st = self.update({n: v[r] for n, v in shards.items()},
                                {n: grads[n][r] for n in shards},
                                None if states is None else states[r],
                                lr_now)
            new_states.append(st)
        return new_states if self.stateful else None

    def dense_state(self, state, shapes: Dict[str, Tuple[int, ...]]):
        """A flat :class:`~repro_torch.optim.zero.ZeroState` gathered to
        full float32 moments of ``shapes`` (an ``AdamWState``); any other
        state as it is."""
        if not isinstance(state, ZeroState):
            return state
        return AdamWState(state.step,
                          self.gather_params(state.mu, shapes=shapes),
                          self.gather_params(state.nu, shapes=shapes))

    def split_state(self, state, stage_param_names: Dict[int, Sequence[str]]):
        """Split a merged optimizer state (always full moments, an
        ``AdamWState``) into per-stage states keyed by stage index
        (``stage_param_names``: stage -> its param names), sharded flat at
        this spec's dp fold under ZeRO; stateless optimizers split to None
        entries."""
        if not self.stateful or state is None:
            return {s: None for s in stage_param_names}
        out = {}
        for s, names in stage_param_names.items():
            missing = [n for n in names if n not in state.mu]
            if missing:
                raise ValueError(
                    f"optimizer state missing moments for params {missing}")
            mu = {n: state.mu[n] for n in names}
            nu = {n: state.nu[n] for n in names}
            out[s] = (ZeroState(state.step, self.shard_masters(mu),
                                self.shard_masters(nu)) if self.zero
                      else AdamWState(state.step, mu, nu))
        return out

    def merge_states(self, states: Sequence[Any]):
        """Inverse of :meth:`split_state`: one ``AdamWState`` over all
        params, flat ZeRO states gathered to full moments by
        :attr:`zero_shape_map`, so the merged form is partition- and
        ZeRO-agnostic (None for a stateless optimizer)."""
        if not self.stateful:
            return None
        states = [s for s in states if s is not None]
        if not states:
            return None
        if self.zero:
            states = [self.dense_state(st, self.zero_shape_map)
                      for st in states]
        mu: Dict[str, torch.Tensor] = {}
        nu: Dict[str, torch.Tensor] = {}
        for st in states:
            mu.update(st.mu)
            nu.update(st.nu)
        return AdamWState(states[0].step, mu, nu)


def global_state(states: Optional[Sequence], mesh: DeviceMesh,
                 sbp: Dict[str, NdSbp]):
    """Per-rank optimizer states as one state over global tensors (each
    moment assembled by its param's signature); the state itself on a
    one-rank mesh."""
    if states is None:
        return None
    if mesh.size == 1:
        return states[0]
    first = states[0]
    return AdamWState(
        first.step,
        {n: assemble([st.mu[n] for st in states], mesh, sbp[n])
         for n in first.mu},
        {n: assemble([st.nu[n] for st in states], mesh, sbp[n])
         for n in first.nu})


def rank_states(opt: OptimizerSpec, state,
                shards: Dict[str, List[torch.Tensor]], mesh: DeviceMesh,
                sbp: Dict[str, NdSbp]) -> List:
    """A merged optimizer state over global moments (tensors or numpy
    arrays, e.g. from :func:`repro_torch.runtime.snapshot.load_snapshot`)
    cut into one state per rank over the params in ``shards``: each moment
    placed by its param's signature as an owned float32 copy on its rank's
    device (the optimizer updates it in place; the caller's arrays are
    never written), and under ZeRO laid flat ``(dp, 1, chunk)`` as
    :meth:`OptimizerSpec.init_rank_states` lays its zeros."""
    def owned(x, name):
        x = torch.as_tensor(x).detach()
        if mesh.size == 1:
            return [torch.empty(tuple(x.shape), dtype=torch.float32,
                                device=mesh.devices[0]).copy_(x)]
        return [p.float() for p in place(x.float(), mesh, sbp[name])]

    def flat(x):
        return shard_flat(x, dp=opt.zero_dp) if opt.zero else x

    kind = ZeroState if opt.zero else AdamWState
    step = int(state.step)
    mu = {n: owned(state.mu[n], n) for n in shards}
    nu = {n: owned(state.nu[n], n) for n in shards}
    return [kind(torch.tensor(step, dtype=torch.int32, device=dev),
                 {n: flat(v[r]) for n, v in mu.items()},
                 {n: flat(v[r]) for n, v in nu.items()})
            for r, dev in enumerate(mesh.devices)]


def rank_masters(opt: OptimizerSpec, shards: Dict[str, List[torch.Tensor]]):
    """The float32 masters of per-rank float32 param ``shards``, which the
    optimizer updates in place (:meth:`OptimizerSpec.master_of`), and the
    params as float32 views of them (the shards themselves without ZeRO):
    ``(masters, params)``."""
    masters = {n: [opt.master_of(x) for x in v] for n, v in shards.items()}
    if not opt.zero:
        return masters, dict(shards)
    return masters, {n: [gather_flat(m, shape=x.shape)
                         for m, x in zip(masters[n], v)]
                     for n, v in shards.items()}


def rank_compute(opt: OptimizerSpec, masters: Dict[str, List[torch.Tensor]],
                 params: Dict[str, List[torch.Tensor]]
                 ) -> Dict[str, List[torch.Tensor]]:
    """Each rank's compute-dtype copy of each master, shaped as its param
    in ``params`` (Fig 14's cast, then the gather under ZeRO)."""
    return {n: [opt.compute_param(m, tuple(p.shape))
                for m, p in zip(ms, params[n])]
            for n, ms in masters.items()}


def rank_opt_state(opt: OptimizerSpec, states: Optional[Sequence],
                   mesh: DeviceMesh, sbp: Dict[str, NdSbp],
                   shards: Dict[str, List[torch.Tensor]]):
    """One stage's per-rank optimizer states as one state over global
    moments: flat ZeRO states first gathered to each rank's shard shapes
    (those of ``shards``)."""
    if states is None:
        return None
    states = [opt.dense_state(st, {n: tuple(shards[n][r].shape)
                                   for n in st.mu})
              for r, st in enumerate(states)]
    return global_state(states, mesh, sbp)


def opt_state_bytes(opt: OptimizerSpec, states: Optional[Sequence],
                    shards: Dict[str, List[torch.Tensor]], nranks: int) -> int:
    """The optimizer-held float32 bytes of one stage on its fullest rank,
    over the ZeRO fold: the moments, plus with masters (mixed precision
    or ZeRO) each param's master padded to the fold -- 3x the float32
    param bytes (over dp under ZeRO), 2x for plain AdamW (whose params are
    the model, not optimizer state)."""
    zdp = opt.zero_dp if opt.zero else 1
    per_rank = []
    for r in range(nranks):
        total = 0
        st = None if states is None else states[r]
        if st is not None:
            total += sum(v.numel() * v.element_size()
                         for tree in (st.mu, st.nu) for v in tree.values())
        if opt.mixed_precision:
            for v in shards.values():
                nelem = v[r].numel()
                total += -(-nelem // zdp) * zdp * 4
        per_rank.append(total // zdp)
    return max(per_rank)


def accumulate(acc: Optional[List[torch.Tensor]],
               g: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Add one microbatch's per-rank gradient into the float32 sums, in
    place; the first one becomes owned float32 copies. The acc actors and
    the monolithic engine sum this way, in microbatch order."""
    if acc is None:
        return [x.to(torch.float32, copy=True) for x in g]
    for a, x in zip(acc, g):
        a.add_(x.float())
    return acc


def box_grads(mesh: DeviceMesh, graph: LogicalGraph, plan: Plan,
              grads: Dict[str, List[torch.Tensor]]
              ) -> Dict[str, List[torch.Tensor]]:
    """Per-rank gradient sums moved from their cotangent layout to their
    params' signatures: a broadcast param's partial sums are all-reduced
    (P -> B), a split one's shards stay."""
    axis_names = tuple(graph.placement.axis_names)
    shape = {t.name: t.shape for t in graph.inputs}
    fns = {}
    for n in grads:
        sig = plan.tensor_sbp[n]
        cot = cotangent_sbp(sig)
        if not boxing_is_identity(cot, sig, mesh.shape):
            fns[n] = boxing_fn(cot, sig, axis_names, mesh.shape, shape[n])
    if not fns:
        return grads
    names = list(fns)
    boxed = run_ranks(mesh, lambda *gs: tuple(fns[n](g) for n, g in
                                              zip(names, gs)),
                      [grads[n] for n in names], len(names))
    return {**grads, **dict(zip(names, boxed))}


def grad_sqnorms(mesh: DeviceMesh, plan: Plan,
                 grads: Dict[str, List[torch.Tensor]]) -> Dict[str, Any]:
    """Each param's squared gradient norm over its distinct shards (a
    broadcast param counted once), the P contribution to the global norm."""
    return sqnorm_partials_sharded(
        grads, {n: mesh.distinct_ranks(plan.tensor_sbp[n]) for n in grads})


def clip_grads(grads: Dict[str, List[torch.Tensor]], order: Sequence[str],
               grad_clip: float, mesh: DeviceMesh, plan: Plan):
    """Global-norm clipping as the pipeline does it: per-param partials,
    summed in ``order`` on the host, one scale for every shard. Returns
    ``(clipped grads, pre-clip norm)``."""
    norm = global_norm_from_partials(grad_sqnorms(mesh, plan, grads), order)
    scale = clip_scale(norm, grad_clip)
    return {n: [scale_grad(g, scale) for g in gs]
            for n, gs in grads.items()}, norm


def split_microbatches(inputs: Dict[str, Any],
                       microbatch_names: Sequence[str],
                       num_microbatches: int) -> List[Dict[str, Any]]:
    """Split each named input into ``num_microbatches`` equal chunks along
    axis 0 -- one payload dict per microbatch, in version order. Both the
    actor pipeline and the monolithic engine chunk with this one helper.
    Tensors split into views; numpy arrays become tensors first."""
    for n in microbatch_names:
        if inputs[n].shape[0] % num_microbatches:
            raise ValueError(
                f"input {n} axis 0 ({inputs[n].shape[0]}) not divisible by "
                f"num_microbatches={num_microbatches}")
    payloads: List[Dict[str, Any]] = [dict() for _ in range(num_microbatches)]
    for n in microbatch_names:
        chunks = torch.chunk(torch.as_tensor(inputs[n]), num_microbatches,
                             dim=0)
        for k, chunk in enumerate(chunks):
            payloads[k][n] = chunk
    return payloads


def reassemble_sinks(graph: LogicalGraph, sinks: Sequence[LTensor],
                     microbatch_inputs: Sequence[str],
                     per_chunk: Sequence[Dict[str, Any]]) -> Tuple:
    """Reassemble graph sinks from per-microbatch results (the inverse of
    :func:`split_microbatches`): sinks downstream of a microbatched input
    are concatenated along axis 0, anything else (a weights-only sink) is
    the same every chunk and taken once. Shared by both backends."""
    mb_dependent = graph.downstream_of(microbatch_inputs)
    results = []
    for t in sinks:
        if t.name in mb_dependent:
            results.append(torch.cat([d[t.name] for d in per_chunk], dim=0))
        else:
            results.append(per_chunk[0][t.name])
    return tuple(results)


def _resolve_loss(graph: LogicalGraph, loss) -> LTensor:
    sinks = graph.sinks()
    if loss is None:
        if len(sinks) != 1:
            raise ValueError(
                f"graph has {len(sinks)} sinks "
                f"({[t.name for t in sinks]}); pass loss= explicitly")
        return sinks[0]
    name = loss.name if isinstance(loss, LTensor) else loss
    for t in sinks:
        if t.name == name:
            return t
    raise ValueError(f"loss {name!r} is not a graph sink "
                     f"(sinks: {[t.name for t in sinks]})")


def _resolve_params(graph: LogicalGraph, params) -> List[LTensor]:
    by_name = {t.name: t for t in graph.inputs}
    out = []
    for p in params:
        name = p.name if isinstance(p, LTensor) else p
        if name not in by_name:
            raise ValueError(f"param {name!r} is not a graph input")
        t = by_name[name]
        if t.dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"param {name!r} has non-float dtype {t.dtype}")
        out.append(t)
    return out


def loss_seed(mesh: DeviceMesh, sbp: NdSbp, loss: Sequence[torch.Tensor],
              value: Optional[float] = None) -> List[torch.Tensor]:
    """The per-rank backward seed of a loss laid out as ``sbp``: ones (the
    objective is the *sum* of the loss tensor), in the cotangent layout --
    on a broadcast axis only the rank at index 0 seeds it (B -> P(sum)),
    so replicas are not counted once each. ``value`` seeds that constant
    instead of 1: the loss scale, which multiplies every cotangent by it
    and keeps bf16 gradients out of the underflow range."""
    out = []
    for r, v in enumerate(loss):
        first = all(c == 0 for c, comp in zip(mesh.coords(r), sbp)
                    if comp.is_broadcast)
        out.append(torch.zeros_like(v) if not first
                   else torch.ones_like(v) if value is None
                   else torch.full_like(v, value))
    return out


@dataclasses.dataclass
class TrainStageProgram:
    """One pipeline stage of a training graph: forward, backward, interface.

    ``fwd(*values)`` takes one per-rank list per ``input_names`` entry and
    returns ``(outputs, tapes)``: the stage outputs (one per-rank list per
    ``output_names``) and one :class:`OpTape` per rank holding the
    stage-local activations, which the actor runtime stashes in the
    forward actor's out register so they are released exactly when the
    backward actor acks.

    ``bwd(tapes, cotangents)`` takes those tapes and the seeds of
    :meth:`output_cotangents`, and returns one per-rank list per
    ``diff_input_names`` entry, in its cotangent layout: gradients for
    this stage's params, cotangents for boundary activations from earlier
    stages (``None`` where nothing flowed). ``bwd`` is None for a stage
    with no differentiable inputs."""

    index: int
    fwd: Callable
    bwd: Optional[Callable]
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    diff_input_names: Tuple[str, ...]
    param_names: Tuple[str, ...]
    mesh: DeviceMesh
    in_sbp: Dict[str, NdSbp]
    out_sbp: Dict[str, NdSbp]

    def place(self, name: str, value) -> List[torch.Tensor]:
        """A global input value as this stage's per-rank shards."""
        return place(value, self.mesh, self.in_sbp[name])

    def output_cotangents(self, outputs: Dict[str, Any],
                          cotangents: Dict[str, Any], loss_name: str,
                          scale: Optional[float] = None
                          ) -> Dict[str, List[torch.Tensor]]:
        """The backward seeds of this stage: ones for the loss sink (see
        :func:`loss_seed`; ``scale`` instead where loss scaling is on), the
        incoming cotangent for every output consumed downstream, and for
        every boundary input that later stages also consume -- its sum so
        far, which this stage's own contributions then extend."""
        seeds = {}
        for name in self.output_names:
            if name == loss_name:
                seeds[name] = loss_seed(self.mesh, self.out_sbp[name],
                                        outputs[name], scale)
            elif cotangents.get(name) is not None:
                seeds[name] = cotangents[name]
        for name in self.diff_input_names:
            if (name not in self.param_names
                    and cotangents.get(name) is not None):
                seeds[name] = cotangents[name]
        return seeds


class TrainStagedProgram:
    """A training graph cut into forward / backward programs per stage, with
    the pluggable :class:`OptimizerSpec` (None means the executor's default
    SGD). :meth:`reference_step` is the sequential reference semantics; the
    concurrent actor-driven execution (1F1B from register quotas) lives in
    :class:`repro_torch.runtime.pipeline.TrainPipelineExecutor`."""

    def __init__(self, graph: LogicalGraph, plan: Plan,
                 partition: StagePartition, stages: List[TrainStageProgram],
                 loss: LTensor, param_names: Tuple[str, ...],
                 boundary_sbp: Dict[str, NdSbp],
                 optimizer: Optional[OptimizerSpec] = None):
        self.graph, self.plan, self.partition = graph, plan, partition
        self.stages = stages
        self.loss = loss
        self.param_names = param_names
        self.boundary_sbp = boundary_sbp
        self.opt_update = sgd_update
        self.optimizer = optimizer

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def loss_name(self) -> str:
        return self.loss.name

    @property
    def input_names(self) -> List[str]:
        return [t.name for t in self.graph.inputs]

    def stage_of_param(self, name: str) -> int:
        for st in self.stages:
            if name in st.param_names:
                return st.index
        raise KeyError(name)

    def reference_step(self, inputs: Dict[str, Any],
                       microbatch_inputs: Sequence[str],
                       num_microbatches: int, lr: float = 1e-2,
                       optimizer: Optional[OptimizerSpec] = None,
                       opt_state=None, step_index: Optional[int] = None):
        """Sequential (non-actor) execution of one training step.

        Runs every microbatch through all forward stages, then all backward
        stages, accumulating gradients in float32 per rank in microbatch
        order, and applies the optimizer to copies of the params (``inputs``
        stays as it was). Returns ``(loss, grads, new_params)``, or with an
        optimizer in play (``optimizer=`` or the program's) ``(loss, grads,
        new_params, new_state)`` with ``grads`` post-clip, all global. The
        lr schedule resolves at ``step_index`` (default: ``opt_state.step``
        when stateful, else 0)."""
        opt = optimizer if optimizer is not None else self.optimizer
        if opt is not None and (opt.zero or opt.precision is not None):
            raise NotImplementedError(
                "reference_step does not model zero/mixed precision; compare "
                "against the api.compile monolithic backend instead")
        by_stage = {st.index: st for st in self.stages}
        home = {n: by_stage[self.stage_of_param(n)] for n in self.param_names}
        chunks = split_microbatches(inputs, microbatch_inputs,
                                    num_microbatches)
        mb_names = set(microbatch_inputs)
        loss_total = None
        grads: Dict[str, List[torch.Tensor]] = {}
        for chunk in chunks:
            env: Dict[str, Tuple[List, DeviceMesh]] = {}
            tapes = {}
            for st in self.stages:
                args = [relay(*env[n], st.mesh) if n in env
                        else st.place(n, chunk[n] if n in mb_names
                                      else inputs[n])
                        for n in st.input_names]
                outs, tape = st.fwd(*args)
                env.update((n, (o, st.mesh))
                           for n, o in zip(st.output_names, outs))
                tapes[st.index] = tape
            cots: Dict[str, Tuple[List, DeviceMesh]] = {}
            for st in reversed(self.stages):
                if st.bwd is None:
                    continue
                outputs = {n: env[n][0] for n in st.output_names}
                seeds = st.output_cotangents(
                    outputs, {n: relay(*c, st.mesh) for n, c in cots.items()},
                    self.loss_name)
                in_cots = st.bwd(tapes[st.index], seeds)
                for name, c in zip(st.diff_input_names, in_cots):
                    if c is None:
                        continue
                    if name in st.param_names:
                        grads[name] = accumulate(grads.get(name), c)
                    else:
                        cots[name] = (c, st.mesh)
            loss_shards, loss_mesh = env[self.loss_name]
            ls = torch.sum(assemble(loss_shards, loss_mesh,
                                    self.boundary_sbp[self.loss_name]))
            loss_total = ls if loss_total is None else loss_total + ls
        grads = {n: box_grads(home[n].mesh, self.graph, self.plan,
                              {n: grads[n]})[n] for n in self.param_names}
        params = {n: home[n].place(n, torch.as_tensor(inputs[n]).clone())
                  for n in self.param_names}

        def to_global(d):
            return {n: assemble(v, home[n].mesh, self.plan.tensor_sbp[n])
                    for n, v in d.items()}
        if opt is None:
            for n in self.param_names:
                for w, g in zip(params[n], grads[n]):
                    self.opt_update(w, g, lr)
            return loss_total, to_global(grads), to_global(params)
        if opt.grad_clip:
            partials = {}
            for st in self.stages:
                partials.update(grad_sqnorms(
                    st.mesh, self.plan,
                    {n: grads[n] for n in st.param_names}))
            scale = clip_scale(global_norm_from_partials(
                partials, self.param_names), opt.grad_clip)
            grads = {n: [scale_grad(g, scale) for g in gs]
                     for n, gs in grads.items()}
        if step_index is None:
            step_index = int(opt_state.step) if opt_state is not None else 0
        new_states = []
        for st in self.stages:
            if not st.param_names:
                continue
            mine = {n: params[n] for n in st.param_names}
            if opt_state is None or not opt.stateful:
                states = opt.init_rank_states(mine, st.mesh.size)
            else:
                states = rank_states(opt, opt_state, mine, st.mesh,
                                     self.plan.tensor_sbp)
            states = opt.update_ranks(
                mine, {n: grads[n] for n in st.param_names}, states,
                opt.lr_at(step_index), st.mesh.size)
            new_states.append(global_state(states, st.mesh,
                                           self.plan.tensor_sbp))
        return (loss_total, to_global(grads), to_global(params),
                opt.merge_states(new_states))


def _diff_names(graph: LogicalGraph, loss_t: LTensor,
                param_names: set) -> set:
    """Tensors that carry a cotangent: downstream of a param and upstream
    of the loss."""
    return graph.downstream_of(param_names) & graph.ancestors(loss_t)


def _train_program(program: LocalProgram, diff: set, mesh: DeviceMesh):
    """(fwd, bwd) over one lowered program on ``mesh``: per rank, the taped
    forward and its reverse, the cotangents wanted being those of the
    differentiable inputs."""
    diff_in = tuple(n for n in program.input_names if n in diff)
    n_out = len(program.output_names)
    if not diff_in:
        def fwd_nodiff(*ins):
            with torch.no_grad():
                return run_ranks(mesh, program, ins, n_out), None
        return fwd_nodiff, None, diff_in
    key = dict(zip(program.output_names, program.out_keys))

    def fwd(*ins):
        outs = spmd(lambda *v: taped_forward(program, diff, v), mesh)(*ins)
        return (tuple([o[0][i] for o in outs] for i in range(n_out)),
                [o[1] for o in outs])

    def bwd(tapes, cotangents):
        names = list(cotangents)

        def rank_bwd(tape, *cots):
            return taped_backward(
                tape, {key.get(n, n): c for n, c in zip(names, cots)},
                diff_in)
        per_rank = spmd(rank_bwd, mesh)(tapes, *[cotangents[n]
                                                  for n in names])
        return tuple(None if all(p[i] is None for p in per_rank)
                     else [p[i] for p in per_rank]
                     for i in range(len(diff_in)))
    return fwd, bwd, diff_in


def lower_train_plan(graph: LogicalGraph, plan: Plan, params, loss=None,
                     mesh=None, *, device=None) -> Callable:
    """Monolithic training program -- the reference the pipeline is checked
    against. Returns ``fn(*graph_input_shards) -> (loss_vec, grads)``,
    every argument and result a per-rank list on the mesh: ``loss_vec`` is
    the (unreduced) loss sink and ``grads`` holds ``d(sum(loss_vec))/
    d(param)`` for each param, in ``params`` order and in its cotangent
    layout (:func:`box_grads` takes it to the param's). It runs the same
    taped forward and backward as the pipelined stages over the whole
    graph, seeded by :func:`loss_seed` (``fn(*shards, scale=s)`` seeds the
    loss scale ``s``, as the pipelined loss stage does). ``fn.mesh`` is its
    mesh."""
    mesh = _resolve_mesh(graph, mesh, device)
    loss_t = _resolve_loss(graph, loss)
    param_ts = _resolve_params(graph, params)
    sinks = graph.sinks()
    for t in sinks:
        if plan.tensor_sbp[t.name].has_partial:
            raise ValueError(f"graph output {t.name} planned as partial-value")
    boundary = {t.name: plan.tensor_sbp[t.name]
                for t in list(graph.inputs) + sinks}
    program = _lower_subgraph(graph, plan, graph.topo_ops(), graph.inputs,
                              sinks, boundary, boundary)
    pnames = [p.name for p in param_ts]
    diff = _diff_names(graph, loss_t, set(pnames))
    fwd, bwd, diff_in = _train_program(program, diff, mesh)
    loss_pos = [t.name for t in sinks].index(loss_t.name)

    def value_and_grad(*all_ins, scale: Optional[float] = None):
        outs, tapes = fwd(*all_ins)
        loss_vec = outs[loss_pos]
        env = dict(zip(program.input_names, all_ins))
        cots = dict(zip(diff_in, bwd(tapes, {loss_t.name: loss_seed(
            mesh, boundary[loss_t.name], loss_vec, scale)})))
        return loss_vec, tuple(
            cots[n] if cots.get(n) is not None
            else [torch.zeros_like(v) for v in env[n]] for n in pnames)
    value_and_grad.mesh = mesh
    return value_and_grad


def lower_train_stages(graph: LogicalGraph, plan: Plan,
                       partition: StagePartition, params, loss=None,
                       mesh=None, stage_meshes: Optional[Sequence] = None, *,
                       device=None,
                       optimizer: Optional[OptimizerSpec] = None
                       ) -> TrainStagedProgram:
    """Cut a training graph into forward / backward programs per stage.

    Builds on :func:`lower_stages`' partition: each stage's program is run
    taped over its *differentiable* inputs -- the stage-local params plus
    any boundary activations derived from params. Activations stay in the
    stage's tapes; only cotangents cross stage boundaries, flowing backward
    along the seams the activations flowed forward.

    ``params`` names the graph inputs to train; each must be consumed by
    ops of exactly one stage. ``loss`` names the graph sink to
    differentiate (default: the sole sink). ``mesh`` / ``stage_meshes`` as
    in :func:`lower_stages`. ``optimizer`` is carried on the program (the
    executor falls back to plain SGD when absent)."""
    loss_t = _resolve_loss(graph, loss)
    param_ts = _resolve_params(graph, params)
    param_names = {t.name for t in param_ts}

    for p in param_ts:
        stages_using = {partition.stage_of[c.name]
                        for c in graph.consumers(p)}
        if len(stages_using) != 1:
            raise ValueError(
                f"param {p.name!r} is consumed by stages "
                f"{sorted(stages_using)}; pipeline training requires each "
                "param to live on exactly one stage")
    loss_anc = graph.ancestors(loss_t)
    for p in param_ts:
        if p.name not in loss_anc:
            raise ValueError(
                f"param {p.name!r} does not feed the loss {loss_t.name!r}; "
                "its gradient would be identically zero — drop it from "
                "params or pick the right loss sink")
    diff = _diff_names(graph, loss_t, param_names)
    meshes = _resolve_meshes(graph, partition.num_stages, mesh, stage_meshes,
                             device)

    _, boundary_sbp, interfaces = _stage_interfaces(graph, plan, partition)
    stages: List[TrainStageProgram] = []
    for s, iface in enumerate(interfaces):
        program = _lower_subgraph(graph, plan, iface.ops, iface.in_tensors,
                                  iface.out_tensors, iface.in_sbp,
                                  iface.out_sbp)
        fwd, bwd, diff_in = _train_program(program, diff, meshes[s])
        stages.append(TrainStageProgram(
            index=s, fwd=fwd, bwd=bwd, input_names=program.input_names,
            output_names=program.output_names, diff_input_names=diff_in,
            param_names=tuple(n for n in diff_in if n in param_names),
            mesh=meshes[s], in_sbp=dict(iface.in_sbp),
            out_sbp=dict(iface.out_sbp)))

    all_params = tuple(p.name for p in param_ts)
    return TrainStagedProgram(graph, plan, partition, stages, loss_t,
                              all_params, boundary_sbp, optimizer=optimizer)


# ---------------------------------------------------------------------------
# Serve lowering.
# ---------------------------------------------------------------------------

#: cache leaves indexed by position: a prompt fills its first S rows (GQA's
#: k/v, MLA's latent c and rope key kpe)
POSITIONAL = ("k", "v", "c", "kpe")


class StageParams(nn.Module):
    """One stage's weights in the compute dtype: its ``blocks``, plus
    ``embed`` on the first stage and ``final_norm``/``unembed`` on the
    last."""

    def __init__(self, blocks, embed=None, final_norm=None, unembed=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.embed = embed
        self.final_norm = final_norm
        self.unembed = unembed


def _shard_copy(module: nn.Module, dtype: Optional[torch.dtype],
                cfg: ModelConfig, plan: MeshPlan, coords,
                device) -> nn.Module:
    """A copy of ``module`` (a stage's slice of a global model, or a whole
    one) holding the rank at ``coords``'s shard of every parameter under
    :func:`repro_torch.models.transformer.spec_of`, cast to ``dtype``
    (None: each leaf's own) on ``device``; contiguous, and shared with the
    global tensor where the shard is one already in that dtype and place
    (a replicated leaf, a row block)."""
    memo = {}
    for name, p in module.named_parameters():
        t = p.detach()
        t = t[M.shard_slices(t.shape, T.spec_of(name, cfg, plan),
                             plan.axis_sizes, coords)]
        memo[id(p)] = param(t.to(device, dtype or t.dtype).contiguous())
    return copy.deepcopy(module, memo)


@dataclasses.dataclass
class ServeStage:
    """One lowered decode/prefill pipeline stage.

    ``decode(params, caches, xin, pos) -> (xout, caches)``: one token for a
    full slot group, caches updated in place. ``xin`` is the token ids (B,)
    on the first stage, the hidden (B, 1, d) elsewhere; ``xout`` is the
    logits (B, padded_vocab) on the last stage, the hidden elsewhere.

    ``prefill(params, xin, last_index) -> (xout, slot_caches)``: run one
    admitted request's prompt (B = 1) through the slice and build its
    caches; the last stage returns the first-token logits at
    ``last_index`` through the same head as ``decode``.
    ``chunk(params, caches, xin, pos0, adv) -> (xout, caches)``: chunked
    prefill, the stage's ``decode`` looped over the chunk axis of ``xin``
    ((T, B) token ids or (T, B, 1, d) hiddens), slot ``b`` at position
    ``pos0[b] + t * adv[b]`` (parked slots: ``adv == 0``); ``xout`` stacks
    the T outputs.
    ``init_caches(batch, device=None) -> caches`` allocates the zeroed
    group cache (on the stage's device; ``"meta"`` gives its shapes only);
    ``write_slot(caches, slot_caches, slot)`` copies a freshly prefilled
    request into slot ``slot`` of it. ``slot_rows(caches, slot)`` gives
    the views of slot ``slot``'s row in every leaf of the group cache (on a
    mesh, on the ranks that hold it); it is set where a parked slot's rows
    could reach the live slots (:func:`parked_rows_matter`), else None.

    On a ``mesh`` of several ranks each is a per-rank program run through
    :func:`repro_torch.core.mesh.spmd`: ``params`` and the caches are
    per-rank lists (each rank's shards; a group cache ``(group_size / dp,
    cache_len / tp, KV, hd)`` a rank, an MLA layer's latent ``(group_size /
    dp, cache_len, r)`` whole on every rank of ``model``), so is a hidden
    passed between stages
    (replicated over ``model``, split over ``data``). Token ids, positions
    and the last stage's logits stay global: the stage cuts the first two
    by data rank and assembles the third from the ranks' vocab blocks.
    """

    index: int
    decode: Callable
    prefill: Callable
    chunk: Callable
    init_caches: Callable
    write_slot: Callable
    params: StageParams
    units: Tuple[int, int]              # [lo, hi) over prologue+period units
    first: bool
    last: bool
    device: torch.device = None
    mesh: Optional[DeviceMesh] = None
    slot_rows: Optional[Callable] = None


class ServeStagedProgram:
    """A pipeline of decode-stage programs, run sequentially (num_stages
    == 1 is the monolithic serve engine) or concurrently by
    :class:`repro_torch.runtime.pipeline.ServePipelineExecutor`."""

    def __init__(self, cfg, plan, stages: List[ServeStage], cache_len: int,
                 max_prompt_len: int, group_size: int, device, mesh=None):
        self.cfg = cfg
        self.plan = plan
        self.mesh = mesh
        self.stages = stages
        self.cache_len = cache_len
        self.max_prompt_len = max_prompt_len
        self.group_size = group_size
        self.device = device

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def describe(self) -> str:
        kinds = T.stack_layout(self.cfg).layer_kinds()
        layers = ", ".join(f"{kinds.count(k)} {k[0]}/{k[1]}"
                           for k in sorted(set(kinds)))
        lines = [f"serve pipeline: {self.num_stages} stages over "
                 f"{self.stages[-1].units[1]} stack units ({layers} layers) "
                 f"(cache_len={self.cache_len}, "
                 f"group_size={self.group_size}, device={self.device})"]
        if self.mesh is not None:
            cache = ("latent cache replicated" if self.cfg.use_mla
                     else "KV cache by sequence")
            experts = (", experts" if self.cfg.num_experts else "")
            lines.append(f"  on {self.mesh}: tp={self.plan.tp} (heads"
                         f"{experts}, vocab, {cache}), dp={self.plan.dp} "
                         "(slot groups' rows)")
        for st in self.stages:
            extra = []
            if st.first:
                extra.append("embed")
            if st.last:
                extra.append("final_norm+head")
            lines.append(f"  stage {st.index}: units "
                         f"[{st.units[0]}, {st.units[1]})"
                         + (f" + {'+'.join(extra)}" if extra else ""))
        return "\n".join(lines)


def check_token_frontend(cfg: ModelConfig) -> None:
    """The reference's refusal (``repro/core/lowering.py:1350-1353``):
    pipelined serving takes token ids, so an encoder-decoder or an embed
    frontend raises its ``ValueError``; those archs serve through the
    classic loop (:func:`repro_torch.train.steps.make_serve_step`).
    ``api.compile(mode="serve")`` calls it before it builds a model."""
    if cfg.encoder_decoder or cfg.embed_frontend:
        raise ValueError(
            f"{cfg.name}: pipelined serving needs a token frontend "
            "(encoder-decoder / embed-frontend archs are not supported)")


def parked_rows_matter(cfg: ModelConfig) -> bool:
    """Whether a parked slot's decode can change what a live slot computes
    or holds: through an SSM layer's whole-request state (a slot admitted
    this round is parked in its group's decode of the round, and its
    dummy token would advance the state its prefill just wrote) or an MoE
    layer's capacity (a parked token competes with the live ones for
    expert slots, and its hidden depends on what its rows hold). Such a
    stack's stages get ``slot_rows``, through which the dense cache keeps
    its parked rows inert, as the paged cache's are by construction, so
    both caches serve the same tokens, on one device and on a mesh; for
    attention with a dense MLP a parked row reaches nothing, and its
    decode runs as it is."""
    return T.has_ssm_layers(cfg) or any(
        m == "moe" for _, m in T.stack_layout(cfg).layer_kinds())


def lower_serve_stages(cfg: ModelConfig, model: T.Transformer,
                       num_stages: int, cache_len: int, max_prompt_len: int,
                       group_size: int, sliding_window: int = 0,
                       mesh: Optional[DeviceMesh] = None
                       ) -> ServeStagedProgram:
    """Cut ``model`` (a :class:`repro_torch.models.transformer.Transformer`)
    into ``num_stages`` stage programs on the model's device, or, with a
    ``mesh`` of several ranks, into per-rank programs over its
    ``("data", "model")`` axes with each rank's shards on its device
    (``repro/core/lowering.py:1331-1503``). Each stage gets its slice of the
    blocks, plus the embedding on the first stage and the final norm +
    unembedding head on the last."""
    if mesh is not None and mesh.size == 1:
        mesh = None
    plan = MeshPlan.single_device() if mesh is None else MeshPlan.of(mesh)
    T.check_supported(cfg)
    T.check_mesh_supported(cfg, plan)
    if cache_len < 2:
        # retired/empty slots decode a dummy token "parked" at the reserved
        # position cache_len - 1; with cache_len < 2 that position would
        # collide with position 0 of every live request's window
        raise ValueError(
            f"cache_len={cache_len} must be >= 2: the final cache position "
            "(cache_len - 1) is reserved as the parking slot for "
            "retired/empty decode slots")
    if cache_len % plan.tp:
        raise ValueError(f"cache_len={cache_len} must be divisible by the "
                         f"model-parallel degree {plan.tp}")
    if group_size % plan.dp:
        raise ValueError(f"group_size={group_size} must be divisible by the "
                         f"data-parallel degree {plan.dp}")
    attn = next((b.attn for b in model.blocks if hasattr(b, "attn")), None)
    hq = (None if attn is None or cfg.use_mla
          else attn.wq.shape[1] // cfg.head_dim)
    if hq is not None and hq != cfg.padded_heads(plan.tp):
        raise ValueError(f"the model holds {hq} q heads; tp={plan.tp} needs "
                         f"{cfg.padded_heads(plan.tp)} (build it with the "
                         "mesh's MeshPlan)")
    units = T.stage_units(cfg)
    n_units = len(units)
    if not (1 <= num_stages <= n_units):
        raise ValueError(f"num_stages={num_stages} must be in [1, {n_units}] "
                         f"(= prologue blocks + body periods for {cfg.name})")
    adt = T.compute_dtype(cfg)
    device = model.embed.device if mesh is None else mesh.devices[0]
    kinds_all = T.stack_layout(cfg).layer_kinds()

    # contiguous unit ranges, balanced by count
    sizes = [n_units // num_stages + (1 if s < n_units % num_stages else 0)
             for s in range(num_stages)]
    bounds, lo = [], 0
    for sz in sizes:
        bounds.append((lo, lo + sz))
        lo += sz

    stages: List[ServeStage] = []
    for s, (lo, hi) in enumerate(bounds):
        first, last = s == 0, s == num_stages - 1
        layers = [li for u in units[lo:hi] for li in u]
        kinds = [kinds_all[li] for li in layers]
        whole = StageParams(
            [model.blocks[li] for li in layers],
            embed=model.embed if first else None,
            final_norm=model.final_norm if last else None,
            unembed=model.unembed if last else None)

        def decode(p, caches, xin, pos, _first=first, _last=last,
                   _kinds=kinds):
            if _first:
                x = T.embed_tokens(p.embed, xin[:, None], plan)
            else:
                x = xin
            x, caches = T.decode_stack_slice(p.blocks, caches, x, pos, cfg,
                                             plan, _kinds, sliding_window)
            if _last:
                x = T.final_logits(p.final_norm, p.unembed, x[:, 0], cfg)
            return x, caches

        def prefill(p, xin, last_index: int, _first=first, _last=last,
                    _kinds=kinds):
            x = T.embed_tokens(p.embed, xin, plan) if _first else xin
            positions = torch.arange(x.shape[1], device=x.device)
            x, caches = T.prefill_stack_slice(p.blocks, x, positions, cfg,
                                              plan, _kinds, sliding_window,
                                              cache_len)
            if _last:
                x = T.final_logits(p.final_norm, p.unembed,
                                   x[:, last_index], cfg)
            return x, caches

        def init_caches(batch: int, device=device, _layers=layers):
            return make_decode_caches(cfg, plan, batch, cache_len, device,
                                      layers=_layers)

        if mesh is None:
            sparams = T.cast_copy(whole, adt)
            write, rows = write_slot, slot_rows
        else:
            sparams = [_shard_copy(whole, adt, cfg, plan, mesh.coords(r),
                                   mesh.devices[r])
                       for r in range(mesh.size)]
            decode, prefill, init_caches, write, rows = _rank_programs(
                mesh, plan, first, last, decode, prefill, layers, cfg,
                cache_len)

        def chunk(p, caches, xin, pos0, adv, _decode=decode):
            # the reference's lax.scan of the decode step (:1459-1471)
            outs = []
            for t in range(xin.shape[0] if torch.is_tensor(xin)
                           else xin[0].shape[0]):
                xt = xin[t] if torch.is_tensor(xin) else [x[t] for x in xin]
                out, caches = _decode(p, caches, xt, pos0 + t * adv)
                outs.append(out)
            if torch.is_tensor(outs[0]):
                return torch.stack(outs), caches
            return [torch.stack(o) for o in zip(*outs)], caches

        stages.append(ServeStage(
            index=s, decode=decode, prefill=prefill, chunk=chunk,
            init_caches=init_caches, write_slot=write, params=sparams,
            units=(lo, hi), first=first, last=last, device=device,
            mesh=mesh, slot_rows=rows if parked_rows_matter(cfg) else None))
    return ServeStagedProgram(cfg, plan, stages, cache_len, max_prompt_len,
                              group_size, device, mesh=mesh)


def data_index(mesh: DeviceMesh, plan: MeshPlan, rank: int) -> int:
    """The rank's row-major index over the data axes: which block of a slot
    group's rows it holds."""
    d = 0
    for name, size, c in zip(mesh.axis_names, mesh.shape, mesh.coords(rank)):
        if name != plan.model_axis:
            d = d * size + c
    return d


def _rank_programs(mesh: DeviceMesh, plan: MeshPlan, first: bool,
                   last: bool, decode, prefill, layers, cfg, cache_len):
    """A stage's per-rank ``decode``/``prefill`` (the one-rank programs
    given) as programs over the ranks of ``mesh``, with its
    ``init_caches``, ``write_slot`` and ``slot_rows``; see
    :class:`ServeStage`."""
    ranks = list(range(mesh.size))
    data = [data_index(mesh, plan, r) for r in ranks]
    # the last stage's logits: rows over data (decode) or replicated
    # (prefill), vocab blocks over model
    rows = ",".join("S(1)" if n == plan.model_axis else "S(0)"
                    for n in mesh.axis_names)
    one = ",".join("S(1)" if n == plan.model_axis else "B"
                   for n in mesh.axis_names)

    def mesh_decode(params, caches, xin, pos):
        b = pos.shape[0] // plan.dp

        def rank(r):
            blk = slice(data[r] * b, (data[r] + 1) * b)
            x = xin[blk] if first else xin[r]
            return decode(params[r], caches[r], x, pos[blk])[0]
        outs = spmd(rank, mesh)(ranks)
        return (assemble(outs, mesh, rows) if last else outs), caches

    def mesh_prefill(params, xin, last_index: int):
        # the admission prefill (B = 1) runs replicated over data
        outs = spmd(lambda r: prefill(params[r], xin if first else xin[r],
                                      last_index), mesh)(ranks)
        xs, slot_caches = [o[0] for o in outs], [o[1] for o in outs]
        return (assemble(xs, mesh, one) if last else xs), slot_caches

    def mesh_init_caches(batch: int, device=None):
        return [make_decode_caches(cfg, plan, batch // plan.dp, cache_len,
                                   mesh.devices[r] if device is None
                                   else device, layers=layers)
                for r in ranks]

    def owners(caches, slot: int):
        # the data rank that owns the slot holds it, at its local index
        b = next(iter(caches[0][0].values())).shape[0]
        return [r for r in ranks if data[r] == slot // b], slot % b

    def mesh_write_slot(caches, slot_caches, slot: int):
        rs, local = owners(caches, slot)
        for r in rs:
            write_slot(caches[r], slot_caches[r], local)
        return caches

    def mesh_slot_rows(caches, slot: int):
        rs, local = owners(caches, slot)
        return [v for r in rs for v in slot_rows(caches[r], local)]

    return (mesh_decode, mesh_prefill, mesh_init_caches, mesh_write_slot,
            mesh_slot_rows)


def slot_rows(caches: List[dict], slot: int) -> List[torch.Tensor]:
    """The views of slot ``slot``'s row in every leaf of the group
    caches."""
    return [t[slot] for layer in caches for t in layer.values()]


def write_slot(caches: List[dict], slot_caches: List[dict],
               slot: int) -> List[dict]:
    """Copy a prefilled request's caches (B = 1) into slot ``slot`` of the
    group caches in place, casting to the group cache's dtype. Positional
    leaves (:data:`POSITIONAL`, prompt length S) fill the slot's first S
    positions and zero the rest -- the reference's padded write (a rank's
    GQA sequence block at tp > 1 arrives padded and fills it whole; MLA's
    replicated latent arrives unpadded on every rank, each writing the
    same values); the SSM
    state and conv tails are copied whole. A conv tail shorter than the
    cache's (a prompt of fewer than ``ssm_d_conv - 1`` tokens) is refused."""
    for gc, sc in zip(caches, slot_caches):
        for key, dst in gc.items():
            src = sc[key][0]
            if key in POSITIONAL:
                S = src.shape[0]
                dst[slot, :S].copy_(src)
                dst[slot, S:].zero_()
                continue
            if src.shape != dst.shape[1:]:
                raise ValueError(
                    f"write_slot: the prefilled {key!r} has shape "
                    f"{tuple(src.shape)}, the slot holds "
                    f"{tuple(dst.shape[1:])}: an SSM layer needs a prompt of "
                    "at least ssm_d_conv - 1 tokens for its conv tails")
            dst[slot].copy_(src)
    return caches
