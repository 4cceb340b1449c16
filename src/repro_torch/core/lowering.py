"""Lowering: logical graphs and the serve model cut into stage programs.

Port of ``repro/core/lowering.py``, in two halves.

**Graph lowering** (``:41-1230``) turns a (LogicalGraph, Plan) into programs
over torch tensors. The reference runs each (sub)graph as one jitted
``shard_map`` program whose boxing edges are ``jax.lax`` collectives. Here
every placement has one device (each mesh axis of size 1, where each boxing
is the identity, :func:`repro_torch.core.boxing.boxing_fn`); a larger one
raises (ROADMAP Queue 1 item 8). A program is a plain function that runs the
local ops in topological order, eagerly:

* :func:`lower_plan` / :func:`lower_stages` -- inference, the whole graph or
  one program per pipeline stage.
* :func:`lower_train_plan` / :func:`lower_train_stages` -- training. Where the
  reference stashes a ``jax.vjp`` closure per microbatch, a forward here
  records each op on detached leaves (an :class:`OpTape`) and the backward
  walks the tape in reverse, calling ``torch.autograd.grad`` op by op and
  summing cotangents in that fixed order. A stage's backward starts each
  boundary tensor's cotangent from what later stages sent, so the staged
  and the whole-graph backward add the same terms in the same order: that
  is what makes the actor pipeline bitwise the monolithic engine.

The ``softmax_xent`` op goes through the xent kernel and its backward on a
CUDA tensor (:func:`repro_torch.kernels.softmax_xent.xent_local_stats`);
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
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.boxing import boxing_fn
from repro_torch.core.graph import LogicalGraph, LOp, LTensor, StagePartition
from repro_torch.core.planner import Plan
from repro_torch.core.sbp import Broadcast, NdSbp
from repro_torch.kernels.softmax_xent.kernel import xent_local_stats
from repro_torch.models import transformer as T
from repro_torch.models.common import MeshPlan, param
from repro_torch.models.mamba import FLOAT32_PARAMS
from repro_torch.models.model_zoo import make_decode_caches
from repro_torch.optim.adamw import (AdamWState, adamw_param_update,
                                    clip_scale, global_norm_from_partials,
                                    init_adamw, scale_grad, sqnorm_partials)

# ---------------------------------------------------------------------------
# Graph lowering: local ops over torch tensors, one-device placements.
# ---------------------------------------------------------------------------

def _check_one_device(placement) -> None:
    """Lowering here runs only where every mesh axis has size 1 (each
    boxing the identity); planning itself takes any placement."""
    if placement.num_devices != 1:
        raise NotImplementedError(
            f"lowering onto {placement}: placements of more than one device "
            "need the multi-device substrate (boxing collectives), which is "
            "not ported yet (ROADMAP Queue 1 item 8)")


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
    local stats at vocab offset 0 (the whole vocabulary on one device)."""
    m, s, z = xent_local_stats(logits.contiguous(), labels.contiguous(), 0)
    return (torch.log(s) + m - z)[:, None]


def _local_op(op: LOp, in_sigs: Tuple[NdSbp, ...], out_sig: NdSbp,
              axis_names: Sequence[str], mesh_shape: Sequence[int]):
    """Return fn(local_inputs) -> local_output implementing ``op``. On a
    one-device placement every shard is the whole tensor, so the
    reference's cross-shard combines (``pmax``/``psum`` over split axes,
    shard offsets) are the identity and the signatures do not change the
    function."""
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


def _materialized(sig: NdSbp) -> NdSbp:
    """Partial-free storage signature: P components become B. Tensors that
    cross a program boundary (graph outputs, stage boundaries) are stored
    so."""
    return NdSbp(tuple(Broadcast() if c.is_partial else c for c in sig))


@dataclasses.dataclass
class _OpStep:
    """One lowered op: its local function, the boxing of each input from
    its stored signature to the op's, and the epilogue boxing of its
    output (``None`` where the signatures agree)."""

    op: LOp
    fn: Callable
    in_names: Tuple[str, ...]
    out_name: str
    boxers: Tuple[Optional[Callable], ...]
    epilogue: Optional[Callable]

    def apply(self, args):
        args = [b(v) if b is not None else v
                for v, b in zip(args, self.boxers)]
        out = self.fn(*args)
        return self.epilogue(out) if self.epilogue is not None else out


@dataclasses.dataclass
class LocalProgram:
    """A lowered (sub)graph: ``steps`` run in order from ``input_names`` to
    ``output_names``. Calling it runs inference: one value per input in,
    a tuple with one value per output back."""

    steps: List[_OpStep]
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    out_boxers: Tuple[Optional[Callable], ...]

    def outputs(self, env: Dict[str, Any]) -> Tuple:
        """The program's outputs from its environment, boxed from their
        stored signatures to the boundary's."""
        return tuple(env[n] if b is None else b(env[n])
                     for n, b in zip(self.output_names, self.out_boxers))

    def __call__(self, *values) -> Tuple:
        env = dict(zip(self.input_names, values))
        for st in self.steps:
            env[st.out_name] = st.apply([env[n] for n in st.in_names])
        return self.outputs(env)


def _lower_subgraph(graph: LogicalGraph, plan: Plan, ops: Sequence[LOp],
                    in_tensors: Sequence[LTensor],
                    out_tensors: Sequence[LTensor],
                    in_sbp: Dict[str, NdSbp],
                    out_sbp: Dict[str, NdSbp]) -> LocalProgram:
    """The program running ``ops`` from ``in_tensors`` to ``out_tensors``.

    ``in_sbp``/``out_sbp`` give the *stored* (partial-free) signatures at
    the boundary; inside, tensors follow the plan, and every place the
    reference boxes gets a :func:`boxing_fn` (the identity here)."""
    placement = graph.placement
    _check_one_device(placement)
    axis_names = tuple(placement.axis_names)
    mesh_shape = tuple(placement.mesh_shape())
    for t in in_tensors:
        if in_sbp[t.name].has_partial:
            raise ValueError(f"boundary input {t.name} stored as partial-value")
    for t in out_tensors:
        if out_sbp[t.name].has_partial:
            raise ValueError(f"boundary output {t.name} stored as partial-value")

    def box(have, want, t):
        if have == want:
            return None
        return boxing_fn(have, want, axis_names, mesh_shape, t.shape)

    cur_sbp = {t.name: in_sbp[t.name] for t in in_tensors}
    steps: List[_OpStep] = []
    for op in ops:
        in_sigs = plan.op_in_sbp[op.name]
        raw_sig = plan.op_out_sbp[op.name]
        stored_sig = plan.tensor_sbp[op.output.name]
        steps.append(_OpStep(
            op=op, fn=_local_op(op, in_sigs, raw_sig, axis_names, mesh_shape),
            in_names=tuple(t.name for t in op.inputs),
            out_name=op.output.name,
            boxers=tuple(box(cur_sbp[t.name], want, t)
                         for t, want in zip(op.inputs, in_sigs)),
            epilogue=box(raw_sig, stored_sig, op.output)))
        cur_sbp[op.output.name] = stored_sig
    # boundary boxing (e.g. P -> B materialization)
    out_boxers = tuple(box(cur_sbp[t.name], out_sbp[t.name], t)
                       for t in out_tensors)
    return LocalProgram(steps, tuple(t.name for t in in_tensors),
                        tuple(t.name for t in out_tensors), out_boxers)


def _to_device(v, device) -> torch.Tensor:
    """A graph input as a tensor on ``device`` (numpy arrays and tensors
    alike; no copy when it is already there)."""
    return torch.as_tensor(v, device=device)


def lower_plan(graph: LogicalGraph, plan: Plan,
               device=None) -> "PhysicalProgram":
    """The whole graph as one program (the monolithic inference engine)."""
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
    return PhysicalProgram(graph, plan, program, sinks, device)


class PhysicalProgram:
    """Executable physical graph: the lowered program plus metadata.

    Calling it returns a tuple of sink values in ``self.sinks`` order (also
    for a single sink), computed without autograd on ``device``."""

    def __init__(self, graph, plan, program: LocalProgram, sinks, device=None):
        self.graph, self.plan = graph, plan
        self.program = program
        self.sinks = sinks
        self.device = device

    def __call__(self, *global_inputs) -> Tuple:
        with torch.inference_mode():
            return self.program(*(_to_device(v, self.device)
                                  for v in global_inputs))


# ---------------------------------------------------------------------------
# Stage-partitioned lowering (paper §4.3): each pipeline stage becomes its
# own program; tensors crossing a stage boundary are stored partial-free.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageProgram:
    """One lowered pipeline stage: a callable plus its interface.

    ``fn(*values)`` takes one value per ``input_names`` entry (graph inputs
    and/or boundary tensors from earlier stages) and returns a tuple with
    one value per ``output_names`` entry (boundary tensors and/or sinks)."""

    index: int
    fn: Callable
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    device: Any = None

    def place_inputs(self, values: Sequence) -> List:
        """The stage's inputs on its device (a no-op when already there)."""
        return [_to_device(v, self.device) for v in values]


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
        env = {t.name: v for t, v in zip(self.graph.inputs, global_inputs)}
        with torch.inference_mode():
            for stage in self.stages:
                args = stage.place_inputs([env[n] for n in stage.input_names])
                env.update(zip(stage.output_names, stage.fn(*args)))
        return tuple(env[t.name] for t in self.sinks)


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
                 device=None) -> StagedProgram:
    """Lower each pipeline stage of ``partition`` independently, every stage
    on ``device`` (stages share the card; pipelining overlaps host work and
    microbatches). The reference's ``stage_meshes`` (one device group per
    stage) is ROADMAP Queue 1 item 8."""
    sinks, boundary_sbp, interfaces = _stage_interfaces(graph, plan, partition)
    stages: List[StageProgram] = []
    for s, iface in enumerate(interfaces):
        program = _lower_subgraph(graph, plan, iface.ops, iface.in_tensors,
                                  iface.out_tensors, iface.in_sbp,
                                  iface.out_sbp)
        stages.append(StageProgram(
            index=s, fn=program, input_names=program.input_names,
            output_names=program.output_names, device=device))
    return StagedProgram(graph, plan, partition, stages, sinks, boundary_sbp)


# ---------------------------------------------------------------------------
# Training lowering (paper §4.3 + the MPMD fwd/bwd decomposition). The
# forward of a stage records each op on detached leaves; the backward walks
# that tape in reverse. Activations stay stage-local (inside the tape the
# runtime stashes in the forward actor's out register) while cotangents flow
# backward across stage boundaries. The runtime half lives in
# repro_torch.runtime.pipeline.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpTape:
    """What one microbatch's forward through a program keeps for its
    backward: per differentiated op, its output name, its input leaves
    ``((name, leaf), ...)`` and its output with the op's autograd graph."""

    records: List[Tuple[str, Tuple[Tuple[str, torch.Tensor], ...],
                        torch.Tensor]]


def _taped_forward(program: LocalProgram, diff: set, values: Sequence):
    """Run ``program`` recording an :class:`OpTape`: an op's inputs named in
    ``diff`` enter as fresh leaves (one per distinct name) that require
    grad, its output leaves the op detached. Returns ``(outputs, tape)``."""
    env = dict(zip(program.input_names, values))
    records = []
    with torch.enable_grad():
        for st in program.steps:
            leaves: Dict[str, torch.Tensor] = {}
            args = []
            for n in st.in_names:
                if n in diff:
                    if n not in leaves:
                        leaves[n] = env[n].detach().requires_grad_(True)
                    args.append(leaves[n])
                else:
                    args.append(env[n])
            out = st.apply(args)
            if leaves and out.requires_grad:
                records.append((st.out_name, tuple(leaves.items()), out))
            env[st.out_name] = out.detach()
    return program.outputs(env), OpTape(records)


def _taped_backward(tape: OpTape, cotangents: Dict[str, torch.Tensor],
                    wanted: Sequence[str]) -> Tuple:
    """Reverse-mode over ``tape``: start from ``cotangents`` (output seeds
    and the cotangents later stages sent for this program's inputs), walk
    the ops in reverse topological order and add each op's contribution to
    its inputs' cotangents in that order. Returns one cotangent per
    ``wanted`` name (``None`` where nothing flowed)."""
    cot = {n: c for n, c in cotangents.items() if c is not None}
    for out_name, leaves, out in reversed(tape.records):
        g = cot.pop(out_name, None)
        if g is None:
            continue
        grads = torch.autograd.grad(out, [leaf for _, leaf in leaves], g,
                                    allow_unused=True)
        for (n, _), gi in zip(leaves, grads):
            if gi is not None:
                cot[n] = gi if n not in cot else cot[n] + gi
    tape.records.clear()
    return tuple(cot.get(n) for n in wanted)


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

    Only full float32 is ported, which changes nothing (the masters of
    float32 params are the params): bfloat16 compute over float32 masters
    and loss scaling are ROADMAP Queue 1 item 9."""

    compute_dtype: str = "float32"
    loss_scale: Any = None

    def __post_init__(self):
        if self.compute_dtype != "float32" or self.loss_scale is not None:
            raise NotImplementedError(
                f"PrecisionPolicy(compute_dtype={self.compute_dtype!r}, "
                f"loss_scale={self.loss_scale!r}): mixed precision and loss "
                "scaling are not ported yet (ROADMAP Queue 1 item 9); only "
                "float32 is")


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Pluggable optimizer for staged training programs (SGD or AdamW).

    ``lr`` is a float or a step-indexed callable ``lr(step) -> float``
    (``step`` counts optimizer steps from 0). ``grad_clip`` > 0 enables
    *global*-norm clipping: the pipeline wires a ``norm`` actor that sums
    per-stage squared-norm partials (P->B boxing expressed as an actor) and
    broadcasts the clip scale to every ``opt{s}``. AdamW carries an
    :class:`repro_torch.optim.adamw.AdamWState` per stage -- the second
    register stream.

    The update runs in place: the params and moments handed to
    :meth:`update` are the ones it returns, updated. The ZeRO fields
    (``zero``, ``zero_dp``, ``zero_shapes``) are ROADMAP Queue 1 item 9.
    """

    kind: str = "sgd"                     # "sgd" | "adamw"
    lr: Any = 1e-2                        # float or fn(step) -> float
    beta1: float = 0.9                    # adamw only below
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 0.0                # 0 disables global-norm clipping
    zero: bool = False
    zero_dp: int = 1
    zero_shapes: Any = None
    precision: Optional[PrecisionPolicy] = None

    def __post_init__(self):
        if self.kind not in ("sgd", "adamw"):
            raise ValueError(f"unknown optimizer kind {self.kind!r}")
        if self.zero or self.zero_dp != 1 or self.zero_shapes is not None:
            raise NotImplementedError(
                "OptimizerSpec zero=/zero_dp=/zero_shapes=: ZeRO master "
                "shards are not ported yet (ROADMAP Queue 1 item 9)")
        if self.precision is not None and not isinstance(self.precision,
                                                         PrecisionPolicy):
            raise ValueError("precision must be a PrecisionPolicy")

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

    def init_state(self, params: Dict[str, torch.Tensor]):
        """Fresh optimizer state for ``params`` (None for stateless SGD)."""
        if self.kind == "sgd":
            return None
        return init_adamw(dict(params))

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state, lr_now: float):
        """Apply one optimizer step to ``params`` (in place) given
        already-clipped float32 ``grads``; returns ``(params, new_state)``.

        Per-tensor math is :func:`sgd_update` / :func:`repro_torch.optim
        .adamw.adamw_param_update`, so updating per-stage subsets (the opt
        actors) or the whole dict (the monolithic engine) gives the same
        values tensor by tensor."""
        if self.kind == "sgd":
            for n in params:
                sgd_update(params[n], grads[n], lr_now)
            return params, None
        if state is None:
            state = self.init_state(params)
        new_step = state.step + 1
        for n in params:
            adamw_param_update(params[n], grads[n], state.mu[n], state.nu[n],
                               new_step, lr_now, beta1=self.beta1,
                               beta2=self.beta2, eps=self.eps,
                               weight_decay=self.weight_decay)
        return params, AdamWState(new_step, state.mu, state.nu)

    def split_state(self, state, stage_param_names: Dict[int, Sequence[str]]):
        """Split a merged optimizer state into per-stage states keyed by
        stage index (``stage_param_names``: stage -> its param names);
        stateless optimizers split to None entries."""
        if not self.stateful or state is None:
            return {s: None for s in stage_param_names}
        out = {}
        for s, names in stage_param_names.items():
            missing = [n for n in names if n not in state.mu]
            if missing:
                raise ValueError(
                    f"optimizer state missing moments for params {missing}")
            out[s] = AdamWState(state.step,
                                {n: state.mu[n] for n in names},
                                {n: state.nu[n] for n in names})
        return out

    def merge_states(self, states: Sequence[Any]):
        """Inverse of :meth:`split_state`: one state over all params (None
        for a stateless optimizer)."""
        if not self.stateful:
            return None
        states = [s for s in states if s is not None]
        if not states:
            return None
        mu: Dict[str, torch.Tensor] = {}
        nu: Dict[str, torch.Tensor] = {}
        for st in states:
            mu.update(st.mu)
            nu.update(st.nu)
        return AdamWState(states[0].step, mu, nu)


def clip_grads(grads: Dict[str, torch.Tensor], order: Sequence[str],
               grad_clip: float):
    """Global-norm clipping as the pipeline does it: per-tensor partials,
    summed in ``order`` on the host, one scale for every tensor. Returns
    ``(clipped grads, pre-clip norm)``."""
    norm = global_norm_from_partials(sqnorm_partials(grads), order)
    scale = clip_scale(norm, grad_clip)
    return {n: scale_grad(g, scale) for n, g in grads.items()}, norm


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


@dataclasses.dataclass
class TrainStageProgram:
    """One pipeline stage of a training graph: forward, backward, interface.

    ``fwd(*values)`` takes one value per ``input_names`` entry and returns
    ``(outputs, tape)``: the stage outputs (one per ``output_names``) and
    the :class:`OpTape` holding the stage-local activations, which the actor
    runtime stashes in the forward actor's out register so it is released
    exactly when the backward actor acks.

    ``bwd(tape, cotangents)`` takes that tape and the seeds of
    :meth:`output_cotangents`, and returns one cotangent per
    ``diff_input_names`` entry: gradients for this stage's params,
    cotangents for boundary activations from earlier stages (``None`` where
    nothing flowed). ``bwd`` is None for a stage with no differentiable
    inputs."""

    index: int
    fwd: Callable
    bwd: Optional[Callable]
    input_names: Tuple[str, ...]
    output_names: Tuple[str, ...]
    diff_input_names: Tuple[str, ...]
    param_names: Tuple[str, ...]
    device: Any = None

    def place_inputs(self, values: Sequence) -> List:
        return [_to_device(v, self.device) for v in values]

    def output_cotangents(self, outputs: Dict[str, Any],
                          cotangents: Dict[str, Any],
                          loss_name: str) -> Dict[str, torch.Tensor]:
        """The backward seeds of this stage: ones for the loss sink (the
        objective is the *sum* of the loss tensor over each microbatch),
        the incoming cotangent for every output consumed downstream, and
        for every boundary input that later stages also consume -- its sum
        so far, which this stage's own contributions then extend."""
        seeds = {}
        for name in self.output_names:
            if name == loss_name:
                seeds[name] = torch.ones_like(outputs[name])
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
                 optimizer: Optional[OptimizerSpec] = None, device=None):
        self.graph, self.plan, self.partition = graph, plan, partition
        self.stages = stages
        self.loss = loss
        self.param_names = param_names
        self.boundary_sbp = boundary_sbp
        self.opt_update = sgd_update
        self.optimizer = optimizer
        self.device = device

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
        stages, accumulating gradients in float32 in microbatch order, and
        applies the optimizer to copies of the params (``inputs`` stays as
        it was). Returns ``(loss, grads, new_params)``, or with an optimizer
        in play (``optimizer=`` or the program's) ``(loss, grads,
        new_params, new_state)`` with ``grads`` post-clip. The lr schedule
        resolves at ``step_index`` (default: ``opt_state.step`` when
        stateful, else 0)."""
        inputs = {n: _to_device(v, self.device) for n, v in inputs.items()}
        chunks = split_microbatches(inputs, microbatch_inputs,
                                    num_microbatches)
        mb_names = set(microbatch_inputs)
        loss_total = None
        grads: Dict[str, torch.Tensor] = {}
        for chunk in chunks:
            env = {n: (chunk[n] if n in mb_names else inputs[n])
                   for n in self.input_names}
            tapes = {}
            for st in self.stages:
                outs, tape = st.fwd(*[env[n] for n in st.input_names])
                env.update(zip(st.output_names, outs))
                tapes[st.index] = tape
            cots: Dict[str, torch.Tensor] = {}
            for st in reversed(self.stages):
                if st.bwd is None:
                    continue
                seeds = st.output_cotangents(env, cots, self.loss_name)
                in_cots = st.bwd(tapes[st.index], seeds)
                for name, c in zip(st.diff_input_names, in_cots):
                    if c is None:
                        continue
                    if name in st.param_names:
                        c32 = c.float()
                        grads[name] = (grads[name] + c32 if name in grads
                                       else c32)
                    else:
                        cots[name] = c
            ls = torch.sum(env[self.loss_name])
            loss_total = ls if loss_total is None else loss_total + ls
        params = {n: inputs[n].clone() for n in self.param_names}
        opt = optimizer if optimizer is not None else self.optimizer
        if opt is None:
            new_params = {n: self.opt_update(params[n], grads[n], lr)
                          for n in self.param_names}
            return loss_total, grads, new_params
        if opt.grad_clip:
            grads, _ = clip_grads(grads, self.param_names, opt.grad_clip)
        if opt.stateful and opt_state is None:
            opt_state = opt.init_state(params)
        if step_index is None:
            step_index = int(opt_state.step) if opt_state is not None else 0
        new_params, new_state = opt.update(params, grads, opt_state,
                                           opt.lr_at(step_index))
        return loss_total, grads, new_params, new_state


def _diff_names(graph: LogicalGraph, loss_t: LTensor,
                param_names: set) -> set:
    """Tensors that carry a cotangent: downstream of a param and upstream
    of the loss."""
    return graph.downstream_of(param_names) & graph.ancestors(loss_t)


def _train_program(program: LocalProgram, diff: set):
    """(fwd, bwd) over one lowered program: the taped forward and its
    reverse, the cotangents wanted being those of the differentiable
    inputs."""
    diff_in = tuple(n for n in program.input_names if n in diff)
    if not diff_in:
        def fwd_nodiff(*ins):
            with torch.no_grad():
                return program(*ins), None
        return fwd_nodiff, None, diff_in

    def fwd(*ins):
        return _taped_forward(program, diff, ins)

    def bwd(tape, cotangents):
        return _taped_backward(tape, cotangents, diff_in)
    return fwd, bwd, diff_in


def lower_train_plan(graph: LogicalGraph, plan: Plan, params, loss=None,
                     device=None) -> Callable:
    """Monolithic training program -- the reference the pipeline is checked
    against. Returns ``fn(*graph_input_values) -> (loss_vec, grads)`` where
    ``loss_vec`` is the (unreduced) loss sink and ``grads`` holds
    ``d(sum(loss_vec))/d(param)`` for each param, in ``params`` order. It
    runs the same taped forward and backward as the pipelined stages over
    the whole graph, seeding ``ones_like(loss_vec)``."""
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
    fwd, bwd, _ = _train_program(program, diff)
    loss_pos = [t.name for t in sinks].index(loss_t.name)

    def value_and_grad(*all_ins):
        all_ins = [_to_device(v, device) for v in all_ins]
        outs, tape = fwd(*all_ins)
        loss_vec = outs[loss_pos]
        env = dict(zip(program.input_names, all_ins))
        cots = _taped_backward(tape, {loss_t.name: torch.ones_like(loss_vec)},
                               pnames)
        return loss_vec, tuple(
            c if c is not None else torch.zeros_like(env[n])
            for n, c in zip(pnames, cots))
    return value_and_grad


def lower_train_stages(graph: LogicalGraph, plan: Plan,
                       partition: StagePartition, params, loss=None,
                       device=None,
                       optimizer: Optional[OptimizerSpec] = None
                       ) -> TrainStagedProgram:
    """Cut a training graph into forward / backward programs per stage.

    Builds on :func:`lower_stages`' partition: each stage's program is run
    taped over its *differentiable* inputs -- the stage-local params plus
    any boundary activations derived from params. Activations stay in the
    stage's tape; only cotangents cross stage boundaries, flowing backward
    along the seams the activations flowed forward.

    ``params`` names the graph inputs to train; each must be consumed by
    ops of exactly one stage. ``loss`` names the graph sink to
    differentiate (default: the sole sink). ``optimizer`` is carried on the
    program (the executor falls back to plain SGD when absent)."""
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

    _, boundary_sbp, interfaces = _stage_interfaces(graph, plan, partition)
    stages: List[TrainStageProgram] = []
    for s, iface in enumerate(interfaces):
        program = _lower_subgraph(graph, plan, iface.ops, iface.in_tensors,
                                  iface.out_tensors, iface.in_sbp,
                                  iface.out_sbp)
        fwd, bwd, diff_in = _train_program(program, diff)
        stages.append(TrainStageProgram(
            index=s, fwd=fwd, bwd=bwd, input_names=program.input_names,
            output_names=program.output_names, diff_input_names=diff_in,
            param_names=tuple(n for n in diff_in if n in param_names),
            device=device))

    all_params = tuple(p.name for p in param_ts)
    return TrainStagedProgram(graph, plan, partition, stages, loss_t,
                              all_params, boundary_sbp, optimizer=optimizer,
                              device=device)


# ---------------------------------------------------------------------------
# Serve lowering.
# ---------------------------------------------------------------------------

#: cache leaves indexed by position: a prompt fills its first S rows
POSITIONAL = ("k", "v")


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


def _cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose parameters are cast to ``dtype`` (shared,
    not copied, where they already have it), but for those the model reads
    in float32 (:data:`repro_torch.models.mamba.FLOAT32_PARAMS`)."""
    memo = {id(p): param(p.detach().to(
        torch.float32 if name.rsplit(".", 1)[-1] in FLOAT32_PARAMS
        else dtype)) for name, p in module.named_parameters()}
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
    request into slot ``slot`` of it.
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


class ServeStagedProgram:
    """A pipeline of decode-stage programs, run sequentially (num_stages
    == 1 is the monolithic serve engine) or concurrently by
    :class:`repro_torch.runtime.pipeline.ServePipelineExecutor`."""

    def __init__(self, cfg, plan, stages: List[ServeStage], cache_len: int,
                 max_prompt_len: int, group_size: int, device):
        self.cfg = cfg
        self.plan = plan
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


def lower_serve_stages(cfg: ModelConfig, model: T.Transformer,
                       num_stages: int, cache_len: int, max_prompt_len: int,
                       group_size: int, sliding_window: int = 0,
                       plan: Optional[MeshPlan] = None) -> ServeStagedProgram:
    """Cut ``model`` (a :class:`repro_torch.models.transformer.Transformer`)
    into ``num_stages`` stage programs on the model's device. Each stage
    gets its slice of the blocks, plus the embedding on the first stage and
    the final norm + unembedding head on the last."""
    plan = plan or MeshPlan.single_device()
    T.check_supported(cfg)
    if cache_len < 2:
        # retired/empty slots decode a dummy token "parked" at the reserved
        # position cache_len - 1; with cache_len < 2 that position would
        # collide with position 0 of every live request's window
        raise ValueError(
            f"cache_len={cache_len} must be >= 2: the final cache position "
            "(cache_len - 1) is reserved as the parking slot for "
            "retired/empty decode slots")
    units = T.stage_units(cfg)
    n_units = len(units)
    if not (1 <= num_stages <= n_units):
        raise ValueError(f"num_stages={num_stages} must be in [1, {n_units}] "
                         f"(= prologue blocks + body periods for {cfg.name})")
    adt = T.compute_dtype(cfg)
    device = model.embed.device
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
        sparams = _cast_copy(StageParams(
            [model.blocks[li] for li in layers],
            embed=model.embed if first else None,
            final_norm=model.final_norm if last else None,
            unembed=model.unembed if last else None), adt)

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
                                              plan, _kinds, sliding_window)
            if _last:
                x = T.final_logits(p.final_norm, p.unembed,
                                   x[:, last_index], cfg)
            return x, caches

        def chunk(p, caches, xin, pos0, adv, _decode=decode):
            # the reference's lax.scan of the decode step (:1459-1471)
            outs = []
            for t in range(xin.shape[0]):
                out, caches = _decode(p, caches, xin[t], pos0 + t * adv)
                outs.append(out)
            return torch.stack(outs), caches

        def init_caches(batch: int, device=device, _layers=layers):
            return make_decode_caches(cfg, plan, batch, cache_len, device,
                                      layers=_layers)

        stages.append(ServeStage(
            index=s, decode=decode, prefill=prefill, chunk=chunk,
            init_caches=init_caches, write_slot=write_slot, params=sparams,
            units=(lo, hi), first=first, last=last, device=device))
    return ServeStagedProgram(cfg, plan, stages, cache_len, max_prompt_len,
                              group_size, device)


def write_slot(caches: List[dict], slot_caches: List[dict],
               slot: int) -> List[dict]:
    """Copy a prefilled request's caches (B = 1) into slot ``slot`` of the
    group caches in place, casting to the group cache's dtype. Positional
    leaves (:data:`POSITIONAL`, prompt length S) fill the slot's first S
    positions and zero the rest -- the reference's padded write; the SSM
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
