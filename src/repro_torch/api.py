"""The public entry point of the port: ``compile``, the one frontend over
every lowering and executor path (port of ``repro/api.py``).

* ``compile(graph, mode="infer"|"train")`` compiles a
  :class:`~repro_torch.core.graph.LogicalGraph`: SBP plan
  (:func:`repro_torch.core.planner.plan`), stage partition
  (:func:`repro_torch.core.graph.partition_stages`), register quotas
  (:func:`repro_torch.runtime.pipeline.plan_registers`), then staged
  lowering run by stage actors (``backend="actors"``; 1F1B emerges from the
  quotas, §4.3) or one whole-graph program (``backend="monolithic"``, the
  bit-identity reference). It returns a :class:`Session`.
* ``compile(cfg, mode="serve")`` builds a :class:`ServeSession` that runs
  continuously-batched decode over the lowered stage programs: greedy or
  sampled (``sampling=``), over dense per-group caches or the paged pool
  (``cache="paged"``, with shared-prefix pages and ``prefill_chunk=``),
  on one device or, dense, on a ``("data", "model")`` mesh of ranks
  (``mesh=``: tensor parallelism over ``model`` -- heads, MLP units,
  SSM heads, experts and the vocabulary -- data parallelism over
  ``data``).

A graph runs on the ranks of a :class:`~repro_torch.core.mesh.DeviceMesh`
(``mesh=``; default: the graph placement's ranks, all on ``device``), or
stage by stage on ``stage_meshes=``; sessions take and return global
tensors. Training takes the reference's ``zero=``, ``precision=`` and
``loss_scale=`` (float32 masters, bf16 compute, loss scaling, ZeRO master
shards; paper §6.4), and its ``snapshot_dir=``, ``snapshot_every=``,
``restore=`` and ``faults=`` (async snapshots from ``snap{s}`` actors,
kill-and-resume, fault injection). Every actor session runs on
``runtime="threads"`` (the default) or ``runtime="processes"``: one
worker process per actor node, each lowering its stages from a picklable
recipe (:mod:`repro_torch.runtime.recipes`), CUDA tensors crossing by IPC.
What the reference offers beyond that raises :class:`NotImplementedError`
naming its ROADMAP item: stage-body wrappers. Every compile runs the
static plan verifier (:mod:`repro_torch.analysis`, ``check="static"``)
before anything fires; ``describe()`` prints its report.

Entry points run on the card: ``device=None`` means ``"cuda"``, and with no
card an entry point raises unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import (LogicalGraph, StagePartition,
                                    partition_stages)
from repro_torch.core.lowering import (OptimizerSpec, PrecisionPolicy,
                                       _resolve_loss, _resolve_mesh,
                                       accumulate, box_grads,
                                       check_token_frontend, clip_grads,
                                       loss_scale_update, lower_plan,
                                       lower_serve_stages, lower_stages,
                                       lower_train_plan, lower_train_stages,
                                       opt_state_bytes, rank_compute,
                                       rank_masters, rank_opt_state,
                                       rank_states, reassemble_sinks,
                                       split_microbatches, sync_mesh)
from repro_torch.core.mesh import DeviceMesh, assemble, place
from repro_torch.core.placement import Placement
from repro_torch.core.planner import Plan, plan as plan_sbp
from repro_torch.models.common import MeshPlan, resolve_device
from repro_torch.models.transformer import (Transformer,
                                            check_mesh_supported,
                                            compute_dtype, has_ssm_layers,
                                            stack_layout)
from repro_torch.runtime.base import RUNTIME_KINDS
from repro_torch.runtime.pipeline import (ActorPipelineExecutor,
                                          InlineServeEngine, PipelinePlan,
                                          ServePipelineExecutor,
                                          TrainPipelineExecutor,
                                          check_run_inputs, own_params,
                                          plan_registers, unscale)
from repro_torch.runtime.recipes import (InferRecipe, MeshSpec, ServeRecipe,
                                         TrainRecipe)
from repro_torch.serve.paged_cache import (PagedCacheSpec, PagePool,
                                           dense_bytes, slab_bytes)
from repro_torch.serve.sampler import (  # noqa: F401 (re-exported)
    SamplingSpec, greedy_from_logits)

MODES = ("infer", "train", "serve")
BACKENDS = ("actors", "monolithic")

#: named register-quota policies accepted by ``compile(regs=...)``
REG_POLICIES = ("1f1b", "gpipe", "serial")

#: options of the reference's ``compile`` that the port does not take yet:
#: name -> (the reference's default, what it is and the ROADMAP item that
#: brings it). Passing the default is accepted and changes nothing.
NOT_PORTED = {
    "fn_wrap": (None, "stage-body wrappers, ROADMAP Queue 1 item 14"),
}


class StepResult:
    """One training step's outcome, uniform across backends.

    ``metrics`` always carries ``step`` (0-based index of the step just
    taken), ``lr`` (the schedule resolved at that step), ``grad_norm``
    (pre-clip global norm; None when clipping is off) and ``makespan``.
    Actor-backend sessions add ``peak_inflight`` (peak forward registers in
    use — the in-flight microbatch count the quota bounds). ``loss``,
    ``grads`` and ``params`` are global tensors. On a one-rank mesh the
    params are the session's live tensors (the next step updates them in
    place). On a larger one ``grads`` and ``params`` are assembled from the
    ranks' shards when first read, so a step pays for no global copy it
    is not asked for; the shards an optimizer updates in place are read as
    they stand then.
    """

    def __init__(self, loss: Any, metrics: Dict[str, Any],
                 grads: Callable[[], Dict[str, Any]],
                 params: Callable[[], Dict[str, Any]]):
        self.loss, self.metrics = loss, metrics
        self._lazy = {"grads": grads, "params": params}
        self._done: Dict[str, Dict[str, Any]] = {}

    def _read(self, what: str) -> Dict[str, Any]:
        if what not in self._done:
            self._done[what] = self._lazy.pop(what)()
        return self._done[what]

    @property
    def grads(self) -> Dict[str, Any]:
        return self._read("grads")

    @property
    def params(self) -> Dict[str, Any]:
        return self._read("params")

    def __repr__(self) -> str:
        return f"StepResult(loss={self.loss!r}, metrics={self.metrics!r})"


def _canonical_params(graph: LogicalGraph, params: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Reorder a param dict into graph-input order — the canonical order
    both backends use for the global-norm sum, so clipping is bit-identical
    no matter how the caller built the dict."""
    input_names = [t.name for t in graph.inputs]
    unknown = sorted(set(params) - set(input_names))
    if unknown:
        raise ValueError(f"params entries are not graph inputs: {unknown}")
    return {n: params[n] for n in input_names if n in params}


class _MonolithicInferEngine:
    """``backend="monolithic"`` inference: one whole-graph program
    (:func:`repro_torch.core.lowering.lower_plan`), run once per microbatch
    chunk with the same :func:`split_microbatches` chunking as the actor
    pipeline so the two backends agree bitwise."""

    def __init__(self, graph: LogicalGraph, plan: Plan,
                 microbatch_inputs: Sequence[str], num_microbatches: int,
                 mesh: DeviceMesh):
        self.graph = graph
        self.program = lower_plan(graph, plan, mesh)
        self.mesh = mesh
        self.input_names = [t.name for t in graph.inputs]
        self.microbatch_inputs = list(microbatch_inputs)
        self.num_microbatches = num_microbatches
        for n in self.microbatch_inputs:
            if n not in self.input_names:
                raise ValueError(f"{n} is not a graph input")
        self.last_makespan: Optional[float] = None

    def run(self, inputs: Dict[str, Any], timeout: float = 0.0) -> Tuple:
        check_run_inputs(inputs, self.input_names)
        t0 = time.perf_counter()
        if not self.microbatch_inputs:
            chunks = [dict(inputs)]
        else:
            chunks = split_microbatches(inputs, self.microbatch_inputs,
                                        self.num_microbatches)
        mb = set(self.microbatch_inputs)
        sink_names = [t.name for t in self.program.sinks]
        per_chunk = [
            dict(zip(sink_names,
                     self.program(*(c[n] if n in mb else inputs[n]
                                    for n in self.input_names))))
            for c in chunks]
        results = reassemble_sinks(self.graph, self.program.sinks,
                                   self.microbatch_inputs, per_chunk)
        sync_mesh(self.mesh)
        self.last_makespan = time.perf_counter() - t0
        return results


class _MonolithicTrainEngine:
    """``backend="monolithic"`` training: the whole-graph value-and-grad of
    :func:`repro_torch.core.lowering.lower_train_plan` with the exact
    microbatch chunking, float32 accumulation in microbatch order,
    canonical-order global-norm clipping, and :class:`OptimizerSpec` update
    of the actor pipeline — the reference its numbers are checked against,
    owned by the same :class:`Session` surface.

    With a mixed-precision optimizer ``shards`` are float32 (views of the
    flat masters under ZeRO), ``masters`` what the update writes and
    ``compute`` the compute-dtype copies forward and backward see; the
    loss scale is mirrored as the pipelined ``scale`` actor keeps it, and a
    skipped step leaves params, moments and the step count as they were."""

    def __init__(self, graph: LogicalGraph, plan: Plan,
                 params: Dict[str, Any], microbatch_inputs: Sequence[str],
                 num_microbatches: int, optimizer: OptimizerSpec,
                 mesh: DeviceMesh, loss=None):
        self.graph = graph
        self.plan = plan
        self.mesh = mesh
        self.optimizer = optimizer
        self.param_names = tuple(_canonical_params(graph, params))
        self.load_params(params)
        self.vg = lower_train_plan(graph, plan, list(self.param_names),
                                   loss=loss, mesh=mesh)
        self.loss_sbp = plan.tensor_sbp[_resolve_loss(graph, loss).name]
        self.input_names = [t.name for t in graph.inputs]
        self.microbatch_inputs = list(microbatch_inputs)
        self.num_microbatches = num_microbatches
        self.opt_states = None
        self.step_count = 0
        self.last_grad_norm = None
        self.last_makespan: Optional[float] = None
        # the loss-scale mirror: the same trajectory as the scale actor
        self._scaling = optimizer.loss_scaling is not None
        self.loss_scale = optimizer.initial_scale() if self._scaling else None
        self.scale_good_steps = 0
        self.last_skipped = False
        self.last_scale = None

    def _global(self, per_rank: Dict[str, List[torch.Tensor]]):
        sbp = self.plan.tensor_sbp
        return {n: assemble(v, self.mesh, sbp[n])
                for n, v in per_rank.items()}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._global(self.shards)

    @property
    def opt_state(self):
        return rank_opt_state(self.optimizer, self.opt_states, self.mesh,
                              self.plan.tensor_sbp, self.shards)

    def opt_state_bytes(self) -> Dict[int, int]:
        """The monolithic counterpart of :meth:`repro_torch.runtime
        .pipeline.TrainPipelineExecutor.opt_state_bytes`: one entry (stage
        0)."""
        return {0: opt_state_bytes(self.optimizer, self.opt_states,
                                   self.shards, self.mesh.size)}

    def load_params(self, params: Dict[str, Any]) -> None:
        opt = self.optimizer
        self.shards = own_params(params, self.param_names,
                                 {n: self.mesh for n in self.param_names},
                                 self.plan.tensor_sbp, opt.mixed_precision)
        self.masters = self.compute = None
        if opt.mixed_precision:
            self.masters, self.shards = rank_masters(opt, self.shards)
            self.compute = rank_compute(opt, self.masters, self.shards)

    def load_state(self, params: Optional[Dict[str, Any]] = None,
                   opt_state=None, step: Optional[int] = None) -> None:
        """Restore a full training state: params (masters and compute
        copies rebuilt from them), the merged optimizer state (cut per rank,
        flat under ZeRO, as owned copies) and the step counter the lr
        schedule indexes."""
        if params is not None:
            self.load_params(params)
        if opt_state is not None:
            if not self.optimizer.stateful:
                raise ValueError(
                    "opt_state= for a stateless optimizer "
                    f"({self.optimizer.kind})")
            self.opt_states = rank_states(
                self.optimizer, opt_state, self.shards, self.mesh,
                self.plan.tensor_sbp)
        if step is not None:
            self.step_count = int(step)

    def step_shards(self, data_inputs: Dict[str, Any], timeout: float = 0.0):
        check_run_inputs(
            data_inputs,
            [n for n in self.input_names if n not in self.shards],
            owned=self.param_names)
        t0 = time.perf_counter()
        sbp, mesh = self.plan.tensor_sbp, self.mesh
        chunks = split_microbatches(data_inputs, self.microbatch_inputs,
                                    self.num_microbatches)
        mb = set(self.microbatch_inputs)
        bound = {n: place(v, mesh, sbp[n]) for n, v in data_inputs.items()
                 if n not in mb}
        opt = self.optimizer
        params = self.compute if self.compute is not None else self.shards
        loss_total = None
        grads: Dict[str, List[torch.Tensor]] = {}
        for chunk in chunks:
            vals = [place(chunk[n], mesh, sbp[n]) if n in mb
                    else (params[n] if n in params else bound[n])
                    for n in self.input_names]
            loss_vec, g = self.vg(*vals, scale=self.loss_scale)
            ls = torch.sum(assemble(loss_vec, mesh, self.loss_sbp))
            loss_total = ls if loss_total is None else loss_total + ls
            # owned float32 sums per rank, summed into in place after: the
            # acc actors' order and bits
            for n, gn in zip(self.param_names, g):
                grads[n] = accumulate(grads.get(n), gn)
        grads = box_grads(mesh, self.graph, self.plan, grads)
        if self._scaling:
            # unscale ONCE after accumulation, as the acc actors do
            grads = unscale(grads, np.float32(
                np.float32(1.0) / np.float32(self.loss_scale)))
        if opt.grad_clip or opt.dynamic_scaling:
            grads, self.last_grad_norm = clip_grads(
                grads, self.param_names, opt.grad_clip, mesh, self.plan)
        self.last_scale = self.loss_scale
        self.last_skipped = False
        if opt.dynamic_scaling:
            finite = bool(np.isfinite(np.float32(self.last_grad_norm)))
            self.last_skipped, self.loss_scale, self.scale_good_steps = \
                loss_scale_update(opt.precision, self.loss_scale,
                                  self.scale_good_steps, finite)
            if self.last_skipped:
                # non-finite grads: params, masters and moments untouched,
                # as the pipelined opt actors leave them
                sync_mesh(mesh)
                self.last_makespan = time.perf_counter() - t0
                return loss_total, {}, dict(self.shards)
        if opt.stateful and self.opt_states is None:
            self.opt_states = opt.init_rank_states(self.shards, mesh.size)
        with torch.no_grad():
            self.opt_states = opt.update_ranks(
                self.masters if self.masters is not None else self.shards,
                grads, self.opt_states, opt.lr_at(self.step_count),
                mesh.size)
            if self.masters is not None:
                self.compute = rank_compute(opt, self.masters, self.shards)
        sync_mesh(mesh)
        self.step_count += 1
        self.last_makespan = time.perf_counter() - t0
        return loss_total, grads, dict(self.shards)


class Session:
    """The uniform run/step surface every graph compile path returns.

    * ``mode="infer"``: :meth:`run` maps graph-input values to a dict of
      sink values (named by sink tensor).
    * ``mode="train"``: :meth:`step` takes the non-param inputs and returns
      a :class:`StepResult`; the session owns ``params`` and any optimizer
      state across steps.

    ``describe()`` reports the SBP plan, the stage partition with register
    quotas, the simulated register plan and the static check's report
    (``static_report``). ``history`` accumulates one
    record per :meth:`run`/:meth:`step` call. Sessions are built by
    :func:`compile`, never directly.
    """

    def __init__(self, *, graph: LogicalGraph, mode: str, backend: str,
                 engine, plan: Plan, partition: Optional[StagePartition],
                 regs: Optional[List[int]], reg_plan: Optional[PipelinePlan],
                 optimizer: Optional[OptimizerSpec],
                 microbatch_inputs: List[str], num_microbatches: int,
                 device: torch.device, meshes: Sequence[DeviceMesh],
                 timeout: float = 300.0, runtime: Optional[str] = None):
        self.graph = graph
        self.mode = mode
        self.backend = backend
        self.runtime = runtime        # "threads"/"processes"; None: monolithic
        self.plan = plan
        self.partition = partition
        self.regs = regs
        self.reg_plan = reg_plan
        self.optimizer = optimizer
        self.microbatch_inputs = microbatch_inputs
        self.num_microbatches = num_microbatches
        self.device = device
        self.meshes = list(meshes)      # one, or one per stage
        self.timeout = timeout
        self.history: List[Dict[str, Any]] = []
        self.static_report = None     # repro_torch.analysis.StaticReport
        self._engine = engine
        self._sinks = graph.sinks()

    @property
    def executor(self):
        """The backing executor/engine: an
        :class:`~repro_torch.runtime.pipeline.ActorPipelineExecutor` or
        :class:`~repro_torch.runtime.pipeline.TrainPipelineExecutor` for
        ``backend="actors"``, the monolithic engine otherwise."""
        return self._engine

    @property
    def params(self) -> Optional[Dict[str, Any]]:
        """Current trainable params (None for inference sessions)."""
        if self.mode != "train":
            return None
        return dict(self._engine.params)

    @property
    def opt_state(self):
        """Optimizer state over all params (merged across stages for the
        actor backend; None for SGD, inference, or before the first step)."""
        if self.mode != "train":
            return None
        return self._engine.opt_state

    @property
    def step_count(self) -> int:
        return getattr(self._engine, "step_count", 0)

    @property
    def last_makespan(self) -> Optional[float]:
        return self._engine.last_makespan

    @property
    def last_edge_bytes(self) -> Dict[Any, int]:
        """Per-edge payload bytes from the last step/run (empty for the
        monolithic engines: one program, no edges)."""
        return dict(getattr(self._engine, "last_edge_bytes", None) or {})

    def load_params(self, params: Dict[str, Any]) -> None:
        """Replace the session-owned params (copies of ``params``);
        optimizer state is untouched."""
        if self.mode != "train":
            raise RuntimeError("load_params() on an inference session")
        self._engine.load_params(params)

    def load_state(self, params: Optional[Dict[str, Any]] = None,
                   opt_state=None, step: Optional[int] = None) -> None:
        """Restore a full training state -- params, the merged optimizer
        state and the step counter -- e.g. from
        :func:`repro_torch.runtime.snapshot.load_snapshot` (numpy arrays or
        tensors). Each piece is optional and independent; the actor backend
        cuts ``opt_state`` by *this* session's stage partition and meshes,
        so a snapshot taken under one partition restores onto another
        (elastic resume)."""
        if self.mode != "train":
            raise RuntimeError("load_state() on an inference session")
        self._engine.load_state(params=params, opt_state=opt_state,
                                step=step)

    def close(self) -> None:
        """Release the engine's workers (a no-op for monolithic engines)."""
        close = getattr(self._engine, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def run(self, **inputs) -> Dict[str, Any]:
        """Execute the compiled inference program over ``inputs`` (one
        keyword per graph input) and return ``{sink name: value}``."""
        if self.mode == "train":
            raise RuntimeError(
                "run() on a train-mode session; use step(**batch) "
                "(or compile with mode='infer')")
        outs = self._engine.run(inputs, timeout=self.timeout)
        self.history.append({"kind": "run",
                             "makespan": self._engine.last_makespan})
        return {t.name: v for t, v in zip(self._sinks, outs)}

    def step(self, **batch) -> StepResult:
        """Run one training step over the session-owned params and return a
        :class:`StepResult`. ``batch`` maps every non-param graph input to
        its value; the names in ``microbatch_inputs`` are split into
        ``num_microbatches`` chunks along axis 0."""
        if self.mode != "train":
            raise RuntimeError(
                "step() on an infer-mode session; use run(**inputs) "
                "(or compile with mode='train', params=...)")
        eng = self._engine
        index = eng.step_count
        loss, grads, shards = eng.step_shards(batch, timeout=self.timeout)
        metrics = {
            "step": index,
            "lr": self.optimizer.lr_at(index),
            "grad_norm": eng.last_grad_norm,
            "makespan": eng.last_makespan,
        }
        if self.optimizer.loss_scaling is not None:
            metrics["loss_scale"] = (None if eng.last_scale is None
                                     else float(eng.last_scale))
            metrics["skipped"] = bool(eng.last_skipped)
        if self.backend == "actors":
            metrics["peak_inflight"] = eng.peak_inflight_activations
        gn = metrics["grad_norm"]
        self.history.append({"kind": "step", "loss": float(loss), **metrics,
                             "grad_norm": None if gn is None else float(gn)})
        return StepResult(loss=loss, metrics=metrics,
                          grads=lambda: eng._global(grads),
                          params=lambda: eng._global(shards))

    def describe(self) -> str:
        """Human-readable report of the compiled artifact: graph shape, SBP
        plan, stage partition + register quotas, optimizer."""
        g = self.graph
        rt = f" runtime={self.runtime}" if self.runtime is not None else ""
        lines = [f"=== repro_torch.api session: mode={self.mode} "
                 f"backend={self.backend}{rt} device={self.device} ===",
                 f"graph: {len(g.ops)} ops, "
                 f"inputs {[t.name for t in g.inputs]}, "
                 f"sinks {[t.name for t in self._sinks]}",
                 f"microbatches: {self.num_microbatches} over "
                 f"{self.microbatch_inputs or '(none)'}",
                 "mesh: " + (str(self.meshes[0]) if len(self.meshes) == 1
                             else f"{len(self.meshes)} stage meshes, "
                                  f"{self.meshes[0]}")]
        if self.mode == "train":
            opt = self.optimizer
            lines.append(f"optimizer: {opt.kind} (grad_clip={opt.grad_clip}, "
                         f"stateful={opt.stateful})")
            if opt.mixed_precision:
                scaling = opt.loss_scaling
                lines.append(
                    f"precision: compute={opt.compute_dtype} "
                    f"masters=float32 "
                    f"loss_scale={'off' if scaling is None else scaling}")
            if opt.zero:
                lines.append(
                    f"zero: dp={opt.zero_dp} — flat (dp, 1, chunk) float32 "
                    "master/moment shards held by the opt actors")
            if opt.stateful:
                per = self._engine.opt_state_bytes()
                per_s = " ".join(f"stage{s}={per[s]}" for s in sorted(per))
                lines.append("optimizer-state bytes/device: "
                             f"{per_s} (total {sum(per.values())})")
        lines.append(self.plan.describe())
        if self.partition is not None:
            lines.append(self.partition.describe(g, regs=self.regs))
        else:
            lines.append("single whole-graph program (no stage partition)")
        if self.reg_plan is not None:
            rp = self.reg_plan
            lines.append(
                f"register plan (simulated): quota={rp.regs[0]} "
                f"makespan={rp.makespan:.1f} "
                f"bubble={rp.bubble_fraction:.2f}")
        if self.static_report is not None:
            lines.append(self.static_report.describe())
        return "\n".join(lines)

    def __repr__(self):
        return (f"Session(mode={self.mode!r}, backend={self.backend!r}, "
                f"stages={self.partition.num_stages if self.partition else 1}, "
                f"num_microbatches={self.num_microbatches})")


# ---------------------------------------------------------------------------
# mode="serve": continuous-batching autoregressive decode.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeRequest:
    """One generation request: prompt token ids + how many tokens to decode
    (the first generated token, from the prefill logits, counts)."""

    tokens: Any
    max_new_tokens: int


class ServeSession:
    """Pipelined, continuously-batched decode over the actor runtime.

    :meth:`generate` runs a set of :class:`ServeRequest`\\ s to completion:
    requests are packed into ``num_groups * group_size`` decode slots, each
    round advances every live group by one token (one ``DecodeWork`` per
    group streamed down the stage actors), finished requests retire their
    slot and queued ones are admitted mid-flight with a ``PrefillWork`` (or,
    paged with ``prefill_chunk``, a sequence of ``PrefillChunkWork``).
    Tokens are greedy, or drawn by the last stage's sampler under
    ``sampling``. ``history`` accumulates one record per round,
    ``last_stats`` describes the last :meth:`generate` (on a mesh with
    ``collectives``: the mesh's calls and bytes by kind and the seconds
    its ranks spent in them, :class:`repro_torch.core.mesh
    .CollectiveStats`).
    """

    def __init__(self, *, cfg, backend: str, engine, sstaged,
                 num_groups: int, group_size: int, cache_len: int,
                 max_prompt_len: int, max_new_tokens: int,
                 device: torch.device,
                 timeout: float = 300.0, runtime: Optional[str] = None,
                 cache: str = "dense", cache_spec=None, sampling=None,
                 prefill_chunk: Optional[int] = None,
                 share_prefix: bool = False):
        self.cfg = cfg
        self.mode = "serve"
        self.backend = backend
        self.runtime = runtime        # "threads"/"processes"; None: monolithic
        self.sstaged = sstaged
        self.num_groups = num_groups
        self.group_size = group_size
        self.cache_len = cache_len
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        # the stage out-register quotas (the 1F1B rule); None: monolithic
        self.regs = getattr(engine, "regs", None)
        self.device = device
        self.timeout = timeout
        self.cache = cache            # "dense" | "paged"
        self.cache_spec = cache_spec  # PagedCacheSpec when paged
        self.sampling = sampling      # SamplingSpec; None: greedy
        self.prefill_chunk = prefill_chunk
        self.share_prefix = share_prefix
        self.history: List[Dict[str, Any]] = []
        self.last_stats: Optional[Dict[str, Any]] = None
        self.static_report = None     # repro_torch.analysis.StaticReport
        self._engine = engine

    @property
    def executor(self):
        """The backing engine: a
        :class:`repro_torch.runtime.pipeline.ServePipelineExecutor` for
        ``backend="actors"``, the inline monolithic engine otherwise."""
        return self._engine

    @property
    def last_makespan(self) -> Optional[float]:
        return self._engine.last_makespan

    def close(self) -> None:
        """Release the engine's workers (no-op for the inline engine)."""
        close = getattr(self._engine, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @staticmethod
    def _normalize(requests) -> List[ServeRequest]:
        return [r if isinstance(r, ServeRequest) else
                ServeRequest(r[0], int(r[1])) for r in requests]

    def generate(self, requests) -> List[np.ndarray]:
        """Run ``requests`` (ServeRequests or ``(tokens, max_new_tokens)``
        pairs) to completion with continuous batching; returns one int32
        token array per request, in submission order."""
        from repro_torch.serve.admission import AdmissionScheduler

        reqs = self._normalize(requests)
        V = self.cfg.vocab_size
        # an SSM layer's prefill keeps the last d_conv - 1 rows of its conv
        # inputs as the decode state: a shorter prompt has too few (the
        # reference breaks there with a shape error)
        min_len = min_prompt_len(self.cfg)
        prompts = []
        for i, r in enumerate(reqs):
            toks = np.asarray(r.tokens, dtype=np.int32)
            if toks.ndim != 1 or toks.size == 0:
                raise ValueError(f"request {i}: prompt must be a non-empty "
                                 f"1-d token array, got shape {toks.shape}")
            if toks.size < min_len:
                raise ValueError(
                    f"request {i}: prompt length {toks.size} is below "
                    f"ssm_d_conv - 1 = {min_len}: {self.cfg.name}'s SSM "
                    "layers need that many tokens for their conv state")
            if toks.size > self.max_prompt_len:
                raise ValueError(
                    f"request {i}: prompt length {toks.size} exceeds "
                    f"max_prompt_len={self.max_prompt_len}")
            if (toks < 0).any() or (toks >= V).any():
                raise ValueError(f"request {i}: prompt ids must be in "
                                 f"[0, {V})")
            if not (1 <= r.max_new_tokens <= self.max_new_tokens):
                raise ValueError(
                    f"request {i}: max_new_tokens={r.max_new_tokens} must "
                    f"be in [1, {self.max_new_tokens}]")
            prompts.append(toks)

        pool = PagePool(self.cache_spec) if self.cache == "paged" else None
        sched = AdmissionScheduler(
            prompts, [r.max_new_tokens for r in reqs],
            num_groups=self.num_groups, group_size=self.group_size,
            cache_len=self.cache_len, device=self.device, pool=pool,
            prefill_chunk=self.prefill_chunk,
            share_prefix=self.share_prefix)
        mesh = self.sstaged.mesh
        if mesh is not None:
            mesh.stats.reset()
        t0 = time.perf_counter()
        while not sched.done():
            work, meta = sched.plan_round()
            results = self._engine.run_round(work, timeout=self.timeout)
            for m, res in zip(meta, results):
                sched.absorb(m, self._pick_tokens(m, res))
            self.history.append({"kind": "round", "items": len(work),
                                 "makespan": self._engine.last_makespan})
        wall = time.perf_counter() - t0
        total = sum(len(o) for o in sched.outputs)
        self.last_stats = {
            "requests": len(reqs), "tokens": total,
            "rounds": self._engine.rounds, "wall_s": wall,
            "tok_per_s": total / wall if wall > 0 else float("inf"),
            "admitted_mid_flight": sched.admitted_mid_flight,
            "prefill_items": sched.prefill_items,
            "decode_items": sched.decode_items,
            "chunk_items": sched.chunk_items,
            "chunk_tokens": sched.chunk_tokens,
        }
        if mesh is not None:
            st = mesh.stats
            self.last_stats["collectives"] = {
                "calls": dict(st.calls), "bytes": dict(st.bytes),
                "seconds": st.wait_s}
        if pool is not None:
            self.last_stats["peak_pages"] = pool.peak_pages
            self.last_stats["shared_pages"] = sched.shared_pages
        self.history.append({"kind": "generate", **self.last_stats})
        return [np.asarray(o, np.int32) for o in sched.outputs]

    def _pick_tokens(self, m, res):
        """One round result -> the item's token vector (``None`` for a
        non-final chunk). With sampling on, the last stage already drew the
        tokens; otherwise greedy the logits here."""
        if self.sampling is not None:
            toks = res["tokens"]
            return None if toks is None else toks.cpu().numpy()
        if m[0] == "chunk":
            if not m[3]:
                return None
            res = res[-1]        # the chunk's last position feeds the head
        return greedy_from_logits(res, self.cfg.vocab_size).cpu().numpy()

    def cache_bytes(self) -> int:
        """Analytic persistent cache bytes across all stages: the full
        dense reservation (``num_groups`` group blocks) or the paged pool
        (slabs + page table + cursors), from each stage's cache shapes on
        the meta device -- nothing is allocated."""
        total = 0
        for stage in self.sstaged.stages:
            template = stage.init_caches(self.group_size, device="meta")
            if self.cache == "paged":
                total += slab_bytes(template, self.cache_spec)
            else:       # on a mesh, every rank's block
                total += sum(dense_bytes(t, self.num_groups) for t in (
                    template if stage.mesh is not None else [template]))
        return total

    def describe(self) -> str:
        """Human-readable report of the compiled serving artifact."""
        cfg = self.cfg
        rt = f" runtime={self.runtime}" if self.runtime is not None else ""
        lines = [f"=== repro_torch.api session: mode=serve "
                 f"backend={self.backend}{rt} ===",
                 f"model: {cfg.name} ({cfg.num_layers} layers, "
                 f"d_model={cfg.d_model}, vocab={cfg.vocab_size} "
                 f"padded to {cfg.padded_vocab()}, dtype={cfg.dtype})",
                 f"slots: {self.num_groups} groups x {self.group_size} "
                 f"(cache_len={self.cache_len}, "
                 f"max_prompt_len={self.max_prompt_len}, "
                 f"max_new_tokens={self.max_new_tokens})",
                 "cache: dense (one group block per slot group)",
                 self.sstaged.describe()]
        if self.cache == "paged":
            sp = self.cache_spec
            extra = (f" prefill_chunk={self.prefill_chunk}"
                     if self.prefill_chunk is not None else "")
            lines[3] = (f"cache: paged ({sp.num_pages} pages x "
                        f"page_len={sp.page_len}, "
                        f"{sp.pages_per_req} pages/request, "
                        f"share_prefix={self.share_prefix}){extra}")
        if self.sampling is not None:
            sp = self.sampling
            lines.insert(4, f"sampling: temperature={sp.temperature} "
                            f"top_k={sp.top_k} top_p={sp.top_p} "
                            f"seed={sp.seed}")
        if self.regs is not None:
            lines.append(f"register quotas: {self.regs}")
        if self.static_report is not None:
            lines.append(self.static_report.describe())
        return "\n".join(lines)

    def __repr__(self):
        return (f"ServeSession(backend={self.backend!r}, "
                f"stages={self.sstaged.num_stages}, "
                f"groups={self.num_groups}x{self.group_size})")


def min_prompt_len(cfg: ModelConfig) -> int:
    """The shortest prompt ``cfg`` can prefill: ``ssm_d_conv - 1`` tokens
    when it has SSM layers (their conv state), else 0."""
    return cfg.ssm_d_conv - 1 if has_ssm_layers(cfg) else 0


def _serve_options(*, num_groups, group_size, cache_len, max_prompt_len,
                   max_new_tokens, cache=None, page_len=None, num_pages=None,
                   sampling=None, prefill_chunk=None, tp: int = 1):
    """Resolve defaults and validate every serve-only compile option at
    compile time (a bad geometry must fail here, not as a shape error in
    the middle of ``generate``). Returns ``(num_groups, group_size,
    cache_len, max_prompt_len, max_new_tokens, cache, cache_spec)``."""
    num_groups = 2 if num_groups is None else num_groups
    group_size = 2 if group_size is None else group_size
    max_prompt_len = 64 if max_prompt_len is None else max_prompt_len
    max_new_tokens = 64 if max_new_tokens is None else max_new_tokens
    if num_groups < 1 or group_size < 1:
        raise ValueError(f"num_groups={num_groups} and "
                         f"group_size={group_size} must be >= 1")
    if max_prompt_len < 1 or max_new_tokens < 1:
        raise ValueError(f"max_prompt_len={max_prompt_len} and "
                         f"max_new_tokens={max_new_tokens} must be >= 1")
    if cache_len is None:
        cache_len = max_prompt_len + max_new_tokens + 9
        cache_len += -cache_len % tp
    elif cache_len <= max_prompt_len + max_new_tokens:
        # the last cache position is the parking slot for retired requests
        raise ValueError(
            f"cache_len={cache_len} must exceed max_prompt_len + "
            f"max_new_tokens = {max_prompt_len + max_new_tokens} "
            "(the final position is reserved for parked slots); lower "
            "max_prompt_len= or max_new_tokens=, or raise cache_len=")
    cache = "dense" if cache is None else cache
    if cache not in ("dense", "paged"):
        raise ValueError(f"cache={cache!r}; expected 'dense' or 'paged'")
    if sampling is not None and not isinstance(sampling, SamplingSpec):
        raise ValueError(
            "sampling= takes a repro_torch.serve.sampler.SamplingSpec, got "
            f"{type(sampling).__name__}")
    cache_spec = None
    if cache == "dense":
        paged_only = {"page_len": page_len, "num_pages": num_pages,
                      "prefill_chunk": prefill_chunk}
        bad = [k for k, v in paged_only.items() if v is not None]
        if bad:
            raise ValueError(f"{bad[0]}= requires cache='paged' (the dense "
                             "cache has no page geometry)")
    else:
        if page_len is None:
            # largest divisor of cache_len not exceeding 16
            page_len = max(d for d in range(1, min(16, cache_len) + 1)
                           if cache_len % d == 0)
        if page_len < 1 or cache_len % page_len:
            raise ValueError(
                f"page_len={page_len} must be a positive divisor of "
                f"cache_len={cache_len} (every mapped page must be fully "
                "overwritten by the admission prefill)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be >= 1")
        max_requests = num_groups * group_size
        pages_per_req = cache_len // page_len
        # worst-case single request: prompt + all decode writes must fit,
        # or admission could stall forever on an empty pool
        min_pages = math.ceil((max_prompt_len + max_new_tokens - 1)
                              / page_len)
        if num_pages is None:
            num_pages = max_requests * pages_per_req
        if num_pages < min_pages:
            raise ValueError(
                f"num_pages={num_pages} cannot hold one worst-case request "
                f"({min_pages} pages of page_len={page_len} for "
                f"max_prompt_len + max_new_tokens - 1 = "
                f"{max_prompt_len + max_new_tokens - 1} positions)")
        cache_spec = PagedCacheSpec(page_len=page_len, num_pages=num_pages,
                                    max_requests=max_requests,
                                    pages_per_req=pages_per_req)
    return (num_groups, group_size, cache_len, max_prompt_len,
            max_new_tokens, cache, cache_spec)


def _load_model(cfg: ModelConfig, params, seed: int,
                device: torch.device, plan: MeshPlan) -> Transformer:
    """The (global) model to serve: ``params`` as a Transformer or a
    state_dict (e.g. from :func:`repro_torch.models.convert
    .params_from_jax`), or the port's seeded init when ``params`` is None,
    drawn in the compute dtype the stages serve in (the values a cast of
    the float32 init gives, held once); ``plan`` sets its padded q
    heads."""
    from repro_torch.models.model_zoo import build_model

    if params is None:
        return build_model(cfg, plan, seed=seed, device=device,
                           dtype=compute_dtype(cfg))
    if isinstance(params, Transformer):
        return params.to(device)
    if not isinstance(params, Mapping):
        raise ValueError("params= takes a repro_torch Transformer or its "
                         f"state_dict, got {type(params).__name__}")
    with torch.device("meta"):
        model = Transformer(cfg, plan)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                          assign=True)
    return model.to(device)


def _resolve_partition(graph: LogicalGraph,
                       partition: Optional[StagePartition],
                       stages: Optional[int]) -> StagePartition:
    if partition is not None:
        if stages is not None and stages != partition.num_stages:
            raise ValueError(
                f"stages={stages} contradicts partition.num_stages="
                f"{partition.num_stages}; pass one or the other")
        return partition
    if stages is None and all(op.stage is None for op in graph.ops):
        raise ValueError(
            "graph has no stage annotations; pass stages= (a count for "
            "cost-balanced cutting) or partition=, or use "
            "backend='monolithic'")
    return partition_stages(graph, stages)


def _policy_regs(policy: str, num_stages: int, width: int) -> List[int]:
    """Map a :data:`REG_POLICIES` name to per-stage quotas. ``width`` is
    what ``"gpipe"`` admits everywhere: the microbatch count in graph
    modes, the request-group count in serve mode."""
    if policy == "1f1b":
        return [max(1, num_stages - s) for s in range(num_stages)]
    if policy == "gpipe":
        return [width] * num_stages
    if policy == "serial":
        return [1] * num_stages
    raise ValueError(f"unknown regs policy {policy!r}; "
                     f"pass one of {REG_POLICIES} or an explicit list")


def _resolve_regs(regs, partition: StagePartition, num_microbatches: int,
                  mode: str) -> Tuple[List[int], Optional[PipelinePlan]]:
    """Turn the declarative ``regs`` option into per-stage quotas: None ->
    compile-time resource planning (:func:`plan_registers`, §2.3); a policy
    name from :data:`REG_POLICIES` -> its schedule; an explicit sequence ->
    validated pass-through."""
    S = partition.num_stages
    if regs is None:
        bwd = 2.0 if mode == "train" else 0.0
        rp = plan_registers(S, num_microbatches, fwd_time=1.0,
                            bwd_time=max(bwd, 1e-3))
        return list(rp.regs), rp
    if isinstance(regs, str):
        return _policy_regs(regs, S, num_microbatches), None
    regs = list(regs)
    if len(regs) != S:
        raise ValueError(f"need {S} register quotas, got {len(regs)}")
    return regs, None


def _check_not_ported(options: Dict[str, Any]) -> None:
    """Raise for an option of the reference that the port does not take
    yet (naming its ROADMAP item), and as Python would for one neither
    package knows."""
    for name, value in options.items():
        if name not in NOT_PORTED:
            raise TypeError(
                f"compile() got an unexpected keyword argument {name!r}")
        default, what = NOT_PORTED[name]
        if value is not default and value != default:
            raise NotImplementedError(
                f"{name}= ({what}) is not ported yet")


def _fold_precision_options(graph: LogicalGraph, optimizer: OptimizerSpec,
                            params: Dict[str, Any], *, zero, precision,
                            loss_scale) -> OptimizerSpec:
    """Resolve ``compile()``'s ``zero=`` / ``precision=`` / ``loss_scale=``
    into the :class:`OptimizerSpec` fields the lowering and the runtime
    read (``zero``, ``zero_dp``, ``zero_shapes``, ``precision``). The
    spec's own checks re-validate the result (ZeRO needs AdamW; loss
    scaling needs bf16 compute)."""
    if not zero and precision is None and loss_scale is None:
        return optimizer
    policy = precision
    if isinstance(policy, str):
        aliases = {"bf16": "bfloat16", "bfloat16": "bfloat16",
                   "fp32": "float32", "float32": "float32"}
        if policy not in aliases:
            raise ValueError(
                f"unknown precision {policy!r}; expected 'bf16'/'bfloat16', "
                "'fp32'/'float32', or a PrecisionPolicy")
        policy = PrecisionPolicy(compute_dtype=aliases[policy],
                                 loss_scale=loss_scale)
    elif isinstance(policy, PrecisionPolicy):
        if loss_scale is not None:
            policy = dataclasses.replace(policy, loss_scale=loss_scale)
    elif policy is not None:
        raise ValueError(
            f"precision= must be a dtype string or PrecisionPolicy, "
            f"got {type(policy).__name__}")
    elif loss_scale is not None:
        raise ValueError(
            "loss_scale= without precision= — loss scaling only exists to "
            "keep bf16 cotangents representable; pass precision='bf16' "
            "(fp32 compute never needs a scaled backward seed)")
    zero_dp, zero_shapes = 1, None
    if zero:
        pl = graph.placement
        sizes = dict(zip(pl.axis_names, pl.axis_sizes))
        if "data" in sizes:
            zero_dp = int(sizes["data"])
        elif len(pl.axis_names) == 1:
            # a sole placement axis doubles as the data axis
            zero_dp = int(pl.axis_sizes[0])
        else:
            raise ValueError(
                "zero=True requires a data axis to shard the optimizer "
                "state over: name one placement axis 'data' (placement "
                f"axes are {tuple(pl.axis_names)})")
        zero_shapes = tuple((n, tuple(int(d) for d in np.shape(v)))
                            for n, v in params.items())
    return dataclasses.replace(optimizer, zero=bool(zero), zero_dp=zero_dp,
                               zero_shapes=zero_shapes, precision=policy)


def _attach_static_report(sess, check: str):
    """Run the static plan verifier over a freshly compiled session
    (``check="static"``, the default) and attach the report for
    ``describe()``; a FAIL verdict closes the session's workers and raises
    :class:`repro_torch.analysis.AnalysisError` naming the offending cycle
    or edge. ``check="off"`` records a SKIPPED report and returns
    immediately."""
    from repro_torch import analysis

    if check == "off":
        sess.static_report = analysis.StaticReport(verdict="SKIPPED")
        return sess
    report = analysis.run_session_checks(sess)
    sess.static_report = report
    if report.verdict == "FAIL":
        sess.close()
        raise analysis.AnalysisError(report)
    return sess


def _apply_restore(sess: Session, restore) -> Session:
    """Resolve ``compile(restore=<snapshot dir>)``: load the newest
    completed snapshot and install it as the session's full training state,
    with the loss-scale trajectory when the snapshot recorded one."""
    if restore is None:
        return sess
    from repro_torch.runtime.snapshot import load_snapshot

    params, opt_state, step, meta = load_snapshot(str(restore))
    sess.load_state(params=params, opt_state=opt_state, step=step)
    eng = sess._engine
    if (meta.get("loss_scale") is not None
            and getattr(eng, "loss_scale", None) is not None):
        eng.loss_scale = float(meta["loss_scale"])
        eng.scale_good_steps = int(meta.get("scale_good_steps", 0))
    return sess


def _check_snapshot_options(mode: str, backend: str, snapshot_dir,
                            snapshot_every: int, restore, faults) -> None:
    """The reference's checks of the snapshot, restore and fault options:
    train only, snapshots and faults on the actors only, a positive
    cadence, and a cadence only with a directory."""
    if mode != "train":
        train_only = {"snapshot_dir": snapshot_dir, "restore": restore,
                      "faults": faults}
        bad = [k for k, v in train_only.items() if v is not None]
        if bad or snapshot_every != 1:
            bad = bad or ["snapshot_every"]
            raise ValueError(
                f"{bad[0]}= is only meaningful for mode='train' "
                "(snapshots/restore/fault injection act on training state)")
        return
    if backend != "actors":
        if snapshot_dir is not None:
            raise ValueError(
                "snapshot_dir= requires backend='actors' (snapshots are "
                "written by per-stage snap actors; checkpoint a monolithic "
                "session with repro_torch.train.checkpoint)")
        if faults is not None:
            raise ValueError(
                "faults= requires backend='actors' (there are no workers "
                "or messages to inject faults into)")
    if snapshot_every < 1:
        raise ValueError(f"snapshot_every must be >= 1, got {snapshot_every}")
    if snapshot_dir is None and snapshot_every != 1:
        raise ValueError("snapshot_every= without snapshot_dir=")


def compile(model: Union[LogicalGraph, ModelConfig, str], *,
            mode: Optional[str] = None, backend: str = "actors",
            runtime: Optional[str] = None, plan: Optional[Plan] = None,
            partition: Optional[StagePartition] = None,
            stages: Optional[int] = None, num_microbatches: int = 1,
            microbatch_inputs: Optional[Sequence[str]] = None,
            regs=None, optimizer: Optional[OptimizerSpec] = None,
            params=None, loss=None, lr: float = 1e-2,
            mesh: Union[DeviceMesh, Placement, None] = None,
            stage_meshes: Optional[Sequence[DeviceMesh]] = None,
            device=None, seed: int = 0, timeout: float = 300.0,
            num_groups: Optional[int] = None,
            group_size: Optional[int] = None,
            cache_len: Optional[int] = None,
            max_prompt_len: Optional[int] = None,
            max_new_tokens: Optional[int] = None,
            cache: Optional[str] = None, page_len: Optional[int] = None,
            num_pages: Optional[int] = None,
            prefill_chunk: Optional[int] = None, sampling=None,
            zero: bool = False, precision=None, loss_scale=None,
            snapshot_dir=None, snapshot_every: int = 1, restore=None,
            faults=None, check: str = "static", **not_ported):
    """Compile a :class:`~repro_torch.core.graph.LogicalGraph` into a
    runnable :class:`Session` (``mode="infer"`` or ``"train"``), or a
    :class:`~repro_torch.configs.base.ModelConfig` (or ``--arch`` name) into
    a :class:`ServeSession` (``mode="serve"``). ``mode`` defaults to
    ``"infer"`` for a graph and ``"serve"`` for a model.

    Graph modes (everything omitted is inferred, as in the reference):

    * ``backend``: ``"actors"`` — stage programs driven by stage actors
      with register-quota back-pressure (§4.3); ``"monolithic"`` — one
      whole-graph program with identical microbatch semantics (the
      bit-identity reference). The monolithic backend accepts but does not
      use the schedule hints ``partition``, ``stages`` and ``regs``.
    * ``runtime`` (actors only, every mode): ``"threads"`` (the default)
      drives the actors on OS threads in this process; ``"processes"``
      spawns one worker process per actor node (stage ``s`` at node ``s +
      1``), which owns its stage's params, optimizer state or caches and
      lowers its stages from a picklable recipe
      (:mod:`repro_torch.runtime.recipes`); CUDA tensors cross by IPC. The
      optimizer's ``lr`` must then be a float or a module-level function
      (a lambda is refused here). Bitwise the threads runtime.
    * ``plan``: an SBP :class:`~repro_torch.core.planner.Plan`; default
      :func:`repro_torch.core.planner.plan`.
    * ``partition`` / ``stages``: an explicit stage partition, or a stage
      count for cost-balanced cutting; default: the graph's ``g.stage(k)``
      annotations.
    * ``num_microbatches`` / ``microbatch_inputs``: how the batch streams
      through the pipeline (``microbatch_inputs`` defaults to the non-param
      inputs in train mode).
    * ``regs``: per-stage out-register quotas — a list, a policy from
      :data:`REG_POLICIES`, or None for compile-time resource planning
      (:func:`repro_torch.runtime.pipeline.plan_registers`).
    * ``optimizer`` (train): an :class:`OptimizerSpec` (default SGD at
      ``lr``); ``params`` (train): ``{graph input name: initial value}``
      for every trainable input, placed on the ranks by its planned
      signature and owned by the session; ``loss``: the sink to
      differentiate (default: the sole sink).
    * ``mesh`` / ``stage_meshes``: one
      :class:`~repro_torch.core.mesh.DeviceMesh` of the graph placement's
      ranks for every stage (default ``graph.placement.to_mesh(device)``),
      or one per stage -- the same axes on other ranks, the paper's
      placement of each stage on its own device group (actors only). Runs
      and steps take global values and return global sinks, losses,
      gradients and params.
    * ``zero`` (train): keep the optimizer's float32 master params and
      AdamW moments as flat ``(dp, 1, chunk)`` shards over the placement's
      data axis (§6.4): the opt actors' register stream holds them, and the
      forward sees them gathered and cast to the compute dtype (the Fig-14
      ``cast`` before the gather). Needs AdamW and a data axis (one named
      ``"data"``, or a sole placement axis); bitwise the dense path.
    * ``precision`` (train): ``"bf16"``/``"bfloat16"`` runs forward and
      backward in bfloat16 over float32 masters (gradients accumulate in
      float32); ``"fp32"``/``"float32"`` keeps float32 compute over
      masters; or a :class:`~repro_torch.core.lowering.PrecisionPolicy`.
    * ``loss_scale`` (train, needs ``precision="bf16"``): a float seeds the
      backward with it (unscaled once after the float32 accumulation,
      exact for powers of two); ``"dynamic"`` adds the ``scale`` actor
      after ``norm``: a non-finite gradient norm skips the update and backs
      the scale off, ``growth_interval`` finite steps grow it. Steps then
      report ``loss_scale`` and ``skipped`` in their metrics.
    * ``snapshot_dir`` / ``snapshot_every`` (train + actors only): write an
      async snapshot every N steps -- one ``snap{s}`` actor per
      parameterized stage serializes its stage's params and optimizer
      state from its own thread, off the schedule's thread
      (:mod:`repro_torch.runtime.snapshot`, the reference's format).
    * ``restore`` (train only): a ``snapshot_dir`` from an earlier session
      (of either package); the newest *completed* snapshot there becomes
      the session's params, optimizer state, step counter and loss-scale
      trajectory. Partition-agnostic: a snapshot taken on 4 stages
      restores onto 2 stages, a mesh or the monolithic backend.
    * ``faults`` (train + actors only): a
      :class:`repro_torch.runtime.chaos.FaultPlan` injected into the
      runtime (kill a worker at an actor's Nth fire -- under processes a
      real ``os._exit`` of its worker process -- delay or duplicate a Req,
      drop an Ack), for kill-and-resume and chaos tests.

    Serve mode: ``backend`` ``"actors"`` cuts the stack into ``stages``
    stage programs (default ``min(2, units)``) with quotas ``regs`` (a list
    or a policy, ``"gpipe"`` admitting ``num_groups``; default 1F1B);
    ``"monolithic"`` runs the whole stack as one stage inline. ``params``
    is a :class:`~repro_torch.models.transformer.Transformer`, its
    ``state_dict``, or None for the port's seeded init (``seed``); the
    slot geometry options are the reference's, and so are ``cache``
    (``"dense"`` or ``"paged"``), ``page_len``, ``num_pages`` and
    ``prefill_chunk`` (paged only), and ``sampling`` (a
    :class:`repro_torch.serve.sampler.SamplingSpec`; None decodes
    greedily). ``mesh`` (a ``DeviceMesh`` or a
    :class:`~repro_torch.core.placement.Placement` over ``("data",
    "model")``) serves a dense GQA model on its ranks: heads, MLP units,
    vocabulary and the KV cache (by sequence) split over ``model``, each
    slot group's rows over ``data``; ``cache_len`` defaults to a multiple
    of the ``model`` size, and the paged cache takes only one device, as in
    the reference.

    ``device``: None means ``"cuda"`` (raises without a card); tests pass
    ``"cpu"``; a mesh brings its own ranks' devices.

    ``check="static"`` (the default, every mode, backend and runtime) runs
    the :mod:`repro_torch.analysis` plan verifier before anything fires --
    actor-graph deadlock freedom under the register quotas, SBP edge
    legality with no partial value leaking past a sink or a stage boundary,
    and the static per-device memory bound -- and raises
    :class:`repro_torch.analysis.AnalysisError` on a FAIL verdict (the
    offending cycle or edge is named); the report is ``static_report``, and
    ``describe()`` prints it. ``check="off"`` skips it (a SKIPPED report).
    The options in :data:`NOT_PORTED` raise naming their item.
    """
    _check_not_ported(not_ported)
    if mode is None:
        mode = "infer" if isinstance(model, LogicalGraph) else "serve"
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if check not in ("static", "off"):
        raise ValueError(
            f"unknown check {check!r}; expected 'static' (run the "
            "repro_torch.analysis plan verifier at compile time) or 'off'")
    if mode != "train" and (zero or precision is not None
                            or loss_scale is not None):
        raise ValueError(
            "zero=/precision=/loss_scale= are only meaningful for "
            "mode='train' (they shape the optimizer's master/moment state "
            "and the backward seed; nothing is updated in other modes)")
    _check_snapshot_options(mode, backend, snapshot_dir, snapshot_every,
                            restore, faults)
    if runtime is not None and runtime not in RUNTIME_KINDS:
        raise ValueError(f"unknown runtime {runtime!r}; expected one of "
                         f"{RUNTIME_KINDS}")
    if backend == "monolithic" and runtime is not None:
        raise ValueError("runtime= requires backend='actors'")
    if backend == "actors" and runtime is None:
        runtime = "threads"
    if mode == "serve":
        rejected = {"stage_meshes": stage_meshes, "plan": plan,
                    "partition": partition,
                    "optimizer": optimizer, "loss": loss,
                    "microbatch_inputs": microbatch_inputs}
        bad = [k for k, v in rejected.items() if v is not None]
        if bad or num_microbatches != 1:
            bad = bad or ["num_microbatches"]
            raise ValueError(
                f"{bad[0]}= is not meaningful for mode='serve' (serving "
                "compiles a ModelConfig on one mesh; schedule, optimizer "
                "and per-stage mesh options belong to graph modes)")
        return _compile_serve(
            model, backend=backend, runtime=runtime, stages=stages,
            regs=regs, params=params,
            mesh=mesh, device=device, seed=seed, timeout=timeout,
            num_groups=num_groups, group_size=group_size, cache_len=cache_len,
            max_prompt_len=max_prompt_len, max_new_tokens=max_new_tokens,
            cache=cache, page_len=page_len, num_pages=num_pages,
            prefill_chunk=prefill_chunk, sampling=sampling, check=check)
    serve_only = {"num_groups": num_groups, "group_size": group_size,
                  "cache_len": cache_len, "max_prompt_len": max_prompt_len,
                  "max_new_tokens": max_new_tokens, "cache": cache,
                  "page_len": page_len, "num_pages": num_pages,
                  "prefill_chunk": prefill_chunk, "sampling": sampling}
    bad = [k for k, v in serve_only.items() if v is not None]
    if bad:
        raise ValueError(f"{bad[0]}= is only meaningful for mode='serve'")
    if not isinstance(model, LogicalGraph):
        raise ValueError(
            f"mode={mode!r} compiles a LogicalGraph, got "
            f"{type(model).__name__} (a model trains through "
            "repro_torch.train.steps.make_train_step)")
    graph = model
    if num_microbatches < 1:
        raise ValueError(
            f"num_microbatches must be >= 1, got {num_microbatches}")
    if mode == "infer":
        for name, v, why in (
                ("optimizer", optimizer, "inference sessions never update "
                 "params"),
                ("params", params, "inference sessions take every graph "
                 "input at run() time"),
                ("loss", loss, "nothing is differentiated in inference")):
            if v is not None:
                raise ValueError(
                    f"{name}= is only meaningful for mode='train' ({why})")
    else:
        if params is None:
            raise ValueError(
                "mode='train' requires params= "
                "({graph input name: initial value})")
        params = _canonical_params(graph, params)
        if optimizer is None:
            optimizer = OptimizerSpec.sgd(lr)
        optimizer = _fold_precision_options(graph, optimizer, params,
                                            zero=zero, precision=precision,
                                            loss_scale=loss_scale)
    if plan is None:
        plan = plan_sbp(graph)
    if stage_meshes is not None:
        if backend == "monolithic":
            raise ValueError("stage_meshes requires backend='actors' (the "
                             "monolithic program runs on one mesh)")
        if mesh is not None:
            raise ValueError("pass mesh= or stage_meshes=, not both")
        stage_meshes = [_resolve_mesh(graph, m, device) for m in stage_meshes]
        dev = stage_meshes[0].devices[0]
    else:
        # the default mesh's collectives wait as long as the session does
        mesh = (graph.placement.to_mesh(resolve_device(device),
                                        timeout=timeout) if mesh is None
                else _resolve_mesh(graph, mesh, device))
        dev = mesh.devices[0]

    input_names = [t.name for t in graph.inputs]
    if microbatch_inputs is None:
        if mode == "train":
            microbatch_inputs = [n for n in input_names if n not in params]
        elif num_microbatches > 1:
            raise ValueError(
                "num_microbatches > 1 needs microbatch_inputs= naming the "
                "graph inputs to split along axis 0")
        else:
            microbatch_inputs = []
    microbatch_inputs = list(microbatch_inputs)
    for n in microbatch_inputs:
        if n not in input_names:
            raise ValueError(f"{n} is not a graph input")

    common = dict(graph=graph, mode=mode, backend=backend, plan=plan,
                  optimizer=optimizer, microbatch_inputs=microbatch_inputs,
                  num_microbatches=num_microbatches, device=dev,
                  timeout=timeout, meshes=stage_meshes or [mesh])
    if backend == "monolithic":
        if mode == "infer":
            engine = _MonolithicInferEngine(graph, plan, microbatch_inputs,
                                            num_microbatches, mesh)
        else:
            engine = _MonolithicTrainEngine(graph, plan, params,
                                            microbatch_inputs,
                                            num_microbatches, optimizer,
                                            mesh, loss=loss)
        sess = Session(engine=engine, partition=None, regs=None,
                       reg_plan=None, **common)
        return _apply_restore(_attach_static_report(sess, check), restore)

    part = _resolve_partition(graph, partition, stages)
    regs, reg_plan = _resolve_regs(regs, part, num_microbatches, mode)
    meshes = dict(mesh=mesh, stage_meshes=stage_meshes)
    # under processes the workers lower again from data: the graph, plan,
    # partition and each mesh as a MeshSpec
    recipe_meshes = dict(
        mesh=MeshSpec.capture(mesh), device=str(dev),
        stage_meshes=None if stage_meshes is None else tuple(
            MeshSpec.capture(m) for m in stage_meshes))
    if mode == "infer":
        staged = lower_stages(graph, plan, part, **meshes)
        recipe = (InferRecipe(graph, plan, part, **recipe_meshes)
                  if runtime == "processes" else None)
        engine = ActorPipelineExecutor(staged, microbatch_inputs,
                                       num_microbatches, regs=regs,
                                       runtime=runtime, recipe=recipe)
    else:
        tstaged = lower_train_stages(graph, plan, part, list(params),
                                     loss=loss, optimizer=optimizer,
                                     **meshes)
        recipe = (TrainRecipe(graph, plan, part, list(params), loss=loss,
                              optimizer=optimizer, **recipe_meshes)
                  if runtime == "processes" else None)
        engine = TrainPipelineExecutor(tstaged, params, microbatch_inputs,
                                       num_microbatches, lr=lr, regs=regs,
                                       optimizer=optimizer, runtime=runtime,
                                       recipe=recipe,
                                       snapshot_dir=snapshot_dir,
                                       snapshot_every=snapshot_every,
                                       faults=faults)
    sess = Session(engine=engine, partition=part, regs=regs,
                   reg_plan=reg_plan, runtime=runtime, **common)
    return _apply_restore(_attach_static_report(sess, check), restore)


def _serve_mesh(mesh, device, timeout: float) -> Optional[DeviceMesh]:
    """The serve session's mesh: a ``DeviceMesh`` as given, a
    ``Placement``'s ranks on ``device`` (None: the card) waiting as long
    as the session does at a collective, or None for one device."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(mesh, Placement):
        return mesh.to_mesh(resolve_device(device), timeout=timeout)
    raise ValueError("mesh= takes a DeviceMesh or a Placement, got "
                     f"{type(mesh).__name__}")


def _compile_serve(model, *, backend: str, runtime: Optional[str],
                   stages: Optional[int], regs, params, mesh, device,
                   seed: int, timeout: float,
                   num_groups,
                   group_size, cache_len, max_prompt_len, max_new_tokens,
                   cache, page_len, num_pages, prefill_chunk,
                   sampling, check: str = "static") -> ServeSession:
    if isinstance(model, str):
        from repro_torch.configs.registry import get_config
        model = get_config(model)
    if not isinstance(model, ModelConfig):
        raise ValueError("mode='serve' compiles a ModelConfig (or an --arch "
                         f"name), got {type(model).__name__}")
    cfg = model
    check_token_frontend(cfg)   # before a model is built
    mesh = _serve_mesh(mesh, device, timeout)
    dev = resolve_device(device) if mesh is None else mesh.devices[0]
    plan = MeshPlan.single_device() if mesh is None else MeshPlan.of(mesh)
    check_mesh_supported(cfg, plan)
    (num_groups, group_size, cache_len, max_prompt_len, max_new_tokens,
     cache, cache_spec) = _serve_options(
        num_groups=num_groups, group_size=group_size, cache_len=cache_len,
        max_prompt_len=max_prompt_len, max_new_tokens=max_new_tokens,
        cache=cache, page_len=page_len, num_pages=num_pages,
        sampling=sampling, prefill_chunk=prefill_chunk, tp=plan.tp)
    if cache == "paged" and not plan.is_single:
        raise ValueError(
            "cache='paged' requires a 1x1 mesh (the page gather/scatter "
            f"programs are single-device); got dp={plan.dp}, tp={plan.tp}")

    lay = stack_layout(cfg)
    n_units = len(lay.prologue) + lay.n_periods
    if backend == "monolithic":
        if stages not in (None, 1):
            raise ValueError("backend='monolithic' serves the whole stack "
                             "as one stage; use backend='actors' for "
                             f"stages={stages}")
        stages = 1
    elif stages is None:
        stages = min(2, n_units)
    if isinstance(regs, str):
        regs = _policy_regs(regs, stages, num_groups)

    loaded = _load_model(cfg, params, seed, dev, plan)
    sstaged = lower_serve_stages(
        cfg, loaded, num_stages=stages, cache_len=cache_len,
        max_prompt_len=max_prompt_len, group_size=group_size, mesh=mesh)
    # shared-prefix pages assume a prompt prefix's cache values do not
    # depend on its suffix: true of causal attention and SSM stacks, not
    # under MoE capacity routing (expert drop counts see the whole prompt)
    share_prefix = cache == "paged" and cfg.num_experts == 0
    if backend == "monolithic":
        engine = InlineServeEngine(sstaged, cache_spec=cache_spec,
                                   sampling=sampling)
    else:
        # under processes each worker lowers the stages again from the
        # model itself (its tensors mapped, not copied) and the mesh as data
        recipe = (ServeRecipe(cfg, loaded, num_stages=stages,
                              cache_len=cache_len,
                              max_prompt_len=max_prompt_len,
                              group_size=group_size,
                              mesh=MeshSpec.capture(mesh), device=str(dev))
                  if runtime == "processes" else None)
        engine = ServePipelineExecutor(sstaged, regs=regs, runtime=runtime,
                                       cache_spec=cache_spec,
                                       sampling=sampling, recipe=recipe)
    sess = ServeSession(cfg=cfg, backend=backend, engine=engine,
                        sstaged=sstaged, num_groups=num_groups,
                        group_size=group_size, cache_len=cache_len,
                        max_prompt_len=max_prompt_len,
                        max_new_tokens=max_new_tokens, device=dev,
                        timeout=timeout, runtime=runtime, cache=cache,
                        cache_spec=cache_spec, sampling=sampling,
                        prefill_chunk=prefill_chunk,
                        share_prefix=share_prefix)
    return _attach_static_report(sess, check)


def _assert_tree_equal(name: str, a, b, context: str) -> None:
    a = torch.as_tensor(a).detach()
    b = torch.as_tensor(b).detach().to(a.device)
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        diff = ""
        if a.shape == b.shape and a.dtype == b.dtype:
            delta = (a.double() - b.double()).abs().max().item()
            diff = f" (max abs diff {delta:g})"
        raise AssertionError(
            f"sessions disagree on {name} at {context}: "
            f"{a.dtype}{list(a.shape)} vs {b.dtype}{list(b.shape)}{diff}")


def assert_sessions_match(a: Session, b: Session, inputs: Dict[str, Any],
                          steps: int = 1) -> None:
    """Bit-identity check between two sessions compiled from the same graph
    (typically ``backend="actors"`` vs ``backend="monolithic"``).

    Inference sessions: run both on ``inputs`` and compare every sink
    bitwise. Training sessions: step both ``steps`` times on the same batch
    and compare loss, post-clip grads, updated params, and (when stateful)
    the merged optimizer state after every step. Raises ``AssertionError``
    naming the first mismatching tensor.
    """
    if a.mode != b.mode:
        raise ValueError(f"cannot compare mode={a.mode!r} with {b.mode!r}")
    if a.mode == "infer":
        ra, rb = a.run(**inputs), b.run(**inputs)
        for name in ra:
            _assert_tree_equal(f"sink {name!r}", ra[name], rb[name], "run")
        return
    for k in range(steps):
        sa, sb = a.step(**inputs), b.step(**inputs)
        ctx = f"step {k}"
        _assert_tree_equal("loss", sa.loss, sb.loss, ctx)
        for n in sa.grads:
            _assert_tree_equal(f"grad {n!r}", sa.grads[n], sb.grads[n], ctx)
        for n in sa.params:
            _assert_tree_equal(f"param {n!r}", sa.params[n], sb.params[n],
                               ctx)
        oa, ob = a.opt_state, b.opt_state
        if (oa is None) != (ob is None):
            raise AssertionError(
                f"sessions disagree on opt_state presence at {ctx}")
        if oa is not None:
            if int(oa.step) != int(ob.step):
                raise AssertionError(
                    f"opt_state.step differs at {ctx}: "
                    f"{int(oa.step)} vs {int(ob.step)}")
            for n in oa.mu:
                _assert_tree_equal(f"opt mu {n!r}", oa.mu[n], ob.mu[n], ctx)
                _assert_tree_equal(f"opt nu {n!r}", oa.nu[n], ob.nu[n], ctx)
