"""Pipeline-parallel schedules from register quotas (paper §4.3, §6.5).

Port of ``repro/runtime/pipeline.py`` on the threaded runtime. The paper's
key observation: a synchronous pipeline schedule is not a special scheduler
— it *emerges* from out-register quotas. A stage's forward actor output
register is referenced by BOTH the next stage's forward AND this stage's
backward (the stashed activations); it is recycled only when both have
acked. Capping the quota at ``R`` bounds in-flight microbatches to ``R``:

* ``R = num_microbatches``  -> GPipe-style all-forward-then-backward memory;
* ``R = num_stages - stage``-> 1F1B steady state (Megatron's schedule);
* ``R = 1``                 -> fully serialized (no pipelining).

:func:`pipeline_specs` builds the simulated actor graph; :func:`plan_registers`
is the compile-time resource planner: it simulates quotas and picks the
smallest one within ``tolerance`` of the best makespan (§2.3).

Three executors then run lowered programs under that protocol:

* :class:`ActorPipelineExecutor` — forward-only pipelines over the stage
  programs of :func:`repro_torch.core.lowering.lower_stages`;
* :class:`TrainPipelineExecutor` — training pipelines over
  :func:`repro_torch.core.lowering.lower_train_stages`: forward actors
  stash their op tape in the out register the *backward* actor also
  references, backward actors flow cotangents up the chain, accumulation
  actors (``emit_every``) sum per-microbatch gradients, and optimizer
  actors fire once per step;
* :class:`ServePipelineExecutor` — continuous-batching decode with
  per-stage caches as actor-local state (``:1420-1766`` of the reference).

Every executor builds its actor graph ONCE and re-runs it per
run/step/round (one epoch each), with per-epoch inputs in ``ctx`` and fire
bounds in ``fires``. Stage ``s`` is addressed at node ``s + 1``. A stage runs
on its mesh's ranks (:mod:`repro_torch.core.mesh`), so every value a graph
executor carries between actors is a per-rank list of shards; a stage on
other ranks than the one before it relays what it receives onto its own
(:func:`repro_torch.core.lowering.relay`). The executor places global inputs
by their planned signatures and assembles global sinks, losses, gradients
and params. On one card all stages and ranks share one CUDA stream in this
version, and each stage synchronises it before handing its output on (the
reference's ``block_until_ready``), which is what the makespan
instrumentation reads.
Per-stage streams with events are later work (ROADMAP Queue 1 item 3). The
training pipeline writes async snapshots from ``snap{s}`` actors
(:mod:`repro_torch.runtime.snapshot`), restores them (``load_state``) and
takes a fault plan (:mod:`repro_torch.runtime.chaos`). Not ported:
``fn_wrap`` (item 14).

Every executor runs on ``runtime="threads"`` or ``"processes"``: under
the latter each node is a worker process
(:mod:`repro_torch.runtime.process`) that lowers its stages from the
executor's picklable recipe (:mod:`repro_torch.runtime.recipes`), so stage
``s``'s params, optimizer state and caches live in that process; payloads
cross stages as tensors (CUDA IPC on a card) while same-node registers stay
in-process, and the ``"__"`` keys of a payload (the op tape, a stage's
gradients, ZeRO's flat masters) never leave their node.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lowering import (OptimizerSpec, accumulate, box_grads,
                                       grad_sqnorms, loss_scale_update,
                                       opt_state_bytes, rank_compute,
                                       rank_masters, rank_opt_state,
                                       rank_states, reassemble_sinks, relay,
                                       split_microbatches, sync_mesh)
from repro_torch.core.mesh import assemble, place
from repro_torch.optim.adamw import (clip_scale, global_norm_from_partials,
                                     scale_grad)
from repro_torch.optim.zero import ZeroState
from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.base import RUNTIME_KINDS, WorkerError, make_runtime
from repro_torch.runtime.scheduler import CommModel, simulate


def _validate_regs(regs: Sequence[int], num_stages: int,
                   num_microbatches: Optional[int] = None) -> List[int]:
    """Reject bad quota lists up front: a zero/negative quota would deadlock
    (or be silently rewritten), so fail fast naming the offending stage and
    the minimal feasible quota vector."""
    regs = list(regs)
    if len(regs) != num_stages:
        raise ValueError(f"need {num_stages} register quotas, got {len(regs)}")
    for s, r in enumerate(regs):
        if r < 1:
            from repro_torch.analysis.deadlock import min_feasible_stage_regs
            feasible = min_feasible_stage_regs(num_stages, num_microbatches)
            raise ValueError(
                f"stage {s} register quota must be >= 1, got {r} "
                f"(regs={regs}); minimal feasible quotas for "
                f"{num_stages} stages: {feasible}")
    return regs


def pipeline_specs(num_stages: int, num_microbatches: int,
                   fwd_time: float = 1.0, bwd_time: float = 2.0,
                   regs: Optional[Sequence[int]] = None,
                   act_nbytes: int = 1 << 20) -> List[ActorSpec]:
    """Actor graph for a synchronous fwd/bwd pipeline over ``num_stages``
    devices. ``regs[s]`` is stage s's activation register quota."""
    if regs is None:
        regs = [num_stages - s for s in range(num_stages)]  # 1F1B default
    regs = _validate_regs(regs, num_stages, num_microbatches)
    specs: List[ActorSpec] = []
    specs.append(ActorSpec(
        name="data", fn=lambda *a: 0, inputs=(), out_regs=2,
        node=0, thread=0, duration=fwd_time * 0.1,
        max_fires=num_microbatches, out_nbytes=act_nbytes))
    for s in range(num_stages):
        fwd_in = "data" if s == 0 else f"f{s-1}"
        # forward actor on device/thread s
        specs.append(ActorSpec(
            name=f"f{s}", fn=lambda *a: 0, inputs=(fwd_in,),
            out_regs=regs[s], node=0, thread=s + 1,
            duration=fwd_time, max_fires=num_microbatches,
            out_nbytes=act_nbytes))
    for s in reversed(range(num_stages)):
        # backward actor: consumes stashed activation f{s} and upstream grad
        ins = (f"f{s}",) if s == num_stages - 1 else (f"f{s}", f"b{s+1}")
        specs.append(ActorSpec(
            name=f"b{s}", fn=lambda *a: 0, inputs=ins,
            out_regs=2, node=0, thread=s + 1,
            duration=bwd_time, max_fires=num_microbatches,
            out_nbytes=act_nbytes))
    # optimizer actor per stage consuming the gradient stream
    for s in range(num_stages):
        specs.append(ActorSpec(
            name=f"opt{s}", fn=lambda *a: 0, inputs=(f"b{s}",),
            out_regs=1, node=0, thread=s + 1, duration=0.01,
            max_fires=num_microbatches))
    return specs


@dataclasses.dataclass
class PipelinePlan:
    """Result of simulating one register-quota choice: the quota itself, the
    simulated makespan, per-stage peak activation registers actually used,
    and the pipeline-bubble fraction (idle time vs the ideal makespan)."""

    regs: List[int]
    makespan: float
    peak_activation_regs: Dict[str, int]
    bubble_fraction: float


def analyze(num_stages: int, num_microbatches: int, regs: Sequence[int],
            fwd_time: float = 1.0, bwd_time: float = 2.0) -> PipelinePlan:
    """Simulate the fwd/bwd pipeline under quota ``regs`` and summarize it
    as a :class:`PipelinePlan`. Raises if the quota deadlocks the graph."""
    specs = pipeline_specs(num_stages, num_microbatches, fwd_time, bwd_time,
                           list(regs))
    res = simulate(specs, comm=CommModel(same_node=0.0, cross_node_latency=0.0))
    if res.deadlocked:
        raise RuntimeError(f"pipeline deadlocked with regs={list(regs)}")
    ideal = num_microbatches * (fwd_time + bwd_time)
    bubble = 1.0 - ideal / res.makespan if res.makespan > 0 else 0.0
    return PipelinePlan(
        regs=list(regs), makespan=res.makespan,
        peak_activation_regs={f"f{s}": res.peak_regs[f"f{s}"]
                              for s in range(num_stages)},
        bubble_fraction=max(0.0, bubble))


def plan_registers(num_stages: int, num_microbatches: int,
                   fwd_time: float = 1.0, bwd_time: float = 2.0,
                   tolerance: float = 0.02) -> PipelinePlan:
    """Compile-time resource planning: smallest uniform quota whose makespan
    is within ``tolerance`` of the best observed — memory saved for free."""
    best: Optional[PipelinePlan] = None
    plans = []
    for r in range(1, num_microbatches + 1):
        p = analyze(num_stages, num_microbatches, [r] * num_stages,
                    fwd_time, bwd_time)
        plans.append(p)
        if best is None or p.makespan < best.makespan:
            best = p
        if r >= num_stages and p.makespan <= best.makespan * (1 + 1e-9):
            break  # saturated: more registers cannot help
    target = best.makespan * (1 + tolerance)
    for p in plans:
        if p.makespan <= target:
            return p
    return best


def check_run_inputs(provided, expected, what: str = "input",
                     owned: Sequence[str] = ()) -> None:
    """Fail fast with the offending key when a run/step input dict has
    unknown or missing names, instead of failing deep inside an actor body.

    ``expected`` are the names the caller must provide; ``owned`` are names
    the executor itself supplies (trainable params) — passing one of those is
    reported as such rather than as merely "unknown".
    """
    expected = set(expected)
    owned = set(owned)
    provided = set(provided)
    shadowed = sorted(provided & owned)
    if shadowed:
        raise ValueError(
            f"{what} {shadowed[0]!r} is a trainable param owned by the "
            f"executor; pass only data inputs (expected: {sorted(expected)})")
    unknown = sorted(provided - expected)
    if unknown:
        more = f" (+{len(unknown) - 1} more)" if len(unknown) > 1 else ""
        raise ValueError(
            f"unknown {what} {unknown[0]!r}{more}; "
            f"expected {what}s: {sorted(expected)}")
    missing = sorted(expected - provided)
    if missing:
        more = f" (+{len(missing) - 1} more)" if len(missing) > 1 else ""
        raise ValueError(
            f"missing {what} {missing[0]!r}{more}; "
            f"expected {what}s: {sorted(expected)}")


def serve_regs(num_stages: int) -> List[int]:
    """The stage out-register quotas: the 1F1B rule ``max(1, S - s)``,
    under which quota back-pressure alone bounds the groups in flight."""
    return [max(1, num_stages - s) for s in range(num_stages)]


class _SpecBuilderBase:
    """Base of the picklable spec builders the executors hand to
    :func:`repro_torch.runtime.base.make_runtime`.

    Carries an already-lowered program (``staged``, process-local: what
    ``runtime="threads"`` runs, and what the driver of a process runtime
    reads its actor graph from) and/or a lowering recipe
    (:mod:`repro_torch.runtime.recipes`, data). Pickling for a worker
    process drops the lowered program and ships the recipe; the worker
    lowers again on arrival.
    """

    def __init__(self, staged=None, recipe=None):
        if staged is None and recipe is None:
            raise ValueError("spec builder needs a lowered program or a "
                             "lowering recipe")
        self._staged = staged
        self.recipe = recipe

    @property
    def staged(self):
        if self._staged is None:
            self._staged = self.recipe.lower()
        return self._staged

    def __getstate__(self):
        if self.recipe is None:
            raise ValueError(
                "this spec builder carries only a process-local lowered "
                "program; runtime='processes' needs a lowering recipe "
                "(repro_torch.runtime.recipes) -- compile through "
                "repro_torch.api")
        state = dict(self.__dict__)
        state["_staged"] = None      # workers lower again from the recipe
        return state


class _StagedExecutorBase:
    """Shared machinery of the stage-pipeline executors: construction-time
    validation (runtime kind; under ``runtime="processes"`` a picklable
    ``recipe``) and the persistent runtime underneath — built ONCE from the
    spec builder on first use and re-run per round (one epoch each), with
    the optional fault plan ``faults`` (:mod:`repro_torch.runtime.chaos`)
    injected into it. Per-run instrumentation (``last_makespan``,
    ``last_history``, ``last_peak_regs``, ``last_edge_bytes``) snapshots
    the most recent epoch."""

    def __init__(self, runtime: str = "threads", faults=None, recipe=None):
        if runtime not in RUNTIME_KINDS:
            raise ValueError(f"unknown runtime {runtime!r}; expected one of "
                             f"{RUNTIME_KINDS}")
        if runtime == "processes":
            if recipe is None:
                raise ValueError(
                    "runtime='processes' needs a picklable lowering recipe "
                    "(repro_torch.runtime.recipes) -- compile through "
                    "repro_torch.api, or pass recipe=")
            from repro_torch.runtime.process import check_picklable
            check_picklable(recipe, "lowering recipe")
        self.runtime_kind = runtime
        self.recipe = recipe
        self.faults = faults
        # optional repro_torch.analysis.trace.TraceRecorder -- set before
        # the first run; the threads runtime logs every Req delivery into
        # it so repro_torch.analysis.trace.check_trace can certify the
        # resequencer
        self.trace = None
        self._rt = None
        self.last_makespan: Optional[float] = None
        self.last_history: Dict[str, List[Tuple[float, float]]] = {}
        self.last_peak_regs: Dict[str, int] = {}
        self.last_edge_bytes: Dict[Tuple[str, str], int] = {}

    def _make_builder(self):
        raise NotImplementedError

    @property
    def runtime(self):
        """The persistent runtime underneath (built on first use)."""
        if self._rt is None:
            self._rt = make_runtime(self.runtime_kind, self._make_builder(),
                                    faults=self.faults, trace=self.trace)
        return self._rt

    def _run_rt(self, ctx, fires, timeout: float):
        rt = self.runtime
        t0 = time.perf_counter()
        outs = rt.run(ctx=ctx, fires=fires, timeout=timeout)
        self.last_makespan = time.perf_counter() - t0
        self.last_history = dict(rt.last_history)
        self.last_peak_regs = dict(rt.last_peak_regs)
        self.last_edge_bytes = dict(rt.last_edge_bytes)
        return outs

    def close(self) -> None:
        """Release the runtime's workers; rebuilt lazily if used again."""
        if self._rt is not None:
            self._rt.close()
            self._rt = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# Actor-driven execution of lowered graph stage programs (compiler ∘
# runtime). One actor per stage, at node s + 1; microbatch payloads flow
# through Req.payload as {tensor name: value} dicts along the stage chain;
# out-register quotas alone bound in-flight microbatches, so 1F1B-style
# overlap *emerges* (§4.3) instead of being scheduled explicitly.
# ---------------------------------------------------------------------------

class _GraphExecutorBase(_StagedExecutorBase):
    """Construction-time validation shared by the graph executors:
    microbatch count, register-quota length and values, and microbatch
    input names."""

    def __init__(self, program, microbatch_inputs: Sequence[str],
                 num_microbatches: int, regs: Optional[Sequence[int]],
                 runtime: str = "threads", faults=None, recipe=None):
        super().__init__(runtime=runtime, faults=faults, recipe=recipe)
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        if regs is not None:
            regs = _validate_regs(regs, program.num_stages, num_microbatches)
        for n in microbatch_inputs:
            if n not in program.input_names:
                raise ValueError(f"{n} is not a graph input")
        self.microbatch_inputs = list(microbatch_inputs)
        self.num_microbatches = num_microbatches
        self.regs = regs
        self.program = program

    def _microbatch_payloads(self, inputs: Dict[str, Any]) -> List[Dict]:
        """The microbatch chunks of ``inputs``, each placed by its planned
        signature on the first stage's ranks (later stages relay them)."""
        mesh, sbp = self.program.stages[0].mesh, self.program.plan.tensor_sbp
        return [{n: place(v, mesh, sbp[n]) for n, v in chunk.items()}
                for chunk in split_microbatches(
                    inputs, self.microbatch_inputs, self.num_microbatches)]


def _prev_mesh(staged, stage):
    """The mesh a stage's streamed inputs arrive on: the previous stage's
    (the first stage's own for the data source, which places there)."""
    return staged.stages[max(stage.index - 1, 0)].mesh


def _place_incoming(input_names, bound: Dict[str, Any],
                    payload: Dict[str, Any]) -> List[Any]:
    """Assemble a stage's positional inputs: bound values as they are,
    streamed payload entries from the microbatch payload. Shared by the
    forward-only and the training pipelines."""
    return [bound[n] if n in bound else payload[n] for n in input_names]


def _stage_binding():
    """Persistent bound-input state for one stage actor: a ``bound`` dict
    the closures read at fire time and an ``on_epoch`` hook that (re)binds
    the values the executor sent in ``ctx`` -- already placed on the stage's
    ranks, where the weights then stay between epochs."""
    bound: Dict[str, Any] = {}

    def on_epoch(raw):
        if raw:
            bound.update(raw)
    return bound, on_epoch


def _payload_source_spec(name: str, max_fires: int) -> ActorSpec:
    """The streaming source actor: emits one pre-split payload dict per
    version. The payload list is per-epoch state, delivered via ``ctx``."""
    cell: Dict[str, Any] = {"payloads": []}

    def on_epoch(v):
        if v is not None:
            cell["payloads"] = list(v)

    return ActorSpec(
        name=name, fn=lambda version: cell["payloads"][version], inputs=(),
        out_regs=2, node=0, thread=0, max_fires=max_fires,
        wants_version=True, on_epoch=on_epoch)


def _forward_carry(staged, mb_names: Sequence[str]) -> List[set]:
    """``needed_after[s]``: the payload entries a stage at or after ``s``
    reads (microbatched inputs and boundary tensors), so stage ``s - 1``
    forwards them on."""
    graph_inputs = set(staged.input_names)
    S = staged.num_stages
    needed_after: List[set] = [set() for _ in range(S + 1)]
    for s in reversed(range(S)):
        payload_borne = {n for n in staged.stages[s].input_names
                         if n in mb_names or n not in graph_inputs}
        needed_after[s] = needed_after[s + 1] | payload_borne
    return needed_after


def stage_actor_specs(staged, microbatch_inputs: Sequence[str],
                      num_microbatches: int,
                      regs: Optional[Sequence[int]] = None,
                      ) -> Tuple[List[ActorSpec], str]:
    """Build the persistent actor graph executing ``staged`` (a
    :class:`repro_torch.core.lowering.StagedProgram`) over microbatches.

    Each run's inputs arrive via ``ctx``: ``ctx["data"]`` is the pre-split
    microbatch payload list (one dict per version), ``ctx[f"stage{s}"]``
    the stage's non-streamed graph inputs (weights), all placed on the
    ranks. ``regs[s]`` is stage
    s's out-register quota (default 1F1B, ``max(1, S - s)``). Stage ``s``
    lives at node ``s + 1`` (the data source at node 0). Each body runs
    under ``torch.inference_mode()`` (grad mode is per thread) and waits
    for the card before handing its outputs on.

    Returns ``(specs, final_stage_name)``."""
    S = staged.num_stages
    if regs is None:
        regs = [max(1, S - s) for s in range(S)]
    regs = _validate_regs(regs, S, num_microbatches)
    mb_names = list(microbatch_inputs)
    for n in mb_names:
        if n not in staged.input_names:
            raise ValueError(f"{n} is not a graph input")
    needed_after = _forward_carry(staged, mb_names)
    sink_names = {t.name for t in staged.sinks}

    specs: List[ActorSpec] = [_payload_source_spec("data", num_microbatches)]

    def make_stage_fn(stage):
        bound, on_epoch = _stage_binding()
        prev = _prev_mesh(staged, stage)

        def run_stage(payload):
            payload = {n: relay(v, prev, stage.mesh)
                       for n, v in payload.items()}
            with torch.inference_mode():
                outs = stage.fn(*_place_incoming(stage.input_names, bound,
                                                 payload))
                sync_mesh(stage.mesh)
            carried = {n: v for n, v in payload.items()
                       if n in needed_after[stage.index + 1]
                       or n in sink_names}
            carried.update(zip(stage.output_names, outs))
            return carried
        return run_stage, on_epoch

    for s, stage in enumerate(staged.stages):
        fn, on_epoch = make_stage_fn(stage)
        specs.append(ActorSpec(
            name=f"stage{s}", fn=fn,
            inputs=("data",) if s == 0 else (f"stage{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0,
            max_fires=num_microbatches, on_epoch=on_epoch))
    return specs, f"stage{S - 1}"


class InferSpecBuilder(_SpecBuilderBase):
    """Builder of the forward-pipeline actor graph."""

    def __init__(self, staged, microbatch_inputs: Sequence[str],
                 num_microbatches: int, regs=None, recipe=None):
        super().__init__(staged, recipe)
        self.microbatch_inputs = list(microbatch_inputs)
        self.num_microbatches = num_microbatches
        self.regs = None if regs is None else list(regs)

    def __call__(self):
        return stage_actor_specs(self.staged, self.microbatch_inputs,
                                 self.num_microbatches, regs=self.regs)


class ActorPipelineExecutor(_GraphExecutorBase):
    """Run a :class:`repro_torch.core.lowering.StagedProgram` on the actor
    runtime.

    The actor graph is built once; each :meth:`run` is one epoch over it:
    the pre-split microbatch payloads and the per-stage bound inputs
    (weights) travel in ``ctx``, ``num_microbatches`` chunks stream through
    the stage chain, and the graph sinks are reassembled by concatenating
    per-microbatch results along axis 0. ``last_makespan`` /
    ``last_history`` expose the wall-clock schedule of the most recent run.
    """

    def __init__(self, staged, microbatch_inputs: Sequence[str],
                 num_microbatches: int, regs: Optional[Sequence[int]] = None,
                 runtime: str = "threads", recipe=None):
        super().__init__(staged, microbatch_inputs, num_microbatches, regs,
                         runtime=runtime, recipe=recipe)
        self.staged = staged

    def _make_builder(self):
        return InferSpecBuilder(self.staged, self.microbatch_inputs,
                                self.num_microbatches, regs=self.regs,
                                recipe=self.recipe)

    def run(self, inputs: Dict[str, Any], timeout: float = 300.0) -> Tuple:
        check_run_inputs(inputs, self.staged.input_names)
        graph_inputs = set(self.staged.input_names)
        mb = set(self.microbatch_inputs)
        ctx: Dict[str, Any] = {"data": self._microbatch_payloads(inputs)}
        for stage in self.staged.stages:
            ctx[f"stage{stage.index}"] = {
                n: stage.place(n, inputs[n]) for n in stage.input_names
                if n in graph_inputs and n not in mb}
        outs = self._run_rt(ctx, None, timeout)
        if len(outs) != self.num_microbatches:
            raise RuntimeError(
                f"collected {len(outs)} microbatch results, expected "
                f"{self.num_microbatches}")
        # the final stage fires in version order in one worker, so ``outs``
        # is already microbatch-ordered; every sink rides to its mesh
        last, sbp = self.staged.stages[-1].mesh, self.staged.boundary_sbp
        per_chunk = [{t.name: assemble(o[t.name], last, sbp[t.name])
                      for t in self.staged.sinks} for o in outs]
        return reassemble_sinks(self.staged.graph, self.staged.sinks,
                                self.microbatch_inputs, per_chunk)


# ---------------------------------------------------------------------------
# Training pipelines: backward + optimizer actors.
#
# One microbatch's journey: data -> f0 -> ... -> f{S-1} -> b{S-1} -> ... ->
# b0, with acc{s} summing each stage's per-microbatch gradients (OneFlow's
# `acc` op, via ActorSpec.emit_every) and opt{s} firing exactly once per step
# on the summed gradient. Stage s's forward out register holds BOTH the
# boundary activations for f{s+1} AND the op tape (the activations) for
# b{s}; it is recycled only when both have acked — capping that quota at
# R[s] = S - s is all it takes for the 1F1B schedule to emerge.
#
# Stage s's actors (f, b, acc, opt, state) all live at node s+1, one worker
# mailbox — so the stage's params, optimizer state and gradient accumulator
# are node-local closure state, updated in place by the opt actor and never
# shipped between steps.
# ---------------------------------------------------------------------------

_TAPE_KEY = "__tape__"
_GRADS_KEY = "__grads__"
#: the opt payload's same-node entry for snap{s} under ZeRO: the flat
#: float32 masters, whose padding the params' views do not show
_ZERO_KEY = "__zero__"


def _train_collect_names(tstaged, snapshot: bool = False,
                         dynamic: bool = False) -> List[str]:
    """The collect list shared by the builder and the executor: the
    loss-bearing backward actor first, then every ``opt{s}``, then (with
    snapshotting on) every ``snap{s}`` -- the write receipts the executor
    needs before it finalizes a snapshot's MANIFEST -- then (with dynamic
    loss scaling) the ``scale`` actor, whose decision the executor
    mirrors."""
    produced_at = {n: st.index for st in tstaged.stages
                   for n in st.output_names}
    loss_stage = produced_at[tstaged.loss_name]
    param_stages = [st.index for st in tstaged.stages if st.param_names]
    names = [f"b{loss_stage}"] + [f"opt{s}" for s in param_stages]
    if snapshot:
        names += [f"snap{s}" for s in param_stages]
    if dynamic and param_stages:
        names.append("scale")
    return names


def train_stage_actor_specs(tstaged, microbatch_inputs: Sequence[str],
                            num_microbatches: int, lr: float = 1e-2,
                            regs: Optional[Sequence[int]] = None,
                            optimizer=None, snapshot=None,
                            ) -> Tuple[List[ActorSpec], List[str]]:
    """Build the persistent fwd/bwd/opt actor graph for training steps.

    ``tstaged`` is a :class:`repro_torch.core.lowering.TrainStagedProgram`.
    The graph is built once and re-run per step (one epoch each); per-step
    values arrive via ``ctx``:

    * ``ctx["data"]`` — the pre-split microbatch payload list;
    * ``ctx[f"f{s}"]`` — values to (re)bind on stage s, as its per-rank
      shards: its non-microbatch data inputs every step, plus its params on
      the first step (or after a ``load_params``). Afterwards ``opt{s}``
      updates the same tensors in place, so params stay on the card across
      steps;
    * ``ctx[f"opt{s}"]`` — the step index (resolves the lr schedule), as a
      plain int or as ``{"step": int, "load_state": [state per rank]}``
      when the executor hands the stage its optimizer state (the first
      step);
    * with loss scaling, ``ctx[f"b{s}"]`` of the loss stage ``{"loss_seed":
      scale}``, ``ctx[f"acc{s}"]`` ``{"inv_scale": 1/scale}`` and, dynamic,
      ``ctx["scale"]`` ``{"scale", "good_steps"}``: the executor owns the
      scale and re-anchors the actors at it every step;
    * ``ctx[f"snap{s}"]`` -- with ``snapshot`` set, ``{"step": int,
      "write": bool}`` controlling this epoch's snapshot write.

    ``regs[s]`` is forward stage s's out-register quota (default 1F1B,
    ``num_stages - s``); backward/acc/opt actors need no tuning.

    The optimizer subsystem (paper §3.3 partial-value + §4.3 actors):

    * ``optimizer`` is a :class:`repro_torch.core.lowering.OptimizerSpec`
      (falls back to ``tstaged.optimizer``, then plain SGD at ``lr``).
    * Every ``acc{s}`` sums each rank's gradients in microbatch order and,
      at the last microbatch, boxes the sums to their params' signatures
      (P→B for a broadcast param). With ``optimizer.grad_clip`` > 0 it emits
      its stage-local squared-norm partials alongside them (each param's
      distinct shards, a replica counted once), and a ``norm`` actor —
      OneFlow's P→B boxing expressed as an actor, across stage meshes —
      sums the partials in canonical param order and broadcasts the clip
      scale sideways to every ``opt{s}``.
    * With a stateful optimizer (AdamW), a ``state{s}`` source actor emits
      the stage's current optimizer state (one per rank) as a register that
      ``opt{s}`` consumes — the second register stream, initialized on the
      first step. Each rank updates its own shards.
    * Mixed precision (``optimizer.mixed_precision``, paper Fig 14):
      ``f{s}`` keeps the float32 params it is sent for ``opt{s}``, which
      makes its float32 masters of them (flat ``(dp, 1, chunk)`` shards
      under ZeRO, updated in place), and binds their compute-dtype copies
      -- the ``cast``; after each update ``opt{s}`` casts again (after the
      gather under ZeRO) for the next step's forward. With loss scaling the
      loss stage's backward is seeded with the scale, and every ``acc{s}``
      unscales its sums once, on its final fire, before the norm partials.
      Dynamic scaling adds a ``scale`` actor after ``norm``: it checks the
      norm for finiteness and broadcasts skip, backoff or growth to every
      ``opt{s}``; a skipped step leaves params, moments and step count as
      they were.
    * With ``snapshot`` (a :class:`repro_torch.runtime.snapshot
      .SnapshotSpec`), a ``snap{s}`` actor per parameterized stage consumes
      ``opt{s}``'s output register -- the post-update params and fresh
      optimizer state -- on the stage node's thread 1 (its own mailbox,
      thread and register quota) and writes the stage's slice as global
      tensors: shards assembled by their signatures, and under ZeRO the
      flat ``(dp, 1, chunk)`` layout of each global master and moment. It
      copies to the host and writes within its fire, so the step ends
      with the files on disk and no later in-place update can reach them;
      it emits a write receipt the executor collects before finalizing
      the snapshot's manifest.

    Forward actors record autograd and backward actors replay it (grad mode
    is per thread, so each body sets its own); every body waits for the
    card before handing its outputs on. Gradients accumulate in float32 in
    microbatch order; the accumulator resets at every epoch start.

    Returns ``(specs, collect_names)``: ``collect_names[0]`` is the backward
    actor of the loss-producing stage (the per-microbatch loss stream), the
    rest are the ``opt{s}`` actors (each stage's post-clip gradients,
    updated params, and new optimizer state).
    """
    S = tstaged.num_stages
    if regs is None:
        regs = [max(1, S - s) for s in range(S)]
    regs = _validate_regs(regs, S, num_microbatches)
    mb_names = list(microbatch_inputs)
    for n in mb_names:
        if n not in tstaged.input_names:
            raise ValueError(f"{n} is not a graph input")

    opt = optimizer if optimizer is not None else (
        tstaged.optimizer if tstaged.optimizer is not None
        else OptimizerSpec.sgd(lr))
    clip = bool(opt.grad_clip)
    mp = opt.mixed_precision           # float32 masters live in opt{s}
    dynamic = opt.dynamic_scaling
    need_norm = clip or dynamic        # dynamic scaling checks the norm
    param_order = tstaged.param_names
    param_stages = [st.index for st in tstaged.stages if st.param_names]
    loss_name = tstaged.loss_name
    needed_after = _forward_carry(tstaged, mb_names)

    # backward carry: which cotangents b{s} must emit to b{s-1}. A boundary
    # activation produced at stage p collects contributions from every
    # consuming stage >= s on the way down and is consumed as b{p}'s seed.
    produced_at = {n: st.index for st in tstaged.stages
                   for n in st.output_names}
    loss_stage = produced_at[loss_name]
    diff_boundary = {n for st in tstaged.stages
                     for n in st.diff_input_names if n not in st.param_names}
    out_cot_names: List[set] = [set() for _ in range(S)]
    for n in diff_boundary:
        consumers = {st.index for st in tstaged.stages
                     if n in st.diff_input_names}
        for s in range(produced_at[n] + 1, S):
            if any(c >= s for c in consumers):
                out_cot_names[s].add(n)

    specs: List[ActorSpec] = [_payload_source_spec("data", num_microbatches)]

    def make_fwd_fn(stage):
        bound, base_on_epoch = _stage_binding()
        prev = _prev_mesh(tstaged, stage)
        # mixed precision: the executor's float32 params wait here for
        # opt{s} (its masters), and the stage binds their compute-dtype
        # copies -- the paper's Fig-14 cast at the forward stage's boundary
        raw_cell: Dict[str, Any] = {}
        pset = set(stage.param_names)

        def on_epoch(raw):
            base_on_epoch(raw)
            if not (mp and raw):
                return
            for n in raw:
                if n in pset:
                    raw_cell[n] = bound[n]
                    bound[n] = [opt.cast(x) for x in bound[n]]

        def run_fwd(payload):
            payload = {n: relay(v, prev, stage.mesh)
                       for n, v in payload.items() if n != _TAPE_KEY}
            outs, tape = stage.fwd(*_place_incoming(stage.input_names,
                                                    bound, payload))
            sync_mesh(stage.mesh)
            carried = {n: v for n, v in payload.items()
                       if n in needed_after[stage.index + 1]}
            carried.update(zip(stage.output_names, outs))
            carried[_TAPE_KEY] = tape
            return carried
        return run_fwd, bound, raw_cell, on_epoch

    def make_bwd_fn(stage):
        diff_in = set(stage.diff_input_names)
        later = tstaged.stages[min(stage.index + 1, S - 1)].mesh
        # the loss stage's backward seed: 1, or the loss scale the executor
        # sends each step
        seed = {"scale": None}

        def on_epoch(v):
            if v is not None:
                seed["scale"] = float(v["loss_seed"])

        def run_bwd(f_payload, b_payload=None):
            incoming = {} if b_payload is None else {
                n: None if c is None else relay(c, later, stage.mesh)
                for n, c in b_payload["cots"].items()}
            grads, res = {}, {}
            if stage.bwd is not None:
                seeds = stage.output_cotangents(f_payload, incoming,
                                                loss_name, seed["scale"])
                in_cots = stage.bwd(f_payload[_TAPE_KEY], seeds)
                for n, c in zip(stage.diff_input_names, in_cots):
                    if n in stage.param_names:
                        grads[n] = c
                    else:
                        res[n] = c
            # a boundary input of this stage already carries the incoming
            # sum (its seed); anything else passes through
            out_cots = {n: (res[n] if n in diff_in else incoming.get(n))
                        for n in out_cot_names[stage.index]}
            out = {"cots": out_cots, _GRADS_KEY: grads}
            if stage.index == loss_stage:
                out["loss"] = torch.sum(assemble(
                    f_payload[loss_name], stage.mesh,
                    stage.out_sbp[loss_name]))
            sync_mesh(stage.mesh)
            return out
        return run_bwd, on_epoch

    def make_acc_fn(stage):
        # with loss scaling the executor sends 1/scale, and the sums are
        # unscaled ONCE on the final fire, before the norm partials: the
        # norm (and the finiteness check of dynamic scaling) is the true
        # gradients'
        state: Dict[str, Any] = {}
        meta = {"fires": 0, "inv": None}

        def on_epoch(v):
            state.clear()
            meta["fires"] = 0
            meta["inv"] = None if v is None else v.get("inv_scale")

        def run_acc(b_payload):
            meta["fires"] += 1
            for n, g in b_payload[_GRADS_KEY].items():
                if g is None:
                    g = [torch.zeros_like(p) for p in bound_of[stage.index][n]]
                state[n] = accumulate(state.get(n), g)
            if meta["fires"] < num_microbatches:
                return {}
            state.update(box_grads(stage.mesh, tstaged.graph, tstaged.plan,
                                   state))
            if meta["inv"] is not None:
                state.update(unscale(state, meta["inv"]))
            out = {_GRADS_KEY: dict(state)}
            if need_norm:
                # the stage-local P contribution to the global grad norm
                out["sqnorms"] = grad_sqnorms(stage.mesh, tstaged.plan,
                                              state)
            return out
        return run_acc, on_epoch

    def make_opt_fn(stage, bound, raw_cell, state_cell):
        pnames = stage.param_names
        meta = {"step": 0}

        def on_epoch(v):
            if v is None:
                return
            if isinstance(v, dict):
                meta["step"] = int(v["step"])
                # the driver's state replaces the worker-resident one
                # before this epoch's state{s} fire emits it
                state_cell["state"] = v["load_state"]
            else:
                meta["step"] = int(v)

        def refresh_masters():
            # the float32 masters of the float32 params the executor just
            # sent (first step or load_params): the register stream opt{s}
            # owns from here on
            state_cell["masters"], state_cell["params"] = rank_masters(
                opt, {n: raw_cell[n] for n in pnames})
            raw_cell.clear()

        def run_opt(acc_payload, *rest):
            rest = list(rest)
            norm_payload = rest.pop(0) if need_norm else None
            scale_payload = rest.pop(0) if dynamic else None
            state = rest.pop(0)["state"] if opt.stateful else None
            if mp and raw_cell:
                refresh_masters()
            if scale_payload is not None and scale_payload["skip"]:
                # non-finite grads under dynamic scaling: no update and no
                # step advance; masters, moments and bound params stay
                return {"skipped": True, "norm": norm_payload["norm"]}
            grads = acc_payload[_GRADS_KEY]
            if norm_payload is not None:
                grads = {n: [scale_grad(g, norm_payload["scale"])
                             for g in grads[n]] for n in pnames}
            else:
                grads = {n: grads[n] for n in pnames}
            params = (state_cell["masters"] if mp
                      else {n: bound[n] for n in pnames})
            nranks = stage.mesh.size
            if opt.stateful and state is None:
                # first step in this worker: fresh (zeroed) state
                state = opt.init_rank_states(
                    state_cell["params"] if mp else params, nranks)
            lr_now = opt.lr_at(meta["step"])
            meta["step"] += 1
            with torch.no_grad():
                new_state = opt.update_ranks(params, grads, state, lr_now,
                                             nranks)
                if mp:
                    # the next step's forward reads the compute copies: the
                    # Fig-14 cast (after the gather under ZeRO)
                    bound.update(rank_compute(opt, params,
                                              state_cell["params"]))
            sync_mesh(stage.mesh)
            if opt.stateful:
                state_cell["state"] = new_state
            out = {"params": state_cell["params"] if mp else params,
                   "grads": grads}
            if opt.stateful:
                out["state"] = new_state
            if opt.zero and snapshot is not None:
                out[_ZERO_KEY] = {"masters": state_cell["masters"]}
            if norm_payload is not None:
                out["norm"] = norm_payload["norm"]
            return out
        return run_opt, on_epoch

    def make_snap_fn(stage):
        # the snapshot actor's per-epoch control cell: which step this
        # epoch's write belongs to, and whether to write at all
        cell = {"step": 0, "write": False}

        def on_epoch(v):
            if v is not None:
                cell["step"] = int(v["step"])
                cell["write"] = bool(v["write"])

        def run_snap(opt_payload):
            from repro_torch.runtime.snapshot import write_stage_snapshot

            write = cell["write"] and not opt_payload.get("skipped")
            if write:
                with torch.no_grad():
                    params, state, zero = snapshot_leaves(
                        opt, stage, tstaged.plan.tensor_sbp, opt_payload)
                    write_stage_snapshot(snapshot.dir, cell["step"],
                                         stage.index, params,
                                         opt_state=state, zero=zero)
            return {"stage": stage.index, "step": cell["step"],
                    "written": write}
        return run_snap, on_epoch

    bound_of: Dict[int, Dict[str, Any]] = {}
    collect = _train_collect_names(tstaged, snapshot=snapshot is not None,
                                   dynamic=dynamic)
    for s, stage in enumerate(tstaged.stages):
        fwd_fn, bound, raw_cell, fwd_on_epoch = make_fwd_fn(stage)
        bwd_fn, bwd_on_epoch = make_bwd_fn(stage)
        bound_of[s] = bound
        specs.append(ActorSpec(
            name=f"f{s}", fn=fwd_fn,
            inputs=("data",) if s == 0 else (f"f{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0,
            max_fires=num_microbatches, on_epoch=fwd_on_epoch))
        specs.append(ActorSpec(
            name=f"b{s}", fn=bwd_fn,
            inputs=(f"f{s}",) if s == S - 1 else (f"f{s}", f"b{s+1}"),
            out_regs=2, node=s + 1, thread=0,
            max_fires=num_microbatches, on_epoch=bwd_on_epoch))
        if stage.param_names:
            acc_fn, acc_on_epoch = make_acc_fn(stage)
            specs.append(ActorSpec(
                name=f"acc{s}", fn=acc_fn, inputs=(f"b{s}",),
                out_regs=1, node=s + 1, thread=0,
                max_fires=num_microbatches, emit_every=num_microbatches,
                on_epoch=acc_on_epoch))
            opt_inputs = (f"acc{s}",)
            if need_norm:
                opt_inputs += ("norm",)
            if dynamic:
                opt_inputs += ("scale",)
            state_cell: Dict[str, Any] = {"state": None}
            if opt.stateful:
                # the optimizer-state register stream: a source actor emits
                # the worker-resident AdamWState; opt{s} consumes it next to
                # the summed gradients and the broadcast clip scale
                specs.append(ActorSpec(
                    name=f"state{s}",
                    fn=lambda _c=state_cell: {"state": _c["state"]},
                    inputs=(), out_regs=1, node=s + 1, thread=0,
                    max_fires=1))
                opt_inputs += (f"state{s}",)
            opt_fn, opt_on_epoch = make_opt_fn(stage, bound, raw_cell,
                                               state_cell)
            specs.append(ActorSpec(
                name=f"opt{s}", fn=opt_fn,
                inputs=opt_inputs, out_regs=1, node=s + 1, thread=0,
                max_fires=1, on_epoch=opt_on_epoch))
            if snapshot is not None:
                # async checkpointing as one more register-stream consumer,
                # on the stage node's thread 1: serialization never runs on
                # the schedule's thread
                snap_fn, snap_on_epoch = make_snap_fn(stage)
                specs.append(ActorSpec(
                    name=f"snap{s}", fn=snap_fn, inputs=(f"opt{s}",),
                    out_regs=1, node=s + 1, thread=1,
                    max_fires=1, on_epoch=snap_on_epoch))

    if need_norm and param_stages:
        # cross-stage *sideways* communication on the actor protocol: sum the
        # per-stage squared-norm partials (P→B boxing as an actor) and
        # broadcast the clip scale to every opt{s} (1.0 with clipping off,
        # where the norm only feeds dynamic scaling's finiteness check)
        def run_norm(*acc_payloads):
            partials = {}
            for pl in acc_payloads:
                partials.update(pl["sqnorms"])
            norm = global_norm_from_partials(partials, param_order)
            return {"norm": norm, "scale": clip_scale(norm, opt.grad_clip)}

        specs.append(ActorSpec(
            name="norm", fn=run_norm,
            inputs=tuple(f"acc{s}" for s in param_stages),
            out_regs=1, node=0, thread=0, max_fires=1))

    if dynamic and param_stages:
        # dynamic loss scaling rides the norm actor's sideways edge: check
        # the true gradients' norm for finiteness and broadcast the skip,
        # backoff or growth to every opt{s}. The executor re-anchors the
        # cell every step, so the trajectory never forks from its mirror.
        sc_cell = {"scale": opt.initial_scale(), "good": 0}

        def sc_on_epoch(v):
            if v is not None:
                sc_cell["scale"] = float(v["scale"])
                sc_cell["good"] = int(v["good_steps"])

        def run_scale(norm_payload):
            finite = bool(np.isfinite(np.float32(norm_payload["norm"])))
            skip, nxt, good = loss_scale_update(
                opt.precision, sc_cell["scale"], sc_cell["good"], finite)
            sc_cell["scale"], sc_cell["good"] = nxt, good
            return {"skip": skip, "next_scale": nxt, "good_steps": good}

        specs.append(ActorSpec(
            name="scale", fn=run_scale, inputs=("norm",),
            out_regs=1, node=0, thread=0, max_fires=1,
            on_epoch=sc_on_epoch))
    return specs, collect


def snapshot_leaves(opt: OptimizerSpec, stage, sbp, opt_payload):
    """What ``snap{s}`` writes of one stage's opt payload: ``(params,
    state, zero)`` -- the global float32 params (the masters under mixed
    precision), the merged optimizer state over global moments (None for
    SGD) and, under ZeRO, ``{"dp", "shapes"}`` with params and moments in
    the flat ``(dp, 1, chunk)`` layout of each global tensor, the layout
    the reference writes. On one rank these are the stage's own tensors,
    read in place; on a mesh they are assembled from the ranks' shards by
    their signatures."""
    mesh, names = stage.mesh, stage.param_names
    shards = {n: opt_payload["params"][n] for n in names}
    states = opt_payload.get("state")
    if opt.zero and mesh.size == 1:
        # the one rank's flat masters and moments are the global layout
        masters = opt_payload[_ZERO_KEY]["masters"]
        params = {n: masters[n][0] for n in names}
        state = states[0]
    else:
        params = {n: assemble(shards[n], mesh, sbp[n]) for n in names}
        state = rank_opt_state(opt, states, mesh, sbp, shards)
        if opt.zero:
            params = opt.shard_masters(params)
            state = ZeroState(state.step, opt.shard_masters(state.mu),
                              opt.shard_masters(state.nu))
    zero = None
    if opt.zero:
        shapes = opt.zero_shape_map
        zero = {"dp": opt.zero_dp, "shapes": {n: shapes[n] for n in names}}
    return params, state, zero


def unscale(grads: Dict[str, List[torch.Tensor]], inv
            ) -> Dict[str, List[torch.Tensor]]:
    """Each rank's float32 gradient sums times ``inv`` (1/loss scale; exact
    for a power-of-two scale): the acc actors and the monolithic engine
    unscale this way, once, before the norm."""
    return {n: [scale_grad(g, inv) for g in gs] for n, gs in grads.items()}


class TrainSpecBuilder(_SpecBuilderBase):
    """Builder of the fwd/bwd/opt training actor graph."""

    def __init__(self, staged, microbatch_inputs: Sequence[str],
                 num_microbatches: int, lr: float = 1e-2, regs=None,
                 optimizer=None, snapshot=None, recipe=None):
        super().__init__(staged, recipe)
        self.microbatch_inputs = list(microbatch_inputs)
        self.num_microbatches = num_microbatches
        self.lr = lr
        self.regs = None if regs is None else list(regs)
        self.optimizer = optimizer
        self.snapshot = snapshot

    def __call__(self):
        return train_stage_actor_specs(self.staged, self.microbatch_inputs,
                                       self.num_microbatches, lr=self.lr,
                                       regs=self.regs,
                                       optimizer=self.optimizer,
                                       snapshot=self.snapshot)


def own_params(params: Dict[str, Any], names: Sequence[str], meshes,
               sbp, float32: bool = False) -> Dict[str, List[torch.Tensor]]:
    """The session's own per-rank shards of ``params`` (in ``names``
    order), each placed by ``sbp[name]`` on ``meshes[name]``, in float32
    where ``float32`` (a mixed-precision optimizer's masters): the
    optimizer updates them in place, so the caller's values are never
    touched."""
    missing = [n for n in names if n not in params]
    if missing:
        raise ValueError(f"missing params: {missing}")
    out = {}
    for n in names:
        x = torch.as_tensor(params[n]).detach()
        if float32:
            x = x.float()
        mesh = meshes[n]
        out[n] = ([x.to(mesh.devices[0], copy=True)] if mesh.size == 1
                  else place(x, mesh, sbp[n]))
    return out


class TrainPipelineExecutor(_GraphExecutorBase):
    """Run a :class:`repro_torch.core.lowering.TrainStagedProgram` as a 1F1B
    training pipeline.

    The fwd/bwd/opt actor graph is built once; each :meth:`step` is one
    epoch over it. Per-stage persistent state — the bound param shards, the
    AdamW state of each rank, the float32 gradient accumulator — lives in
    the stage's actor closures; the opt actor updates the shards and state
    in place, so nothing round-trips through the caller between steps. The
    executor's ``shards`` and ``opt_states`` are the same tensors (under
    ``runtime="processes"`` views of the stage workers' tensors, refreshed
    from the ``opt{s}`` outputs every step: a worker owns a copy of what the
    executor sends it; after a worker's death they are dropped unread and
    the session refuses to go on -- ``compile(restore=)`` resumes), and
    :meth:`step` returns ``(loss, grads, params)`` as global tensors,
    bit-identical to the monolithic engine with the same
    :class:`OptimizerSpec` (the objective is the *sum* of the loss tensor
    over the batch; ``grads`` are post-clip when global-norm clipping is
    on). On a one-rank mesh the returned params are the live tensors: the
    next step updates them.

    ``opt_state`` merges the per-stage states into global moments;
    ``last_grad_norm`` is the global gradient norm the ``norm`` actor
    computed (None when neither clipping nor dynamic scaling needs it).
    ``last_peak_regs`` ``f{s}`` entries are the in-flight activation counts
    the 1F1B quota bounds.

    With a mixed-precision optimizer the executor's ``shards`` are float32
    (views of the flat masters under ZeRO) and it owns the loss scale: it
    seeds each step's backward with ``loss_scale`` and mirrors the
    ``scale`` actor's decision (``loss_scale``, ``scale_good_steps``,
    ``last_skipped``, ``last_scale``: the scale the last step ran under).

    With ``snapshot_dir`` every ``snapshot_every``-th step's state lands
    there from the ``snap{s}`` actors (:mod:`repro_torch.runtime
    .snapshot`); the executor writes the step's MANIFEST once every
    stage's receipt is in. :meth:`load_state` restores one. ``faults`` is a
    :class:`repro_torch.runtime.chaos.FaultPlan` for the runtime.
    """

    def __init__(self, tstaged, params: Dict[str, Any],
                 microbatch_inputs: Sequence[str], num_microbatches: int,
                 lr: float = 1e-2, regs: Optional[Sequence[int]] = None,
                 optimizer=None, runtime: str = "threads", recipe=None,
                 snapshot_dir: Optional[str] = None, snapshot_every: int = 1,
                 faults=None):
        super().__init__(tstaged, microbatch_inputs, num_microbatches, regs,
                         runtime=runtime, faults=faults, recipe=recipe)
        self.tstaged = tstaged
        self.lr = lr
        self.optimizer = optimizer if optimizer is not None else (
            tstaged.optimizer if tstaged.optimizer is not None
            else OptimizerSpec.sgd(lr))
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self._snapshot = None
        if snapshot_dir is not None:
            from repro_torch.runtime.snapshot import SnapshotSpec
            self._snapshot = SnapshotSpec(str(snapshot_dir))
        self.snapshot_every = snapshot_every
        self.mesh_of = {n: st.mesh for st in tstaged.stages
                        for n in st.param_names}
        self.shards: Dict[str, List[torch.Tensor]] = {}
        self.load_params(params)
        opt = self.optimizer
        # the per-stage, per-rank optimizer states (zeroed; None for SGD):
        # the first step hands each to its stage's worker, which updates it
        # in place from then on, so the executor and the worker share one copy
        self.opt_states: Dict[int, Any] = {
            st.index: self.optimizer.init_rank_states(
                {n: self.shards[n] for n in st.param_names}, st.mesh.size)
            for st in tstaged.stages if st.param_names}
        self._state_dirty = True
        self.step_count = 0
        self.last_grad_norm = None
        # the loss-scale mirror: the executor owns the scale and sends it
        # to the actors every step
        self._scaling = opt.loss_scaling is not None
        self.loss_scale = opt.initial_scale() if self._scaling else None
        self.scale_good_steps = 0
        self.last_skipped = False
        self.last_scale = None
        self._loss_stage = next(st.index for st in tstaged.stages
                                if tstaged.loss_name in st.output_names)
        self._lost: Optional[str] = None

    def _make_builder(self):
        return TrainSpecBuilder(self.tstaged, self.microbatch_inputs,
                                self.num_microbatches, lr=self.lr,
                                regs=self.regs, optimizer=self.optimizer,
                                snapshot=self._snapshot, recipe=self.recipe)

    def close(self) -> None:
        """Release the runtime's workers. Under processes the executor's
        mirrors are views of the workers' tensors, so they go with them:
        the session's state is then read from its snapshots."""
        if self.runtime_kind == "processes" and self._rt is not None:
            self.shards, self.opt_states = {}, {}
            self._lost = self._lost or "the session was closed"
        super().close()

    def _check_live(self) -> None:
        if self._lost is not None:
            raise RuntimeError(
                f"this session's state died with its workers ({self._lost});"
                " compile(restore=<snapshot_dir>) resumes from the last "
                "completed snapshot")

    def _global(self, per_rank: Dict[str, List[torch.Tensor]]):
        sbp = self.tstaged.plan.tensor_sbp
        return {n: assemble(v, self.mesh_of[n], sbp[n])
                for n, v in per_rank.items()}

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The current params as global tensors."""
        self._check_live()
        return self._global(self.shards)

    def load_params(self, params: Dict[str, Any]) -> None:
        """Replace the executor-owned params (shards copied from
        ``params``); they ride the next step's ``ctx`` into each stage's
        worker. Optimizer state is untouched."""
        self.shards = own_params(params, self.tstaged.param_names,
                                 self.mesh_of, self.tstaged.plan.tensor_sbp,
                                 self.optimizer.mixed_precision)
        self._params_dirty = True

    def load_state(self, params: Optional[Dict[str, Any]] = None,
                   opt_state=None, step: Optional[int] = None) -> None:
        """Restore a full training state (the kill-and-resume seam).

        Extends :meth:`load_params` with what a restart must not lose:
        ``opt_state`` -- a *merged* :class:`repro_torch.optim.adamw
        .AdamWState` over global moments (tensors or numpy arrays, e.g.
        from :func:`repro_torch.runtime.snapshot.load_snapshot`), cut per
        stage by THIS executor's partition and per rank by its meshes, so a
        snapshot restores onto another stage cut -- and ``step``, the
        optimizer-step counter the lr schedule is indexed by. The restored
        params and moments are owned copies on the stages' devices; they
        ride the next step's ``ctx`` into each stage's actors, where the
        float32 masters and the compute copies are rebuilt from them."""
        if params is not None:
            self.load_params(params)
        if opt_state is not None:
            if not self.optimizer.stateful:
                raise ValueError(
                    "opt_state given but the optimizer is stateless "
                    f"({self.optimizer.kind})")
            sbp = self.tstaged.plan.tensor_sbp
            self.opt_states = {
                st.index: rank_states(
                    self.optimizer, opt_state,
                    {n: self.shards[n] for n in st.param_names}, st.mesh,
                    sbp)
                for st in self.tstaged.stages if st.param_names}
            self._state_dirty = True
        if step is not None:
            self.step_count = int(step)

    @property
    def peak_inflight_activations(self) -> int:
        """Peak forward registers in use across stages in the last step —
        the in-flight microbatch count the quota back-pressures. Zero
        before the first step."""
        return max((self.last_peak_regs.get(f"f{s}", 0)
                    for s in range(self.tstaged.num_stages)), default=0)

    @property
    def opt_state(self):
        """The per-stage, per-rank optimizer states merged into one
        :class:`repro_torch.optim.adamw.AdamWState` over global moments
        (None for a stateless optimizer)."""
        self._check_live()
        sbp = self.tstaged.plan.tensor_sbp
        return self.optimizer.merge_states(
            [rank_opt_state(self.optimizer, self.opt_states[s],
                            self.tstaged.stages[s].mesh, sbp, self.shards)
             for s in sorted(self.opt_states)])

    def opt_state_bytes(self) -> Dict[int, int]:
        """Per-stage bytes of optimizer-held float32 state on a stage's
        fullest rank (:func:`repro_torch.core.lowering.opt_state_bytes`):
        masters and moments with mixed precision (3x the float32 param
        bytes, over dp under ZeRO), the two moments for plain AdamW."""
        out = {}
        for st in self.tstaged.stages:
            if st.param_names:
                out[st.index] = opt_state_bytes(
                    self.optimizer, self.opt_states.get(st.index),
                    {n: self.shards[n] for n in st.param_names},
                    st.mesh.size)
        return out

    def step(self, data_inputs: Dict[str, Any], timeout: float = 300.0):
        """Run one training step over the current params. ``data_inputs``
        maps non-param graph inputs to global values (the microbatched ones
        are split along axis 0). Returns ``(loss, grads, params)`` as
        global tensors."""
        loss, grads, shards = self.step_shards(data_inputs, timeout)
        return loss, self._global(grads), self._global(shards)

    def step_shards(self, data_inputs: Dict[str, Any],
                    timeout: float = 300.0):
        """:meth:`step` with the post-clip grads and the updated params left
        as per-rank shards (``{name: [shard per rank]}``); :meth:`_global`
        assembles them."""
        self._check_live()
        check_run_inputs(
            data_inputs,
            [n for n in self.tstaged.input_names if n not in self.shards],
            owned=self.tstaged.param_names)
        graph_inputs = set(self.tstaged.input_names)
        mb = set(self.microbatch_inputs)
        ctx: Dict[str, Any] = {"data": self._microbatch_payloads(data_inputs)}
        opt = self.optimizer
        snap_step = self.step_count + 1   # the state after THIS step lands
        write = (self._snapshot is not None
                 and snap_step % self.snapshot_every == 0)
        if self._scaling:
            # seed the loss stage's backward with the scale, the acc actors
            # with 1/scale, and re-anchor the scale actor at the mirror
            inv = np.float32(np.float32(1.0) / np.float32(self.loss_scale))
            self.last_scale = self.loss_scale
            ctx[f"b{self._loss_stage}"] = {"loss_seed": self.loss_scale}
            if opt.dynamic_scaling:
                ctx["scale"] = {"scale": self.loss_scale,
                                "good_steps": self.scale_good_steps}
        for st in self.tstaged.stages:
            bound = {n: st.place(n, data_inputs[n]) for n in st.input_names
                     if n in graph_inputs and n not in mb
                     and n not in self.shards}
            if self._params_dirty:
                bound.update({n: self.shards[n] for n in st.param_names})
            ctx[f"f{st.index}"] = bound
            if st.param_names:
                if self._scaling:
                    ctx[f"acc{st.index}"] = {"inv_scale": inv}
                ctx[f"opt{st.index}"] = (
                    {"step": self.step_count,
                     "load_state": self.opt_states[st.index]}
                    if self._state_dirty else self.step_count)
                if self._snapshot is not None:
                    ctx[f"snap{st.index}"] = {"step": snap_step,
                                              "write": write}
        try:
            outs = self._run_rt(ctx, None, timeout)
        except WorkerError as exc:
            if self.runtime_kind == "processes":
                # the mirrors are views of the dead workers' memory: drop
                # them unread (a restore reads the snapshot files)
                self.shards, self.opt_states = {}, {}
                self._lost = str(exc)
            raise
        self._params_dirty = False
        self._state_dirty = False

        collect = _train_collect_names(
            self.tstaged, snapshot=self._snapshot is not None,
            dynamic=opt.dynamic_scaling)
        # the loss-bearing backward actor fires in version order in one
        # worker, so the collected loss stream is microbatch-ordered
        loss_payloads = outs[collect[0]]
        if len(loss_payloads) != self.num_microbatches:
            raise RuntimeError(
                f"collected {len(loss_payloads)} loss chunks, expected "
                f"{self.num_microbatches}")
        loss = None
        for pl in loss_payloads:
            loss = pl["loss"] if loss is None else loss + pl["loss"]

        grads: Dict[str, Any] = {}
        norm = None
        for name in collect[1:]:
            if not name.startswith("opt"):
                continue
            (opt_out,) = outs[name]        # optimizer fired exactly once
            s = int(name[len("opt"):])
            norm = opt_out.get("norm", norm)
            if opt_out.get("skipped"):
                continue
            grads.update(opt_out["grads"])
            self.shards.update(opt_out["params"])
            if "state" in opt_out:
                self.opt_states[s] = opt_out["state"]
        self.last_grad_norm = norm
        self.last_skipped = False
        if opt.dynamic_scaling:
            (sc,) = outs["scale"]
            self.last_skipped = bool(sc["skip"])
            self.loss_scale = float(sc["next_scale"])
            self.scale_good_steps = int(sc["good_steps"])
        if write and not self.last_skipped:
            self._finalize_snapshot(outs, snap_step)
        if not self.last_skipped:
            self.step_count += 1
        return loss, grads, dict(self.shards)

    def _finalize_snapshot(self, outs, snap_step: int) -> None:
        """Write the snapshot MANIFEST -- only after every stage's snap
        actor delivered a write receipt for this step. The MANIFEST is the
        completeness marker: a step killed mid-write leaves stage dirs
        without one, and restore ignores them."""
        from repro_torch.runtime.snapshot import write_manifest

        receipts = []
        for st in self.tstaged.stages:
            if not st.param_names:
                continue
            (r,) = outs[f"snap{st.index}"]
            if not r["written"] or int(r["step"]) != snap_step:
                raise RuntimeError(
                    f"snapshot receipt mismatch from stage {st.index}: {r} "
                    f"(expected written step {snap_step})")
            receipts.append(int(r["stage"]))
        opt = self.optimizer
        meta = {"param_names": list(self.tstaged.param_names),
                "stateful": opt.stateful,
                "optimizer": opt.kind,
                "num_stages": self.tstaged.num_stages,
                "zero": bool(opt.zero)}
        if self._scaling:
            # the scale to RESUME with (already advanced past this step)
            meta["loss_scale"] = float(self.loss_scale)
            meta["scale_good_steps"] = int(self.scale_good_steps)
        write_manifest(self._snapshot.dir, snap_step, receipts, meta=meta)


# ---------------------------------------------------------------------------
# Serving pipelines: continuous-batching decode on the actor protocol.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PrefillWork:
    """Admit one request: run its prompt, build its slot caches.
    ``tokens`` is (1, prompt_len) int32; ``last_index`` is the prompt's
    final position — the first generated token's logits come from there.
    Under ``cache="paged"``, ``sid`` is the request's slot id in the page
    pool and ``row`` its *write* page-table row (int32 on the stage's
    device; shared-prefix entries masked to ``-1``)."""

    group: int
    slot: int
    tokens: Any
    last_index: int
    sid: int = -1
    row: Any = None


@dataclasses.dataclass
class DecodeWork:
    """Advance every slot of ``group`` by one token. ``tok``/``pos`` are
    (group_size,) int32; retired slots are parked (see
    :class:`repro_torch.serve.admission.AdmissionScheduler`). Under
    ``cache="paged"``, ``sids``/``rows`` carry each slot's pool id and
    page-table row (``-1`` rows for parked or mid-chunk slots)."""

    group: int
    tok: Any
    pos: Any
    sids: Any = None
    rows: Any = None


@dataclasses.dataclass
class PrefillChunkWork:
    """One bounded chunked-prefill step for slot ``(group, slot)``
    (``cache="paged"`` only): the stage's loop-of-decode chunk program over
    ``toks`` (chunk_len, group_size), slot ``b`` visiting positions
    ``pos0[b] + t * adv[b]``. Non-owner columns are parked no-ops
    (``adv == 0``, table row ``-1``) so the group program keeps one fixed
    shape. ``sids_in`` gates the state-row gather (``-1`` on the first
    chunk: recurrent state starts from exact zeros), ``sids_out`` the
    state-row scatter. ``final`` marks the chunk whose last-position logits
    produce the request's first token."""

    group: int
    slot: int
    toks: Any
    pos0: Any
    adv: Any
    rows: Any
    sids_in: Any
    sids_out: Any
    final: bool


def _work_input(work):
    """The first stage's input: prompt ids for a prefill, the chunk token
    matrix for a chunk, last tokens for a decode."""
    if isinstance(work, PrefillWork):
        return work.tokens
    if isinstance(work, PrefillChunkWork):
        return work.toks
    return work.tok


class DenseStageCache:
    """The dense per-group caches of one stage: one ``(group_size,
    cache_len, ...)`` block per slot group (on a mesh, a list of each
    rank's block of it), allocated the first time the group reaches the
    stage."""

    def __init__(self, stage, group_size: int):
        self.stage = stage
        self.group_size = group_size
        self.caches: Dict[int, Any] = {}

    def _ensure(self, group: int) -> None:
        if group not in self.caches:
            self.caches[group] = self.stage.init_caches(self.group_size)

    def write_prefill(self, work, slot_caches) -> None:
        self._ensure(work.group)
        self.stage.write_slot(self.caches[work.group], slot_caches, work.slot)

    def run_decode(self, work, xin):
        self._ensure(work.group)
        xout, _ = self.stage.decode(self.stage.params,
                                    self.caches[work.group], xin, work.pos)
        return xout

    def run_chunk(self, work, xin):
        raise RuntimeError(
            "chunked prefill (PrefillChunkWork) requires cache='paged'; the "
            "dense cache admits whole prompts only")


def make_stage_cache(stage, group_size: int, cache_len: int, spec=None):
    """One stage's serving cache: dense per-group blocks, or the paged
    slab pool when a :class:`repro_torch.serve.paged_cache.PagedCacheSpec`
    is given."""
    if spec is None:
        return DenseStageCache(stage, group_size)
    from repro_torch.serve.paged_cache import PagedStageCache

    return PagedStageCache(stage, group_size, cache_len, spec)


def _sync(stage) -> None:
    """Wait for the stage's queued work on its cards, once a card however
    many ranks share it (a no-op on the CPU)."""
    devices = {stage.device} if stage.mesh is None else set(
        stage.mesh.devices)
    for device in devices:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()


def serve_stage_apply(stage, cache, work, xin):
    """Run one work item through one serve stage, updating the stage's
    persistent cache (a :class:`DenseStageCache` or ``PagedStageCache``)
    in place; returns the stage's output (the hidden mid-pipeline, the
    logits on the last stage) once the card has computed it. Shared by the
    actor executor and the monolithic engine so their math is identical.
    Grad mode is thread-local, and actor threads are fresh every round, so
    inference mode is entered here; on a mesh, :func:`repro_torch.core.mesh
    .spmd` enters it in every rank thread too. A stage on a mesh carries
    per-rank payloads (see :class:`repro_torch.core.lowering.ServeStage`)."""
    with torch.inference_mode():
        if isinstance(work, PrefillWork):
            xout, slot_caches = stage.prefill(stage.params, xin,
                                              work.last_index)
            cache.write_prefill(work, slot_caches)
        elif isinstance(work, PrefillChunkWork):
            xout = cache.run_chunk(work, xin)
        else:
            xout = cache.run_decode(work, xin)
        _sync(stage)
    return xout


def _make_sampler(sstaged, sampling):
    """The sampler stream of the stage that owns the decode head, on that
    stage's device; None without ``sampling``."""
    if sampling is None:
        return None
    from repro_torch.serve.sampler import SamplerStream

    return SamplerStream(sampling, sstaged.cfg.vocab_size,
                         sstaged.stages[-1].device)


def _finish_round_item(sampler, work, logits):
    """Shape one round result. Without a sampler the result is the raw
    logits. With one, it is ``{"logits", "tokens"}``: the sampler draws
    once per token-producing item (never for a non-final chunk), in work
    order, so every backend consumes the stream identically."""
    if sampler is None:
        return logits
    with torch.inference_mode():
        if isinstance(work, PrefillChunkWork):
            if not work.final:
                return {"logits": logits, "tokens": None}
            return {"logits": logits, "tokens": sampler.sample(logits[-1])}
        return {"logits": logits, "tokens": sampler.sample(logits)}


class InlineServeEngine:
    """``backend="monolithic"`` serving: the same round protocol as the
    actor executor, run inline (no actors) over a whole-stack
    ``lower_serve_stages(num_stages=1)`` program — the reference the
    pipelined engine is checked against, token for token. One persistent
    stage cache per stage (dense blocks or the paged pool) and the optional
    sampler stream; ``rounds``/``total_makespan`` accumulate, and so does
    ``item_seconds``, the wall time of each kind of work item (every item
    ends in a device sync, so it holds the card's time too)."""

    def __init__(self, sstaged, cache_spec=None, sampling=None):
        self.sstaged = sstaged
        self.stage_caches = [
            make_stage_cache(stage, sstaged.group_size, sstaged.cache_len,
                             cache_spec)
            for stage in sstaged.stages]
        self.sampler = _make_sampler(sstaged, sampling)
        self.rounds = 0
        self.total_makespan = 0.0
        self.last_makespan: Optional[float] = None
        self.item_seconds = {"prefill": 0.0, "chunk": 0.0, "decode": 0.0}

    def run_round(self, work: Sequence, timeout: float = 300.0) -> List:
        t0 = time.perf_counter()
        results = []
        for w in work:
            t_item = time.perf_counter()
            xin = _work_input(w)
            for cache in self.stage_caches:
                xin = serve_stage_apply(cache.stage, cache, w, xin)
            results.append(_finish_round_item(self.sampler, w, xin))
            kind = ("prefill" if isinstance(w, PrefillWork) else
                    "chunk" if isinstance(w, PrefillChunkWork) else "decode")
            self.item_seconds[kind] += time.perf_counter() - t_item
        self.last_makespan = time.perf_counter() - t0
        self.rounds += 1
        self.total_makespan += self.last_makespan
        return results


def serve_stage_actor_specs(sstaged, regs: Optional[Sequence[int]] = None,
                            cache_spec=None, sampling=None
                            ) -> Tuple[List[ActorSpec], str]:
    """Build the persistent serve actor graph: an ``admit`` source emitting
    the round's work items (delivered via ``ctx["admit"]``, with ``fires``
    set to the round's work count) and one ``stage{s}`` actor per model
    shard at node ``s + 1``, each owning its stage cache (dense per-group
    blocks, or the paged pool under ``cache_spec``) as closure state, with
    out-register quota ``regs[s]`` (default :func:`serve_regs`). The last
    stage also owns the sampler stream under ``sampling``. Returns
    ``(specs, final_stage_name)``."""
    S = sstaged.num_stages
    regs = serve_regs(S) if regs is None else _validate_regs(regs, S)

    cell: Dict[str, Any] = {"work": []}

    def on_epoch(v):
        if v is not None:
            cell["work"] = list(v)

    specs: List[ActorSpec] = [ActorSpec(
        name="admit", fn=lambda version: {"work": cell["work"][version]},
        inputs=(), out_regs=2, node=0, thread=0, max_fires=0,
        wants_version=True, on_epoch=on_epoch)]

    def make_stage_fn(stage):
        cache = make_stage_cache(stage, sstaged.group_size, sstaged.cache_len,
                                 cache_spec)
        # the sampler stream is closure state of the LAST stage actor,
        # drawn once per token-producing fire; fires are FIFO in submission
        # order, so the stream is the monolithic engine's
        sampler = _make_sampler(sstaged, sampling) if stage.last else None

        def run_stage(payload):
            work = payload["work"]
            xin = payload.get("x")
            if xin is None:                       # first stage: token ids in
                xin = _work_input(work)
            xout = serve_stage_apply(stage, cache, work, xin)
            if stage.last:
                return {"work": work,
                        "result": _finish_round_item(sampler, work, xout)}
            return {"work": work, "x": xout}
        run_stage.cache = cache
        return run_stage

    for s, stage in enumerate(sstaged.stages):
        specs.append(ActorSpec(
            name=f"stage{s}", fn=make_stage_fn(stage),
            inputs=("admit",) if s == 0 else (f"stage{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0, max_fires=0))
    return specs, f"stage{S - 1}"


class ServeSpecBuilder(_SpecBuilderBase):
    """Builder of the continuous-batching serve actor graph."""

    def __init__(self, staged, regs=None, cache_spec=None, sampling=None,
                 recipe=None):
        super().__init__(staged, recipe)
        self.regs = None if regs is None else list(regs)
        self.cache_spec = cache_spec
        self.sampling = sampling

    def __call__(self):
        return serve_stage_actor_specs(self.staged, regs=self.regs,
                                       cache_spec=self.cache_spec,
                                       sampling=self.sampling)


class ServePipelineExecutor(_StagedExecutorBase):
    """Run a :class:`repro_torch.core.lowering.ServeStagedProgram` as a
    pipelined continuous-batching decode engine.

    The actor graph persists across rounds; per-stage, per-group caches are
    closure state inside each ``stage{s}`` actor. Each :meth:`run_round` is
    one epoch: the round's work items travel in ``ctx``, the per-actor fire
    bound is the round's work count, and the last stage's logits are
    collected in emission order. ``regs[s]`` is stage s's out-register
    quota (default :func:`serve_regs`, the 1F1B rule); quota back-pressure
    alone bounds how many groups are in flight. ``cache_spec`` (a
    :class:`repro_torch.serve.paged_cache.PagedCacheSpec`) gives every
    stage the paged pool; ``sampling`` (a
    :class:`repro_torch.serve.sampler.SamplingSpec`) gives the last stage
    the sampler stream. ``rounds`` and ``total_makespan`` accumulate over
    the session. Under ``runtime="processes"`` (with a
    :class:`repro_torch.runtime.recipes.ServeRecipe`) each stage and its
    caches live in a worker process of its own.
    """

    def __init__(self, sstaged, regs: Optional[Sequence[int]] = None,
                 runtime: str = "threads", cache_spec=None, sampling=None,
                 recipe=None):
        super().__init__(runtime=runtime, recipe=recipe)
        self.sstaged = sstaged
        S = sstaged.num_stages
        self.regs = serve_regs(S) if regs is None else _validate_regs(regs, S)
        self.cache_spec = cache_spec
        self.sampling = sampling
        self.rounds = 0
        self.total_makespan = 0.0

    def _make_builder(self):
        return ServeSpecBuilder(self.sstaged, regs=self.regs,
                                cache_spec=self.cache_spec,
                                sampling=self.sampling, recipe=self.recipe)

    @property
    def stage_caches(self) -> List:
        """Each stage actor's cache (a :class:`DenseStageCache` or
        ``PagedStageCache``), as the inline engine's ``stage_caches``;
        threads runtime only (a worker process owns its stage's cache)."""
        if self.runtime_kind != "threads":
            raise ValueError("stage_caches: a worker process owns each "
                             "stage's cache under runtime='processes'")
        rt = self.runtime
        return [rt.by_name[f"stage{s}"].spec.fn.cache
                for s in range(self.sstaged.num_stages)]

    def run_round(self, work: Sequence, timeout: float = 300.0) -> List:
        """Stream ``work`` (PrefillWork/PrefillChunkWork/DecodeWork items)
        through the stage actors; returns one entry per item in submission
        order: the last stage's logits, or ``{"logits", "tokens"}`` dicts
        when sampling is on."""
        if not work:
            return []
        work = list(work)
        n = len(work)
        S = self.sstaged.num_stages
        fires = {"admit": n}
        fires.update({f"stage{s}": n for s in range(S)})
        outs = self._run_rt({"admit": work}, fires, timeout)
        if len(outs) != n:
            raise RuntimeError(f"collected {len(outs)} round results, "
                               f"expected {n}")
        self.rounds += 1
        self.total_makespan += self.last_makespan
        # the final stage fires in FIFO submission order in one worker
        return [o["result"] for o in outs]
