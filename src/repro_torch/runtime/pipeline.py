"""Serving pipelines: continuous-batching decode on the actor protocol.

Port of the serve half of ``repro/runtime/pipeline.py`` (``:209-332``,
``:1420-1766``) on the threaded runtime. Stage = contiguous
model shard (:func:`repro_torch.core.lowering.lower_serve_stages`);
microbatch = request group. Each round streams one work item per live group
through the stage chain: a :class:`DecodeWork` advances every slot of the
group by one token, a :class:`PrefillWork` runs one freshly admitted
request's prompt and copies its caches into the group cache. A stage's KV
caches never ride the payload — they are persistent state in the stage
actor's closure — so the only tensors crossing stages are the (B, 1, d)
hidden and the final logits. Overlap across groups emerges from the stage
out-register quotas alone (§4.3).

On one card all stages share one CUDA stream in this version, and each
stage synchronises it before handing its output on (the reference's
``block_until_ready``), which is what the makespan instrumentation reads.
Per-stage streams with events are later work (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.runtime.actor import ActorSpec
from repro_torch.runtime.base import RUNTIME_KINDS, make_runtime


def serve_regs(num_stages: int) -> List[int]:
    """The stage out-register quotas: the 1F1B rule ``max(1, S - s)``,
    under which quota back-pressure alone bounds the groups in flight."""
    return [max(1, num_stages - s) for s in range(num_stages)]


class _SpecBuilderBase:
    """Base of the spec builders the executors hand to
    :func:`repro_torch.runtime.base.make_runtime`: carries the lowered
    program (threads only; the process runtime's picklable recipes are not
    ported yet)."""

    def __init__(self, staged):
        self.staged = staged


class _StagedExecutorBase:
    """Shared machinery of the stage-pipeline executors: construction-time
    validation (runtime kind) and the persistent runtime
    underneath — built ONCE from the spec builder on first use and re-run
    per round (one epoch each). Per-run instrumentation (``last_makespan``,
    ``last_history``, ``last_peak_regs``, ``last_edge_bytes``) snapshots
    the most recent epoch."""

    def __init__(self, runtime: str = "threads"):
        if runtime == "processes":
            raise NotImplementedError(
                "runtime='processes' is not ported yet (ROADMAP Queue 1 "
                "item 11)")
        if runtime not in RUNTIME_KINDS:
            raise ValueError(f"unknown runtime {runtime!r}; expected one of "
                             f"{RUNTIME_KINDS}")
        self.runtime_kind = runtime
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
            self._rt = make_runtime(self.runtime_kind, self._make_builder())
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


@dataclasses.dataclass
class PrefillWork:
    """Admit one request: run its prompt, build its slot caches.
    ``tokens`` is (1, prompt_len) int32; ``last_index`` is the prompt's
    final position — the first generated token's logits come from there."""

    group: int
    slot: int
    tokens: Any
    last_index: int


@dataclasses.dataclass
class DecodeWork:
    """Advance every slot of ``group`` by one token. ``tok``/``pos`` are
    (group_size,) int32; retired slots are parked (see
    :class:`repro_torch.serve.admission.AdmissionScheduler`)."""

    group: int
    tok: Any
    pos: Any


def _work_input(work):
    """The first stage's input: prompt ids for a prefill, last tokens for a
    decode."""
    return work.tokens if isinstance(work, PrefillWork) else work.tok


class DenseStageCache:
    """The dense per-group caches of one stage: one ``(group_size,
    cache_len, ...)`` block per slot group, allocated the first time the
    group reaches the stage."""

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


def make_stage_cache(stage, group_size: int, cache_len: int, spec=None):
    """One stage's serving cache (dense per-group blocks)."""
    if spec is not None:
        raise NotImplementedError(
            "cache='paged' is not ported yet (ROADMAP Queue 1 item 1)")
    return DenseStageCache(stage, group_size)


def _sync(device) -> None:
    """Wait for the stage's queued work on the card (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def serve_stage_apply(stage, cache: DenseStageCache, work, xin):
    """Run one work item through one serve stage, updating the stage's
    persistent cache in place; returns the stage's output (the hidden
    mid-pipeline, the logits on the last stage) once the card has computed
    it. Shared by the actor executor and the monolithic engine so their
    math is identical. Grad mode is thread-local, and actor threads are
    fresh every round, so inference mode is entered here."""
    with torch.inference_mode():
        if isinstance(work, PrefillWork):
            xout, slot_caches = stage.prefill(stage.params, xin,
                                              work.last_index)
            cache.write_prefill(work, slot_caches)
        else:
            xout = cache.run_decode(work, xin)
        _sync(stage.device)
    return xout


class InlineServeEngine:
    """``backend="monolithic"`` serving: the same round protocol as the
    actor executor, run inline (no actors) over a whole-stack
    ``lower_serve_stages(num_stages=1)`` program — the reference the
    pipelined engine is checked against, token for token. One persistent
    stage cache per stage; ``rounds``/``total_makespan`` accumulate."""

    def __init__(self, sstaged):
        self.sstaged = sstaged
        self.stage_caches = [
            make_stage_cache(stage, sstaged.group_size, sstaged.cache_len)
            for stage in sstaged.stages]
        self.rounds = 0
        self.total_makespan = 0.0
        self.last_makespan: Optional[float] = None

    def run_round(self, work: Sequence, timeout: float = 300.0) -> List:
        t0 = time.perf_counter()
        results = []
        for w in work:
            xin = _work_input(w)
            for cache in self.stage_caches:
                xin = serve_stage_apply(cache.stage, cache, w, xin)
            results.append(xin)
        self.last_makespan = time.perf_counter() - t0
        self.rounds += 1
        self.total_makespan += self.last_makespan
        return results


def serve_stage_actor_specs(sstaged) -> Tuple[List[ActorSpec], str]:
    """Build the persistent serve actor graph: an ``admit`` source emitting
    the round's work items (delivered via ``ctx["admit"]``, with ``fires``
    set to the round's work count) and one ``stage{s}`` actor per model
    shard at node ``s + 1``, each owning its per-group KV caches as closure
    state, and out-register quota :func:`serve_regs`. Returns ``(specs,
    final_stage_name)``."""
    S = sstaged.num_stages
    regs = serve_regs(S)

    cell: Dict[str, Any] = {"work": []}

    def on_epoch(v):
        if v is not None:
            cell["work"] = list(v)

    specs: List[ActorSpec] = [ActorSpec(
        name="admit", fn=lambda version: {"work": cell["work"][version]},
        inputs=(), out_regs=2, node=0, thread=0, max_fires=0,
        wants_version=True, on_epoch=on_epoch)]

    def make_stage_fn(stage):
        cache = make_stage_cache(stage, sstaged.group_size, sstaged.cache_len)

        def run_stage(payload):
            work = payload["work"]
            xin = payload.get("x")
            if xin is None:                       # first stage: token ids in
                xin = _work_input(work)
            xout = serve_stage_apply(stage, cache, work, xin)
            if stage.last:
                return {"work": work, "result": xout}
            return {"work": work, "x": xout}
        return run_stage

    for s, stage in enumerate(sstaged.stages):
        specs.append(ActorSpec(
            name=f"stage{s}", fn=make_stage_fn(stage),
            inputs=("admit",) if s == 0 else (f"stage{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0, max_fires=0))
    return specs, f"stage{S - 1}"


class ServeSpecBuilder(_SpecBuilderBase):
    """Builder of the continuous-batching serve actor graph."""

    def __call__(self):
        return serve_stage_actor_specs(self.staged)


class ServePipelineExecutor(_StagedExecutorBase):
    """Run a :class:`repro_torch.core.lowering.ServeStagedProgram` as a
    pipelined continuous-batching decode engine.

    The actor graph persists across rounds; per-stage, per-group caches are
    closure state inside each ``stage{s}`` actor. Each :meth:`run_round` is
    one epoch: the round's work items travel in ``ctx``, the per-actor fire
    bound is the round's work count, and the last stage's logits are
    collected in emission order. ``regs[s]`` is stage s's out-register
    quota (:func:`serve_regs`); quota back-pressure alone bounds how many
    groups are in flight. ``rounds`` and ``total_makespan`` accumulate over
    the session.
    """

    def __init__(self, sstaged, runtime: str = "threads"):
        super().__init__(runtime=runtime)
        self.sstaged = sstaged
        self.regs = serve_regs(sstaged.num_stages)
        self.rounds = 0
        self.total_makespan = 0.0

    def _make_builder(self):
        return ServeSpecBuilder(self.sstaged)

    def run_round(self, work: Sequence, timeout: float = 300.0) -> List:
        """Stream ``work`` (PrefillWork/DecodeWork items) through the stage
        actors; returns the last stage's logits per item, in submission
        order."""
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
