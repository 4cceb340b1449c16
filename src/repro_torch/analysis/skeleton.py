"""Dummy-fn actor-graph skeletons mirroring the real executor topologies.

The deadlock pass only reads the *wiring* of an ``ActorSpec`` graph — names,
inputs, quotas, fire bounds, emit rates — never the stage bodies.  These
builders reproduce the exact topologies of
:func:`repro_torch.runtime.pipeline.stage_actor_specs`,
:func:`repro_torch.runtime.pipeline.train_stage_actor_specs` and
:func:`repro_torch.runtime.pipeline.serve_stage_actor_specs` with trivial fns, so
the CLI and benchmarks can analyze a plan without lowering any stage program,
and ``min_feasible_stage_regs`` can search quota vectors cheaply.  A parity
test pins these skeletons against the real builders field by field.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.runtime.actor import ActorSpec


def _noop(*args: object) -> int:
    return 0


def _default_regs(num_stages: int) -> List[int]:
    return [max(1, num_stages - s) for s in range(num_stages)]


def infer_spec_skeleton(
    num_stages: int,
    num_microbatches: int,
    regs: Optional[Sequence[int]] = None,
) -> List[ActorSpec]:
    """Topology of the forward pipeline: data -> stage0 -> ... -> stage{S-1}."""
    regs = _default_regs(num_stages) if regs is None else list(regs)
    specs = [ActorSpec(name="data", fn=_noop, inputs=(), out_regs=2,
                       node=0, thread=0, max_fires=num_microbatches)]
    for s in range(num_stages):
        specs.append(ActorSpec(
            name=f"stage{s}", fn=_noop,
            inputs=("data",) if s == 0 else (f"stage{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0,
            max_fires=num_microbatches))
    return specs


def train_spec_skeleton(
    num_stages: int,
    num_microbatches: int,
    regs: Optional[Sequence[int]] = None,
    *,
    param_stages: Optional[Sequence[int]] = None,
    loss_stage: Optional[int] = None,
    clip: bool = False,
    dynamic: bool = False,
    stateful: bool = False,
    snapshot: bool = False,
) -> List[ActorSpec]:
    """Topology of the 1F1B training pipeline, including the sideways
    ``norm``/``scale`` edges and the ``state{s}``/``snap{s}`` streams."""
    S = num_stages
    M = num_microbatches
    regs = _default_regs(S) if regs is None else list(regs)
    pstages = list(range(S)) if param_stages is None else list(param_stages)
    need_norm = clip or dynamic

    specs = [ActorSpec(name="data", fn=_noop, inputs=(), out_regs=2,
                       node=0, thread=0, max_fires=M)]
    for s in range(S):
        specs.append(ActorSpec(
            name=f"f{s}", fn=_noop,
            inputs=("data",) if s == 0 else (f"f{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0, max_fires=M))
        specs.append(ActorSpec(
            name=f"b{s}", fn=_noop,
            inputs=(f"f{s}",) if s == S - 1 else (f"f{s}", f"b{s+1}"),
            out_regs=2, node=s + 1, thread=0, max_fires=M))
        if s in pstages:
            specs.append(ActorSpec(
                name=f"acc{s}", fn=_noop, inputs=(f"b{s}",),
                out_regs=1, node=s + 1, thread=0,
                max_fires=M, emit_every=M))
            opt_inputs: Tuple[str, ...] = (f"acc{s}",)
            if need_norm:
                opt_inputs += ("norm",)
            if dynamic:
                opt_inputs += ("scale",)
            if stateful:
                specs.append(ActorSpec(
                    name=f"state{s}", fn=_noop, inputs=(),
                    out_regs=1, node=s + 1, thread=0, max_fires=1))
                opt_inputs += (f"state{s}",)
            specs.append(ActorSpec(
                name=f"opt{s}", fn=_noop, inputs=opt_inputs,
                out_regs=1, node=s + 1, thread=0, max_fires=1))
            if snapshot:
                specs.append(ActorSpec(
                    name=f"snap{s}", fn=_noop, inputs=(f"opt{s}",),
                    out_regs=1, node=s + 1, thread=1, max_fires=1))
    if need_norm and pstages:
        specs.append(ActorSpec(
            name="norm", fn=_noop,
            inputs=tuple(f"acc{s}" for s in pstages),
            out_regs=1, node=0, thread=0, max_fires=1))
    if dynamic and pstages:
        specs.append(ActorSpec(
            name="scale", fn=_noop, inputs=("norm",),
            out_regs=1, node=0, thread=0, max_fires=1))
    return specs


def serve_spec_skeleton(
    num_stages: int,
    regs: Optional[Sequence[int]] = None,
    *,
    round_items: int = 1,
) -> List[ActorSpec]:
    """Topology of one serve round: admit -> stage0 -> ... -> stage{S-1}.

    The real specs carry ``max_fires=0`` (open-ended, bounded per round via
    ``fires``); the skeleton bounds every actor at ``round_items`` so the
    deadlock pass analyzes one representative round directly.
    """
    regs = _default_regs(num_stages) if regs is None else list(regs)
    specs = [ActorSpec(name="admit", fn=_noop, inputs=(), out_regs=2,
                       node=0, thread=0, max_fires=round_items)]
    for s in range(num_stages):
        specs.append(ActorSpec(
            name=f"stage{s}", fn=_noop,
            inputs=("admit",) if s == 0 else (f"stage{s-1}",),
            out_regs=regs[s], node=s + 1, thread=0, max_fires=round_items))
    return specs
