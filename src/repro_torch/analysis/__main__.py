"""CLI for the static plan verifier.

Analyze a config-zoo model's pipeline plan without lowering or executing
anything (no device is touched; the printed milliseconds are host time)::

    python -m repro_torch.analysis deepseek-v3-671b --stages 8 --regs 1f1b
    python -m repro_torch.analysis qwen3-1.7b --stages 4 --regs 2,2,1,1 --mode train

Builds the model's layer-stack logical graph (one matmul block per layer,
cut into ``--stages`` contiguous stages), plans SBP signatures, mirrors the
executor's actor topology as a dummy-fn skeleton, and runs the deadlock,
SBP-legality and memory-bound passes.  Exit code 1 on a FAIL verdict.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from repro_torch.analysis import membound, run_static_checks
from repro_torch.analysis.skeleton import (infer_spec_skeleton,
                                           train_spec_skeleton)
from repro_torch.core.graph import LogicalGraph, partition_stages
from repro_torch.core.placement import Placement
from repro_torch.core.planner import plan as plan_sbp


def build_stack_graph(num_layers: int, d_model: int, num_stages: int,
                      batch: int = 8) -> LogicalGraph:
    """A synthetic per-layer matmul stack pinned to contiguous stages — the
    same shape/stage structure the real lowered models have, cheap enough
    to plan at 671B scale."""
    placement = Placement(("d",), (1,), device_kind="cpu")
    g = LogicalGraph(placement)
    x = g.input("x", (batch, d_model), sbp="B")
    h = x
    for i in range(num_layers):
        w = g.input(f"w{i}", (d_model, d_model))
        stage = min(i * num_stages // num_layers, num_stages - 1)
        with g.stage(stage):
            h = g.matmul(h, w, name=f"layer{i}")
    return g


def parse_regs(text: str, num_stages: int, num_microbatches: int) -> List[int]:
    if text == "1f1b":
        return [max(1, num_stages - s) for s in range(num_stages)]
    if text == "gpipe":
        return [num_microbatches] * num_stages
    if text == "serial":
        return [1] * num_stages
    return [int(part) for part in text.split(",")]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan verifier over a config-zoo model")
    parser.add_argument("config", help="config name (repro_torch.configs registry)")
    parser.add_argument("--stages", type=int, default=4)
    parser.add_argument("--regs", default="1f1b",
                        help="'1f1b' | 'gpipe' | 'serial' | comma list")
    parser.add_argument("--microbatches", type=int, default=8)
    parser.add_argument("--mode", choices=("infer", "train"),
                        default="train")
    args = parser.parse_args(argv)

    from repro_torch.configs.registry import get_config

    cfg = get_config(args.config)
    regs = parse_regs(args.regs, args.stages, args.microbatches)
    if len(regs) != args.stages:
        print(f"need {args.stages} quotas, got {len(regs)}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    graph = build_stack_graph(cfg.num_layers, cfg.d_model, args.stages)
    plan = plan_sbp(graph)
    partition = partition_stages(graph)
    if args.mode == "train":
        specs = train_spec_skeleton(args.stages, args.microbatches, regs)
    else:
        specs = infer_spec_skeleton(args.stages, args.microbatches, regs)
    memory = membound.stage_boundary_bound(graph, plan, partition, regs,
                                          args.microbatches)
    report = run_static_checks(specs=specs, graph=graph, plan=plan,
                               partition=partition, memory=memory)
    elapsed = time.perf_counter() - t0

    print(f"model: {cfg.name} ({cfg.num_layers} layers, "
          f"d_model={cfg.d_model})")
    print(f"plan: {args.stages} stages, regs={regs}, "
          f"microbatches={args.microbatches}, mode={args.mode}")
    print(report.describe())
    print(f"analyzer wall time: {elapsed * 1e3:.1f} ms")
    return 0 if report.verdict == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
