"""Static per-device memory bounds from register quotas and SBP signatures.

The actor protocol's only buffering is the out-register pools, so a plan's
peak in-flight bytes per device is bounded *statically*: quota × the
per-device payload bytes of each register stream (activations via
``NdSbp.bytes_per_device`` on the stage boundary signatures, optimizer
moments/masters via the same ZeRO sharding math as
``TrainPipelineExecutor.opt_state_bytes``, serve cache slabs via the
``cache_bytes`` math on the meta device).  The bound is informational — it
is surfaced in ``Session.describe()`` next to the *measured*
``peak_inflight_activations`` so existing instrumentation cross-checks it.
Nothing here allocates a tensor on a device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

from repro_torch.core.graph import LogicalGraph
from repro_torch.core.sbp import NdSbp


def _per_device_bytes(
    graph: LogicalGraph,
    name: str,
    sbp_of: Mapping[str, NdSbp],
    itemsize: Optional[int] = None,
) -> int:
    tensors = {t.name: t for t in graph.tensors}
    t = tensors.get(name)
    if t is None:
        return 0
    sig = sbp_of.get(name)
    size = t.itemsize if itemsize is None else itemsize
    if sig is None:
        nelem = 1
        for d in t.shape:
            nelem *= int(d)
        return nelem * size
    mesh_shape = tuple(graph.placement.mesh_shape())
    return int(sig.bytes_per_device(t.shape, mesh_shape, size))


def infer_memory_bound(
    staged: Any, regs: Sequence[int], num_microbatches: int
) -> Dict[str, int]:
    """Per-stage bound for the forward pipeline: quota × boundary payload."""
    graph = staged.graph
    sbp_of = dict(staged.plan.tensor_sbp)
    sbp_of.update(staged.boundary_sbp)
    mb = max(1, num_microbatches)
    out: Dict[str, int] = {}
    for s, stage in enumerate(staged.stages):
        payload = sum(_per_device_bytes(graph, n, sbp_of)
                      for n in stage.output_names)
        out[f"stage{s}"] = regs[s] * -(-payload // mb)
    return out


def train_memory_bound(
    tstaged: Any,
    regs: Sequence[int],
    num_microbatches: int,
    optimizer: Any = None,
) -> Dict[str, int]:
    """Per-stage bound for the 1F1B pipeline.

    Counts the forward activation stream (quota × boundary bytes per
    microbatch — the registers the 1F1B quota actually caps), the backward
    cotangent stream (quota 2), the fp32 gradient accumulator, and the
    optimizer state streams (AdamW moments, fp32 masters under mixed
    precision), sharded by ``zero_dp`` when ZeRO is on — the same math as
    ``TrainPipelineExecutor.opt_state_bytes``.
    """
    graph = tstaged.graph
    sbp_of = dict(tstaged.plan.tensor_sbp)
    sbp_of.update(tstaged.boundary_sbp)
    opt = optimizer if optimizer is not None else tstaged.optimizer
    stateful = bool(opt is not None and getattr(opt, "stateful", False))
    mp = bool(opt is not None and getattr(opt, "mixed_precision", False))
    zero_dp = 1
    if opt is not None and getattr(opt, "zero", False):
        zero_dp = max(1, int(getattr(opt, "zero_dp", 1)))
    mb = max(1, num_microbatches)
    out: Dict[str, int] = {}
    for s, stage in enumerate(tstaged.stages):
        fwd_payload = sum(_per_device_bytes(graph, n, sbp_of)
                          for n in stage.output_names)
        cot_payload = sum(
            _per_device_bytes(graph, n, sbp_of)
            for n in stage.diff_input_names if n not in stage.param_names)
        total = regs[s] * -(-fwd_payload // mb)
        total += 2 * -(-cot_payload // mb)
        if stage.param_names:
            # element count per device = bytes_per_device at itemsize 1
            nelem = sum(_per_device_bytes(graph, n, sbp_of, itemsize=1)
                        for n in stage.param_names)
            total += 4 * nelem                      # fp32 grad accumulator
            state = 0
            if stateful:
                state += 2 * 4 * nelem              # AdamW m + v, fp32
            if mp:
                state += 4 * nelem                  # fp32 masters
            total += state // zero_dp
        out[f"stage{s}"] = total
    return out


def stage_boundary_bound(
    graph: LogicalGraph,
    plan: Any,
    partition: Any,
    regs: Sequence[int],
    num_microbatches: int,
) -> Dict[str, int]:
    """Per-stage bound straight from (graph, plan, partition) — no lowering.

    A stage's register payload is its boundary tensors: produced at stage
    ``s`` and consumed at a later stage (or a graph sink at the last stage).
    Used by the CLI and the plan-search oracle, where no staged program
    exists yet.
    """
    stage_of_tensor = {op.output.name: partition.stage_of[op.name]
                       for op in graph.ops}
    mb = max(1, num_microbatches)
    boundary: Dict[int, int] = {s: 0 for s in range(partition.num_stages)}
    sinks = {t.name for t in graph.sinks()}
    for op in graph.ops:
        t = op.output
        src = stage_of_tensor[t.name]
        crosses = t.name in sinks and src == partition.num_stages - 1
        for consumer in graph.consumers(t):
            if partition.stage_of[consumer.name] > src:
                crosses = True
        if crosses:
            boundary[src] += _per_device_bytes(graph, t.name, plan.tensor_sbp)
    return {f"stage{s}": regs[s] * -(-boundary[s] // mb)
            for s in range(partition.num_stages)}


def monolithic_memory_bound(graph: LogicalGraph, plan: Any) -> Dict[str, int]:
    """Whole-graph bound: every planned tensor resident at once."""
    total = sum(_per_device_bytes(graph, t.name, plan.tensor_sbp)
                for t in graph.tensors)
    return {"whole-graph": total}


def serve_cache_bound(
    sstaged: Any,
    num_groups: int,
    cache: str = "dense",
    cache_spec: Any = None,
) -> Dict[str, int]:
    """Per-stage persistent cache reservation of the serve pipeline (paged
    slab or dense), from each stage's cache template on the meta device:
    nothing is allocated. On a mesh every rank has its own template and
    the bound, per device, takes the fullest rank."""
    from repro_torch.serve.paged_cache import dense_bytes, slab_bytes

    out: Dict[str, int] = {}
    for s, stage in enumerate(sstaged.stages):
        template = stage.init_caches(sstaged.group_size, device="meta")
        per_rank = template if stage.mesh is not None else [template]
        if cache == "paged":
            out[f"stage{s}"] = max(slab_bytes(t, cache_spec)
                                   for t in per_rank)
        else:
            out[f"stage{s}"] = max(dense_bytes(t, num_groups)
                                   for t in per_rank)
    return out


def serve_param_bound(sstaged: Any) -> Dict[str, int]:
    """Per-stage weight bytes a rank of the serve pipeline holds, counted
    from the model's shapes and signatures on the meta device (nothing is
    allocated): the stage's blocks at each leaf's shard under
    :func:`repro_torch.models.transformer.spec_of` (an MoE layer's ``E /
    tp`` expert stacks, MLA's latent projection whole on every rank), the
    embedding on the first stage and the head on the last, in the compute
    dtype (leaves the model reads in float32 at 4 bytes). Every rank holds
    as much (the signatures split evenly), so this is each rank's count.
    It sits beside :func:`serve_memory_bound`, which counts what the
    reference's does (registers and caches), not the weights."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.mamba import FLOAT32_PARAMS
    from repro_torch.optim.zero import local_shape_of

    cfg, plan = sstaged.cfg, sstaged.plan
    itemsize = T.compute_dtype(cfg).itemsize
    with torch.device("meta"):
        shapes = {n: tuple(t.shape) for n, t in
                  T.Transformer(cfg, plan).state_dict().items()}
    units = T.stage_units(cfg)
    out: Dict[str, int] = {}
    for s, stage in enumerate(sstaged.stages):
        layers = {li for u in units[stage.units[0]:stage.units[1]]
                  for li in u}
        total = 0
        for name, shape in shapes.items():
            parts = name.split(".")
            if parts[0] == "blocks":
                if int(parts[1]) not in layers:
                    continue
            elif not ((stage.first and name == "embed") or (
                    stage.last and name in ("final_norm", "unembed"))):
                continue
            nelem = 1
            for d in local_shape_of(shape, T.spec_of(name, cfg, plan), plan):
                nelem *= d
            total += nelem * (4 if parts[-1] in FLOAT32_PARAMS
                              else itemsize)
        out[f"stage{s}"] = total
    return out


def serve_memory_bound(
    sstaged: Any,
    regs: Sequence[int],
    num_groups: int,
    cache: str = "dense",
    cache_spec: Any = None,
) -> Dict[str, int]:
    """Per-stage bound for the serve pipeline: quota × hidden payload plus
    the persistent per-stage cache reservation (:func:`serve_cache_bound`).
    The payload is a group's ``(group_size, d_model)`` hidden, or on the
    last stage its padded-vocab logits, at the itemsize of the stages'
    compute dtype."""
    from repro_torch.models.transformer import compute_dtype

    cfg = sstaged.cfg
    itemsize = compute_dtype(cfg).itemsize
    hidden = sstaged.group_size * cfg.d_model * itemsize
    logits = sstaged.group_size * cfg.padded_vocab() * itemsize
    caches = serve_cache_bound(sstaged, num_groups, cache, cache_spec)
    return {name: regs[s] * (logits if stage.last else hidden) + caches[name]
            for s, (name, stage) in enumerate(zip(caches, sstaged.stages))}
