"""Serve lowering: the autoregressive model cut into per-stage programs.

Port of ``repro/core/lowering.py:1233-1503`` (dense cache; the paged
``chunk`` program waits, ROADMAP Queue 1 item 1). Stage ``s`` owns a
contiguous slice of the layer stack, balanced by unit count exactly as the
reference; its KV caches never leave the stage — they are a persistent
stage-local register stream, updated in place by every decode fire. The
request-admission runtime half lives in :mod:`repro_torch.runtime.pipeline`.

Where the reference jits each stage program under ``shard_map``, a stage
here is eager PyTorch over the stage's own copy of its weights, cast ONCE
to the compute dtype at construction (the reference casts
``param.astype(x.dtype)`` at every call; a cast is deterministic, so the
numbers are the same). The SSM params the reference reads in float32
(``dt_bias``, ``A_log``, ``D``) stay float32.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import MeshPlan, param
from repro_torch.models.mamba import FLOAT32_PARAMS
from repro_torch.models.model_zoo import make_decode_caches

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
    ``init_caches(batch) -> caches`` allocates the zeroed group cache;
    ``write_slot(caches, slot_caches, slot)`` copies a freshly prefilled
    request into slot ``slot`` of it.
    """

    index: int
    decode: Callable
    prefill: Callable
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

        def init_caches(batch: int, _layers=layers):
            return make_decode_caches(cfg, plan, batch, cache_len, device,
                                      layers=_layers)

        stages.append(ServeStage(
            index=s, decode=decode, prefill=prefill,
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
