"""MLP layers: dense SwiGLU (port of ``repro/models/mlp.py:29-49``) and the
capacity-routed MoE (``:56-131``) on one device.

On a mesh a rank holds the column-parallel ``w_gate``/``w_up`` S(1) and
the row-parallel ``w_down`` S(0) blocks of its hidden units
(:func:`repro_torch.models.transformer.block_specs`), so
:func:`dense_mlp_forward` of its shards is the P(sum) partial that the
block psums over the model axis. The MoE's expert parallelism (experts
S(0) over ``model``) is ROADMAP Queue 1 item 13: :func:`moe_forward` runs
every expert on its device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param, swiglu


class DenseMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_gate = param(torch.empty((d_model, d_ff), **kw))
        self.w_up = param(torch.empty((d_model, d_ff), **kw))
        self.w_down = param(torch.empty((d_ff, d_model), **kw))


def init_dense_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> DenseMLP:
    with torch.device("meta"):
        p = DenseMLP(d_model, d_ff)             # shapes only; filled below
    p.w_gate = param(dense_init(gen, (d_model, d_ff)))
    p.w_up = param(dense_init(gen, (d_model, d_ff)))
    p.w_down = param(dense_init(gen, (d_ff, d_model)))
    return p


def dense_mlp_forward(p: DenseMLP, x):
    dt = x.dtype
    return swiglu(x @ p.w_gate.to(dt), x @ p.w_up.to(dt)) @ p.w_down.to(dt)


class MoE(nn.Module):
    """The reference's MoE leaves (``init_moe``): ``router (d, E)``, the
    expert stacks ``w_gate``/``w_up (E, d, ff)`` and ``w_down (E, ff, d)``,
    and with shared experts ``shared``, a dense SwiGLU of ``ff *
    num_shared_experts`` units."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        kw = dict(device=device, dtype=dtype)
        self.router = param(torch.empty((d, E), **kw))
        self.w_gate = param(torch.empty((E, d, ff), **kw))
        self.w_up = param(torch.empty((E, d, ff), **kw))
        self.w_down = param(torch.empty((E, ff, d), **kw))
        if cfg.num_shared_experts:
            self.shared = DenseMLP(d, ff * cfg.num_shared_experts, **kw)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> MoE:
    """The port's seeded MoE weights, the reference's distributions (its
    ``dense_init`` takes the fan-in from axis 0, so the expert stacks are
    drawn at std ``1 / sqrt(E)``)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    with torch.device("meta"):
        p = MoE(cfg)                            # shapes only; filled below
    p.router = param(dense_init(gen, (d, E), scale=0.1))
    p.w_gate = param(dense_init(gen, (E, d, ff)))
    p.w_up = param(dense_init(gen, (E, d, ff)))
    p.w_down = param(dense_init(gen, (E, ff, d)))
    if cfg.num_shared_experts:
        p.shared = init_dense_mlp(gen, d, ff * cfg.num_shared_experts)
    return p


def top_k(x, k: int):
    """The ``k`` largest entries along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none): a
    stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Tokens an expert takes: ``ceil(T K / E * capacity_factor)``, at least
    1 and at most ``T`` (``mlp.py:115-116``)."""
    cap = max(1, int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                               * cfg.capacity_factor)))
    return min(cap, tokens)


def moe_forward(p: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Capacity-routed MoE (``mlp.py:81-131``) on one device. x: (B, S, d).
    Top-k of the float32 router softmax per token, gates renormalised; the
    affinity matrix ``A (T, E)``; each expert takes the ``cap`` tokens of
    highest affinity (a token past an expert's capacity is dropped there:
    its affinity-0 picks carry weight 0), runs its SwiGLU on them in one
    batched product over experts (``torch.bmm``) and scatter-adds the
    gated outputs back; the shared experts' dense MLP adds to that.
    Returns ``(out (B, S, d), aux)``, the Switch-style load-balance loss
    ``E * sum_e f_e * P_e`` in float32. The scatter-add accumulates with
    ``index_put_``, whose CUDA kernel sums a row's contributions in a
    fixed order (sorted indices), so a call repeats its bits."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    t = x.reshape(T, d)
    logits = (t @ p.router.to(dt)).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)                                # (T, K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    f = F.one_hot(idx, E).float().sum(dim=(0, 1)) / (T * K)
    aux = E * torch.sum(f * probs.mean(dim=0))

    A = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    A.scatter_(1, idx, gates)                 # a token's K experts differ
    vals, tok = top_k(A.t(), moe_capacity(cfg, T))              # (E, cap)

    xe = t[tok]                                                 # (E, cap, d)
    h = swiglu(torch.bmm(xe, p.w_gate.to(dt)), torch.bmm(xe, p.w_up.to(dt)))
    y = torch.bmm(h, p.w_down.to(dt)) * vals[..., None].to(dt)
    out = torch.zeros((T, d), dtype=dt, device=x.device)
    out.index_put_((tok.reshape(-1),), y.reshape(-1, d), accumulate=True)
    if cfg.num_shared_experts:
        out = out + dense_mlp_forward(p.shared, t)
    return out.reshape(B, S, d), aux
