"""MLP layers: dense SwiGLU (port of ``repro/models/mlp.py:29-49``) and the
capacity-routed MoE (``:56-131``).

On a mesh a rank holds the column-parallel ``w_gate``/``w_up`` S(1) and
the row-parallel ``w_down`` S(0) blocks of its hidden units
(:func:`repro_torch.models.transformer.block_specs`), so
:func:`dense_mlp_forward` of its shards is the P(sum) partial that the
block psums over the model axis. The MoE is expert-parallel: the expert
stacks are S(0) over ``model``, each rank routes the replicated tokens to
its ``E / tp`` experts, and its output (with the shared experts'
row-parallel partial added, one deferred psum) is P(sum) too.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as M
from repro_torch.models.common import MeshPlan, dense_init, param, swiglu


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


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> MoE:
    """The port's seeded MoE weights, the reference's distributions (its
    ``dense_init`` takes the fan-in from axis 0, so the expert stacks are
    drawn at std ``1 / sqrt(E)``). Each expert stack is cast to ``dtype``
    as it is drawn (the draws, their order and so the values are
    ``dtype``'s cast of the float32 init's), so one float32 stack is
    resident at a time, not the three; the router and the shared experts
    stay float32 here (the block's cast takes them)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    with torch.device("meta"):
        p = MoE(cfg)                            # shapes only; filled below
    p.router = param(dense_init(gen, (d, E), scale=0.1))
    p.w_gate = param(dense_init(gen, (E, d, ff), dtype=dtype))
    p.w_up = param(dense_init(gen, (E, d, ff), dtype=dtype))
    p.w_down = param(dense_init(gen, (E, ff, d), dtype=dtype))
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


def moe_forward(p: MoE, x, cfg: ModelConfig,
                plan: MeshPlan = MeshPlan()) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Capacity-routed MoE (``mlp.py:81-131``) on one rank of ``plan``'s
    mesh (one device at tp = 1). x: (B, S, d), replicated over ``model``.
    Top-k of the float32 router softmax per token, gates renormalised; the
    rank's affinity matrix ``A (T, E / tp)`` over its experts ``[lo, lo +
    E / tp)``, every pick of another rank's expert sent to column 0 with
    weight 0 and the picks scatter-ADDED (as the reference's ``.at[].add``:
    a plain scatter would let a non-local pick's 0 overwrite a real gate
    in column 0); each expert takes the ``cap`` tokens of highest affinity,
    ``cap`` from the global token count (a token past an expert's capacity
    is dropped there: its affinity-0 picks carry weight 0), runs its
    SwiGLU on them in one batched product over the rank's experts
    (``torch.bmm``) and scatter-adds the gated outputs back; the shared
    experts' dense MLP (its row-parallel partial on a mesh) adds to that.
    Returns ``(out (B, S, d), aux)``: ``out`` the P(sum) partial over
    ``model`` (the whole output at tp = 1) and the Switch-style
    load-balance loss ``E * sum_e f_e * P_e`` in float32, computed whole on
    every rank. The scatter-add accumulates with ``index_put_``, whose CUDA
    kernel sums a row's contributions in a fixed order (sorted indices), so
    a call repeats its bits; ``A``'s adds are exact (a gate plus zeros)."""
    B, S, d = x.shape
    E, K, tp = cfg.num_experts, cfg.top_k, plan.tp
    if E % tp:
        raise ValueError(f"{cfg.name}: {E} experts do not split over "
                         f"tp = {tp} ranks")
    E_loc = E // tp
    T = B * S
    dt = x.dtype
    t = x.reshape(T, d)
    logits = (t @ p.router.to(dt)).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, K)                                # (T, K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    f = F.one_hot(idx, E).float().sum(dim=(0, 1)) / (T * K)
    aux = E * torch.sum(f * probs.mean(dim=0))

    lo = M.axis_index(plan.model_axis) * E_loc if tp > 1 else 0
    local = (idx >= lo) & (idx < lo + E_loc)
    A = torch.zeros((T, E_loc), dtype=torch.float32, device=x.device)
    A.scatter_add_(1, torch.where(local, idx - lo, 0),
                   torch.where(local, gates, 0.0))
    vals, tok = top_k(A.t(), moe_capacity(cfg, T))          # (E_loc, cap)

    xe = t[tok]                                             # (E_loc, cap, d)
    h = swiglu(torch.bmm(xe, p.w_gate.to(dt)), torch.bmm(xe, p.w_up.to(dt)))
    y = torch.bmm(h, p.w_down.to(dt)) * vals[..., None].to(dt)
    out = torch.zeros((T, d), dtype=dt, device=x.device)
    out.index_put_((tok.reshape(-1),), y.reshape(-1, d), accumulate=True)
    if cfg.num_shared_experts:
        out = out + dense_mlp_forward(p.shared, t)      # both P(sum): defer
    return out.reshape(B, S, d), aux
