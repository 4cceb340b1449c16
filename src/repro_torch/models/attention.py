"""GQA attention: the prefill and one-token decode halves.

Port of the GQA half of ``repro/models/attention.py`` at tp = 1. The kernel
call sites are the reference's three ref call sites:

* :func:`gqa_forward` calls :func:`repro_torch.kernels.flash_attention
  .flash_attention` where the reference calls ``flash_attention_triangular``
  / ``flash_attention_ref`` (``attention.py:148-154``);
* :func:`gqa_decode` calls :func:`repro_torch.kernels.flash_decode
  .flash_decode` where the reference calls ``flash_decode_partial_ref``
  (``attention.py:268-272``).

On CUDA tensors both launch the Hopper kernels; on CPU tensors they run the
plain versions. Weights are cast to the activations' dtype at each use, as
the reference casts ``p[...].astype(x.dtype)``: training keeps float32
params and lets the gradient flow back through the cast, and serving's
pre-cast weights make the cast a no-op. MLA and the ring (sliding-window)
decode cache wait (ROADMAP Queue 1 item 13, Queue 2 item 3).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.common import (MeshPlan, apply_rope, dense_init, param,
                                       rms_norm)


def q_heads_local(cfg: ModelConfig, plan: MeshPlan) -> int:
    return cfg.padded_heads(plan.tp) // plan.tp


def kv_heads_local(cfg: ModelConfig, plan: MeshPlan) -> int:
    tp, kv = plan.tp, cfg.num_kv_heads
    if kv >= tp:
        assert kv % tp == 0, (kv, tp)
        return kv // tp
    assert tp % kv == 0, (kv, tp)
    return 1


class GQAttention(nn.Module):
    """GQA weights: ``wq (d, Hp*hd)``, ``wk``/``wv (d, KV*hd)``,
    ``wo (Hp*hd, d)``, optional biases and per-head q/k norms — the
    reference's param names and layouts (``x @ w``)."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        Hp, KV = cfg.padded_heads(plan.tp), cfg.num_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = param(torch.empty((d, Hp * hd), **kw))
        self.wk = param(torch.empty((d, KV * hd), **kw))
        self.wv = param(torch.empty((d, KV * hd), **kw))
        self.wo = param(torch.empty((Hp * hd, d), **kw))
        if cfg.qkv_bias:
            self.bq = param(torch.zeros((Hp * hd,), **kw))
            self.bk = param(torch.zeros((KV * hd,), **kw))
            self.bv = param(torch.zeros((KV * hd,), **kw))
        if cfg.qk_norm:
            self.q_norm = param(torch.ones((hd,), **kw))
            self.k_norm = param(torch.ones((hd,), **kw))


def init_gqa(gen: torch.Generator, cfg: ModelConfig,
             plan: MeshPlan) -> GQAttention:
    with torch.device("meta"):
        p = GQAttention(cfg, plan)              # shapes only; filled below
    d, hd = cfg.d_model, cfg.head_dim
    Hp, KV = cfg.padded_heads(plan.tp), cfg.num_kv_heads
    wq = dense_init(gen, (d, Hp * hd))
    p.wk = param(dense_init(gen, (d, KV * hd)))
    p.wv = param(dense_init(gen, (d, KV * hd)))
    wo = dense_init(gen, (Hp * hd, d))
    if Hp != cfg.num_heads:       # zero the padded q heads and their wo rows
        real = cfg.num_heads * hd
        wq[:, real:] = 0.0
        wo[real:, :] = 0.0
    p.wq, p.wo = param(wq), param(wo)
    for name, t in list(p.named_parameters()):
        if t.is_meta:             # biases start at 0, q/k norms at 1
            fill = 1.0 if name.endswith("_norm") else 0.0
            setattr(p, name, param(torch.full(t.shape, fill,
                                              device=gen.device)))
    return p


def _project_qkv(p: GQAttention, x, cfg: ModelConfig, plan: MeshPlan,
                 positions):
    hd = cfg.head_dim
    qh, n_kv = q_heads_local(cfg, plan), kv_heads_local(cfg, plan)
    B, S = x.shape[0], x.shape[1]
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(B, S, qh, hd)
    k = k.reshape(B, S, n_kv, hd)
    v = v.reshape(B, S, n_kv, hd)
    if cfg.qk_norm:                 # per head, before RoPE
        q = rms_norm(q, p.q_norm.to(dt), cfg.norm_eps)
        k = rms_norm(k, p.k_norm.to(dt), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def gqa_forward(p: GQAttention, x, cfg: ModelConfig, plan: MeshPlan,
                positions, causal: bool = True, sliding_window: int = 0):
    """Prefill self-attention. Returns ``(y, (k, v))``: the output
    projection and the (post-RoPE) keys and values for the decode cache."""
    q, k, v = _project_qkv(p, x, cfg, plan, positions)
    out = flash_attention(q, k, v, causal=causal,
                          sliding_window=sliding_window)
    B, S = x.shape[0], x.shape[1]
    return out.reshape(B, S, -1) @ p.wo.to(x.dtype), (k, v)


def gqa_decode(p: GQAttention, x, cache_k, cache_v, pos, cfg: ModelConfig,
               plan: MeshPlan, sliding_window: int = 0):
    """One-token decode. x: (B, 1, d); cache_k/v: (B, L, KV, hd); pos: (B,)
    int32 absolute positions. Writes the new token's k/v into the caches IN
    PLACE (the reference rebuilds them functionally; the stage owns one
    resident copy) and returns the output projection (B, 1, d)."""
    B = x.shape[0]
    hd, Hp = cfg.head_dim, cfg.padded_heads(plan.tp)
    q, k_new, v_new = _project_qkv(p, x, cfg, plan, pos[:, None])
    q = q[:, 0]                                             # (B, Hp, hd)
    rows = torch.arange(B, device=x.device)
    cols = pos.long()
    cache_k[rows, cols] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, cols] = v_new[:, 0].to(cache_v.dtype)
    _, ll, acc = flash_decode(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                              cur_pos=pos, sliding_window=sliding_window)
    # one shard: combine_partials would weigh it by exp(m - m) = 1
    out = (acc / torch.clamp_min(ll, 1e-30)[..., None]).to(x.dtype)
    return out.reshape(B, 1, Hp * hd) @ p.wo.to(x.dtype)
