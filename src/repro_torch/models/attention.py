"""GQA and MLA attention: the prefill and one-token decode halves, GQA also
tensor-parallel over the ``model`` axis of a mesh.

Port of ``repro/models/attention.py``: GQA, and MLA (DeepSeek's multi-head
latent attention, :class:`MLAttention`, ``:291-414``) on one device. SBP view (model
axis), as in the reference: ``wq`` S(1) (heads), ``wk``/``wv`` B (each rank
slices its kv group), ``wo`` S(0), so the output is P(sum), reduced by the
caller. Decode runs over a sequence-sharded KV cache (S(seq) on the model
axis): each rank's shard gives flash-decode partials that the cross-rank
:func:`~repro_torch.kernels.flash_decode.ref.combine_partials` reduces
with pmax/psum. The kernel call sites are the reference's three ref call
sites:

* :func:`gqa_forward` calls :func:`repro_torch.kernels.flash_attention
  .flash_attention` where the reference calls ``flash_attention_triangular``
  / ``flash_attention_ref`` (``attention.py:148-154``);
* :func:`gqa_decode` calls :func:`repro_torch.kernels.flash_decode
  .flash_decode` where the reference calls ``flash_decode_partial_ref``
  (``attention.py:268-272``).

Cross-attention (whisper's decoder, ``init_gqa(..., cross=True)``: no qkv
bias) is :func:`gqa_forward` with ``kv_src=`` the encoder states: q from
x, k and v from them, RoPE on q at the decoder positions and on k at the
encoder's (``kv_positions``), as the reference applies it
(``attention.py:102-158``), then the attention forward with
``causal=False`` (also the encoder's self-attention). Its decode half is
:func:`cross_attn_decode`, the reference's ``_cross_attn_decode``
(``transformer.py:231-242``): q unrotated over the static cross cache,
through the decode attention with every row at ``cur_pos = enc_len - 1``,
whose mask then passes all of the encoder's keys.

On CUDA tensors both launch the Hopper kernels; on CPU tensors they run the
plain versions; on a mesh each rank launches them on its own shard (the
decode kernel at its shard's ``k_offset``). Weights are cast to the
activations' dtype at each use, as the reference casts
``p[...].astype(x.dtype)``: training keeps float32 params and lets the
gradient flow back through the cast, and serving's pre-cast weights make
the cast a no-op. The ring (sliding-window) decode cache waits (ROADMAP
Queue 1 item 13, Queue 2 item 3).

MLA's prefill (:func:`mla_forward`) materialises each head's k and v from
the latent and calls :func:`~repro_torch.kernels.flash_attention
.flash_attention` at q/k head dim ``nope + rope`` and v head dim
``v_head_dim`` (192 and 128 on deepseek-v2-lite), where the reference calls
``flash_attention_triangular`` (``attention.py:355-372``). Its decode
(:func:`mla_decode`) is the reference's absorbed form: scores and outputs
in latent space, plain einsums over the latent cache ``c (B, L, r)`` and
``kpe (B, L, rope)``, as the reference computes them outside any Pallas
kernel. MLA on a mesh (heads over ``model``, the latent cache replicated)
is ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as M
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import combine_partials, flash_decode
from repro_torch.models.common import (  # noqa: F401 (re-exported)
    MODEL_GRAD_SUM_LEAVES, Boxer, MeshPlan, apply_rope, dense_init, param,
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


def _kv_slice(w, cfg: ModelConfig, plan: MeshPlan, hd: int):
    """This rank's kv-head columns of the replicated kv weight (or bias):
    its group's first head, group-aligned for kv < tp."""
    if plan.tp == 1:
        return w
    n_kv = kv_heads_local(cfg, plan)
    start = (M.axis_index(plan.model_axis) * cfg.num_kv_heads) // plan.tp
    return w[..., start * hd:(start + n_kv) * hd]


class GQAttention(nn.Module):
    """GQA weights: ``wq (d, Hp*hd)``, ``wk``/``wv (d, KV*hd)``,
    ``wo (Hp*hd, d)``, optional biases (never on a ``cross`` layer, as in
    the reference's ``init_gqa``) and per-head q/k norms — the reference's
    param names and layouts (``x @ w``)."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, device=None,
                 dtype=torch.float32, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        Hp, KV = cfg.padded_heads(plan.tp), cfg.num_kv_heads
        kw = dict(device=device, dtype=dtype)
        self.wq = param(torch.empty((d, Hp * hd), **kw))
        self.wk = param(torch.empty((d, KV * hd), **kw))
        self.wv = param(torch.empty((d, KV * hd), **kw))
        self.wo = param(torch.empty((Hp * hd, d), **kw))
        if cfg.qkv_bias and not cross:
            self.bq = param(torch.zeros((Hp * hd,), **kw))
            self.bk = param(torch.zeros((KV * hd,), **kw))
            self.bv = param(torch.zeros((KV * hd,), **kw))
        if cfg.qk_norm:
            self.q_norm = param(torch.ones((hd,), **kw))
            self.k_norm = param(torch.ones((hd,), **kw))


def init_gqa(gen: torch.Generator, cfg: ModelConfig, plan: MeshPlan,
             cross: bool = False) -> GQAttention:
    with torch.device("meta"):
        p = GQAttention(cfg, plan, cross=cross)  # shapes only; filled below
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
                 positions, kv_src=None, kv_positions=None):
    """q from x, k and v from ``kv_src`` (x itself for self-attention, the
    encoder states for cross-attention), RoPE on q at ``positions`` and on
    k at ``kv_positions`` (``positions`` for self-attention)."""
    hd = cfg.head_dim
    qh, n_kv = q_heads_local(cfg, plan), kv_heads_local(cfg, plan)
    kv_src = x if kv_src is None else kv_src
    kv_positions = positions if kv_positions is None else kv_positions
    B, S, Skv = x.shape[0], x.shape[1], kv_src.shape[1]
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = kv_src @ _kv_slice(p.wk, cfg, plan, hd).to(dt)
    v = kv_src @ _kv_slice(p.wv, cfg, plan, hd).to(dt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(dt)
        k = k + _kv_slice(p.bk, cfg, plan, hd).to(dt)
        v = v + _kv_slice(p.bv, cfg, plan, hd).to(dt)
    q = q.reshape(B, S, qh, hd)
    k = k.reshape(B, Skv, n_kv, hd)
    v = v.reshape(B, Skv, n_kv, hd)
    if cfg.qk_norm:                 # per head, before RoPE
        q = rms_norm(q, p.q_norm.to(dt), cfg.norm_eps)
        k = rms_norm(k, p.k_norm.to(dt), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, kv_positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def gqa_forward(p: GQAttention, x, cfg: ModelConfig, plan: MeshPlan,
                positions, causal: bool = True, sliding_window: int = 0,
                kv_src=None, kv_positions=None):
    """Prefill attention at this rank's local heads: self-attention, or
    with ``kv_src`` (the encoder states, ``kv_positions`` theirs)
    cross-attention. Returns ``(y, (k, v))``: the output projection,
    P(sum) over the model axis, and this rank's kv heads' (post-RoPE) keys
    and values over the whole key sequence."""
    q, k, v = _project_qkv(p, x, cfg, plan, positions, kv_src, kv_positions)
    out = flash_attention(q, k, v, causal=causal,
                          sliding_window=sliding_window)
    B, S = x.shape[0], x.shape[1]
    return out.reshape(B, S, -1) @ p.wo.to(x.dtype), (k, v)


def kv_to_seq_sharded(k, v, cfg: ModelConfig, plan: MeshPlan,
                      cache_len: int):
    """Boxing for the decode cache: S(head) -> S(seq) on the model axis.

    k, v: (B, S, n_kv, hd), this rank's kv heads. For kv >= tp the
    transition is Table 2's ``S(i) -> S(j)`` all_to_all; for kv < tp the
    heads are replicated in groups of tp / kv ranks, so the ranks gather
    the kv distinct heads and each keeps its sequence block (the free
    ``B -> S`` slice). Returns this rank's ``(B, cache_len / tp, KV, hd)``
    cache block of each, zero-padded to ``cache_len`` in all, contiguous
    and owned."""
    tp, KV = plan.tp, cfg.num_kv_heads
    B, S, _, hd = k.shape
    L_loc = cache_len // tp

    def pad_to_cache(t):
        if S < cache_len:
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cache_len - S))
        return t

    if tp == 1:
        return pad_to_cache(k), pad_to_cache(v)
    ax = plan.model_axis
    if KV >= tp:
        return tuple(M.all_to_all(pad_to_cache(t), ax, split_dim=1,
                                  concat_dim=2) for t in (k, v))
    group = tp // KV
    start = M.axis_index(ax) * L_loc

    def gather_slice(t):
        full = M.all_gather(pad_to_cache(t), ax, dim=2)    # (B, L, tp, hd)
        # de-duplicate: the tp / KV ranks of group g all computed head g
        full = full.reshape(B, cache_len, KV, group, hd)[:, :, :, 0]
        return full[:, start:start + L_loc].contiguous()
    return gather_slice(k), gather_slice(v)


def gqa_decode(p: GQAttention, x, cache_k, cache_v, pos, cfg: ModelConfig,
               plan: MeshPlan, sliding_window: int = 0):
    """One-token decode over this rank's sequence block of the KV cache.
    x: (B, 1, d), replicated over the model axis; cache_k/v: (B, L_loc, KV,
    hd), positions ``[m * L_loc, (m + 1) * L_loc)`` on model rank m; pos:
    (B,) int32 absolute positions. Writes the new token's k/v into the
    shard that owns its position IN PLACE (the reference rebuilds the
    caches functionally; the stage owns one resident copy) and returns the
    output projection (B, 1, d), P(sum) over the model axis."""
    B = x.shape[0]
    hd, tp, KV = cfg.head_dim, plan.tp, cfg.num_kv_heads
    Hp = cfg.padded_heads(tp)
    ax = plan.model_axis
    L_loc = cache_k.shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, plan, pos[:, None])
    if tp > 1:
        # q for ALL heads on every rank, and the new token's kv heads: tiny
        bx = Boxer(plan)
        q = bx.allgather_model(q, 2)                        # S(head) -> B
        k_new = bx.allgather_model(k_new, 2)
        v_new = bx.allgather_model(v_new, 2)
        if KV < tp:       # group g's tp / KV ranks all computed head g
            group = tp // KV
            k_new = k_new.reshape(B, 1, KV, group, hd)[:, :, :, 0]
            v_new = v_new.reshape(B, 1, KV, group, hd)[:, :, :, 0]
        else:             # heads arrive in order; groups exact
            k_new, v_new = k_new[:, :, :KV], v_new[:, :, :KV]
    q = q[:, 0]                                             # (B, Hp, hd)
    m = M.axis_index(ax) if tp > 1 else 0
    k_off = m * L_loc
    rows = torch.arange(B, device=x.device)
    if tp == 1:
        cols = pos.long()
        cache_k[rows, cols] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, cols] = v_new[:, 0].to(cache_v.dtype)
    else:
        # only the owning shard takes the write; the others rewrite a row
        # with itself (no host sync on which rows own)
        local = pos.long() - k_off
        owns = ((local >= 0) & (local < L_loc))[:, None, None]
        safe = local.clamp(0, L_loc - 1)
        for cache, new in ((cache_k, k_new), (cache_v, v_new)):
            cache[rows, safe] = torch.where(
                owns, new[:, 0].to(cache.dtype), cache[rows, safe])
    mm, ll, acc = flash_decode(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                               cur_pos=pos, k_offset=k_off,
                               sliding_window=sliding_window)
    if tp > 1:
        out = combine_partials(mm, ll, acc, axis_name=ax)    # P -> B
        qh = Hp // tp                  # the local heads, for the row-split wo
        out = out[:, m * qh:(m + 1) * qh]
    else:
        # one shard: combine_partials would weigh it by exp(m - m) = 1
        out = acc / torch.clamp_min(ll, 1e-30)[..., None]
    out = out.to(x.dtype)
    return out.reshape(B, 1, -1) @ p.wo.to(x.dtype)


def cross_attn_decode(p: GQAttention, x, xk, xv, cfg: ModelConfig,
                      plan: MeshPlan):
    """Decode-time cross-attention (the reference's ``_cross_attn_decode``,
    ``transformer.py:231-242``): the local q heads, UNROTATED as the
    reference leaves them, over the whole static cross cache ``xk``/``xv``
    ``(B, enc_len, KV, hd)`` cast to x's dtype; no cache update. The
    decode attention runs with every row at ``cur_pos = enc_len - 1`` and
    ``k_offset`` 0, whose mask then passes every key: the reference's
    non-causal ``attention_dense_ref`` over the cache. x: (B, 1, d);
    returns the output projection (B, 1, d)."""
    B, hd = x.shape[0], cfg.head_dim
    qh = q_heads_local(cfg, plan)
    dt = x.dtype
    q = (x @ p.wq.to(dt)).reshape(B, 1, qh, hd)
    k, v = xk.to(dt), xv.to(dt)
    cur = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                     device=q.device)
    _, ll, acc = flash_decode(q[:, 0], k, v, cur_pos=cur)
    out = (acc / torch.clamp_min(ll, 1e-30)[..., None]).to(dt)
    return out.reshape(B, 1, qh * hd) @ p.wo.to(dt)


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------

class MLAttention(nn.Module):
    """MLA weights, the reference's names and layouts (``init_mla``,
    ``attention.py:296-313``): ``wq (d, H*(nope+rope))``, or with a q LoRA
    ``wq_a (d, qr)``, ``q_norm (qr,)``, ``wq_b (qr, H*(nope+rope))``;
    ``wkv_a (d, r+rope)``, ``kv_norm (r,)``, ``w_uk (r, H*nope)``,
    ``w_uv (r, H*vd)``, ``wo (H*vd, d)``."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
        nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                          cfg.v_head_dim)
        kw = dict(device=device, dtype=dtype)
        if qr:
            self.wq_a = param(torch.empty((d, qr), **kw))
            self.q_norm = param(torch.ones((qr,), **kw))
            self.wq_b = param(torch.empty((qr, H * (nope + rope)), **kw))
        else:
            self.wq = param(torch.empty((d, H * (nope + rope)), **kw))
        self.wkv_a = param(torch.empty((d, r + rope), **kw))
        self.kv_norm = param(torch.ones((r,), **kw))
        self.w_uk = param(torch.empty((r, H * nope), **kw))
        self.w_uv = param(torch.empty((r, H * vd), **kw))
        self.wo = param(torch.empty((H * vd, d), **kw))


def init_mla(gen: torch.Generator, cfg: ModelConfig,
             plan: MeshPlan) -> MLAttention:
    """The port's seeded MLA weights, the reference's distributions: each
    matrix normal at std ``1 / sqrt(fan_in)``, the norms 1."""
    with torch.device("meta"):
        p = MLAttention(cfg, plan)              # shapes only; filled below
    for name, t in list(p.named_parameters()):
        w = (torch.ones(t.shape, device=gen.device) if name.endswith("_norm")
             else dense_init(gen, tuple(t.shape)))
        setattr(p, name, param(w))
    return p


def _mla_q(p: MLAttention, x, cfg: ModelConfig, plan: MeshPlan, positions):
    B, S = x.shape[0], x.shape[1]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype
    if cfg.q_lora_rank:
        cq = rms_norm(x @ p.wq_a.to(dt), p.q_norm.to(dt), cfg.norm_eps)
        q = cq @ p.wq_b.to(dt)
    else:
        q = x @ p.wq.to(dt)
    q = q.reshape(B, S, cfg.num_heads // plan.tp, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_pe, positions, 1.0, cfg.rope_theta)


def _mla_latent(p: MLAttention, x, cfg: ModelConfig, positions):
    """The latent ``c (B, S, r)`` (normed) and the shared rope key
    ``k_pe (B, S, rope)``."""
    r = cfg.kv_lora_rank
    ckv = x @ p.wkv_a.to(x.dtype)                       # (B, S, r + rope)
    c = rms_norm(ckv[..., :r], p.kv_norm.to(x.dtype), cfg.norm_eps)
    k_pe = apply_rope(ckv[..., None, r:], positions, 1.0,
                      cfg.rope_theta)[..., 0, :]
    return c, k_pe


def mla_forward(p: MLAttention, x, cfg: ModelConfig, plan: MeshPlan,
                positions, sliding_window: int = 0):
    """Prefill MLA: each head's k and v materialised from the latent, then
    causal attention through :func:`flash_attention` (the kernel on the
    card) at q/k head dim ``nope + rope`` and v head dim ``v_head_dim``.
    Returns ``(y, (c, k_pe))``: the output projection and the latent cache
    entries of the prompt."""
    B, S = x.shape[0], x.shape[1]
    H = cfg.num_heads // plan.tp
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    dt = x.dtype
    q_nope, q_pe = _mla_q(p, x, cfg, plan, positions)
    c, k_pe = _mla_latent(p, x, cfg, positions)
    k_nope = (c @ p.w_uk.to(dt)).reshape(B, S, H, nope)
    v = (c @ p.w_uv.to(dt)).reshape(B, S, H, vd)
    # both concatenations build contiguous tensors, as the kernel takes them
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, rope)], dim=-1)
    out = flash_attention(q, k, v, causal=True,
                          sliding_window=sliding_window)
    return out.reshape(B, S, H * vd) @ p.wo.to(dt), (c, k_pe)


def mla_decode(p: MLAttention, x, cache_c, cache_kpe, pos, cfg: ModelConfig,
               plan: MeshPlan, sliding_window: int = 0):
    """Absorbed-MLA decode (``attention.py:375-414``): the query is moved
    into latent space through ``w_uk`` and scored against the latent cache,
    the output taken there and lifted through ``w_uv``. x: (B, 1, d);
    cache_c: (B, L, r); cache_kpe: (B, L, rope); pos: (B,) int32. Writes
    the new token's latent and rope key into the caches IN PLACE (the
    reference rebuilds them functionally) and returns the output
    projection (B, 1, d)."""
    B, L = x.shape[0], cache_c.shape[1]
    H = cfg.num_heads // plan.tp
    r = cfg.kv_lora_rank
    nope, rope, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    dt = x.dtype
    q_nope, q_pe = _mla_q(p, x, cfg, plan, pos[:, None])
    c_new, kpe_new = _mla_latent(p, x, cfg, pos[:, None])
    rows, cols = torch.arange(B, device=x.device), pos.long()
    cache_c[rows, cols] = c_new[:, 0].to(cache_c.dtype)
    cache_kpe[rows, cols] = kpe_new[:, 0].to(cache_kpe.dtype)
    cc = cache_c.to(dt)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0],
                         p.w_uk.to(dt).reshape(r, H, nope))
    s_lat = torch.einsum("bhr,blr->bhl", q_lat, cc)
    s_pe = torch.einsum("bhe,ble->bhl", q_pe[:, 0], cache_kpe.to(dt))
    s = (s_lat + s_pe).float() * (1.0 / ((nope + rope) ** 0.5))
    kpos = torch.arange(L, device=x.device)
    mask = kpos[None, :] <= pos[:, None]
    if sliding_window:
        mask &= kpos[None, :] > (pos[:, None] - sliding_window)
    # a fill, not a scalar tensor made on the card: that copy would make
    # the host wait for the device at every layer
    s = s.masked_fill(~mask[:, None, :], -1e30)
    pr = torch.softmax(s, dim=-1).to(dt)
    out_lat = torch.einsum("bhl,blr->bhr", pr, cc)
    out = torch.einsum("bhr,rhv->bhv", out_lat,
                       p.w_uv.to(dt).reshape(r, H, vd))
    return out.reshape(B, 1, H * vd) @ p.wo.to(dt)
