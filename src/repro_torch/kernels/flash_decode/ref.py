"""Plain PyTorch twins of the single-token flash-decode oracles.

Ports of ``repro/kernels/flash_decode/ref.py``. Each KV-cache shard (or
split) produces *partial* attention statistics — the paper's partial-value
signature with a non-sum reduction:

    m   : P(max)   running max of scores
    l   : P(sum)   exp sum (after rescale)
    acc : P(sum)   exp-weighted value accumulation (after rescale)

:func:`flash_decode_partial_ref` computes one shard's contribution;
:func:`combine_partials` reduces a stacked leading shard axis, or the
shards of the ranks of a mesh axis. They are the
port's CPU path and the oracle of the CUDA kernel in
:mod:`repro_torch.kernels.flash_decode.kernel`.

As in the reference, the score einsum runs in the input dtype (bf16 scores
for bf16 inputs) before the float32 scale; the value product accumulates in
float32. The finite sentinel ``NEG_INF`` makes a fully masked row average
``v`` instead of producing NaN.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mesh as M

NEG_INF = -1e30


def flash_decode_partial_ref(q, k, v, *, k_offset: int = 0,
                             cur_pos=None, sliding_window: int = 0,
                             k_positions=None,
                             sm_scale: Optional[float] = None):
    """Partial attention of a 1-token query over one KV-cache shard.

    q: (B, H, D); k, v: (B, L, KV, D) — this shard's cache slice;
    ``k_offset``: absolute position of k[0]; ``cur_pos``: (B,) current decode
    position (entries beyond it are masked: the cache is pre-allocated).
    ``k_positions``: (B, L) explicit absolute position per slot (ring-buffer
    sliding-window caches; -1 = empty slot), overrides ``k_offset``.
    Returns (m, l, acc): (B, H), (B, H), (B, H, D) float32 partials.
    """
    B, H, D = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q, k).float() * sm_scale
    if k_positions is not None:
        kpos = k_positions                                   # (B, L)
        mask = kpos >= 0
    else:
        kpos = (k_offset + torch.arange(L, device=q.device)).expand(B, L)
        mask = torch.ones((B, L), dtype=torch.bool, device=q.device)
    if cur_pos is not None:
        mask &= kpos <= cur_pos[:, None]
        if sliding_window:
            mask &= kpos > cur_pos[:, None] - sliding_window
    s = torch.where(mask[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B, H)  P(max)
    p = torch.exp(s - m[..., None])
    # kept from the reference: with the finite sentinel m is always finite
    p = torch.where(torch.isfinite(m)[..., None], p, 0.0)
    l = p.sum(dim=-1)                                        # (B, H)  P(sum)
    acc = torch.einsum("bhk,bkhd->bhd", p, v.float())
    return m, l, acc


def combine_partials(m, l, acc, axis_name: Optional[str] = None):
    """Reduce shard partials to the attention output ``(B, H, Dv)``
    (float32).

    With ``axis_name``: the cross-rank combine inside
    :func:`repro_torch.core.mesh.spmd`, each rank holding its own cache
    shard's partials -- pmax of ``m``, then psums of the rescaled ``l`` and
    ``acc``, added in rank order (elementwise work between collectives, as
    the reference's jnp combine). Without: combines a stacked leading shard
    axis. A wholly masked shard (``m`` at the finite sentinel) weighs
    ``exp(-1e30 - m_g) = 0``."""
    if axis_name is not None:
        m_g = M.pmax(m, axis_name)
        scale = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
        l_g = M.psum(l * scale, axis_name)
        acc_g = M.psum(acc * scale[..., None], axis_name)
        return acc_g / torch.clamp_min(l_g, 1e-30)[..., None]
    m_g = m.amax(dim=0)
    scale = torch.where(torch.isfinite(m), torch.exp(m - m_g[None]), 0.0)
    l_g = (l * scale).sum(dim=0)
    acc_g = (acc * scale[..., None]).sum(dim=0)
    return acc_g / torch.clamp_min(l_g, 1e-30)[..., None]


def ring_positions(first, last, L: int):
    """The slot position table ``(B, L)`` int32 of a ring of ``L`` slots
    after row ``b`` wrote positions ``first[b]`` to ``last[b]`` (both
    included), position ``p`` into slot ``p % L`` (the reference's ring
    write, ``repro/models/attention.py:246-263``): each slot holds the
    latest position written to it, -1 if none was. ``first`` and ``last``
    are (B,) integer tensors."""
    last = torch.as_tensor(last).long()[:, None]
    slot = torch.arange(L, device=last.device)[None, :]
    p = last - (last - slot) % L
    return torch.where(p >= torch.as_tensor(first, device=last.device)
                       .long()[:, None], p, -1).to(torch.int32)


def decode_attention_ref(q, k, v, cur_pos, *, sliding_window: int = 0,
                         sm_scale=None):
    """Single-shard (logical) decode attention oracle."""
    m, l, acc = flash_decode_partial_ref(
        q, k, v, k_offset=0, cur_pos=cur_pos, sliding_window=sliding_window,
        sm_scale=sm_scale)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
