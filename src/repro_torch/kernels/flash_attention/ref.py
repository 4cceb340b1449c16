"""Plain PyTorch twins of the blocked (flash-style) attention oracles.

Line-for-line ports of ``repro/kernels/flash_attention/ref.py``:
:func:`flash_attention_ref` (all q x kv block rectangles),
:func:`flash_attention_triangular` (causal self-attention that skips the
fully masked block pairs) and :func:`attention_dense_ref` (direct softmax).
They are the port's CPU path and the oracle the CUDA kernel in
:mod:`repro_torch.kernels.flash_attention.kernel` is checked against.

Layouts follow the reference: q ``(B, Sq, H, D)``, k ``(B, Sk, KV, D)``,
v ``(B, Sk, KV, Dv)``; q head ``h`` reads kv head ``h // (H // KV)``.
Scores and both products accumulate in float32 (``preferred_element_type``
in the reference), so bf16 inputs are upcast before each einsum. Masked
scores take the finite sentinel ``NEG_INF``: a row with every key masked
therefore averages ``v`` instead of producing NaN, exactly as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def _online_step(m, l, acc, s, v_blk):
    """One online-softmax update of ``(m, l, acc)`` with masked scores ``s``
    ``(B, H, bq, bk)`` and the value block ``v_blk`` ``(B, bk, H, Dv)``."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(dim=-1)
    acc_new = acc * scale[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_blk.float())
    return m_new, l_new, acc_new


def _prepare(q, k, v, block_q, block_k):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    assert H % KV == 0, (H, KV)
    G = H // KV
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    qp = _pad_seq(q, (-Sq) % block_q)
    kp = _pad_seq(k, (-Sk) % block_k).repeat_interleave(G, dim=2)
    vp = _pad_seq(v, (-Sk) % block_k).repeat_interleave(G, dim=2)
    return qp, kp, vp, block_q, block_k


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: int = 0, q_offset: int = 0,
                        block_q: int = 512, block_k: int = 512,
                        sm_scale: Optional[float] = None):
    """Blocked attention with online softmax over every block rectangle.

    ``q_offset``: absolute position of q[0]; ``sliding_window`` > 0 limits
    attention to the last W positions.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qp, kp, vp, block_q, block_k = _prepare(q, k, v, block_q, block_k)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k
    dev = q.device
    outs = []
    for qi in range(nq):
        q_i = qp[:, qi * block_q:(qi + 1) * block_q].float()
        qpos = q_offset + qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, block_q, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_i = kp[:, ki * block_k:(ki + 1) * block_k]
            v_i = vp[:, ki * block_k:(ki + 1) * block_k]
            kpos = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_i.float()) * sm_scale
            mask = torch.ones((block_q, block_k), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if sliding_window:
                mask &= kpos[None, :] > qpos[:, None] - sliding_window
            mask &= kpos[None, :] < Sk                    # padding
            s = torch.where(mask[None, None], s, NEG_INF)
            m, l, acc = _online_step(m, l, acc, s, v_i)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                  # (B, bq, H, Dv)
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(q.dtype)


def attention_dense_ref(q, k, v, *, causal=True, sliding_window=0,
                        q_offset=0, sm_scale=None):
    """O(S^2)-memory direct attention — oracle for the oracle (tiny shapes).

    The score einsum runs in the input dtype (bf16 scores for bf16 inputs,
    as in the reference) before the float32 scale and softmax."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    dev = q.device
    qpos = q_offset + torch.arange(Sq, device=dev)
    kpos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if sliding_window:
        mask &= kpos[None, :] > qpos[:, None] - sliding_window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def flash_attention_triangular(q, k, v, *, sliding_window: int = 0,
                               block_q: int = 512, block_k: int = 512,
                               sm_scale: Optional[float] = None):
    """Causal self-attention that SKIPS fully masked (q, kv) block pairs:
    only blocks intersecting the causal (banded) region are visited.
    Numerically identical to :func:`flash_attention_ref` (online softmax is
    order-invariant). Requires Sq == Sk and q_offset == 0."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Dv = v.shape[-1]
    assert Sq == Sk, "triangular path is for square self-attention"
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qp, kp, vp, block_q, block_k = _prepare(q, k, v, block_q, block_k)
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k
    dev = q.device
    outs = []
    for qi in range(nq):
        q_lo, q_hi = qi * block_q, (qi + 1) * block_q - 1
        q_i = qp[:, q_lo:q_hi + 1].float()
        qpos = q_lo + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, block_q, Dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_lo, k_hi = ki * block_k, (ki + 1) * block_k - 1
            if k_lo > q_hi:
                continue                       # strictly above the diagonal
            if sliding_window and k_hi <= q_lo - sliding_window:
                continue                       # entirely left of the band
            k_i = kp[:, k_lo:k_hi + 1]
            v_i = vp[:, k_lo:k_hi + 1]
            kpos = k_lo + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, k_i.float()) * sm_scale
            mask = qpos[:, None] >= kpos[None, :]
            if sliding_window:
                mask &= kpos[None, :] > qpos[:, None] - sliding_window
            mask &= kpos[None, :] < Sk
            s = torch.where(mask[None, None], s, NEG_INF)
            m, l, acc = _online_step(m, l, acc, s, v_i)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(q.dtype)
