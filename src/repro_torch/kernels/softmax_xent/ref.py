"""Plain PyTorch twins of the sharded-vocab softmax cross-entropy oracles.

Line-for-line ports of ``repro/kernels/softmax_xent/ref.py`` (paper Fig
11b): each vocab shard reduces its logits locally to ``(m, s, z)`` --
max, sum-exp given that max, label logit -- and the tiny stats are combined
across shards, never materialising gathered logits. They are the port's CPU
path and the oracle the CUDA kernels of
:mod:`repro_torch.kernels.softmax_xent.kernel` are checked against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mesh as M


def local_stats_ref(logits, labels, vocab_offset):
    """Per-shard stats: (local_max, local_sumexp_given_max, local_label_logit).

    logits: (N, Vl) this shard's vocab slice; labels: (N,) global ids;
    vocab_offset: scalar -- global id of this shard's column 0.
    Returns m: (N,), s: (N,) = sum exp(logit - m), z: (N,) label logit or 0,
    all float32. ``m`` is detached, as the reference's ``stop_gradient``
    (exact: d/dm [log sum exp(l - m) + m] == 0).
    """
    Vl = logits.shape[1]
    lf = logits.float()
    m = lf.amax(dim=-1).detach()
    s = torch.exp(lf - m[:, None]).sum(dim=-1)
    local_ids = labels.long() - vocab_offset
    in_range = (local_ids >= 0) & (local_ids < Vl)
    safe = local_ids.clamp(0, Vl - 1)
    z = torch.gather(lf, 1, safe[:, None])[:, 0]
    z = torch.where(in_range, z, 0.0)
    return m, s, z


def combine_stats(m, s, z, axis_name: Optional[str] = None):
    """Combine per-shard stats into per-token loss.

    m is P(max); z is P(sum) (exactly one shard contributes); s must be
    rescaled by exp(m - m_global) before its P(sum) reduction. Without
    ``axis_name`` the shards are stacked on dim 0; with it each rank holds
    its own (N,) stats inside :func:`repro_torch.core.mesh.spmd` and they
    are combined across the mesh axis ``axis_name`` with collectives (in
    rank order; ``m`` held fixed, and the collectives' results are
    detached), giving every rank the whole loss.
    """
    if axis_name is not None:
        m_g = M.pmax(m.detach(), axis_name)
        s_g = M.psum(s * torch.exp(m - m_g), axis_name)
        z_g = M.psum(z, axis_name)
        return torch.log(s_g) + m_g - z_g
    m_g = m.amax(dim=0)
    s_g = (s * torch.exp(m - m_g[None])).sum(dim=0)
    z_g = z.sum(dim=0)
    return torch.log(s_g) + m_g - z_g     # -log softmax[label]


def softmax_xent_ref(logits, labels):
    """Unsharded oracle: -log softmax(logits)[label] per row."""
    lf = logits.float()
    m = lf.amax(dim=-1)
    lse = torch.log(torch.exp(lf - m[:, None]).sum(dim=-1)) + m
    z = torch.gather(lf, 1, labels.long()[:, None])[:, 0]
    return lse - z
