"""Mamba-2 (SSD) block: the prefill and one-token decode halves,
tensor-parallel over SSM heads.

Port of ``repro/models/mamba.py``. On a ``("data", "model")`` mesh each
rank holds its shards under the reference's ``mamba_specs``
(``mamba.py:50-59``; :func:`repro_torch.models.transformer.block_specs`):
``w_x``, ``w_z``, ``w_dt`` S(1) (the head-structured columns); ``w_bc`` and
``conv_bc`` replicated (the G groups of B and C serve every head);
``conv_x``, ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` S(0) (per head);
``out_proj`` S(0), so the block's output is P(sum), psummed by the caller.
The functions here run on one rank's shards and read every width from
them; at tp = 1 the shards are the whole weights. The gated RMSNorm before
``out_proj`` normalises over the rank's *local* channels, as the
reference's does: a GroupNorm with groups == tp (exact at tp = 1), so a
mesh with tp > 1 gives the reference's numbers on that mesh, not one
device's.

The kernel call site is the reference's: :func:`mamba_forward` calls
:func:`repro_torch.kernels.ssd_scan.ssd_scan` where the reference calls
``ssd_chunked_ref`` (``mamba.py:107``), so a CUDA tensor launches the
Hopper kernels (with their backward when autograd records) and a CPU
tensor runs the plain version. The one-token :func:`mamba_decode` runs
:func:`ssd_decode_step` in eager PyTorch, as the reference runs it in jnp
(it has no kernel either).

Weights are cast to the activations' dtype at each use, as the reference
casts ``p[...].astype(x.dtype)``; ``dt_bias``, ``A_log`` and ``D`` are read
in float32, as the reference reads them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_decode_step, ssd_scan
from repro_torch.models.common import MeshPlan, dense_init, param, rms_norm

G_GROUPS = 1   # number of B/C groups (mamba2 default: 1)
#: params the model reads in float32 whatever the compute dtype
FLOAT32_PARAMS = ("dt_bias", "A_log", "D")


class Mamba(nn.Module):
    """The SSM weights under the reference's 11 names and layouts
    (``x @ w``): ``w_x``, ``w_z (d, d_inner)``, ``w_bc (d, 2GN)``,
    ``w_dt (d, heads)``, ``dt_bias``, ``A_log``, ``D (heads,)``,
    ``conv_x (d_inner, d_conv)``, ``conv_bc (2GN, d_conv)``,
    ``norm_w (d_inner,)``, ``out_proj (d_inner, d)``."""

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, device=None,
                 dtype=torch.float32):
        super().__init__()
        d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
        nh, dc = cfg.ssm_heads, cfg.ssm_d_conv
        kw = dict(device=device, dtype=dtype)
        self.w_x = param(torch.empty((d, di), **kw))
        self.w_z = param(torch.empty((d, di), **kw))
        self.w_bc = param(torch.empty((d, 2 * G_GROUPS * N), **kw))
        self.w_dt = param(torch.empty((d, nh), **kw))
        self.dt_bias = param(torch.empty((nh,), **kw))
        self.A_log = param(torch.empty((nh,), **kw))
        self.D = param(torch.empty((nh,), **kw))
        self.conv_x = param(torch.empty((di, dc), **kw))
        self.conv_bc = param(torch.empty((2 * G_GROUPS * N, dc), **kw))
        self.norm_w = param(torch.empty((di,), **kw))
        self.out_proj = param(torch.empty((di, d), **kw))


def init_mamba(gen: torch.Generator, cfg: ModelConfig, plan: MeshPlan) -> Mamba:
    """The reference's distributions (``mamba.py:28``): normal weights over
    their fan-in, the convolutions at scale 1, ``A_log = log(linspace(1,
    16))``, ``D = 1``, ``dt_bias = 0``, ``norm_w = 1``."""
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_d_state
    nh, dc = cfg.ssm_heads, cfg.ssm_d_conv
    dev = gen.device
    with torch.device("meta"):
        p = Mamba(cfg, plan)                    # shapes only; filled below
    p.w_x = param(dense_init(gen, (d, di)))
    p.w_z = param(dense_init(gen, (d, di)))
    p.w_bc = param(dense_init(gen, (d, 2 * G_GROUPS * N)))
    p.w_dt = param(dense_init(gen, (d, nh)))
    p.dt_bias = param(torch.zeros((nh,), device=dev))
    p.A_log = param(torch.log(torch.linspace(1.0, 16.0, nh, device=dev)))
    p.D = param(torch.ones((nh,), device=dev))
    p.conv_x = param(dense_init(gen, (di, dc), scale=1.0))
    p.conv_bc = param(dense_init(gen, (2 * G_GROUPS * N, dc), scale=1.0))
    p.norm_w = param(torch.ones((di,), device=dev))
    p.out_proj = param(dense_init(gen, (di, d)))
    return p


def _causal_conv(x, w, prepend=None):
    """Depthwise causal conv along seq. x: (B, S, C); w: (C, K)."""
    B, S, C = x.shape
    K = w.shape[1]
    if prepend is None:
        prepend = x.new_zeros((B, K - 1, C))
    xp = torch.cat([prepend, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(K):
        # xp[:, i : i+S] is x shifted so that tap i sees x[t - (K-1) + i]
        out = out + xp[:, i:i + S] * w[:, i][None, None, :]
    return out


def _dt_and_a(p: Mamba, dt_raw):
    """The step sizes ``softplus(dt_raw + dt_bias)`` and the decay rates
    ``-exp(A_log)``, in float32."""
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    return dt, -torch.exp(p.A_log.float())


def mamba_forward(p: Mamba, x, cfg: ModelConfig, plan: MeshPlan,
                  return_state: bool = False):
    """x: (B, S, d), replicated over ``model`` -> the block's output (B, S,
    d), P(sum) over ``model`` (the rank's local heads' part). With
    ``return_state`` also ``(ssm_state, (tail_x, tail_bc))`` for decoding:
    the final SSD state (B, local heads, P, N) in float32 and the last
    ``d_conv - 1`` rows of the convolutions' inputs (local channels of x,
    all of B and C), in x's dtype."""
    B, S, d = x.shape
    nh_l = cfg.ssm_heads // plan.tp
    P_hd = cfg.ssm_head_dim
    N = cfg.ssm_d_state
    dt_ = x.dtype

    xs = x @ p.w_x.to(dt_)                       # (B, S, di)
    z = x @ p.w_z.to(dt_)
    bc = x @ p.w_bc.to(dt_)                      # (B, S, 2GN)
    dt_raw = x @ p.w_dt.to(dt_)                  # (B, S, nh)

    conv_tail = (xs[:, -(cfg.ssm_d_conv - 1):], bc[:, -(cfg.ssm_d_conv - 1):])
    xs = F.silu(_causal_conv(xs, p.conv_x.to(dt_)))
    bc = F.silu(_causal_conv(bc, p.conv_bc.to(dt_)))

    Bm = bc[..., :G_GROUPS * N].reshape(B, S, G_GROUPS, N)
    Cm = bc[..., G_GROUPS * N:].reshape(B, S, G_GROUPS, N)
    dt, A = _dt_and_a(p, dt_raw)

    xh = xs.reshape(B, S, nh_l, P_hd)
    y, hT = ssd_scan(xh, dt, A, Bm, Cm, p.D.float(), chunk=cfg.ssm_chunk)
    y = y.reshape(B, S, nh_l * P_hd)
    y = rms_norm(y * F.silu(z), p.norm_w.to(dt_), cfg.norm_eps)
    out = y @ p.out_proj.to(dt_)
    if return_state:
        return out, (hT.float(), conv_tail)
    return out


def mamba_decode(p: Mamba, x, state, cfg: ModelConfig, plan: MeshPlan):
    """Single-token step. x: (B, 1, d); state: (ssm_state, tail_x, tail_bc)
    with ssm_state (B, local heads, P, N), tail_x (B, d_conv-1, local
    d_inner), tail_bc (B, d_conv-1, 2GN). Returns ``(out (B, 1, d) P(sum)
    over model, new_state)``."""
    B = x.shape[0]
    nh_l = cfg.ssm_heads // plan.tp
    P_hd = cfg.ssm_head_dim
    N = cfg.ssm_d_state
    dt_ = x.dtype
    h, tail_x, tail_bc = state
    di_l = nh_l * P_hd

    xs = (x @ p.w_x.to(dt_))[:, 0]              # (B, di)
    z = (x @ p.w_z.to(dt_))[:, 0]
    bc = (x @ p.w_bc.to(dt_))[:, 0]
    dt_raw = (x @ p.w_dt.to(dt_))[:, 0]

    win_x = torch.cat([tail_x.to(dt_), xs[:, None]], dim=1)
    win_bc = torch.cat([tail_bc.to(dt_), bc[:, None]], dim=1)
    xs_c = F.silu(torch.einsum("bkc,ck->bc", win_x, p.conv_x.to(dt_)))
    bc_c = F.silu(torch.einsum("bkc,ck->bc", win_bc, p.conv_bc.to(dt_)))
    new_tail_x, new_tail_bc = win_x[:, 1:], win_bc[:, 1:]

    Bm = bc_c[..., :G_GROUPS * N].reshape(B, G_GROUPS, N)
    Cm = bc_c[..., G_GROUPS * N:].reshape(B, G_GROUPS, N)
    dt, A = _dt_and_a(p, dt_raw)
    y, h_new = ssd_decode_step(xs_c.reshape(B, nh_l, P_hd), dt, A, Bm, Cm,
                               p.D.float(), h)
    y = y.reshape(B, di_l)
    y = rms_norm(y * F.silu(z), p.norm_w.to(dt_), cfg.norm_eps)
    out = (y @ p.out_proj.to(dt_))[:, None]
    return out, (h_new, new_tail_x, new_tail_bc)


def init_mamba_state(cfg: ModelConfig, plan: MeshPlan, batch: int,
                     dtype=torch.bfloat16, device=None):
    """Zeroed decode state ``(h, tail_x, tail_bc)`` of one rank: h (B,
    local heads, P, N) float32, the tails (B, d_conv-1, ...) in ``dtype``
    (x's local channels, all of B and C)."""
    nh_l = cfg.ssm_heads // plan.tp
    di_l = nh_l * cfg.ssm_head_dim
    h = torch.zeros((batch, nh_l, cfg.ssm_head_dim, cfg.ssm_d_state),
                    dtype=torch.float32, device=device)
    tail_x = torch.zeros((batch, cfg.ssm_d_conv - 1, di_l), dtype=dtype,
                         device=device)
    tail_bc = torch.zeros((batch, cfg.ssm_d_conv - 1,
                           2 * G_GROUPS * cfg.ssm_d_state), dtype=dtype,
                          device=device)
    return h, tail_x, tail_bc
