"""Dense SwiGLU MLP (port of ``repro/models/mlp.py:29-49``). MoE waits
(ROADMAP Queue 1 item 13).

On a mesh a rank holds the column-parallel ``w_gate``/``w_up`` S(1) and
the row-parallel ``w_down`` S(0) blocks of its hidden units
(:func:`repro_torch.models.transformer.block_specs`), so
:func:`dense_mlp_forward` of its shards is the P(sum) partial that the
block psums over the model axis."""
from __future__ import annotations

import torch
from torch import nn

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
