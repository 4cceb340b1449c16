"""Shared model-building blocks: the mesh plan, numerics and init.

Ports of ``repro/models/common.py:23-57`` and ``:156-197``. The reference
runs its model code inside ``shard_map`` with SBP boxing between shards;
this package so far runs one device (tp = dp = 1), where every boxing op is
the identity, so :class:`MeshPlan` only admits that plan. Sharded plans are
ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How the mesh axes are used by the model code (tp = dp = 1 only)."""

    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (1, 1)
    model_axis: str = "model"

    def __post_init__(self):
        if any(s != 1 for s in self.axis_sizes):
            raise NotImplementedError(
                f"mesh {dict(zip(self.axis_names, self.axis_sizes))}: "
                "tp/dp > 1 is not ported yet (ROADMAP Queue 1 item 8)")

    @property
    def tp(self) -> int:
        if self.model_axis not in self.axis_names:
            return 1
        return self.axis_sizes[self.axis_names.index(self.model_axis)]

    @staticmethod
    def single_device() -> "MeshPlan":
        return MeshPlan(("data", "model"), (1, 1))


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``None`` means the card; without one,
    only an explicit CPU device is accepted — never a quiet fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card — pass "
            "device='cpu' to run its plain PyTorch path instead")
    return dev


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-5):
    """Normalise in float32, cast back to x's dtype, THEN scale by ``w`` in
    that dtype — the reference's rounding order."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w


def rope_freqs(head_dim: int, rope_fraction: float, theta: float,
               device=None):
    rot = int(head_dim * rope_fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return rot, inv


def apply_rope(x, positions, rope_fraction: float = 1.0, theta: float = 1e4):
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates INTERLEAVED pairs ``(x[..., 0::2], x[..., 1::2])`` (not the
    rotate-half layout); angles and products in float32, cast back."""
    hd = x.shape[-1]
    rot, inv = rope_freqs(hd, rope_fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].float() * inv       # (..., seq, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < hd else out


def swiglu(gate, up):
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, scale: float = 1.0,
               device: Optional[torch.device] = None):
    """Normal(0, scale / sqrt(fan_in)) drawn from ``gen`` (on ``gen``'s
    device). The draws differ from ``jax.random``'s: parity tests load the
    reference's params through :mod:`repro_torch.models.convert`."""
    std = scale / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return (w * std).to(dtype)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter, created without grad (serving); the training step turns
    grad on (:func:`repro_torch.train.steps.make_train_step`)."""
    return torch.nn.Parameter(t, requires_grad=False)
