"""Shared model-building blocks: the mesh plan, the boxing helper,
numerics and init.

Ports of ``repro/models/common.py:23-93`` and ``:156-197``. As in the
reference, the model code runs once per rank of a ``("data", "model")``
mesh -- here inside :func:`repro_torch.core.mesh.spmd`, each rank a thread
-- and writes every collective as an SBP transition (:class:`Boxer`) or a
named-axis collective of :mod:`repro_torch.core.mesh`. On a 1 x 1 plan
every one of them is the identity and no rank context is needed.
Training on a mesh keeps every collective off autograd's graph: the
model's forward is a program of local segments between tape entries
(:mod:`repro_torch.core.tape`), and the reference's ``grad_sync``
(Megatron's "f", ``repro/models/common.py:97-123``) and the branch psum
(its conjugate "g"), which JAX differentiates through ``vma``, are such
entries here, :func:`grad_sync_step` and :func:`branch_psum_step`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import mesh as M
from repro_torch.core.boxing import boxing_fn
from repro_torch.core.sbp import Split, ndsbp
from repro_torch.core.tape import Step


#: The leaves replicated over ``model`` that each rank uses only in part:
#: attention's kv-group columns of ``wk``/``wv``/``bk``/``bv``
#: (``attention.py:_kv_slice``) and the q/k norms over its local heads;
#: MLA's latent projection ``wkv_a`` and its ``kv_norm``, and the q LoRA's
#: ``wq_a`` and ``q_norm``, whose outputs feed only the rank's heads;
#: Mamba's ``w_bc`` and ``conv_bc``, whose B and C feed only the rank's
#: local heads; and the MoE ``router``, whose gates weigh only the rank's
#: experts (its aux loss, computed whole on every rank, reaches it through
#: :func:`aux_pmean_step` at 1 / tp a rank). A rank's gradient of one is
#: its disjoint part of the true one, so training psums it over ``model``
#: after the backward, once (the reference's ``_MODEL_GRAD_SUM_LEAVES``,
#: ``repro/train/steps.py:79-80``, with MLA's leaves, which its plain path
#: gets summed by JAX's autodiff and its ZeRO path by summing every
#: replicated leaf). With kv heads < tp the ranks of a group share a head,
#: and the psum adds their parts alike.
MODEL_GRAD_SUM_LEAVES = frozenset({"wk", "wv", "bk", "bv", "q_norm",
                                   "k_norm", "w_bc", "conv_bc", "router",
                                   "wkv_a", "kv_norm", "wq_a"})


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How the mesh axes are used by the model code."""

    axis_names: Tuple[str, ...] = ("data", "model")
    axis_sizes: Tuple[int, ...] = (1, 1)
    model_axis: str = "model"

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(n for n in self.axis_names if n != self.model_axis)

    @property
    def tp(self) -> int:
        if self.model_axis not in self.axis_names:
            return 1          # FSDP plan: every mesh axis is a data axis
        return self.axis_sizes[self.axis_names.index(self.model_axis)]

    @property
    def dp(self) -> int:
        return math.prod(s for n, s in zip(self.axis_names, self.axis_sizes)
                         if n != self.model_axis)

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    @property
    def spec_model_axis(self) -> Optional[str]:
        """The model axis name for specs; None under the FSDP plan."""
        return self.model_axis if self.model_axis in self.axis_names else None

    @property
    def is_single(self) -> bool:
        return self.tp == 1 and self.dp == 1

    @staticmethod
    def single_device() -> "MeshPlan":
        return MeshPlan(("data", "model"), (1, 1))

    @staticmethod
    def of(mesh) -> "MeshPlan":
        """The plan of a :class:`repro_torch.core.mesh.DeviceMesh`."""
        return MeshPlan(tuple(mesh.axis_names), tuple(mesh.shape))


class Boxer:
    """SBP-transition helper bound to a mesh plan, usable inside
    :func:`repro_torch.core.mesh.spmd`.

    ``bx(x, "S(0),B", "B,B")`` runs the collective
    :func:`repro_torch.core.boxing.boxing_fn` emits for that transition;
    the logical shape comes from the local shard's and ``src``."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan

    def __call__(self, x, src, dst):
        src_n, dst_n = ndsbp(src), ndsbp(dst)
        logical = list(x.shape)
        for comp, size in zip(src_n, self.plan.axis_sizes):
            if isinstance(comp, Split):
                logical[comp.axis] *= size
        fn = boxing_fn(src_n, dst_n, self.plan.axis_names,
                       self.plan.axis_sizes, tuple(logical))
        return fn(x)

    # frequent shortcuts ---------------------------------------------------
    def psum_model(self, x):
        return M.psum(x, self.plan.model_axis) if self.plan.tp > 1 else x

    def psum_data(self, x):
        for ax in self.plan.data_axes:
            if self.plan.axis_size(ax) > 1:
                x = M.psum(x, ax)
        return x

    def allgather_model(self, x, axis: int):
        if self.plan.tp == 1:
            return x
        return M.all_gather(x, self.plan.model_axis, dim=axis)


# ---------------------------------------------------------------------------
# Megatron's "f" and "g" as tape entries
# ---------------------------------------------------------------------------

def grad_sync_step(src: str, dst: str, plan: MeshPlan) -> Step:
    """Megatron's "f" (the reference's ``grad_sync``): ``dst`` is ``src``,
    a model-replicated activation entering a branch that each rank runs on
    its own heads, MLP units or vocabulary block. Each rank's cotangent of
    ``dst`` is its branch's part of the true one, so the transpose psums it
    over ``model``."""
    return Step(lambda v: v, (src,), (dst,), collective=True,
                transpose=lambda g: M.psum(g, plan.model_axis))


def branch_psum_step(src: str, dst: str, plan: MeshPlan) -> Step:
    """Megatron's "g": ``dst`` is the psum over ``model`` of ``src``, a
    branch's P(sum) partial. ``dst`` is replicated and every rank holds its
    whole cotangent, so the transpose is the identity."""
    return Step(lambda v: M.psum(v, plan.model_axis), (src,), (dst,),
                collective=True, transpose=lambda g: g)


def aux_pmean_step(src: str, dst: str, plan: MeshPlan) -> Step:
    """The reference's ``certified_pmean`` of the routers' aux loss
    (``repro/models/transformer.py:419-424``): ``dst`` is ``src``, a value
    every rank of ``model`` computes whole (and alike) without a mediating
    psum. The forward keeps the value (the mean of tp equal values); the
    transpose gives each rank ``1 / tp`` of the cotangent, so that after
    the router's sum over ``model`` (:data:`MODEL_GRAD_SUM_LEAVES`) and the
    branch input's "f" the aux's gradient counts once."""
    return Step(lambda v: v, (src,), (dst,), collective=True,
                transpose=lambda g: g / plan.tp)


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
    device) in float32, scaled in place and cast to ``dtype``: one float32
    copy of the leaf at a time, the values of ``(w * std).to(dtype)``.
    The draws differ from ``jax.random``'s: parity tests load the
    reference's params through :mod:`repro_torch.models.convert`."""
    std = scale / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device if device is not None else gen.device)
    return w.mul_(std).to(dtype)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    """A parameter, created without grad (serving); the training step turns
    grad on (:func:`repro_torch.train.steps.make_train_step`)."""
    return torch.nn.Parameter(t, requires_grad=False)
