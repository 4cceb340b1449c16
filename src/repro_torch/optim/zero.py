"""ZeRO optimizer-state (and master-param) sharding in SBP, and the plain
data-parallel update (port of ``repro/optim/zero.py``).

The paper's point (§6.4): ZeRO-DP falls out of SBP annotations. The
*master* float32 parameters and the Adam moments live as ``S(0)``-over-data
flat shards of shape ``(DP, TP, chunk)``; a rank holds its ``(1, 1,
chunk)`` rows of every leaf (:func:`shard_master_local`). Each step

1. casts the rank's shard to the compute dtype (the Fig-14 ``cast`` op) and
   boxes ``S(0) -> B`` over the data axes -- an all-gather of the
   half-precision weights (:func:`gather_master_local`);
2. runs forward and backward on the gathered weights; the gather's
   transpose is the ``P(sum) -> S(0)`` reduce-scatter of the gradients
   (:func:`scatter_grad_local`). The gather is a collective step of the
   training tape (:mod:`repro_torch.core.tape`), never an autograd node;
3. updates the rank's master shard with Adam in float32
   (:func:`zero_adamw_update`).

The global-view kernels (:func:`shard_flat` ... :func:`zero_stage_update`)
hold a whole ``(dp, 1, chunk)`` flat master in one tensor: the graph
pipeline's optimizer actors and its monolithic engine share them, and there
ZeRO is a relayout (the flat update is elementwise, so it is bitwise the
dense one).

Model-replicated leaves keep one master copy per model shard; their
gradients need a model-axis combine before the update
(:func:`model_combine_tree`). The plain update
(:func:`plain_dp_adamw_update`) all-reduces gradients over ``data`` and
keeps replicated moments.

The reference's plain path reports dp times the true gradient and norm:
under ``shard_map(check=True)`` a data-replicated param's gradient arrives
already summed over ``data`` (the transpose of the implicit ``pvary``, as
its ZeRO path notes at ``repro/train/steps.py:187-188``), and its plain
update then divides by dp and psums again. Here the gradient entering is
each rank's own, so the result is the true data mean (ROADMAP Queue 3).
Its ZeRO path gives the true norm, as both paths here do.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import mesh as M
from repro_torch.core.sbp import NdSbp, Split, ndsbp
from repro_torch.models.common import MODEL_GRAD_SUM_LEAVES, MeshPlan
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     adamw_param_update, adamw_update)


class ZeroState(NamedTuple):
    step: torch.Tensor                 # int32 scalar
    mu: Dict[str, torch.Tensor]        # float32, the masters' flat layout
    nu: Dict[str, torch.Tensor]


#: Model-replicated leaves whose per-rank gradients are DISJOINT parts (each
#: rank's heads reach only its kv group's columns, its heads' norms, MLA's
#: latent projection, the B and C projections its SSM heads read, and the
#: router's columns its experts weigh): the port's
#: :data:`repro_torch.models.common.MODEL_GRAD_SUM_LEAVES`. The reference's
#: set (``repro/optim/zero.py:43-44``) lacks MLA's ``wkv_a``, ``kv_norm``
#: and ``wq_a``: its ZeRO path sums every replicated leaf
#: (``model_combine_tree``), so it needs no names for them.
MODEL_SUM_LEAVES = MODEL_GRAD_SUM_LEAVES


def _chunk_size(local_size: int, dp: int) -> int:
    return math.ceil(local_size / dp)


def local_shape_of(global_shape: Sequence[int], sbp, plan: MeshPlan
                   ) -> Tuple[int, ...]:
    """A rank's shard shape of a ``global_shape`` tensor laid out ``sbp``
    (one component per mesh axis of ``plan``)."""
    shape = list(global_shape)
    for comp, size in zip(ndsbp(sbp), plan.axis_sizes):
        if isinstance(comp, Split):
            shape[comp.axis] //= size
    return tuple(shape)


def _flat_sbp(plan: MeshPlan) -> NdSbp:
    """``S(0)`` on every data axis, ``S(1)`` on the model axis."""
    return ndsbp(",".join("S(1)" if n == plan.model_axis else "S(0)"
                          for n in plan.axis_names))


def master_specs(param_specs: Dict[str, NdSbp], plan: MeshPlan
                 ) -> Dict[str, NdSbp]:
    """The signatures of the flat ``(DP, TP, chunk)`` master and moment
    leaves: rows over the data axes, the model copies over ``model``."""
    return {n: _flat_sbp(plan) for n in param_specs}


def zero_state_specs(param_specs: Dict[str, NdSbp], plan: MeshPlan
                     ) -> ZeroState:
    m = master_specs(param_specs, plan)
    return ZeroState(ndsbp(",".join("B" for _ in plan.axis_names)), m,
                     dict(m))


def master_shapes(global_shapes: Dict[str, Sequence[int]],
                  specs: Dict[str, NdSbp], plan: MeshPlan
                  ) -> Dict[str, Tuple[int, int, int]]:
    """The global ``(dp, tp, chunk)`` shapes of the flat float32 masters."""
    out = {}
    for n, shape in global_shapes.items():
        n_loc = math.prod(local_shape_of(shape, specs[n], plan))
        out[n] = (plan.dp, plan.tp, _chunk_size(n_loc, plan.dp))
    return out


def zero_state_shapes(global_shapes, specs, plan: MeshPlan):
    m = master_shapes(global_shapes, specs, plan)
    return ZeroState((), m, dict(m))


# ---------------------------------------------------------------------------
# a rank's flat shards (inside spmd on a mesh)
# ---------------------------------------------------------------------------

def shard_master_local(p_local: torch.Tensor, plan: MeshPlan,
                       index: int = 0) -> torch.Tensor:
    """A rank's full local param -> its ``(1, 1, chunk)`` float32 master
    rows: the flat param zero-padded to ``dp * chunk``, block ``index``
    (the rank's row-major index over the data axes)."""
    dp = plan.dp
    flat = p_local.reshape(-1).float()
    chunk = _chunk_size(flat.numel(), dp)
    flat = torch.nn.functional.pad(flat, (0, dp * chunk - flat.numel()))
    return flat[index * chunk:(index + 1) * chunk].reshape(1, 1, chunk) \
        .clone()


def gather_master_local(m_local: torch.Tensor, local_shape: Sequence[int],
                        compute_dtype: torch.dtype, plan: MeshPlan
                        ) -> torch.Tensor:
    """A rank's ``(1, 1, chunk)`` master rows -> its full local param in
    ``compute_dtype``: Fig 14's cast, then the ``S(0) -> B`` all-gather
    over the data axes in the compute dtype (half the bytes of gathering
    float32 in bf16), then the padding cut off."""
    sh = m_local.reshape(-1).to(compute_dtype)       # the Fig-14 cast op
    flat = M.all_gather(sh, plan.data_axes) if plan.dp > 1 else sh
    n = math.prod(local_shape)
    return flat[:n].reshape(tuple(local_shape))


def scatter_grad_local(g: torch.Tensor, plan: MeshPlan) -> torch.Tensor:
    """The transpose of :func:`gather_master_local`: the cotangent of the
    full local param zero-padded, reduce-scattered over the data axes (each
    rank's block summed in rank order, in the cotangent's dtype), then
    float32 -- ``(1, 1, chunk)``, the data *sum* of the rank's rows."""
    dp = plan.dp
    flat = g.reshape(-1)
    chunk = _chunk_size(flat.numel(), dp)
    flat = torch.nn.functional.pad(flat, (0, dp * chunk - flat.numel()))
    if dp > 1:
        flat = M.psum_scatter(flat, plan.data_axes)
    return flat.float().reshape(1, 1, chunk)


def init_zero_state_local(masters_local: Dict[str, torch.Tensor],
                          plan: MeshPlan = MeshPlan()) -> ZeroState:
    """Zero float32 moments beside each master shard, step 0."""
    return init_zero_flat(masters_local)


# ---------------------------------------------------------------------------
# global flat-shard kernels: the per-stage entry points the graph
# pipeline's opt actors and its monolithic engine share. The whole
# (dp, 1, chunk) flat master of a tensor lives in one tensor.
# ---------------------------------------------------------------------------

def shard_flat(x: torch.Tensor, *, dp: int) -> torch.Tensor:
    """Full tensor -> flat ``(dp, 1, chunk)`` float32 shards, zero-padded
    (a new tensor). The global-view dual of :func:`shard_master_local`.
    Padding stays exactly zero through AdamW updates (0 moments, 0 grad, 0
    weight-decay term), so gather -> re-shard across dp values is bitwise
    lossless."""
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32, copy=True)
    chunk = _chunk_size(flat.numel(), dp)
    flat = torch.nn.functional.pad(flat, (0, dp * chunk - flat.numel()))
    return flat.reshape(dp, 1, chunk)


def gather_flat(m: torch.Tensor, *, shape: Sequence[int],
                dtype=torch.float32) -> torch.Tensor:
    """Flat ``(dp, 1, chunk)`` shards -> the full tensor in ``dtype``. The
    cast comes *before* the reshape: Fig 14's ``cast`` ahead of the
    ``S(0) -> B`` gather, so a master crosses the wire at compute width.
    In float32 the result is a view of ``m`` (the masters' own bits)."""
    flat = m.to(_dtype(dtype)).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(tuple(shape))


def flat_zeros(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Zeros in the flat ``(dp, 1, chunk)`` float32 layout of ``x``."""
    return torch.zeros((dp, 1, _chunk_size(x.numel(), dp)),
                       dtype=torch.float32, device=x.device)


def _dtype(dtype) -> torch.dtype:
    """A torch dtype, or its name (``"float32"``, ``"bfloat16"``)."""
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def init_zero_flat(masters: Dict[str, torch.Tensor]) -> ZeroState:
    """Zero float32 moments in the masters' flat layout, step 0."""
    dev = next(iter(masters.values())).device
    zeros = lambda: {n: torch.zeros_like(m, dtype=torch.float32)  # noqa: E731
                     for n, m in masters.items()}
    return ZeroState(torch.zeros((), dtype=torch.int32, device=dev),
                     zeros(), zeros())


@torch.no_grad()
def zero_stage_update(masters: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor], state: ZeroState, lr,
                      *, dp: int, beta1: float, beta2: float, eps: float,
                      weight_decay: float) -> ZeroState:
    """One optimizer stage's ZeRO AdamW step on flat masters, in place.

    ``masters``: ``{name: (dp, 1, chunk) float32}``; ``grads``: ``{name:
    full-shape pre-clipped float32}``. The per-element math is
    :func:`repro_torch.optim.adamw.adamw_param_update`, which is
    elementwise and so layout-invariant: the flat update is bitwise the
    dense one reshaped. Returns the new :class:`ZeroState`."""
    step = state.step + 1
    for n, m in masters.items():
        adamw_param_update(m, shard_flat(grads[n], dp=dp), state.mu[n],
                           state.nu[n], step, lr, beta1=beta1, beta2=beta2,
                           eps=eps, weight_decay=weight_decay)
    return ZeroState(step, state.mu, state.nu)


# ---------------------------------------------------------------------------
# gradient combine over the model axis for replicated leaves
# ---------------------------------------------------------------------------

def model_combine_tree(param_specs: Dict[str, NdSbp], plan: MeshPlan
                       ) -> Dict[str, str]:
    """Per-leaf model-axis gradient combine: ``"none"`` | ``"sum"``.

    A leaf split over ``model`` needs none. In the reference every
    model-replicated leaf is ``"sum"``: under ``shard_map``'s varying
    masters each rank's autodiff covers only its own branch of every psum.
    Here the model's "f" steps (:func:`repro_torch.models.common
    .grad_sync_step`) psum a branch input's cotangent already, so a
    replicated leaf applied before an "f" (the norms of the residual
    stream) has its whole gradient on every rank; only the leaves used
    inside a rank's branch (:data:`MODEL_SUM_LEAVES`) hold disjoint parts
    and are summed -- the combine of the port's plain path."""
    mx = plan.axis_names.index(plan.model_axis) if plan.tp > 1 else None

    def mode(name, sbp):
        if mx is None or isinstance(ndsbp(sbp)[mx], Split):
            return "none"
        return ("sum" if name.rsplit(".", 1)[-1] in MODEL_SUM_LEAVES
                else "none")
    return {n: mode(n, s) for n, s in param_specs.items()}


def combine_model_grads(grads: Dict[str, torch.Tensor],
                        combine: Dict[str, str], plan: MeshPlan
                        ) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient combined over ``model`` by ``combine`` (inside
    spmd on a mesh; the identity at tp = 1)."""
    if plan.tp == 1:
        return grads
    return {n: M.psum(g, plan.model_axis) if combine[n] == "sum" else g
            for n, g in grads.items()}


# ---------------------------------------------------------------------------
# the updates
# ---------------------------------------------------------------------------

@torch.no_grad()
def zero_adamw_update(cfg: AdamWConfig, masters: Dict[str, torch.Tensor],
                      grads_flat: Dict[str, torch.Tensor], state: ZeroState,
                      plan: MeshPlan, replication: Dict[str, int],
                      lr_scale: float = 1.0
                      ) -> Tuple[ZeroState, torch.Tensor]:
    """Adam on a rank's ``(1, 1, chunk)`` master shards, in place, in the
    order of ``masters`` (the reference tree's). ``grads_flat`` has the
    same layout, already reduce-scattered over data, divided by dp and
    model-combined. The global norm: each shard's float32 sum of squares
    over its leaf's model-axis replication, psummed over ``data`` and then
    ``model``. Returns the new state and the pre-clip norm."""
    sumsq = sum(grads_flat[n].float().square().sum() / replication[n]
                for n in masters)
    if plan.dp > 1:
        sumsq = M.psum(sumsq, plan.data_axes)
    if plan.tp > 1:
        sumsq = M.psum(sumsq, plan.model_axis)
    norm = torch.sqrt(sumsq)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(norm, 1e-12),
                         max=1.0) if cfg.grad_clip else 1.0)
    step = state.step + 1
    for n, m in masters.items():
        adamw_param_update(m, grads_flat[n].float() * scale, state.mu[n],
                           state.nu[n], step, cfg.lr * lr_scale,
                           beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                           weight_decay=cfg.weight_decay)
    return ZeroState(step, state.mu, state.nu), norm


@torch.no_grad()
def data_mean(grads: Dict[str, torch.Tensor], plan: MeshPlan
              ) -> Dict[str, torch.Tensor]:
    """Each rank's float32 gradients all-reduced over the data axes in rank
    order and divided by dp: their mean over the batch's row blocks."""
    dp = plan.dp
    return {n: (M.psum(g.float(), plan.data_axes) / dp if dp > 1
                else g.float()) for n, g in grads.items()}


@torch.no_grad()
def plain_dp_adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                          grads: Dict[str, torch.Tensor], state: AdamWState,
                          plan: MeshPlan = MeshPlan(),
                          replication: Optional[Dict[str, int]] = None,
                          lr_scale: float = 1.0
                          ) -> Tuple[AdamWState, torch.Tensor]:
    """Global-norm clip, then AdamW on every param, in place, in the order
    of ``params`` (the reference tree's). Returns the new state and the
    pre-clip global norm.

    At dp = tp = 1 the mean over dp and the psums are the identity and
    every ``replication`` divisor is 1, so this is :func:`adamw_update`.
    On a mesh ``grads`` are this rank's (its model-disjoint leaves already
    summed over ``model``) and ``replication[n]`` counts the identical
    model-axis copies of leaf ``n`` (tp for a replicated leaf, 1 for a
    split one)."""
    if plan.is_single:
        return adamw_update(cfg, params, grads, state, lr_scale)
    grads = data_mean(grads, plan)
    sumsq = sum(g.square().sum() / replication[n] for n, g in grads.items())
    if plan.tp > 1:
        sumsq = M.psum(sumsq, plan.model_axis)
    norm = torch.sqrt(sumsq)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp_min(norm, 1e-12),
                         max=1.0) if cfg.grad_clip else 1.0)
    step = state.step + 1
    for n, p in params.items():
        adamw_param_update(p, grads[n] * scale, state.mu[n], state.nu[n], step,
                           cfg.lr * lr_scale, beta1=cfg.beta1,
                           beta2=cfg.beta2, eps=cfg.eps,
                           weight_decay=cfg.weight_decay)
    return AdamWState(step, state.mu, state.nu), norm
