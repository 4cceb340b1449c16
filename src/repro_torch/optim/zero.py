"""The plain data-parallel AdamW update (port of the ``plain_dp_adamw_update``
half of ``repro/optim/zero.py``, ``:301-340``).

On a mesh it runs once per rank, inside :func:`repro_torch.core.mesh.spmd`
and outside autograd: the gradients are all-reduced over the data axes in
rank order and divided by dp, the global norm sums each leaf's squares over
its model-axis copies once, then the clip and the AdamW recurrence, in the
reference's order. Every rank of a data group ends with the same params
and moments.

The reference's plain path reports dp times the true gradient and norm:
under ``shard_map(check=True)`` a data-replicated param's gradient arrives
already summed over ``data`` (the transpose of the implicit ``pvary``, as
its ZeRO path notes at ``repro/train/steps.py:187-188``), and this update
then divides by dp and psums again. Here the gradient entering is each
rank's own, so the result is the true data mean (ROADMAP Queue 3).

The ZeRO half (flat master shards, ``zero=True``) is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import mesh as M
from repro_torch.models.common import MeshPlan
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     adamw_param_update, adamw_update)


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
