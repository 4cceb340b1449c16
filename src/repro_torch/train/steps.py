"""The training step builder (port of ``repro/train/steps.py``'s
``make_train_step``, plain path, at dp = tp = 1).

The reference wraps the local step in ``shard_map`` over the mesh and
``jax.jit``s it; on one device the step is the local step itself, run
eagerly: the loss, ``torch.autograd.grad`` (``jax.value_and_grad``), then
:func:`repro_torch.optim.zero.plain_dp_adamw_update`. Params are the
:class:`repro_torch.models.transformer.Transformer` module (float32, updated
in place); the optimizer state is an :class:`AdamWState` keyed by its
parameter names.

Not ported yet: ``zero=True`` (flat master shards, ROADMAP Queue 1 item 9;
at dp = 1 the reference gives the same numbers either way), ``fsdp`` and
meshes beyond 1 x 1 (item 8), the ``Graph*`` shims of graph training
(item 7), and SSM layers (the SSD scan's backward, Queue 2 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import MeshPlan, resolve_device
from repro_torch.models.convert import jax_leaves
from repro_torch.models.model_zoo import build_model, loss_fn
from repro_torch.models.transformer import Transformer, check_trainable
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init_adamw
from repro_torch.optim.zero import plain_dp_adamw_update


@dataclasses.dataclass
class TrainStep:
    step_fn: Callable       # (params, opt_state, batch) -> (params, opt, metrics)
    init_params: Callable   # (seed) -> params: the model, trainable, on device
    init_opt: Callable      # (params) -> AdamWState
    plan: MeshPlan
    device: torch.device


def make_train_step(cfg: ModelConfig, plan: MeshPlan = MeshPlan(),
                    optimizer: Optional[AdamWConfig] = None,
                    zero: bool = False, remat: bool = True,
                    device=None) -> TrainStep:
    """A training step for ``cfg`` on one device (``None``: the card).

    ``step_fn(params, opt_state, batch)`` takes ``{"tokens": (B, S+1)}``
    int32 and returns ``(params, opt_state, metrics)``, the params and
    state updated in place; metrics ``lm_loss``, ``aux_loss``, ``loss`` and
    ``grad_norm`` (pre-clip) are 0-d tensors on the device."""
    if zero:
        raise NotImplementedError(
            "make_train_step(zero=True): ZeRO master shards are not ported "
            "yet (ROADMAP Queue 1 item 9); at dp = 1 zero=False computes "
            "the same step")
    check_trainable(cfg)
    optimizer = optimizer or AdamWConfig()
    device = resolve_device(device)
    order = [n for _, names in jax_leaves(cfg) for n in names]

    def leaves(params: Transformer) -> Dict[str, torch.Tensor]:
        """The params in the reference tree's leaf order."""
        named = dict(params.named_parameters())
        return {n: named[n] for n in order}

    def init_params(seed: int = 0) -> Transformer:
        model = build_model(cfg, plan, seed=seed, device=device)
        for p in model.parameters():
            p.requires_grad_(True)
        return model

    def init_opt(params: Transformer) -> AdamWState:
        return init_adamw(leaves(params))

    def step_fn(params: Transformer, opt_state: AdamWState, batch: Dict[str, Any]):
        named = leaves(params)
        loss, metrics = loss_fn(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()))
        opt_state, gnorm = plain_dp_adamw_update(
            optimizer, named, dict(zip(named, grads)), opt_state)
        metrics["grad_norm"] = gnorm
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return TrainStep(step_fn, init_params, init_opt, plan, device)
