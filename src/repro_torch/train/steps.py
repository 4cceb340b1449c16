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
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

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
    if not plan.is_single:
        mesh = dict(zip(plan.axis_names, plan.axis_sizes))
        raise NotImplementedError(
            f"make_train_step on a {mesh} mesh: tp/dp > 1 training "
            "(grad_sync, the vocab-parallel lm_loss, collectives kept out "
            "of autograd) is the training half of ROADMAP Queue 1 item 8, "
            "now item 8c, not ported yet; serving runs on a mesh")
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


# ---------------------------------------------------------------------------
# Deprecated graph-training shims (the reference's ``:357-488``). New code
# calls repro_torch.api.compile directly.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphTrainStep:
    """Monolithic microbatched training step over a ``LogicalGraph``.

    ``step_fn(param_values, data) -> (loss, grads, new_params)`` runs every
    microbatch through the whole-graph value-and-grad, accumulates
    gradients in float32, and applies the
    :class:`repro_torch.core.lowering.OptimizerSpec` (default plain SGD)
    with global-norm clipping and the lr schedule resolved exactly like the
    pipeline's optimizer actors. A stateful optimizer's state persists on
    ``opt_state`` across :meth:`step` calls; ``step_count`` indexes the lr
    schedule; ``last_grad_norm`` is the pre-clip global norm.
    """

    step_fn: Any
    param_names: Tuple[str, ...]
    num_microbatches: int
    lr: float
    optimizer: Any = None
    opt_state: Any = None
    step_count: int = 0
    last_grad_norm: Any = None

    def step(self, param_values: Dict[str, Any], data: Dict[str, Any]):
        return self.step_fn(param_values, data)


def make_graph_train_step(graph, params, microbatch_inputs,
                          num_microbatches: int, lr: float = 1e-2,
                          loss=None, graph_plan=None, optimizer=None,
                          device=None) -> GraphTrainStep:
    """DEPRECATED: use ``repro_torch.api.compile(graph, mode="train",
    backend="monolithic", ...)``; this shim adapts the old
    params-threaded-per-call convention onto the session it builds.

    ``params`` names the graph inputs to train; ``microbatch_inputs`` names
    the inputs split along axis 0 into ``num_microbatches`` chunks.
    ``optimizer`` is an :class:`~repro_torch.core.lowering.OptimizerSpec`
    (default: SGD at ``lr``)."""
    warnings.warn(
        "make_graph_train_step is deprecated; use repro_torch.api.compile("
        "graph, mode='train', backend='monolithic', ...) instead",
        DeprecationWarning, stacklevel=2)
    from repro_torch import api
    from repro_torch.core.lowering import (OptimizerSpec, _resolve_loss,
                                           _resolve_params)

    param_names = tuple(getattr(t, "name", t) for t in params)
    # fail at build time, not on the first step
    _resolve_params(graph, param_names)
    _resolve_loss(graph, loss)
    opt = optimizer if optimizer is not None else OptimizerSpec.sgd(lr)
    ts = GraphTrainStep(step_fn=None, param_names=param_names,
                        num_microbatches=num_microbatches, lr=lr,
                        optimizer=opt)
    holder: Dict[str, Any] = {"session": None}

    def step_fn(param_values: Dict[str, Any], data: Dict[str, Any]):
        sess = holder["session"]
        missing = [n for n in param_names if n not in param_values]
        if missing:
            raise ValueError(f"missing params: {missing}")
        pvals = {n: param_values[n] for n in param_names}
        if sess is None:
            sess = holder["session"] = api.compile(
                graph, mode="train", backend="monolithic", plan=graph_plan,
                params=pvals, microbatch_inputs=list(microbatch_inputs),
                num_microbatches=num_microbatches, lr=lr, optimizer=opt,
                loss=loss, device=device)
        else:
            sess.load_params(pvals)
        res = sess.step(**{n: v for n, v in data.items()
                           if n not in pvals})
        ts.opt_state = sess.opt_state
        ts.step_count = sess.step_count
        ts.last_grad_norm = res.metrics["grad_norm"]
        return res.loss, res.grads, res.params

    ts.step_fn = step_fn
    return ts


def make_pipeline_train_step(graph, init_params: Dict[str, Any],
                             microbatch_inputs, num_microbatches: int,
                             num_stages: Optional[int] = None,
                             lr: float = 1e-2, regs=None, loss=None,
                             graph_plan=None, optimizer=None, device=None):
    """DEPRECATED: use ``repro_torch.api.compile(graph, mode="train",
    backend="actors", ...)``; this shim compiles a session and returns its
    :class:`~repro_torch.runtime.pipeline.TrainPipelineExecutor`, the
    historical return type. It keeps the historical 1F1B quotas unless
    ``regs`` is given."""
    warnings.warn(
        "make_pipeline_train_step is deprecated; use repro_torch.api.compile("
        "graph, mode='train', backend='actors', ...) instead",
        DeprecationWarning, stacklevel=2)
    from repro_torch import api

    sess = api.compile(
        graph, mode="train", backend="actors", plan=graph_plan,
        stages=num_stages, params=init_params,
        microbatch_inputs=list(microbatch_inputs),
        num_microbatches=num_microbatches, lr=lr,
        regs=regs if regs is not None else "1f1b", loss=loss,
        optimizer=optimizer, device=device)
    return sess.executor
