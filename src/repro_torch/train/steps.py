"""The training and serving step builders (port of ``repro/train/steps.py``'s
``make_train_step`` and ``make_serve_step``).

The reference wraps the local step in ``shard_map`` over the mesh and
``jax.jit``s it. Here the step runs eagerly on the ranks of a
:class:`repro_torch.core.mesh.DeviceMesh` (threads of
:func:`repro_torch.core.mesh.spmd`; on one card they are virtual ranks of
it): tensor parallelism over ``model`` (heads, MLP units and vocabulary
split, :func:`repro_torch.models.transformer.model_specs`) and data
parallelism over ``data`` (rows split). The loss is the taped program of
:func:`repro_torch.models.transformer.mesh_loss_program`, whose
collectives never run inside autograd. ``fsdp=True`` makes every mesh axis
a data axis, as the reference does (tp = 1).

``zero=True`` (the default, as in the reference) is the paper's §6.4
ZeRO-DP (:mod:`repro_torch.optim.zero`): each rank owns its ``(1, 1,
chunk)`` rows of every leaf's flat float32 master and of its
:class:`~repro_torch.optim.zero.ZeroState` moments (:class:`ZeroParams`).
The rank's loss program is the model's with one collective step in front
of each leaf's first use (:func:`zero_loss_program`): the rank's rows cast
to the compute dtype and all-gathered over the data axes, whose transpose
is the reduce-scatter of the gradient. Then the data sum divided by dp,
the ``model`` combine of the model-disjoint leaves and
:func:`~repro_torch.optim.zero.zero_adamw_update`.

``zero=False`` is the plain path: on one device the loss, autograd and
:func:`~repro_torch.optim.zero.plain_dp_adamw_update` over the
:class:`~repro_torch.models.transformer.Transformer` module (float32,
updated in place); on a mesh each rank owns a copy of its shard of every
param and its own AdamW state (:class:`MeshParams`), the model-disjoint
leaves (:data:`repro_torch.models.common.MODEL_GRAD_SUM_LEAVES`) are
psummed over ``model`` after the backward and the update all-reduces over
``data``.

Every path trains dense GQA stacks and Mamba-2 (SSM) stacks alike, on one
device and on any ``(data, model)`` mesh whose model axis splits the heads;
on the card an SSM layer's scan runs the SSD kernels forward and backward
(:class:`repro_torch.kernels.ssd_scan.kernel.SsdScan`). MLA + MoE stacks
(deepseek-v2-lite) train on one device, plain and ZeRO at 1 x 1, the
attention backward at MLA's ``(D, Dv)`` on the card and the routers'
load-balance loss in the loss (``aux_loss``); on any other mesh they raise
(ROADMAP Queue 1 item 13), as hybrid stacks do before any path is chosen.
So do the frontend architectures, trained on one device plain and ZeRO at
1 x 1 from the reference's batch forms (:func:`batch_specs`): an embed
frontend (pixtral) from ``{"embeds", "labels"}``, an encoder-decoder
(whisper) from ``{"tokens", "enc_embeds"}``; on the card the encoder's
non-causal attention and the decoder's cross-attention run the attention
backward kernels with ``causal=False``.

:func:`make_serve_step` is the reference's serving step of its classic
loop (``launch/serve.py:19-77``): the whole-model
:func:`~repro_torch.models.transformer.prefill` and
:func:`~repro_torch.models.transformer.decode_step`, the caches, and the
decode head for the prefill's first token, on one device.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mesh as M
from repro_torch.core.lowering import data_index
from repro_torch.core.placement import Placement
from repro_torch.core.sbp import Split
from repro_torch.core.tape import (INTERNAL, LocalProgram, Step,
                                   taped_backward, taped_forward)
from repro_torch.models.common import (MODEL_GRAD_SUM_LEAVES, MeshPlan,
                                       resolve_device)
from repro_torch.models.convert import jax_leaves
from repro_torch.models.model_zoo import build_model, loss_fn
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import make_decode_caches
from repro_torch.models.transformer import (Transformer, batch_inputs,
                                            batch_tensors,
                                            check_mesh_supported,
                                            check_supported, compute_dtype,
                                            mesh_loss_program, model_specs,
                                            shard_params)
from repro_torch.optim.adamw import AdamWConfig, AdamWState, init_adamw
from repro_torch.optim.zero import (ZeroState, combine_model_grads,
                                    data_mean, gather_flat,
                                    gather_master_local, init_zero_flat,
                                    model_combine_tree, plain_dp_adamw_update,
                                    scatter_grad_local, shard_master_local,
                                    zero_adamw_update)
from repro_torch.serve.sampler import (  # noqa: F401 (re-exported)
    greedy_from_logits)


def batch_specs(cfg: ModelConfig, plan: MeshPlan, kind: str
                ) -> Dict[str, Any]:
    """Each batch key's signature over ``plan``'s mesh (reference
    ``train/steps.py:37-56``): rows split over the data axes, replicated
    over ``model``. ``kind`` "train": ``tokens``, or ``embeds`` and
    ``labels`` for an embed frontend; "prefill": ``tokens``, or ``embeds``;
    an encoder-decoder adds ``enc_embeds`` to either."""
    from repro_torch.core.sbp import ndsbp
    rows = ndsbp(",".join("B" if n == plan.model_axis else "S(0)"
                          for n in plan.axis_names))
    return dict.fromkeys(batch_inputs(cfg, kind), rows)


@dataclasses.dataclass
class TrainStep:
    step_fn: Callable       # (params, opt_state, batch) -> (params, opt, metrics)
    init_params: Callable   # (seed) -> params, trainable, on device
    init_opt: Callable      # (params) -> AdamWState (a list, a rank each)
    plan: MeshPlan
    device: torch.device
    #: (params, batch) -> (loss, grads): the pre-clip gradients of the
    #: batch's mean loss by ``state_dict`` name, global tensors (on a mesh
    #: assembled from the ranks' data means), for tests and tools
    grad_fn: Optional[Callable] = None
    mesh: Optional[M.DeviceMesh] = None   # the ranks, beyond plain 1 x 1
    zero: bool = False
    #: (zero) global params (a ``state_dict``, a ``Transformer`` or
    #: :class:`MeshParams`) -> :class:`ZeroParams`, the flat master rows
    shard_params_fn: Optional[Callable] = None
    #: (zero) :class:`ZeroParams` -> the global ``state_dict``, float32
    gather_params_fn: Optional[Callable] = None


class MeshParams:
    """Each rank's own copy of its shard of every param of a global
    ``state_dict`` under :func:`~repro_torch.models.transformer
    .model_specs`, float32, in the reference tree's leaf order ``order``;
    the step updates them in place (a rank owns its replicas, so no update
    reaches another rank's). :meth:`state_dict` assembles the global
    tensors when asked (checkpoints, tests), never inside a step."""

    def __init__(self, state: Dict[str, torch.Tensor], order: List[str],
                 cfg: ModelConfig, plan: MeshPlan, mesh: M.DeviceMesh):
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.ranks: List[Dict[str, torch.Tensor]] = []
        for r in range(mesh.size):
            mine = shard_params(state, cfg, plan, mesh.coords(r))
            self.ranks.append({n: mine[n].to(
                mesh.devices[r], copy=True,
                memory_format=torch.contiguous_format) for n in order})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        specs = model_specs(self.cfg, self.plan)
        return {n: M.assemble([r[n] for r in self.ranks], self.mesh,
                              specs[n]) for n in self.ranks[0]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy each rank's shard of the global ``state`` in."""
        for r, mine in enumerate(self.ranks):
            src = shard_params(state, self.cfg, self.plan,
                               self.mesh.coords(r))
            for n, t in mine.items():
                t.copy_(src[n])

    def numel(self) -> int:
        """Parameters held over all ranks (replicas counted each time)."""
        return sum(t.numel() for r in self.ranks for t in r.values())


def make_train_step(cfg: ModelConfig, plan: MeshPlan = MeshPlan(),
                    optimizer: Optional[AdamWConfig] = None,
                    zero: bool = True, remat: bool = True,
                    fsdp: bool = False, device=None) -> TrainStep:
    """A training step for ``cfg`` on the mesh of ``plan`` (1 x 1: one
    device), on ``device`` (``None``: the card; every rank of a mesh on
    it). ``zero=True`` shards float32 masters and moments over the data
    axes (the reference's default); ``fsdp=True`` uses every mesh axis for
    data, as the reference.

    ``step_fn(params, opt_state, batch)`` takes the global batch in the
    reference's form for ``cfg`` (:func:`batch_specs`): ``{"tokens": (B,
    S+1)}`` int32; for an embed frontend ``{"embeds": (B, S, d),
    "labels": (B, S)}``; an encoder-decoder adds ``"enc_embeds": (B,
    enc_len, d)``. It returns ``(params, opt_state, metrics)``, the
    params and state updated in place; metrics ``lm_loss``, ``aux_loss``,
    ``loss`` and ``grad_norm`` (pre-clip) are 0-d tensors on the device,
    on a mesh averaged over its ranks in rank order (the reference's
    ``certified_mean``). On a mesh B must divide by dp."""
    if fsdp:
        plan = MeshPlan(plan.axis_names, plan.axis_sizes,
                        model_axis="__fsdp_none__")
    check_supported(cfg)
    check_mesh_supported(cfg, plan)
    optimizer = optimizer or AdamWConfig()
    device = resolve_device(device)
    order = [n for _, names in jax_leaves(cfg) for n in names]
    if zero:
        return _zero_train_step(cfg, plan, optimizer, remat, device, order)
    if not plan.is_single:
        return _mesh_train_step(cfg, plan, optimizer, remat, device, order)

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
        grads = _grads(loss, named)
        opt_state, gnorm = plain_dp_adamw_update(
            optimizer, named, grads, opt_state)
        metrics["grad_norm"] = gnorm
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params: Transformer, batch: Dict[str, Any]):
        named = leaves(params)
        loss, _ = loss_fn(params, batch, remat=remat)
        return loss.detach(), _grads(loss, named)

    return TrainStep(step_fn, init_params, init_opt, plan, device, grad_fn)


METRICS = ("lm_loss", "aux_loss", "loss", "grad_norm")


def _or_zeros(grads: Dict[str, Any], like: Dict[str, torch.Tensor]):
    """``grads`` with zeros (shaped as ``like``'s tensor of the name) where
    no cotangent reached a leaf: a leaf the loss does not read (an embed
    frontend's ``embed``), whose gradient JAX gives as zeros."""
    return {n: torch.zeros_like(like[n]) if g is None else g
            for n, g in grads.items()}


def _grads(loss, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradient of ``loss`` for each of ``named`` (:func:`_or_zeros`)."""
    return _or_zeros(dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), allow_unused=True))), named)


def _rank_rows(mesh: M.DeviceMesh, plan: MeshPlan, device: torch.device,
               cfg: ModelConfig):
    """A global batch -> each rank's block of its rows (by data index) of
    every batch input (:func:`~repro_torch.models.transformer
    .batch_inputs`), in the loss program's input order."""
    rows = [data_index(mesh, plan, r) for r in range(mesh.size)]

    def rank_rows(batch: Dict[str, Any]) -> List[List[torch.Tensor]]:
        bt = list(batch_tensors(batch, cfg, device).values())
        B = bt[0].shape[0]
        if B % plan.dp:
            raise ValueError(f"a batch of {B} rows does not split over "
                             f"dp = {plan.dp}")
        B_l = B // plan.dp
        return [[t[d * B_l:(d + 1) * B_l] for t in bt] for d in rows]
    return rank_rows


def _metrics(plan: MeshPlan, mesh: M.DeviceMesh, lm, aux, loss,
             gnorm) -> Dict[str, torch.Tensor]:
    """A rank's metrics (its loss program's ``lm_loss``, ``aux_loss`` and
    ``loss``, and the step's ``grad_norm``) averaged over every rank in
    rank order (inside spmd)."""
    vals = torch.stack([lm, aux, loss, gnorm])
    vals = M.psum(vals, plan.axis_names) / mesh.size
    return dict(zip(METRICS, vals.unbind()))


def _mesh_train_step(cfg: ModelConfig, plan: MeshPlan,
                     optimizer: AdamWConfig, remat: bool,
                     device: torch.device, order: List[str]) -> TrainStep:
    """The step on the ranks of ``plan``'s mesh (see the module doc)."""
    mesh = Placement(plan.axis_names, plan.axis_sizes).to_mesh(device)
    specs = model_specs(cfg, plan)
    program = mesh_loss_program(cfg, plan, remat=remat)
    diff = set(order)
    mx = plan.axis_names.index(plan.model_axis) if plan.tp > 1 else None
    # identical model-axis copies of each leaf, for the norm
    replication = {n: 1 if mx is None or isinstance(specs[n][mx], Split)
                   else plan.tp for n in order}
    model_sum = [n for n in order if replication[n] > 1
                 and n.rsplit(".", 1)[-1] in MODEL_GRAD_SUM_LEAVES]
    ranks = list(range(mesh.size))
    rank_rows = _rank_rows(mesh, plan, device, cfg)
    n_batch = len(batch_inputs(cfg))

    def init_params(seed: int = 0) -> MeshParams:
        return MeshParams(build_model(cfg, plan, seed=seed,
                                      device=device).state_dict(),
                          order, cfg, plan, mesh)

    def init_opt(params: MeshParams) -> List[AdamWState]:
        return [init_adamw(mine) for mine in params.ranks]

    def rank_grads(mine: Dict[str, torch.Tensor], rows: List[torch.Tensor]):
        """This rank's losses ``(loss, lm_loss, aux_loss)`` and gradients,
        the model-disjoint leaves summed over ``model``: the taped forward
        and backward, then collectives outside autograd."""
        losses, tape = taped_forward(
            program, diff, [*rows, *(mine[n] for n in
                                     program.input_names[n_batch:])])
        grads = _or_zeros(dict(zip(order, taped_backward(
            tape, {"loss": torch.ones_like(losses[0])}, order))), mine)
        for n in model_sum:
            grads[n] = M.psum(grads[n], plan.model_axis)
        return losses, grads

    def step_fn(params: MeshParams, opt_state: List[AdamWState],
                batch: Dict[str, Any]):
        rows = rank_rows(batch)

        def rank_step(r: int):
            mine = params.ranks[r]
            (loss, lm, aux), grads = rank_grads(mine, rows[r])
            state, gnorm = plain_dp_adamw_update(
                optimizer, mine, grads, opt_state[r], plan, replication)
            return state, _metrics(plan, mesh, lm, aux, loss, gnorm)

        outs = M.spmd(rank_step, mesh)(ranks)
        return params, [o[0] for o in outs], outs[0][1]

    def grad_fn(params: MeshParams, batch: Dict[str, Any]):
        rows = rank_rows(batch)

        def rank(r: int):
            (loss, _, _), grads = rank_grads(params.ranks[r], rows[r])
            loss = M.psum(loss, plan.axis_names) / mesh.size
            return loss, data_mean(grads, plan)

        outs = M.spmd(rank, mesh)(ranks)
        return outs[0][0], {n: M.assemble([o[1][n] for o in outs], mesh,
                                          specs[n]) for n in order}

    return TrainStep(step_fn, init_params, init_opt, plan, device,
                     grad_fn, mesh)


# ---------------------------------------------------------------------------
# ZeRO: flat float32 master rows on each rank, gathered on the tape
# ---------------------------------------------------------------------------

def _master(name: str) -> str:
    """The program input holding a leaf's master rows."""
    return name + INTERNAL + "master"


def _data_group(mesh: M.DeviceMesh, plan: MeshPlan, rank: int):
    """The ranks of ``rank``'s data group, in rank order (= data index)."""
    return mesh.group(rank, plan.data_axes) if plan.dp > 1 else (rank,)


def gather_ranks(ranks: List[Dict[str, torch.Tensor]],
                 shapes: Dict[str, Tuple[int, ...]], mesh: M.DeviceMesh,
                 plan: MeshPlan, specs) -> Dict[str, torch.Tensor]:
    """Every rank's ``(1, 1, chunk)`` rows of each leaf -> the global
    float32 tensors: each rank's data group's rows joined into its full
    local shard (on the host side of the mesh, no collective), then the
    shards assembled by their signatures."""
    full = []
    for r in range(mesh.size):
        dev = mesh.devices[r]
        group = _data_group(mesh, plan, r)
        full.append({n: gather_flat(torch.cat([ranks[g][n].to(dev)
                                               for g in group]),
                                    shape=shapes[n])
                     for n in ranks[r]})
    return {n: M.assemble([f[n] for f in full], mesh, specs[n])
            for n in ranks[0]}


class ZeroParams:
    """Each rank's ``(1, 1, chunk)`` float32 master rows of every param
    (:func:`repro_torch.optim.zero.shard_master_local` of its shard under
    :func:`~repro_torch.models.transformer.model_specs`, block = its data
    index), in the reference tree's leaf order ``order``; the step updates
    them in place. ``shapes`` are the local shard shapes the gathers
    restore; :meth:`state_dict` assembles the global tensors when asked
    (checkpoints, tests), never inside a step."""

    def __init__(self, state: Dict[str, torch.Tensor], order: List[str],
                 cfg: ModelConfig, plan: MeshPlan, mesh: M.DeviceMesh):
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.specs = model_specs(cfg, plan)
        self.ranks: List[Dict[str, torch.Tensor]] = []
        for r in range(mesh.size):
            mine = shard_params(state, cfg, plan, mesh.coords(r))
            self.shapes = {n: tuple(mine[n].shape) for n in order}
            d = data_index(mesh, plan, r)
            self.ranks.append({n: shard_master_local(
                mine[n].detach().to(mesh.devices[r]), plan, d)
                for n in order})

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return gather_ranks(self.ranks, self.shapes, self.mesh, self.plan,
                            self.specs)

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Copy each rank's rows of the global ``state`` in."""
        for r, mine in enumerate(self.ranks):
            src = shard_params(state, self.cfg, self.plan,
                               self.mesh.coords(r))
            d = data_index(self.mesh, self.plan, r)
            for n, t in mine.items():
                t.copy_(shard_master_local(torch.as_tensor(src[n]).detach()
                                           .to(t.device), self.plan, d))

    def numel(self) -> int:
        """Master elements held over all ranks (padding included)."""
        return sum(t.numel() for r in self.ranks for t in r.values())


def zero_loss_program(program: LocalProgram, shapes: Dict[str, Tuple],
                      cdt: torch.dtype, plan: MeshPlan) -> LocalProgram:
    """``program`` (a rank's loss over its param shards) over master rows
    instead: each param input becomes its master rows (:func:`_master`),
    and one collective step in front of the param's first use casts the
    rows to ``cdt``, all-gathers them over the data axes and reshapes them
    to the shard (:func:`~repro_torch.optim.zero.gather_master_local`).
    Its transpose reduce-scatters the shard's cotangent over the same axes
    in rank order, then float32
    (:func:`~repro_torch.optim.zero.scatter_grad_local`): the data *sum* of
    the rank's rows. Gathering at first use lets the backward scatter each
    gradient as soon as it is whole."""
    def gather(n):
        return Step(lambda m: gather_master_local(m, shapes[n], cdt, plan),
                    (_master(n),), (n,), collective=True,
                    transpose=lambda g: scatter_grad_local(g, plan))
    steps, done = [], set()
    for st in program.steps:
        for n in st.ins:
            if n in shapes and n not in done:
                steps.append(gather(n))
                done.add(n)
        steps.append(st)
    inputs = tuple(_master(n) if n in shapes else n
                   for n in program.input_names)
    return LocalProgram(steps, inputs, program.output_names,
                        program.out_keys)


def _zero_train_step(cfg: ModelConfig, plan: MeshPlan,
                     optimizer: AdamWConfig, remat: bool,
                     device: torch.device, order: List[str]) -> TrainStep:
    """The ZeRO step on the ranks of ``plan``'s mesh (one rank at 1 x 1;
    see the module doc)."""
    mesh = Placement(plan.axis_names, plan.axis_sizes).to_mesh(device)
    specs = model_specs(cfg, plan)
    with torch.device("meta"):
        shapes = {n: tuple(t.shape) for n, t in shard_params(
            Transformer(cfg, plan).state_dict(), cfg, plan,
            mesh.coords(0)).items()}
    program = zero_loss_program(mesh_loss_program(cfg, plan, remat=remat),
                                shapes, compute_dtype(cfg), plan)
    param_of = {_master(n): n for n in order}
    diff = set(order) | set(param_of)
    mx = plan.axis_names.index(plan.model_axis) if plan.tp > 1 else None
    replication = {n: 1 if mx is None or isinstance(specs[n][mx], Split)
                   else plan.tp for n in order}
    combine = model_combine_tree(specs, plan)
    ranks = list(range(mesh.size))
    rank_rows = _rank_rows(mesh, plan, device, cfg)
    n_batch = len(batch_inputs(cfg))

    def shard_params_fn(params) -> ZeroParams:
        state = (params.state_dict() if hasattr(params, "state_dict")
                 else params)
        return ZeroParams(state, order, cfg, plan, mesh)

    def gather_params_fn(params: ZeroParams) -> Dict[str, torch.Tensor]:
        return params.state_dict()

    def init_params(seed: int = 0) -> ZeroParams:
        return shard_params_fn(build_model(cfg, plan, seed=seed,
                                           device=device))

    def init_opt(params: ZeroParams) -> List[ZeroState]:
        return [init_zero_flat(mine) for mine in params.ranks]

    def rank_grads(mine: Dict[str, torch.Tensor], rows: List[torch.Tensor]):
        """This rank's losses ``(loss, lm_loss, aux_loss)`` and its rows'
        gradients: the data mean, the model-disjoint leaves summed over
        ``model``. The gathers and their reduce-scatters run on the tape,
        outside autograd."""
        losses, tape = taped_forward(
            program, diff, [*rows, *(mine[param_of[n]]
                                     for n in program.input_names[n_batch:])])
        cots = taped_backward(tape, {"loss": torch.ones_like(losses[0])},
                              [_master(n) for n in order])
        grads = {n: g / plan.dp for n, g in _or_zeros(
            dict(zip(order, cots)), mine).items()}
        return losses, combine_model_grads(grads, combine, plan)

    def step_fn(params: ZeroParams, opt_state: List[ZeroState],
                batch: Dict[str, Any]):
        rows = rank_rows(batch)

        def rank_step(r: int):
            mine = params.ranks[r]
            (loss, lm, aux), grads = rank_grads(mine, rows[r])
            state, gnorm = zero_adamw_update(
                optimizer, mine, grads, opt_state[r], plan, replication)
            return state, _metrics(plan, mesh, lm, aux, loss, gnorm)

        outs = M.spmd(rank_step, mesh)(ranks)
        return params, [o[0] for o in outs], outs[0][1]

    def grad_fn(params: ZeroParams, batch: Dict[str, Any]):
        rows = rank_rows(batch)

        def rank(r: int):
            (loss, _, _), grads = rank_grads(params.ranks[r], rows[r])
            return M.psum(loss, plan.axis_names) / mesh.size, grads

        outs = M.spmd(rank, mesh)(ranks)
        return outs[0][0], gather_ranks([o[1] for o in outs],
                                        params.shapes, mesh, plan, specs)

    return TrainStep(step_fn, init_params, init_opt, plan, device, grad_fn,
                     mesh, zero=True, shard_params_fn=shard_params_fn,
                     gather_params_fn=gather_params_fn)


# ---------------------------------------------------------------------------
# serving: the reference's classic loop's step (``:257-340``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeStep:
    """The classic loop's programs on one device: ``prefill_fn(params,
    batch) -> (h_last, caches)``, ``decode_fn(params, caches, tok, pos) ->
    (logits, caches)`` (the caches updated in place), ``init_caches_fn(tok)
    -> caches`` (zeroed, for tok's rows) and ``logits_fn(params, h_last) ->
    logits``, the decode step's head; ``params`` is the
    :class:`~repro_torch.models.transformer.Transformer` to serve (its
    compute-dtype copy: :func:`make_serve_step`'s ``init_params``)."""

    prefill_fn: Callable
    decode_fn: Callable
    init_caches_fn: Callable
    logits_fn: Callable
    init_params: Callable      # (seed) -> the seeded model, compute dtype
    batch_specs: Dict[str, Any]
    plan: MeshPlan
    device: torch.device


def make_serve_step(cfg: ModelConfig, plan: MeshPlan = MeshPlan(),
                    cache_len: int = 0, device=None, sliding_window: int = 0,
                    ring: bool = False) -> ServeStep:
    """The serving step of the reference's classic loop (``make_serve_step``,
    ``repro/train/steps.py:289-340``) for any arch the port builds, the
    embed-frontend and encoder-decoder ones among them, on one device
    (``device`` None: the card). ``logits_fn`` is the decode step's head
    bit for bit, ``h_last[:, 0] @ unembed`` in h's dtype (the reference's
    ``:329-337``): the prefill's first-token logits come from the same
    product as every decode step's. A mesh, ``ring=True`` (the
    sliding-window ring cache) and ``sliding_window > 0`` raise: ROADMAP
    Queue 1 item 13, and on the card Queue 2 item 3(a)."""
    check_supported(cfg)
    check_mesh_supported(cfg, plan)
    if not plan.is_single:
        raise NotImplementedError(
            "make_serve_step on a mesh is ROADMAP Queue 1 item 13 (the "
            "classic loop serves on one device; api.compile(cfg, "
            "mode='serve', mesh=...) serves token-frontend archs on one)")
    if ring or sliding_window > 0:
        raise NotImplementedError(
            "make_serve_step: the sliding-window ring cache is ROADMAP "
            "Queue 1 item 13, its decode kernel Queue 2 item 3(a)")
    if cache_len < 1:
        raise ValueError(f"cache_len={cache_len} must be >= 1")
    device = resolve_device(device)
    from repro_torch.models.model_zoo import build_model

    def init_params(seed: int = 0) -> Transformer:
        return build_model(cfg, plan, seed=seed, device=device,
                           dtype=compute_dtype(cfg))

    def prefill_fn(params: Transformer, batch):
        return T.prefill(params, batch, cache_len)

    def decode_fn(params: Transformer, caches, tok, pos):
        return T.decode_step(params, caches, tok, pos)

    def init_caches_fn(tok):
        return make_decode_caches(cfg, plan, len(tok), cache_len, device)

    def logits_fn(params: Transformer, h_last):
        with torch.no_grad():
            return h_last[:, 0] @ params.unembed.to(h_last.dtype)

    return ServeStep(prefill_fn, decode_fn, init_caches_fn, logits_fn,
                     init_params, batch_specs(cfg, plan, "prefill"), plan,
                     device)


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
