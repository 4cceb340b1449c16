"""Public model API: build a model from its config, its training loss,
decode caches.

Port of ``repro/models/model_zoo.py:34-140``: the reference's bundle of
init/loss/prefill/decode closures becomes the
:class:`repro_torch.models.transformer.Transformer` module (which carries
its config and plan), :func:`loss_fn`, and decode caches as one dict per
layer: ``{"k", "v"}`` for GQA attention, ``{"c", "kpe"}`` for MLA (the
latent and the rope key), ``{"h", "tail_x", "tail_bc"}`` for an SSM
layer, and an encoder-decoder's also its cross keys and values ``{"xk",
"xv"}`` over the encoder's ``encoder_seq`` positions; a sliding-window
RING cache (``ring=True``) gives a GQA layer the slot position table
``pos`` too. On a mesh each rank holds its block of every cache
(:func:`cache_specs`): the batch over the data axes, a GQA layer's k/v
also over ``model`` by sequence, an MLA layer's latent replicated over
it, an SSM layer's state over ``model`` by head and its x conv tail by
channel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sbp import NdSbp, ndsbp
from repro_torch.models import transformer as T
from repro_torch.models.attention import kv_heads_local
from repro_torch.models.common import MeshPlan
from repro_torch.models.mamba import init_mamba_state


def build_model(cfg: ModelConfig, plan: MeshPlan, seed: int = 0,
                device=None, dtype=None) -> T.Transformer:
    """The model with the port's seeded init (see :func:`T.init_model`;
    ``dtype`` None gives float32 params)."""
    return T.init_model(cfg, plan, seed=seed, device=device, dtype=dtype)


def loss_fn(params: T.Transformer, batch, remat: bool = True):
    """The training loss, ``(loss, metrics)``: the reference bundle's
    ``loss_fn(params, batch)``."""
    return T.forward_loss(params, batch, params.cfg, params.plan, remat=remat)


def _block_cache(cfg: ModelConfig, plan: MeshPlan, kind: str, batch: int,
                 cache_len: int, device=None,
                 ring: bool = False) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode cache, in the config's compute dtype for
    bfloat16 configs and float32 otherwise (the reference's rule); an SSM
    layer's state ``h`` is float32 whatever the dtype. ``batch`` is this
    rank's rows; a GQA layer holds ``cache_len / tp`` positions, an MLA
    layer all ``cache_len`` of its latent ``c (B, L, r)`` and rope key
    ``kpe (B, L, rope)`` (``repro/models/model_zoo.py:70-72``); an
    encoder-decoder's layer also ``xk``/``xv (B, encoder_seq, KV, hd)``
    (``:87-90``). With ``ring`` a GQA layer also holds its slot position
    table ``pos (B, cache_len / tp)`` int32, every slot -1 (empty;
    ``:77-78``)."""
    adt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if kind == "ssm":
        h, tail_x, tail_bc = init_mamba_state(cfg, plan, batch, adt, device)
        c = {"h": h, "tail_x": tail_x, "tail_bc": tail_bc}
    elif cfg.use_mla:
        c = {key: torch.zeros((batch, cache_len, width), dtype=adt,
                              device=device)
             for key, width in (("c", cfg.kv_lora_rank),
                                ("kpe", cfg.qk_rope_head_dim))}
    else:
        assert kind == "attn", kind
        shape = (batch, cache_len // plan.tp, cfg.num_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=adt, device=device),
             "v": torch.zeros(shape, dtype=adt, device=device)}
        if ring:
            c["pos"] = torch.full(shape[:2], -1, dtype=torch.int32,
                                  device=device)
    if cfg.encoder_decoder:
        shape = (batch, cfg.encoder_seq, kv_heads_local(cfg, plan),
                 cfg.head_dim)
        c.update(xk=torch.zeros(shape, dtype=adt, device=device),
                 xv=torch.zeros(shape, dtype=adt, device=device))
    return c


def make_decode_caches(cfg: ModelConfig, plan: MeshPlan, batch: int,
                       cache_len: int, device=None,
                       layers: Optional[Sequence[int]] = None,
                       ring: bool = False) -> List[Dict[str, torch.Tensor]]:
    """Zeroed decode caches, one dict per layer (or per layer of
    ``layers``, a stage's slice), in layer order; ``ring``: the
    sliding-window ring cache (its GQA layers' ``pos`` tables all -1)."""
    kinds = T.stack_layout(cfg).layer_kinds()
    if layers is None:
        layers = range(len(kinds))
    return [_block_cache(cfg, plan, kinds[i][0], batch, cache_len, device,
                         ring) for i in layers]


def cache_specs(cfg: ModelConfig, plan: MeshPlan,
                batch_axes: Sequence[str],
                ring: bool = False) -> List[Dict[str, NdSbp]]:
    """Each layer's NdSbp per cache leaf (``repro/models/model_zoo.py:
    108-140``): the batch (dim 0) split over ``batch_axes`` -- the data
    axes for a slot group's cache, none for an admission prefill's; a GQA
    layer's k/v split by sequence (dim 1) over the model axis, an MLA
    layer's ``c``/``kpe`` replicated over it (``:122-124``); an SSM
    layer's ``h (B, heads, P, N)`` by head (dim 1) and ``tail_x (B,
    d_conv-1, d_inner)`` by channel (dim 2), ``tail_bc`` replicated; an
    encoder-decoder's ``xk``/``xv`` by head (dim 2, ``:135-137``); a ring
    cache's ``pos`` table as its layer's ``k`` (``:128-129``)."""
    def comps(model_comp: str) -> NdSbp:
        return ndsbp(",".join("S(0)" if n in batch_axes else
                              model_comp if n == plan.model_axis else "B"
                              for n in plan.axis_names))
    attn = ({"c": comps("B"), "kpe": comps("B")} if cfg.use_mla
            else {"k": comps("S(1)"), "v": comps("S(1)"),
                  **({"pos": comps("S(1)")} if ring else {})})
    by_kind = {"attn": attn,
               "ssm": {"h": comps("S(1)"), "tail_x": comps("S(2)"),
                       "tail_bc": comps("B")}}
    cross = ({"xk": comps("S(2)"), "xv": comps("S(2)")}
             if cfg.encoder_decoder else {})
    return [dict(by_kind[kind], **cross)
            for kind, _ in T.stack_layout(cfg).layer_kinds()]
