"""Stand-ins for every model input, and the serve plan of a decode shape.

Port of ``repro/launch/specs.py``: the reference's ``ShapeDtypeStruct``
stand-ins become ``torch.empty(..., device="meta")`` tensors of the same
shapes and dtypes (nothing is allocated), and :func:`serve_plan_for` is
its cache and window policy as plain Python. A long-context decode shape
(over 100,000 positions: ``long_500k``) serves a dense GQA arch through
the sliding-window ring cache of 8,192 slots
(:func:`repro_torch.train.steps.make_serve_step` with ``ring=True``);
MLA, SSM and hybrid archs keep their native caches. The dry run that lowers
these (the reference's ``launch/dryrun.py``) is ROADMAP Queue 1 item 14.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig

#: a decode shape past this many positions is long-context
LONG_CONTEXT = 100_000
#: the ring cache's slots, and its window, for a long-context decode
RING_SLOTS = 8192


def _adt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """A training batch: ``embeds`` and ``labels`` for an embed frontend,
    else ``tokens (B, S + 1)``; an encoder-decoder's ``enc_embeds`` too."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embed_frontend and not cfg.encoder_decoder:
        batch = {"embeds": _meta((B, S, cfg.d_model), _adt(cfg)),
                 "labels": _meta((B, S), torch.int32)}
    else:
        batch = {"tokens": _meta((B, S + 1), torch.int32)}
    if cfg.encoder_decoder:
        batch["enc_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                    _adt(cfg))
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """A prefill batch: ``embeds`` for an embed frontend, else ``tokens
    (B, S)``; an encoder-decoder's ``enc_embeds`` too."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.embed_frontend and not cfg.encoder_decoder:
        batch = {"embeds": _meta((B, S, cfg.d_model), _adt(cfg))}
    else:
        batch = {"tokens": _meta((B, S), torch.int32)}
    if cfg.encoder_decoder:
        batch["enc_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                    _adt(cfg))
    return batch


def decode_io_specs(cfg: ModelConfig, shape: InputShape) -> Tuple:
    """A decode step's ``(tok, pos)``, each int32 ``(B,)``."""
    B = shape.global_batch
    return _meta((B,), torch.int32), _meta((B,), torch.int32)


def serve_plan_for(cfg: ModelConfig, shape: InputShape) -> Dict:
    """The cache and window policy of a decode shape (the reference's
    ``:47-61``): ``cache_len`` the shape's length, no window, no ring, the
    batch sharded from 16 rows; past :data:`LONG_CONTEXT` positions a
    dense GQA arch takes the ring of :data:`RING_SLOTS` slots and window,
    an MLA, SSM or hybrid arch keeps its native cache."""
    if shape.kind != "decode":
        raise ValueError(f"serve_plan_for: {shape.name} is a {shape.kind} "
                         "shape, not a decode one")
    plan = {"cache_len": shape.seq_len, "sliding_window": 0, "ring": False,
            "shard_batch": shape.global_batch >= 16}
    if shape.seq_len > LONG_CONTEXT and not (
            cfg.use_mla or cfg.family in ("ssm", "hybrid")):
        plan.update({"cache_len": RING_SLOTS, "sliding_window": RING_SLOTS,
                     "ring": True})
    return plan
