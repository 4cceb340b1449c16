"""Load the reference's parameter tree into the port's modules.

The one place that knows the JAX tree's layout (``repro/models/transformer
.py:249-281``): top-level ``embed``, ``unembed`` and ``final_norm``; a
``prologue`` list of per-layer trees; and ``body``, one tree per period
slot ``j`` whose leaves are stacked over periods, so layer
``n_pro + i*P + j`` is ``body[j][leaf][i]``. Leaves arrive as numpy arrays
(``jax.device_get`` of the reference's params); nothing here imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported, stack_layout


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(tree: Mapping[str, Any], cfg: ModelConfig) -> List[Any]:
    """The per-layer subtrees of a ``{"prologue", "body"}`` tree (params or
    caches), in layer order."""
    lay = stack_layout(cfg)
    layers = list(tree["prologue"])
    for i in range(lay.n_periods):
        for j in range(len(lay.period_slots)):
            layers.append(_map(lambda a, i=i: np.asarray(a)[i],
                               tree["body"][j]))
    return layers


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = np.asarray(v)


def params_from_jax(np_tree: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The reference's param tree -> a ``state_dict`` for
    :class:`repro_torch.models.transformer.Transformer`."""
    check_supported(cfg)
    flat: Dict[str, np.ndarray] = {}
    for k in ("embed", "unembed", "final_norm"):
        flat[k] = np.asarray(np_tree[k])
    for li, blk in enumerate(unstack_layers(np_tree, cfg)):
        _flatten(blk, f"blocks.{li}.", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}
