"""Move parameters between the reference's tree and the port's modules.

The one place that knows the JAX tree's layout (``repro/models/transformer
.py:249-281``): top-level ``embed``, ``unembed`` and ``final_norm``; a
``prologue`` list of per-layer trees; and ``body``, one tree per period
slot ``j`` whose leaves are stacked over periods, so layer
``n_pro + i*P + j`` is ``body[j][leaf][i]``; an encoder-decoder's
``enc_body`` (one block tree stacked over encoder layers: encoder layer
``i`` is ``enc_body[leaf][i]``, the port's ``enc_blocks.i``) and
``enc_norm``, and its body blocks' ``ln_x`` and ``xattn``. Leaves arrive as
numpy arrays (``jax.device_get`` of the reference's params); nothing here
imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import MeshPlan
from repro_torch.models.transformer import (Block, check_supported, is_cross,
                                            stack_layout)

Path = Tuple[Union[str, int], ...]


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
    for k in ("embed", "unembed", "final_norm") + (
            ("enc_norm",) if cfg.encoder_decoder else ()):
        flat[k] = np.asarray(np_tree[k])
    for li, blk in enumerate(unstack_layers(np_tree, cfg)):
        _flatten(blk, f"blocks.{li}.", flat)
    for li in range(cfg.num_encoder_layers if cfg.encoder_decoder else 0):
        _flatten(_map(lambda a, i=li: np.asarray(a)[i], np_tree["enc_body"]),
                 f"enc_blocks.{li}.", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def jax_leaves(cfg: ModelConfig) -> List[Tuple[Path, List[str]]]:
    """The reference tree's leaves in its flatten order (dict keys sorted,
    list entries by index), each as its key path and the ``state_dict``
    names it holds: one name, or for a ``body`` leaf one per period, in
    period order, and for an ``enc_body`` leaf one per encoder layer (the
    leaf stacks them)."""
    check_supported(cfg)
    lay = stack_layout(cfg)
    n_pro, P = len(lay.prologue), len(lay.period_slots)

    def block(kind, cross: bool = False) -> List[str]:
        """A block's leaf names in the JAX tree's sorted-key order."""
        with torch.device("meta"):
            names = [n for n, _ in Block(cfg, MeshPlan(), kind=kind,
                                         cross=cross).named_parameters()]
        return sorted(names, key=lambda n: tuple(n.split(".")))

    out: List[Tuple[Path, List[str]]] = []
    for j, kind in enumerate(lay.period_slots):
        out += [(("body", j, *leaf.split(".")),
                 [f"blocks.{n_pro + i * P + j}.{leaf}"
                  for i in range(lay.n_periods)])
                for leaf in block(kind, is_cross(cfg, n_pro + j))]
    out.append((("embed",), ["embed"]))
    if cfg.encoder_decoder:
        out += [(("enc_body", *leaf.split(".")),
                 [f"enc_blocks.{i}.{leaf}"
                  for i in range(cfg.num_encoder_layers)])
                for leaf in block(("attn", "dense"))]
        out.append((("enc_norm",), ["enc_norm"]))
    out.append((("final_norm",), ["final_norm"]))
    for i, kind in enumerate(lay.prologue):
        out += [(("prologue", i, *leaf.split(".")), [f"blocks.{i}.{leaf}"])
                for leaf in block(kind)]
    out.append((("unembed",), ["unembed"]))
    return out


def params_to_jax(state: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` -> the
    reference's param tree of numpy arrays (body leaves stacked over
    periods, ``enc_body`` leaves over encoder layers)."""
    lay = stack_layout(cfg)
    tree: Dict[str, Any] = {
        "body": [{} for _ in lay.period_slots],
        "prologue": [{} for _ in lay.prologue]}
    for path, names in jax_leaves(cfg):
        arrs = [state[n].detach().cpu().numpy() for n in names]
        arr = (np.stack(arrs) if path[0] in ("body", "enc_body")
               else arrs[0])
        node: Any = tree
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = arr
    return tree
