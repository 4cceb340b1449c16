"""Checkpointing: a tree of tensors -> a directory of .npy leaves + manifest.

Port of ``repro/train/checkpoint.py`` with the same layout and leaf keys, so
each package restores the other's checkpoints:

    <dir>/manifest.json     {"leaves": {key: {"file", "shape", "dtype"}},
                             "step": int, "meta": {...}}
    <dir>/<key>.npy         one file per leaf

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), lists/tuples and NamedTuples of tensors or arrays; a leaf's
key is its path joined by ``.`` (dict key, list index or field name), as
the reference's ``_key_str``. Model params travel as the reference's tree
(:func:`repro_torch.models.convert.params_to_jax` and ``params_from_jax``).
"""
from __future__ import annotations

import json
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _key_str(path) -> str:
    key = ".".join(str(p) for p in path)
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", key)


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):     # NamedTuple
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced, in flatten order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, tree: Any, step: int = 0,
                    meta: Optional[Dict] = None) -> None:
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    leaves = {}
    for path, leaf in _flatten(tree):
        key = _key_str(path)
        arr = _numpy(leaf)
        fn = f"{key}.npy"
        np.save(d / fn, arr)
        leaves[key] = {"file": fn, "shape": list(arr.shape),
                       "dtype": str(arr.dtype)}
    (d / "manifest.json").write_text(json.dumps(
        {"leaves": leaves, "step": step, "meta": meta or {}}, indent=2))


def load_checkpoint(ckpt_dir: str, like: Any, device=None):
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays: only the structure and shapes are read), as CPU tensors or on
    ``device``. Returns ``(tree, step)``."""
    d = pathlib.Path(ckpt_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for path, leaf in _flatten(like):
        key = _key_str(path)
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / manifest["leaves"][key]["file"])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(device))
    return _unflatten(like, iter(out)), manifest["step"]
