"""The kernels' launch counters, carried between processes.

Each kernel module counts its own launches in module-level attributes whose
names end in ``launches`` (an int, or a dict by kernel or by offset). Under
``runtime="processes"`` the kernels launch in the worker processes, so each
worker :func:`take`\\ s its counts with every epoch's stats and the driver
:func:`add`\\ s them into its own modules: a caller that zeroes the driver's
counters, runs a session and reads them back sees every worker's launches,
as it would see the threads runtime's.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

#: the kernel packages under ``repro_torch.kernels`` that count launches
MODULES = ("flash_attention", "flash_decode", "softmax_xent", "ssd_scan")


def _module(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}.kernel")


def _counters(mod) -> Dict[str, Any]:
    return {attr: v for attr, v in vars(mod).items()
            if attr.endswith("launches") and isinstance(v, (int, dict))}


def snapshot() -> Dict[str, Dict[str, Any]]:
    """This process's counts as they stand, zeroing nothing: ``{module:
    {counter: int or {key: int}}}`` (copies)."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in MODULES:
        mod = _module(name)
        with mod._count_lock:
            out[name] = {attr: dict(v) if isinstance(v, dict) else v
                         for attr, v in _counters(mod).items()}
    return out


def take() -> Dict[str, Dict[str, Any]]:
    """This process's counts since the last :func:`take`, and zero them:
    ``{module: {counter: int or {key: int}}}`` with only nonzero entries."""
    out: Dict[str, Dict[str, Any]] = {}
    for name in MODULES:
        mod = _module(name)
        got: Dict[str, Any] = {}
        with mod._count_lock:
            for attr, v in _counters(mod).items():
                if isinstance(v, dict):
                    nonzero = {k: n for k, n in v.items() if n}
                    if nonzero:
                        got[attr] = nonzero
                    for k in v:
                        v[k] = 0
                else:
                    if v:
                        got[attr] = v
                    setattr(mod, attr, 0)
        if got:
            out[name] = got
    return out


def add(counts: Dict[str, Dict[str, Any]]) -> None:
    """Add counts another process took (:func:`take`) into this process's
    counters."""
    for name, got in counts.items():
        mod = _module(name)
        with mod._count_lock:
            for attr, v in got.items():
                if isinstance(v, dict):
                    d = getattr(mod, attr)
                    for k, n in v.items():
                        d[k] = d.get(k, 0) + n
                else:
                    setattr(mod, attr, getattr(mod, attr) + v)
