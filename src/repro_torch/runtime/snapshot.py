"""Snapshot actors: async checkpointing as a register-stream consumer (port
of ``repro/runtime/snapshot.py``, with its on-disk format, so each package
restores the other's snapshots).

Optimizer state is just *another register stream* (``state{s}`` ->
``opt{s}``). Checkpointing rides the same pattern one hop further: a
``snap{s}`` actor per parameterized stage subscribes to ``opt{s}``'s output
stream -- the register that already carries the post-update params *and*
the fresh optimizer state -- and serializes it from its **own** mailbox
thread (``thread=1`` on the stage's node). It copies the stage's tensors to
the host and writes them before its fire returns, so the epoch (the step)
ends only after the files are on disk: the next step's in-place updates
never race the write.

On-disk layout (all under the session's ``snapshot_dir``)::

    <dir>/step-00000003/stage0/           per-stage arrays + manifest.json
                        stage1/              (repro_torch.train.checkpoint
                        ...                   format: params.<name>.npy,
                                              opt.mu.<name>.npy, opt.step.npy)
                        MANIFEST.json     written LAST, by the executor, only
                                          after every stage's write receipt
                                          arrived: its presence marks the
                                          snapshot complete (a kill
                                          mid-write leaves stage dirs without
                                          a MANIFEST, which restore ignores)

``step-N`` holds the state *after* N optimizer steps together with the
schedule state (the step counter the lr schedule is indexed by), so a
session restored from it replays step N+1 bit-identically. Under ZeRO a
stage writes each param's float32 master and moments in the flat ``(dp, 1,
chunk)`` layout of the global tensor, with ``meta.zero``, ``zero_dp`` and
``zero_shapes``; :func:`load_snapshot` gathers them back to full tensors.

:func:`load_snapshot` merges the per-stage trees back into the flat
``params`` / merged ``AdamWState`` form that ``Session.load_state`` takes --
partition-agnostic, so a snapshot taken on a 4-stage pipeline restores onto
a 2-stage (or monolithic) session, on a mesh or on none.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MANIFEST_NAME = "MANIFEST.json"
_STEP_DIR_RE = re.compile(r"^step-(\d+)$")


@dataclasses.dataclass(frozen=True)
class SnapshotSpec:
    """The snapshot config the train spec builder carries (the per-epoch
    step/write decision travels through ``ctx``)."""

    dir: str


def step_dir(root: str, step: int) -> pathlib.Path:
    return pathlib.Path(root) / f"step-{step:08d}"


def stage_dir(root: str, step: int, stage: int) -> pathlib.Path:
    return step_dir(root, step) / f"stage{stage}"


def _sanitize(name: str) -> str:
    # mirror repro_torch.train.checkpoint._key_str's sanitization
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", name)


def write_stage_snapshot(root: str, step: int, stage: int,
                         params: Dict[str, Any], opt_state=None,
                         zero: Optional[Dict[str, Any]] = None) -> None:
    """One stage's slice of a snapshot, in the
    :mod:`repro_torch.train.checkpoint` directory format. Runs inside the
    ``snap{s}`` actor, off the schedule's thread.

    ``params`` and ``opt_state`` hold global tensors (or arrays). With
    ``zero`` set (``{"dp": int, "shapes": {name: [dims]}}``), they are the
    flat ``(dp, 1, chunk)`` float32 masters and moments, persisted as they
    are; the metadata lets :func:`_load_stage` gather them back to full
    tensors on the host, so restore stays partition- and ZeRO-agnostic."""
    from repro_torch.train.checkpoint import save_checkpoint

    tree: Dict[str, Any] = {"params": dict(params)}
    if opt_state is not None:
        tree["opt"] = {"step": opt_state.step, "mu": dict(opt_state.mu),
                       "nu": dict(opt_state.nu)}
    meta: Dict[str, Any] = {"stage": stage,
                            "param_names": list(params),
                            "stateful": opt_state is not None}
    if zero is not None:
        meta["zero"] = True
        meta["zero_dp"] = int(zero["dp"])
        meta["zero_shapes"] = {n: [int(d) for d in s]
                               for n, s in zero["shapes"].items()}
    save_checkpoint(str(stage_dir(root, step, stage)), tree, step=step,
                    meta=meta)


def write_manifest(root: str, step: int, stages: List[int],
                   meta: Optional[Dict[str, Any]] = None) -> None:
    """Finalize a snapshot: written by the executor only after every stage's
    receipt, and renamed into place so a complete MANIFEST either exists or
    does not."""
    d = step_dir(root, step)
    d.mkdir(parents=True, exist_ok=True)
    body = json.dumps({"version": 1, "step": int(step),
                       "stages": sorted(int(s) for s in stages),
                       "meta": meta or {}}, indent=2)
    tmp = d / (MANIFEST_NAME + ".tmp")
    tmp.write_text(body)
    os.replace(tmp, d / MANIFEST_NAME)


def list_snapshots(root: str) -> List[int]:
    """Completed (manifest-bearing) snapshot steps under ``root``, sorted."""
    d = pathlib.Path(root)
    if not d.is_dir():
        return []
    steps = []
    for child in d.iterdir():
        m = _STEP_DIR_RE.match(child.name)
        if m and (child / MANIFEST_NAME).is_file():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_snapshot(root: str) -> Optional[int]:
    """The newest completed snapshot step, or None (e.g. killed before the
    first snapshot landed: the caller restarts from scratch)."""
    steps = list_snapshots(root)
    return steps[-1] if steps else None


def _load_stage(d: pathlib.Path):
    """Load one stage dir -> ``(params, mu, nu, opt_step or None)`` as
    numpy arrays.

    ZeRO stage dirs (``meta["zero"]``) hold flat ``(dp, 1, chunk)`` rows;
    they are gathered back to full tensors here, on the host, by
    reshape-then-truncate -- a pure layout operation, so the round trip is
    bitwise. The caller never sees flat rows."""
    manifest = json.loads((d / "manifest.json").read_text())
    meta = manifest.get("meta") or {}
    names = meta.get("param_names", [])
    stateful = bool(meta.get("stateful"))
    leaves = manifest["leaves"]
    zero_shapes = meta.get("zero_shapes") if meta.get("zero") else None

    def load(key, shape=None):
        if key not in leaves:
            raise KeyError(f"stage snapshot {d} missing leaf {key!r}")
        arr = np.load(d / leaves[key]["file"])
        if shape is not None:
            n = int(np.prod(shape)) if shape else 1
            arr = arr.reshape(-1)[:n].reshape(shape)
        return arr

    def shape_of(n):
        if zero_shapes is None:
            return None
        return tuple(int(x) for x in zero_shapes[n])

    params = {n: load(f"params.{_sanitize(n)}", shape_of(n)) for n in names}
    if not stateful:
        return params, {}, {}, None
    mu = {n: load(f"opt.mu.{_sanitize(n)}", shape_of(n)) for n in names}
    nu = {n: load(f"opt.nu.{_sanitize(n)}", shape_of(n)) for n in names}
    return params, mu, nu, load("opt.step")


def load_snapshot(root: str, step: Optional[int] = None
                  ) -> Tuple[Dict[str, Any], Any, int, Dict[str, Any]]:
    """Load a completed snapshot -> ``(params, opt_state, step, meta)``.

    ``params`` is the flat name -> numpy array dict and ``opt_state`` the
    merged :class:`repro_torch.optim.adamw.AdamWState` over numpy arrays
    (None for a stateless optimizer) -- what ``Session.load_state`` takes,
    independent of the stage partition the snapshot was written under.
    ``step=None`` loads the latest snapshot; a missing or incomplete
    snapshot raises ``FileNotFoundError``."""
    if step is None:
        step = latest_snapshot(root)
        if step is None:
            raise FileNotFoundError(
                f"no completed snapshot (step-*/{MANIFEST_NAME}) under "
                f"{root!r}")
    d = step_dir(root, step)
    mpath = d / MANIFEST_NAME
    if not mpath.is_file():
        raise FileNotFoundError(f"snapshot {d} has no {MANIFEST_NAME} "
                                "(incomplete write?)")
    manifest = json.loads(mpath.read_text())
    params: Dict[str, Any] = {}
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    opt_steps = []
    for s in manifest["stages"]:
        p, m, v, ostep = _load_stage(d / f"stage{s}")
        params.update(p)
        mu.update(m)
        nu.update(v)
        if ostep is not None:
            opt_steps.append(ostep)
    opt_state = None
    if opt_steps:
        from repro_torch.optim.adamw import AdamWState
        first = opt_steps[0]
        if any(o != first for o in opt_steps[1:]):
            raise ValueError(
                f"snapshot {d} has inconsistent per-stage optimizer steps: "
                f"{opt_steps}")
        opt_state = AdamWState(first, mu, nu)
    return params, opt_state, int(manifest["step"]), manifest.get("meta", {})
