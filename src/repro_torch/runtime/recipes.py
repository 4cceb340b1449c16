"""Picklable lowering recipes -- how a worker process rebuilds its stages.

``runtime="processes"`` ships each executor's spec builder to one worker
per node id (:mod:`repro_torch.runtime.process`). A lowered program cannot
make that trip: its stage functions are closures, and a
:class:`~repro_torch.core.mesh.DeviceMesh` holds locks and rendezvous
state. What can travel is the recipe the driver lowered from -- the logical
graph, the SBP plan, the stage partition, the optimizer and a description
of each mesh, or for serving the model itself -- so each worker re-runs the
same deterministic lowering. The model's tensors ride as tensors: by CUDA
IPC on a card (each worker maps the driver's weights; serving never
updates them), by shared memory on the CPU.

:class:`MeshSpec` is the wire form of a mesh. Every recipe carries the
session's ``device``, which the worker takes before it lowers anything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A :class:`~repro_torch.core.mesh.DeviceMesh` as data: axis names,
    shape, one device string per rank, the placement's device kind and the
    collectives' timeout."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[str, ...]
    timeout: float
    device_kind: str = "cuda"

    @classmethod
    def capture(cls, mesh) -> Optional["MeshSpec"]:
        if mesh is None:
            return None
        return cls(tuple(mesh.axis_names), tuple(mesh.shape),
                   tuple(str(d) for d in mesh.devices), float(mesh.timeout),
                   mesh.placement.device_kind)

    def to_mesh(self):
        from repro_torch.core.mesh import DeviceMesh
        from repro_torch.core.placement import Placement

        placement = Placement(self.axis_names, self.shape, self.device_kind)
        return DeviceMesh(placement, list(self.devices), self.timeout)


def _meshes(mesh: Optional[MeshSpec],
            stage_meshes: Optional[Tuple[MeshSpec, ...]]):
    """The driver's mesh choice rebuilt: one mesh shared by every stage, or
    one per stage."""
    return (None if mesh is None else mesh.to_mesh(),
            None if stage_meshes is None
            else [m.to_mesh() for m in stage_meshes])


def _device(device, mesh, stage_meshes):
    """The lowering's ``device``: a mesh brings its ranks' own."""
    return device if mesh is None and stage_meshes is None else None


@dataclasses.dataclass
class InferRecipe:
    """Everything :func:`repro_torch.core.lowering.lower_stages` needs."""

    graph: Any
    plan: Any
    partition: Any
    mesh: Optional[MeshSpec] = None
    stage_meshes: Optional[Tuple[MeshSpec, ...]] = None
    device: Optional[str] = None

    def lower(self):
        from repro_torch.core.lowering import lower_stages

        mesh, stage_meshes = _meshes(self.mesh, self.stage_meshes)
        return lower_stages(self.graph, self.plan, self.partition, mesh=mesh,
                            stage_meshes=stage_meshes,
                            device=_device(self.device, mesh, stage_meshes))


@dataclasses.dataclass
class TrainRecipe:
    """Everything :func:`repro_torch.core.lowering.lower_train_stages`
    needs. ``loss`` is a tensor name; the optimizer's ``lr`` must be a
    float or a module-level function to survive pickling."""

    graph: Any
    plan: Any
    partition: Any
    param_names: List[str]
    loss: Any = None
    mesh: Optional[MeshSpec] = None
    stage_meshes: Optional[Tuple[MeshSpec, ...]] = None
    optimizer: Any = None
    device: Optional[str] = None

    def lower(self):
        from repro_torch.core.lowering import lower_train_stages

        mesh, stage_meshes = _meshes(self.mesh, self.stage_meshes)
        return lower_train_stages(
            self.graph, self.plan, self.partition, list(self.param_names),
            loss=self.loss, mesh=mesh, stage_meshes=stage_meshes,
            device=_device(self.device, mesh, stage_meshes),
            optimizer=self.optimizer)


@dataclasses.dataclass
class ServeRecipe:
    """Everything :func:`repro_torch.core.lowering.lower_serve_stages`
    needs: the config, the model (a
    :class:`~repro_torch.models.transformer.Transformer`, whose tensors
    each worker maps rather than copies) and the slot geometry."""

    cfg: Any
    model: Any
    num_stages: int
    cache_len: int
    max_prompt_len: int
    group_size: int
    mesh: Optional[MeshSpec] = None
    device: Optional[str] = None

    def lower(self):
        from repro_torch.core.lowering import lower_serve_stages

        return lower_serve_stages(
            self.cfg, self.model, num_stages=self.num_stages,
            cache_len=self.cache_len, max_prompt_len=self.max_prompt_len,
            group_size=self.group_size,
            mesh=None if self.mesh is None else self.mesh.to_mesh())
