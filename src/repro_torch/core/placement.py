"""Placement — which mesh axes / device groups a logical op runs on (paper §3).

OneFlow's ``flow.placement("cuda", {0:[0,1]})`` names nodes and device ids.
Here it is a *named mesh* (axes like ``pod``, ``data``, ``model``): a named
axis tuple + sizes. Planning reads only the sizes, so it needs no devices;
:meth:`Placement.to_mesh` gives the ranks that lowering runs on (a
:class:`repro_torch.core.mesh.DeviceMesh`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Placement:
    """A named logical mesh: ``axis_names[i]`` has ``axis_sizes[i]`` devices."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_kind: str = "cuda"

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("axis_names and axis_sizes must align")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError("duplicate mesh axis names")

    @property
    def ndim(self) -> int:
        return len(self.axis_names)

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.axis_names.index(name)]

    def mesh_shape(self) -> Tuple[int, ...]:
        return self.axis_sizes

    def to_mesh(self, devices=None, timeout=None):
        """A :class:`repro_torch.core.mesh.DeviceMesh` of this placement's
        ranks. ``devices``: None puts every rank on the card; one device
        (``"cpu"``, ``"cuda:0"``) puts every rank there; a sequence gives
        each rank its own, in rank order."""
        from repro_torch.core.mesh import DEFAULT_TIMEOUT, DeviceMesh
        from repro_torch.models.common import resolve_device

        n = self.num_devices
        if devices is None or isinstance(devices, (str, torch.device)):
            devices = [resolve_device(devices)] * n
        elif len(devices) < n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        return DeviceMesh(self, list(devices)[:n],
                          DEFAULT_TIMEOUT if timeout is None else timeout)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
        return f"Placement[{self.device_kind}]({dims})"


def single_pod_placement(data: int = 16, model: int = 16) -> Placement:
    return Placement(("data", "model"), (data, model))


def multi_pod_placement(pod: int = 2, data: int = 16, model: int = 16) -> Placement:
    return Placement(("pod", "data", "model"), (pod, data, model))
