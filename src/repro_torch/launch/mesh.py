# Port of repro/launch/mesh.py (the JAX package): mesh shapes as metadata, and a live torch.distributed DeviceMesh built from one.
"""Mesh definitions.

A :class:`MeshShape` is metadata, the counterpart of a JAX ``Mesh`` as the
sharding functions read it: ``shape`` (axis -> size) and ``axis_names``.
JAX builds its production meshes on 256 / 512 placeholder host devices;
here the shapes are plain objects, so nothing touches a device.
:func:`device_mesh` builds a live ``torch.distributed`` ``DeviceMesh`` of
such a shape over the current process group (one rank per device).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from ..device import DeviceLike, resolve_device


class MeshShape:
    """A mesh's axes and sizes, in order."""

    def __init__(self, sizes: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{sizes} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) = ("data", "model") — 256 chips.
    Multi-pod: (2, 16, 16) = ("pod", "data", "model") — 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_mesh_for_devices(n_devices: int,
                          model_parallel: int = 16) -> MeshShape:
    """Elastic variant: the largest (data, model) mesh that fits
    ``n_devices`` (node-failure / scale-down path)."""
    model = min(model_parallel, n_devices)
    data = n_devices // model
    return MeshShape((data, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    """Mesh axes over which the batch dimension is sharded."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def device_mesh(mesh: MeshShape, device: DeviceLike = None):
    """A live ``DeviceMesh`` of ``mesh``'s shape on ``device``'s type
    (``None``: CUDA; raises without a card) over the default process
    group, one rank per device: its world size must be ``mesh.size``
    (``core.sharded.fleet_group``, which makes a process outside any group
    the one rank of a new one)."""
    from torch.distributed.device_mesh import init_device_mesh
    from ..core.sharded import fleet_group
    dev = resolve_device(device)
    fleet_group(mesh.size, dev)
    return init_device_mesh(dev.type, tuple(mesh.shape.values()),
                            mesh_dim_names=mesh.axis_names)


__all__ = ["MeshShape", "make_production_mesh", "make_mesh_for_devices",
           "batch_axes", "device_mesh"]
