# Port of repro/launch/mesh.py (the JAX package): mesh shapes as metadata, a live torch.distributed DeviceMesh built from one, and the production meshes' placeholder ranks in one process.
"""Mesh definitions.

A :class:`MeshShape` is metadata, the counterpart of a JAX ``Mesh`` as the
sharding functions read it: ``shape`` (axis -> size) and ``axis_names``.
JAX builds its production meshes on 256 / 512 placeholder host devices;
here the shapes are plain objects, so nothing touches a device.
:func:`device_mesh` builds a live ``torch.distributed`` ``DeviceMesh`` of
such a shape over the current process group (one rank per device), and
:func:`fake_device_mesh` builds one over ``torch.distributed``'s ``"fake"``
backend: ``mesh.size`` placeholder ranks in this one process (it is rank
0), whose collectives communicate nothing.  With ``meta`` local shards
(``sharding.distribute``) nothing is allocated either: the counterpart of
JAX's placeholder devices, for ``launch.dryrun``'s count.
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


def mesh_shape_of(device_mesh) -> MeshShape:
    """The ``MeshShape`` of a live ``DeviceMesh`` (its axes and sizes)."""
    return MeshShape(tuple(device_mesh.shape), device_mesh.mesh_dim_names)


def fake_device_mesh(mesh: MeshShape):
    """A ``DeviceMesh`` of ``mesh``'s shape over a ``"fake"`` process group
    of ``mesh.size`` ranks in this process (rank 0), on the ``cpu`` device
    type; its local shards are meant to be ``meta`` tensors.  A fake group
    of another size is replaced; any other default group raises: one
    process holds one default group, so the count runs in a process of its
    own (the dry-run's CLI, or a subprocess), never in one that already
    holds a real group.  Raises where this PyTorch lacks the fake backend
    (``torch.testing._internal.distributed.fake_pg``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this PyTorch has no fake process group (torch."
                           "testing._internal.distributed.fake_pg); the "
                           "production-mesh dry-run needs it") from e
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"this process already holds a {dist.get_backend()!r} "
                "process group; count a production mesh in a process of "
                "its own")
        if dist.get_world_size() != mesh.size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=mesh.size)
    return init_device_mesh("cpu", tuple(mesh.shape.values()),
                            mesh_dim_names=mesh.axis_names)


__all__ = ["MeshShape", "make_production_mesh", "make_mesh_for_devices",
           "batch_axes", "device_mesh", "mesh_shape_of", "fake_device_mesh"]
