# Port of repro/launch/elastic.py (the JAX package): rescale planning as metadata; the re-layout as DTensors on a live torch.distributed mesh.
"""Elastic rescaling: re-shard a checkpoint onto a different mesh.

Node-failure path at scale: when a node drops out, the job restarts with
fewer devices; parameters are pure data, so rescaling is a re-layout —
load the host-side checkpoint and commit it to the new mesh's layout.
The reverse (scale-up) is identical.  GRMU's consolidation doubles as the
*scheduler-side* half of this story: it drains work off a failing row
before the restart (see core/podsched.py).

``plan_rescale`` and ``validate_divisibility`` are metadata (a
``mesh.MeshShape`` and specs; nothing is allocated); ``apply_rescale``
commits tensors as DTensors on a live ``DeviceMesh``
(``mesh.device_mesh``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..models.config import ModelConfig
from ..models.transformer import param_axes
from . import sharding as SH
from .mesh import MeshShape, make_mesh_for_devices


def plan_rescale(cfg: ModelConfig, param_shapes: Any, n_devices: int,
                 model_parallel: int = 16) -> Tuple[MeshShape, Any]:
    """Returns (mesh shape, specs) for the params on a resized device
    set."""
    mesh = make_mesh_for_devices(n_devices, model_parallel)
    axes = param_axes(cfg)
    shardings = SH.tree_shardings(axes, param_shapes, mesh)
    return mesh, shardings


def apply_rescale(tree: Any, shardings: Any, mesh) -> Any:
    """Commit each tensor of ``tree`` to its spec in ``shardings`` as a
    DTensor on the live ``DeviceMesh`` ``mesh`` (``distribute_tensor``,
    rank 0's values; a tensor off the mesh's device type is moved)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: apply_rescale(tree[k], shardings[k], mesh) for k in tree}
    return distribute_tensor(tree, mesh, SH.placements(
        shardings, mesh.mesh_dim_names))


def validate_divisibility(cfg: ModelConfig, n_devices: int,
                          model_parallel: int = 16) -> Dict[str, bool]:
    """Quick feasibility check before committing to a rescale."""
    mesh = make_mesh_for_devices(n_devices, model_parallel)
    out = {
        "d_model_by_dp": cfg.d_model % max(1, mesh.shape.get("data", 1)) == 0,
        "heads_by_tp": (cfg.n_heads * cfg.resolved_head_dim) %
        mesh.shape.get("model", 1) == 0,
        "dff_by_tp": cfg.d_ff % mesh.shape.get("model", 1) == 0,
    }
    return out


__all__ = ["plan_rescale", "apply_rescale", "validate_divisibility"]
