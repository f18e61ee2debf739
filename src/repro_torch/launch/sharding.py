# Port of repro/launch/sharding.py (the JAX package): the same logical-axis rules; specs are tuples of mesh axes per dim, turned into DTensor placements on a live mesh.
"""Logical-axis -> mesh-axis sharding rules.

Baseline layout (the JAX package's):
  * tensor-parallel axes (heads / mlp / experts / vocab / ssm channel) on
    ``model``,
  * ``embed`` on (pod, data) — ZeRO-3/FSDP-style parameter sharding,
  * batch on (pod, data).

A spec is what JAX's ``PartitionSpec`` holds: a tuple with one entry per
tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of names
(sharded jointly, major first); ``()`` replicates everything.
``logical_to_pspec`` drops an axis the mesh lacks, uses each mesh axis
once and replicates a dimension the axis size does not divide (e.g.
whisper's vocab=51865) — recorded per parameter by ``explain_sharding``.
The mesh is anything with ``shape`` (axis -> size) and ``axis_names``:
``mesh.MeshShape``, or a JAX ``Mesh``.  :func:`placements` turns a spec
into ``torch.distributed`` DTensor placements on a live ``DeviceMesh``;
:func:`shard_shape` is a spec's local shard shape (JAX's
``NamedSharding(mesh, spec).shard_shape``) and :func:`distribute` /
:func:`distribute_tree` commit tensors to a ``DeviceMesh`` under their
specs (a ``meta`` tensor as a DTensor over a ``meta`` local shard of that
shape, which allocates nothing: the dry-run's production meshes).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

# logical axis -> mesh axes (tuple = joint sharding over both)
DEFAULT_RULES: Dict[str, Any] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "experts_vec": "model",
    "q_lora": "model",
    "kv_lora": "model",
    "ssm_in": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "heads_vec": "model",
    "embed": ("pod", "data"),      # FSDP; 'pod' dropped on single-pod mesh
    "layers": None,
    # activation/cache logical axes
    "batch": ("pod", "data"),
    "kv_heads_cache": "model",
    "seq_model": "model",      # sequence-sharded KV cache (GQA kv < TP)
    "embed_vec": None,
    None: None,
}

# The JAX hillclimb's layout variants, as rule tables (``hillclimb``
# counts them on the production meshes).
NO_FSDP_RULES = dict(DEFAULT_RULES, embed=None)
FSDP_DATA_ONLY = dict(DEFAULT_RULES, embed="data")
# pure FSDP/DP: no tensor parallelism; params sharded over every device,
# batch over every mesh axis.
PURE_DP_RULES = {k: None for k in DEFAULT_RULES}
PURE_DP_RULES.update(embed=("pod", "data", "model"),
                     batch=("pod", "data", "model"))

Spec = Tuple[Any, ...]


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _resolve(mesh, axes):
    """Drop mesh axes absent from this mesh (e.g. 'pod' on single pod)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    present = tuple(a for a in axes if a in mesh.axis_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def logical_to_pspec(logical_axes: Tuple[Optional[str], ...],
                     shape: Tuple[int, ...], mesh,
                     rules: Optional[Dict[str, Any]] = None) -> Spec:
    rules = rules or DEFAULT_RULES
    parts = []
    used = set()
    for dim, name in zip(shape, logical_axes):
        mesh_axes = _resolve(mesh, rules.get(name))
        if mesh_axes is None:
            parts.append(None)
            continue
        flat = (mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes
        if any(a in used for a in flat):
            parts.append(None)          # a mesh axis may appear only once
            continue
        if dim % _axis_size(mesh, mesh_axes) != 0:
            parts.append(None)          # non-divisible -> replicate
            continue
        used.update(flat)
        parts.append(mesh_axes)
    return tuple(parts)


def _tree_map2(fn, axes, shaped):
    if isinstance(axes, tuple):
        return fn(axes, shaped)
    return {k: _tree_map2(fn, axes[k], shaped[k]) for k in axes}


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh,
                   rules: Optional[Dict[str, Any]] = None):
    """Map trees of logical axes + shaped leaves (``.shape``) to specs."""
    return _tree_map2(lambda axes, shaped: logical_to_pspec(
        tuple(axes), tuple(shaped.shape), mesh, rules), axes_tree,
        shape_tree)


def batch_pspec(mesh, ndim: int, batch_dim: int = 0, axes=None) -> Spec:
    axes = tuple(a for a in (axes or ("pod", "data"))
                 if a in mesh.axis_names)
    parts = [None] * ndim
    parts[batch_dim] = axes if len(axes) > 1 else (axes[0] if axes else None)
    return tuple(parts)


def batch_sharding(mesh, shaped, batch_dim: int = 0,
                   shardable: bool = True, axes=None) -> Spec:
    """Spec of an input array; replicated (``()``) when the batch dim is
    smaller than the dp extent (e.g. long_500k's batch=1)."""
    ndim = len(shaped.shape)
    if not shardable or ndim == 0:
        return ()
    ax = tuple(a for a in (axes or ("pod", "data"))
               if a in mesh.axis_names)
    dp = 1
    for a in ax:
        dp *= mesh.shape[a]
    if shaped.shape[batch_dim] % dp != 0:
        return ()
    return batch_pspec(mesh, ndim, batch_dim, ax)


def explain_sharding(axes_tree: Any, shape_tree: Any, mesh,
                     rules: Optional[Dict[str, Any]] = None):
    """(path, logical axes, shape, spec) rows, one per leaf."""
    rows = []

    def walk(prefix, axes, shaped):
        if isinstance(axes, tuple):
            spec = logical_to_pspec(axes, tuple(shaped.shape), mesh, rules)
            rows.append((prefix, axes, tuple(shaped.shape), spec))
            return
        for k in axes:
            walk(f"{prefix}/{k}", axes[k], shaped[k])

    walk("", axes_tree, shape_tree)
    return rows


def placements(spec: Spec, axis_names: Tuple[str, ...]):
    """DTensor placements of ``spec`` on a mesh of ``axis_names``: per mesh
    axis ``Shard(d)`` where tensor dim d is sharded over it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(axis_names)
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            out[axis_names.index(a)] = Shard(d)
    return out


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis -> size of a ``MeshShape``, a JAX ``Mesh`` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a torch DeviceMesh
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return dict(mesh.shape)


def _split(part) -> Tuple[str, ...]:
    return (part,) if isinstance(part, str) else tuple(part or ())


def shard_shape(spec: Spec, shape: Tuple[int, ...], mesh) -> Tuple[int, ...]:
    """The local shard shape of a ``shape`` tensor under ``spec``: each
    dim divided by the sizes of the mesh axes sharding it (which divide
    it, as ``logical_to_pspec`` and ``batch_sharding`` make them)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, part in enumerate(spec):
        for a in _split(part):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)}: {sizes[a]} "
                                 f"({a}) does not divide {out[d]}")
            out[d] //= sizes[a]
    return tuple(out)


def distribute(t, spec: Spec, device_mesh):
    """``t`` as a DTensor on ``device_mesh`` under ``spec``.  A ``meta``
    tensor becomes a DTensor over a ``meta`` local shard of
    :func:`shard_shape` (nothing is allocated, nothing communicated);
    any other is cut locally on every rank (``src_data_rank=None``: each
    rank holds the same ``t``), no collective; its local shard may share
    ``t``'s storage."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    import torch
    pl = placements(spec, device_mesh.mesh_dim_names)
    if t.device.type == "meta":
        local = torch.empty(shard_shape(spec, tuple(t.shape), device_mesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, device_mesh, pl, src_data_rank=None)


def distribute_tree(tree: Any, specs: Any, device_mesh):
    """:func:`distribute` of every leaf of ``tree`` (nested dicts) under
    the spec of the same path in ``specs``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], specs[k], device_mesh)
                for k in tree}
    return distribute(tree, specs, device_mesh)


__all__ = ["DEFAULT_RULES", "NO_FSDP_RULES", "FSDP_DATA_ONLY",
           "PURE_DP_RULES", "logical_to_pspec", "tree_shardings",
           "batch_pspec", "batch_sharding", "explain_sharding",
           "placements", "mesh_sizes", "shard_shape", "distribute",
           "distribute_tree"]
