# Port of repro/models/registry.py (the JAX package): serving step builders, input specs, cells and parameter counts.
"""Registry: (architecture x input shape) -> step function + input specs.

  * ``train_4k``     — ``train_step`` (forward + backward + AdamW,
    ``train.step.make_train_step``),
  * ``prefill_32k``  — ``prefill``   (full-context forward, last logits;
    encdec: ``encode`` over the frames, the last encoder state's logits),
  * ``decode_32k`` / ``long_500k`` — ``decode_step`` (one new token against
    a seq_len cache).

``input_specs`` and ``abstract_train_state`` return tensors on the
``meta`` device, which carry shape and dtype and allocate nothing (a
``decode_32k`` cache is hundreds of GB), as the JAX package's
``ShapeDtypeStruct``s do.
``cell_supported`` encodes the applicability matrix (long_500k only for
sub-quadratic archs).

On a ``DeviceMesh`` (``make_step(..., mesh=)``) the step runs on
DTensors: :func:`shard_model` / :func:`shard_opt_state` commit the
parameters and AdamW's moments under the rules (``launch.sharding.
tree_shardings`` of ``param_axes``), the step commits its batch
(:func:`shard_batch`, JAX's ``_batch_shardings``) and the decode cache
(:func:`shard_cache`, JAX's ``_cache_shardings``), and sets the
activation axes that JAX's ``lower_cell`` sets (:func:`cell_axes`) while
it runs; operands that are plain tensors (positions, masks, the
step count's scalars) are taken as replicated (``implicit_replication``).

Parameter counts and ``model_flops`` are the JAX package's formulas over
the port's specs.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..device import DeviceLike, is_dtensor, resolve_device
from ..launch import sharding as SH
from ..launch.mesh import mesh_shape_of
from ..serve import llm_decode as serve_engine
from ..train.optimizer import AdamWConfig, OptState, tree_leaves, tree_map
from ..train.step import make_train_step
from .config import SHAPES, ModelConfig, ShapeConfig
from . import flags
from . import transformer as M
from .params import is_leaf, param_count
from .transformer import check_family, stacked_model_spec

META = torch.device("meta")


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: O(S^2) prefill/cache at "
                       "524288 ctx — skipped per brief (see DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no allocation)
# ---------------------------------------------------------------------------

def train_input_specs(cfg: ModelConfig,
                      shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    specs = {"tokens": torch.empty((B, S), **i32),
             "labels": torch.empty((B, S), **i32)}
    if cfg.family == "encdec":                          # stub frontend
        specs = {"frames": torch.empty((B, S, cfg.d_model),
                                       dtype=torch.bfloat16, device=META),
                 **specs}
    if cfg.family == "vlm":                             # stub frontend
        specs["mrope_positions"] = torch.empty((3, B, S), **i32)
    return specs


def prefill_input_specs(cfg: ModelConfig,
                        shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":                          # stub frontend
        return {"frames": torch.empty((B, S, cfg.d_model),
                                      dtype=torch.bfloat16, device=META)}
    return {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}


def decode_input_specs(cfg: ModelConfig,
                       shape: ShapeConfig) -> Dict[str, object]:
    B, S = shape.global_batch, shape.seq_len
    return {
        "cache": serve_engine.init_cache(cfg, B, S, device=META),
        "tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
        "pos": torch.empty((B,), dtype=torch.int32, device=META),
    }


def input_specs(arch_or_cfg, shape_name: str, *, smoke: bool = False):
    if isinstance(arch_or_cfg, str):
        cfg = (get_smoke_config(arch_or_cfg) if smoke
               else get_config(arch_or_cfg))
    else:
        cfg = arch_or_cfg
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def cell_axes(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              batch_axes=None, head_axes="model") -> Dict[str, object]:
    """The activation axes JAX's ``lower_cell`` sets for this cell on
    ``mesh`` (a ``MeshShape`` or ``DeviceMesh``), as
    ``flags.activation_axes`` keywords: the batch on ``batch_axes``
    (default: pod and data) where their extent divides the global batch,
    heads on ``head_axes``, kv heads on ``model`` where the model axis
    divides them, else (and always for MLA's latent) the decode cache's
    sequence on ``model``."""
    sizes = SH.mesh_sizes(mesh)
    dp_axes = tuple(a for a in (batch_axes if batch_axes is not None
                                else ("pod", "data")) if a in sizes)
    dp = 1
    for a in dp_axes:
        dp *= sizes[a]
    heads_ok = (head_axes is not None
                and cfg.n_kv_heads % sizes.get("model", 1) == 0)
    return {"batch": dp_axes if shape.global_batch % dp == 0 else None,
            "heads": head_axes,
            "kv_heads": "model" if heads_ok else None,
            "kv_seq": ("model" if (cfg.family == "mla_moe" or not heads_ok)
                       else None)}


def shard_model(model: M.Transformer, cfg: ModelConfig, device_mesh,
                rules=None) -> M.Transformer:
    """A ``Transformer`` over ``model``'s stacked parameters committed to
    ``device_mesh`` under ``rules`` (default: ``DEFAULT_RULES``), each
    parameter a DTensor (a layer's a view of its stacked DTensor)."""
    tree = M.stacked_params(model)
    specs = SH.tree_shardings(M.param_axes(cfg), tree,
                              mesh_shape_of(device_mesh), rules)
    dtree = SH.distribute_tree(tree, specs, device_mesh)
    dtype = next(iter(tree_leaves(tree))).dtype
    return M.load_stacked(M.Transformer(cfg, device="meta", dtype=dtype),
                          dtree)


def shard_opt_state(opt: OptState, cfg: ModelConfig, device_mesh,
                    rules=None) -> OptState:
    """AdamW's state on ``device_mesh``: the moments under the parameters'
    specs, the step count replicated (JAX's ``opt_shard``)."""
    ms = mesh_shape_of(device_mesh)
    axes = M.param_axes(cfg)

    def moments(tree):
        return SH.distribute_tree(tree, SH.tree_shardings(axes, tree, ms,
                                                          rules),
                                  device_mesh)
    return OptState(step=SH.distribute(opt.step, (), device_mesh),
                    m=moments(opt.m), v=moments(opt.v))


def shard_batch(batch: Dict[str, torch.Tensor], device_mesh,
                axes=None) -> Dict[str, torch.Tensor]:
    """``batch`` on ``device_mesh``: each entry's batch dim over ``axes``
    (default: pod and data) where their extent divides it, else
    replicated; ``mrope_positions`` (3, B, S) on its dim 1 (JAX's
    ``_batch_shardings``)."""
    ms = mesh_shape_of(device_mesh)

    def one(name, t):
        if name == "mrope_positions":
            spec = SH.batch_pspec(ms, t.dim(), 1, axes)
        else:
            spec = SH.batch_sharding(ms, t, axes=axes)
        return SH.distribute(t, spec, device_mesh)
    return {k: one(k, v) for k, v in batch.items()}


def shard_cache(cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                device_mesh) -> Dict[str, torch.Tensor]:
    """The decode cache on ``device_mesh`` under ``llm_decode.cache_axes``
    and the default rules (JAX's ``_cache_shardings``): kv heads on
    ``model`` where it divides them, else the sequence."""
    ms = mesh_shape_of(device_mesh)
    axes = serve_engine.cache_axes(cfg, model_size=ms.shape.get("model", 1))
    # A copy: ``init_cache`` makes inference tensors, which a step on a
    # mesh (under no_grad) cannot write in place.
    return {k: SH.distribute(v if v.device.type == "meta" else v.clone(),
                             SH.logical_to_pspec(axes[k], tuple(v.shape),
                                                 ms), device_mesh)
            for k, v in cache.items()}


@contextlib.contextmanager
def on_mesh(cfg: ModelConfig, shape: ShapeConfig, device_mesh, **axes_kw):
    """The block runs as a step on ``device_mesh``: ``cell_axes`` set and
    plain tensors taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with flags.activation_axes(**cell_axes(cfg, shape, device_mesh,
                                           **axes_kw)), \
            implicit_replication():
        yield


def mesh_step(fn: Callable, cfg: ModelConfig, shape: ShapeConfig,
              device_mesh, *, batch_axes=None,
              head_axes="model") -> Callable:
    """``fn(model, ..., batch)`` as a step on ``device_mesh``: a plain
    batch committed with :func:`shard_batch`, a plain ``batch["cache"]``
    with :func:`shard_cache`, then ``fn`` under :func:`on_mesh` on the
    model read through ``transformer.unsharded``."""
    def run(model, *args):
        batch = args[-1]
        if "cache" in batch and not is_dtensor(
                next(iter(batch["cache"].values()))):
            batch = dict(batch, cache=shard_cache(batch["cache"], cfg,
                                                  device_mesh))
        plain = {k: v for k, v in batch.items()
                 if k != "cache" and not is_dtensor(v)}
        batch = dict(batch, **shard_batch(plain, device_mesh, batch_axes))
        with on_mesh(cfg, shape, device_mesh, batch_axes=batch_axes,
                     head_axes=head_axes):
            return fn(M.unsharded(model), *args[:-1], batch)
    return run


def make_step(cfg: ModelConfig, shape: ShapeConfig, *, n_micro: int = 1,
              device: DeviceLike = None, mesh=None, batch_axes=None,
              head_axes="model") -> Callable:
    """The step function of this cell: ``step(model, batch)``, or for the
    train kind ``step(model, opt_state, batch) -> (opt_state, metrics)``
    with AdamW's defaults over ``n_micro`` micro-batches (the model
    trainable, ``transformer.make_trainable``).  The model must live on
    ``device`` (None: the CUDA device).

    ``mesh``: a ``DeviceMesh`` whose devices are of ``device``'s type (a
    ``meta`` step: any mesh, its local shards on ``meta``).
    The model and optimizer state must then be on it
    (:func:`shard_model`, :func:`shard_opt_state`); the step commits a
    plain batch with :func:`shard_batch` (over ``batch_axes``) and a plain
    decode cache with :func:`shard_cache`, and runs under
    :func:`on_mesh` (heads on ``head_axes``), reading the parameters
    through ``transformer.unsharded`` (FSDP's gather)."""
    check_family(cfg)
    device = resolve_device(device)
    if mesh is not None and device.type not in ("meta", mesh.device_type):
        raise ValueError(f"mesh on {mesh.device_type}, step built for "
                         f"{device}")

    def _on_device(model):
        model = getattr(model, "_module", model)
        where = model.embedding.device
        if where.type != device.type or device.index not in (None,
                                                             where.index):
            raise ValueError(f"model on {where}, step built for {device}")
        if (mesh is None) == is_dtensor(model.embedding):
            raise ValueError("a model of DTensors takes a step built on "
                             "their mesh (make_step(mesh=)), and only it")

    def sharded(fn):
        if mesh is None:
            return fn
        return mesh_step(fn, cfg, shape, mesh, batch_axes=batch_axes,
                         head_axes=head_axes)

    if shape.kind == "train":
        ts = make_train_step(cfg, AdamWConfig(), n_micro=n_micro)

        def train_fn(model, opt_state, batch):
            _on_device(model)
            return ts(model, opt_state, batch)
        return sharded(train_fn)

    if shape.kind == "prefill":
        def prefill_fn(model, batch):
            _on_device(model)
            if cfg.family == "encdec":
                enc = M.encode(model, batch["frames"], cfg)
                return M.logits_fn(model, enc[:, -1:], cfg)
            return serve_engine.prefill(model, batch["tokens"], cfg,
                                        shape.seq_len)
        return sharded(prefill_fn)

    def decode_fn(model, batch):
        _on_device(model)
        return serve_engine.decode_step(model, batch["cache"],
                                        batch["tokens"], batch["pos"], cfg)
    return sharded(decode_fn)


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
    """The stacked parameter tree as meta tensors (no allocation)."""
    def leaf(spec):
        if is_leaf(spec):
            return torch.empty(spec.shape, dtype=dtype, device=META)
        return {k: leaf(v) for k, v in spec.items()}
    return leaf(stacked_model_spec(cfg))


def abstract_train_state(cfg: ModelConfig,
                         dtype: torch.dtype = torch.bfloat16):
    """(params, OptState) as meta tensors: the stacked tree in ``dtype``
    and float32 moments of its shapes, step a () int32."""
    params = abstract_params(cfg, dtype)
    moments = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device=META), params)
    opt = OptState(step=torch.empty((), dtype=torch.int32, device=META),
                   m=moments, v=tree_map(torch.empty_like, moments))
    return params, opt


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train;
    2*N*D for prefill; 2*N_active per token for decode."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # one token per seq


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    total = total_param_count(cfg)
    if cfg.moe is None:
        return total
    # subtract inactive routed experts
    m = cfg.moe
    f = m.d_ff_expert or cfg.d_ff
    per_expert = 3 * cfg.d_model * f
    inactive = (m.n_experts - m.top_k) * per_expert * cfg.n_layers
    return total - inactive


def total_param_count(cfg: ModelConfig) -> int:
    return param_count(stacked_model_spec(cfg))


ALL_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def supported_cells():
    out = []
    for a, s in ALL_CELLS:
        cfg = get_config(a)
        ok, why = cell_supported(cfg, SHAPES[s])
        out.append((a, s, ok, why))
    return out


__all__ = ["input_specs", "make_step", "cell_supported", "model_flops",
           "cell_axes", "shard_model", "shard_opt_state", "shard_batch",
           "shard_cache", "on_mesh", "mesh_step",
           "abstract_params", "abstract_train_state",
           "active_param_count", "total_param_count", "ALL_CELLS",
           "supported_cells", "train_input_specs", "prefill_input_specs",
           "decode_input_specs"]
