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
sub-quadratic archs).  Parameter counts and ``model_flops`` are the JAX
package's formulas over the port's specs.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..serve import llm_decode as serve_engine
from ..train.optimizer import AdamWConfig, OptState, tree_map
from ..train.step import make_train_step
from .config import SHAPES, ModelConfig, ShapeConfig
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

def make_step(cfg: ModelConfig, shape: ShapeConfig, *, n_micro: int = 1,
              device: DeviceLike = None) -> Callable:
    """The step function of this cell: ``step(model, batch)``, or for the
    train kind ``step(model, opt_state, batch) -> (opt_state, metrics)``
    with AdamW's defaults over ``n_micro`` micro-batches (the model
    trainable, ``transformer.make_trainable``).  The model must live on
    ``device`` (None: the CUDA device)."""
    check_family(cfg)
    device = resolve_device(device)

    def _on_device(model):
        where = model.embedding.device
        if where.type != device.type or device.index not in (None,
                                                             where.index):
            raise ValueError(f"model on {where}, step built for {device}")

    if shape.kind == "train":
        ts = make_train_step(cfg, AdamWConfig(), n_micro=n_micro)

        def train_fn(model, opt_state, batch):
            _on_device(model)
            return ts(model, opt_state, batch)
        return train_fn

    if shape.kind == "prefill":
        def prefill_fn(model, batch):
            _on_device(model)
            if cfg.family == "encdec":
                enc = M.encode(model, batch["frames"], cfg)
                return M.logits_fn(model, enc[:, -1:], cfg)
            return serve_engine.prefill(model, batch["tokens"], cfg,
                                        shape.seq_len)
        return prefill_fn

    def decode_fn(model, batch):
        _on_device(model)
        return serve_engine.decode_step(model, batch["cache"],
                                        batch["tokens"], batch["pos"], cfg)
    return decode_fn


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
           "abstract_params", "abstract_train_state",
           "active_param_count", "total_param_count", "ALL_CELLS",
           "supported_cells", "train_input_specs", "prefill_input_specs",
           "decode_input_specs"]
