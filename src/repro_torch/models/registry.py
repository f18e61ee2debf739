# Port of repro/models/registry.py (the JAX package): serving step builders and parameter counts.
"""Registry: (architecture x input shape) -> step function.

  * ``prefill_32k``  — ``prefill``   (full-context forward, last logits),
  * ``decode_32k`` / ``long_500k`` — ``decode_step`` (one new token against
    a seq_len cache).

Training (``train_4k``) is not ported yet and raises.  Parameter counts
and ``model_flops`` are the JAX package's formulas over the port's specs.
"""
from __future__ import annotations

from typing import Callable

from ..device import DeviceLike, resolve_device
from ..serve import llm_decode as serve_engine
from .config import ModelConfig, ShapeConfig
from .params import param_count
from .transformer import check_family, stacked_model_spec


def make_step(cfg: ModelConfig, shape: ShapeConfig, *,
              device: DeviceLike = None) -> Callable:
    """The step function of this cell: ``step(model, batch)``.  The model
    must live on ``device`` (None: the CUDA device)."""
    check_family(cfg)
    if shape.kind == "train":
        raise NotImplementedError(
            "training (train/step.py, train/optimizer.py) is not ported "
            "yet; see ROADMAP.md, Queue 2")
    device = resolve_device(device)

    def _on_device(model):
        where = model.embedding.device
        if where.type != device.type or device.index not in (None,
                                                             where.index):
            raise ValueError(f"model on {where}, step built for {device}")

    if shape.kind == "prefill":
        def prefill_fn(model, batch):
            _on_device(model)
            return serve_engine.prefill(model, batch["tokens"], cfg,
                                        shape.seq_len)
        return prefill_fn

    def decode_fn(model, batch):
        _on_device(model)
        return serve_engine.decode_step(model, batch["cache"],
                                        batch["tokens"], batch["pos"], cfg)
    return decode_fn


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
    """Parameters touched per token (the dense family touches all)."""
    return total_param_count(cfg)


def total_param_count(cfg: ModelConfig) -> int:
    return param_count(stacked_model_spec(cfg))


__all__ = ["make_step", "model_flops", "active_param_count",
           "total_param_count"]
