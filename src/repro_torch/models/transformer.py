# Port of repro/models/transformer.py (the JAX package), dense and vlm families only.
"""Dense decoder LM: embedding, pre-norm GQA + SwiGLU layers, final norm.

``Transformer`` holds the parameters under the JAX tree's names
(``embedding``, ``layers.{i}.{ln1,attn,ln2,ffn}.*``, ``final_norm.scale``,
``lm_head`` when embeddings are untied).  The JAX package stacks each layer
leaf with a leading ``n_layers`` axis and scans over it; the port keeps a
``ModuleList`` and loops.  ``forward``, ``logits_fn`` and ``lm_forward``
take the module.  The ``vlm`` family (Qwen2-VL) is the dense decoder with
M-RoPE over (3, B, S) positions.  Other families raise and point at
ROADMAP.md.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig
from .params import P, init_tree

f32 = torch.float32


FAMILIES = ("dense", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if (cfg.family not in FAMILIES or cfg.moe is not None
            or cfg.mla is not None):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"runs the families {FAMILIES}); see ROADMAP.md, Queue 2")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def layer_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder layer (pre-norm)."""
    check_family(cfg)
    return {"ln1": L.rmsnorm_spec(cfg.d_model),
            "ln2": L.rmsnorm_spec(cfg.d_model),
            "attn": L.attention_spec(cfg),
            "ffn": L.mlp_spec(cfg.d_model, cfg.d_ff)}


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec: Dict[str, Any] = {
        "embedding": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=1.0),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
        "layers": layer_spec(cfg),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return spec


def _stack_spec(spec, n):
    """Add a leading 'layers' axis to every leaf of a per-layer spec."""
    if isinstance(spec, P):
        return P((n,) + spec.shape, ("layers",) + spec.axes, spec.init,
                 spec.scale)
    return {k: _stack_spec(v, n) for k, v in spec.items()}


def stacked_model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec = model_spec(cfg)
    spec["layers"] = _stack_spec(spec["layers"], cfg.n_layers)
    return spec


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """One pre-norm layer's blocks: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.attn = L.Attention(cfg, device=device, dtype=dtype)
        self.ln2 = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff, device=device, dtype=dtype)


class Transformer(nn.Module):
    """The dense decoder's parameters, allocated uninitialized on
    ``device`` (None: the CUDA device); fill them with :func:`init_params`
    or :func:`repro_torch.models.convert.params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.embedding = L._param((cfg.vocab, cfg.d_model), device, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device=device, dtype=dtype)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab), device, dtype)


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    """(dotted name, tensor) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def load_stacked(model: Transformer, tree: Dict[str, Any]) -> Transformer:
    """Set ``model``'s parameters from a tree shaped like
    ``stacked_model_spec`` (layer leaves carry a leading ``n_layers``
    axis, split here into the ``ModuleList``).  Each tensor must already
    have the parameter's device and dtype; a layer's parameter is a view
    of the stacked tensor (no copy).  Builds no reference cycle, so a
    model is freed as soon as its last reference goes."""
    params = dict(model.named_parameters())
    todo = []
    for name, v in _leaves(tree):
        if name.startswith("layers."):
            if v.shape[0] != len(model.layers):
                raise ValueError(f"{name}: {v.shape[0]} layers, model "
                                 f"has {len(model.layers)}")
            rest = name[len("layers."):]
            todo += [(f"layers.{i}.{rest}", v[i]) for i in range(v.shape[0])]
        else:
            todo.append((name, v))
    for name, t in todo:
        old = params.get(name)
        if old is None:
            raise KeyError(f"{name}: not a parameter of the model")
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model "
                             f"wants {tuple(old.shape)}")
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, nn.Parameter(t, requires_grad=False))
    missing = sorted(set(params) - {name for name, _ in todo})
    if missing:
        raise KeyError(f"tree lacks parameters {missing}")
    return model


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None) -> Transformer:
    """A ``Transformer`` with the JAX package's random init (std rule of
    ``params.init_tree`` on the stacked spec), drawn from ``generator``."""
    device = resolve_device(device)
    tree = init_tree(stacked_model_spec(cfg), generator, dtype, device)
    return load_stacked(Transformer(cfg, device="meta", dtype=dtype), tree)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _positions(cfg: ModelConfig, batch: int, seq: int,
               mrope_positions: Optional[torch.Tensor],
               device: torch.device) -> torch.Tensor:
    """The vlm family's (3, B, S) ``mrope_positions`` where given, else
    (B, S) text positions: M-RoPE with three equal axes is plain RoPE."""
    if cfg.mrope and mrope_positions is not None:
        return mrope_positions                  # (3, B, S) from frontend stub
    return torch.arange(seq, device=device)[None].expand(batch, seq)


def _decoder_layer_fwd(cfg: ModelConfig, layer: DecoderLayer, x, positions):
    """One pre-norm decoder layer."""
    h = L.attention_apply(layer.attn, L.rmsnorm(layer.ln1.scale, x), cfg,
                          positions)
    x = x + h
    h = L.mlp_apply(layer.ffn, L.rmsnorm(layer.ln2.scale, x))
    return x + h


def forward(model: Transformer, tokens_or_embeds: torch.Tensor,
            cfg: ModelConfig, *,
            mrope_positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden_states (B,S,D), aux_loss ()); the dense family's
    aux is 0.  ``mrope_positions`` (3, B, S): the vlm family's position
    ids (default: every axis 0..S-1)."""
    check_family(cfg)
    if not tokens_or_embeds.is_floating_point():
        x = model.embedding[tokens_or_embeds]
    else:
        x = tokens_or_embeds
    B, Sq = x.shape[:2]
    positions = _positions(cfg, B, Sq, mrope_positions, x.device)
    for layer in model.layers:
        x = _decoder_layer_fwd(cfg, layer, x, positions)
    x = L.rmsnorm(model.final_norm.scale, x)
    return x, torch.zeros((), dtype=f32, device=x.device)


def logits_fn(model: Transformer, hidden, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return hidden @ model.embedding.T
    return hidden @ model.lm_head


def lm_forward(model: Transformer, tokens, cfg: ModelConfig, **kw):
    """tokens -> (logits (B,S,V) in the model dtype, aux); ``kw`` goes to
    :func:`forward`."""
    hidden, aux = forward(model, tokens, cfg, **kw)
    return logits_fn(model, hidden, cfg), aux


__all__ = ["model_spec", "stacked_model_spec", "layer_spec", "Transformer",
           "DecoderLayer", "init_params", "load_stacked", "forward",
           "logits_fn", "lm_forward", "check_family"]
