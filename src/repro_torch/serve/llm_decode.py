# Port of repro/serve/llm_decode.py (the JAX package), dense and vlm families only.
"""LLM inference: prefill (last-token logits) and a single-token decode
step against a KV cache — **not** the placement serving layer.

Cache layout: ``{'k', 'v'}: (L, B, S, KV, hd)``.  ``decode_step`` writes
each layer's new K/V into slot ``pos % S`` in place (JAX threads a new
cache through its scan; the values are the same) and returns the cache.
``prefill`` returns the last token's logits and fills no cache, exactly
as the JAX function does; a caller fills the cache with ``decode_step``
over the prompt.  Everything runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..device import DeviceLike, resolve_device
from ..models import layers as L
from ..models import transformer as M
from ..models.config import ModelConfig

bf16 = torch.bfloat16


@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    M.check_family(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=bf16, device=device),
            "v": torch.zeros(shape, dtype=bf16, device=device)}


@torch.inference_mode()
def decode_step(model: M.Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """One token for every sequence.  tokens: (B,1) int; pos: (B,) int
    (current length of each sequence).  Returns (logits (B,1,V), cache)."""
    M.check_family(cfg)
    x = model.embedding[tokens]                           # (B,1,D)
    for i, layer in enumerate(model.layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = L.attention_decode(layer.attn,
                                  L.rmsnorm(layer.ln1.scale, x), cfg, lc, pos)
        x = x + h
        x = x + L.mlp_apply(layer.ffn, L.rmsnorm(layer.ln2.scale, x))
    x = L.rmsnorm(model.final_norm.scale, x)
    return M.logits_fn(model, x, cfg), cache


@torch.inference_mode()
def prefill(model: M.Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int) -> torch.Tensor:
    """Run the full prompt; return the last token's logits (B,1,V).
    ``max_seq`` is the JAX signature's; no cache is filled."""
    hidden, _ = M.forward(model, tokens, cfg)
    return M.logits_fn(model, hidden[:, -1:], cfg)


__all__ = ["init_cache", "decode_step", "prefill"]
