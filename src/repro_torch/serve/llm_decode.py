# Port of repro/serve/llm_decode.py (the JAX package), dense, vlm, moe and encdec families.
"""LLM inference: prefill (last-token logits) and a single-token decode
step against a KV cache — **not** the placement serving layer.

Cache layouts: ``{'k', 'v'}: (L, B, S, KV, hd)``; encdec adds the cross
attention's ``'xk'``, ``'xv'`` of the same shape.  ``decode_step`` writes
each layer's new K/V into slot ``pos % S`` in place (JAX threads a new
cache through its scan; the values are the same) and returns the cache.
``prefill`` returns the last token's logits and fills no cache, exactly
as the JAX function does; a caller fills the cache with ``decode_step``
over the prompt.  Nor does anything fill ``xk`` / ``xv`` (the JAX
package's docstring says prefill does; its code does not): a caller
writes each decoder layer's ``encoder_out @ xattn.wk`` / ``wv`` there.
Everything runs under ``torch.inference_mode()``.
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
    # encdec: the cross-KV, to be filled from the encoder states.
    names = ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")
    return {n: torch.zeros(shape, dtype=bf16, device=device) for n in names}


@torch.inference_mode()
def decode_step(model: M.Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """One token for every sequence.  tokens: (B,1) int; pos: (B,) int
    (current length of each sequence).  Returns (logits (B,1,V), cache).
    encdec: cross attention over all of ``xk`` / ``xv`` (no length mask,
    as in JAX), q without RoPE; moe: the routed FFN at this step's T = B
    tokens."""
    M.check_family(cfg)
    x = model.embedding[tokens]                           # (B,1,D)
    encdec = cfg.family == "encdec"
    layers = model.dec_layers if encdec else model.layers
    for i, layer in enumerate(layers):
        lc = {"k": cache["k"][i], "v": cache["v"][i]}
        h, _ = L.attention_decode(layer.attn,
                                  L.rmsnorm(layer.ln1.scale, x), cfg, lc, pos)
        x = x + h
        if encdec:
            # cross-attention against the precomputed encoder KV
            B, hd = x.shape[0], cfg.resolved_head_dim
            xq = L.rmsnorm(layer.ln_x.scale, x)
            q = (xq @ layer.xattn.wq).reshape(B, 1, cfg.n_heads, hd)
            o = L.decode_attention(q, cache["xk"][i], cache["xv"][i])
            x = x + o.reshape(B, 1, -1) @ layer.xattn.wo
        h_in = L.rmsnorm(layer.ln2.scale, x)
        if cfg.moe is not None:
            h, _ = L.moe_apply(layer.ffn, h_in, cfg)
        else:
            h = L.mlp_apply(layer.ffn, h_in)
        x = x + h
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
