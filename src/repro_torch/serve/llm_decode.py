# Port of repro/serve/llm_decode.py (the JAX package): every family (dense, vlm, moe, mla_moe, encdec, rwkv6, hybrid).
"""LLM inference: prefill (last-token logits) and a single-token decode
step against a KV cache — **not** the placement serving layer.

Cache layouts: ``{'k', 'v'}: (L, B, S, KV, hd)``; encdec adds the cross
attention's ``'xk'``, ``'xv'`` of the same shape; mla_moe holds the
*latent* ``'c'`` (L, B, S, kv_lora) and ``'kr'`` (L, B, S, 1, rope) bf16,
each step re-expanding it through ``wkv_b`` as JAX does; rwkv6 holds
``'tm_state'`` (L, B, H, hd, hd) float32 and the token-shift carries
``'tm_x'``, ``'cm_x'`` (L, B, D) bf16; hybrid holds ``'ssm'`` (L, B, H, hd,
N) float32 and, per shared-block call (``n_layers // shared_attn_period``
of them: the block shares weights, not its cache), a K/V ring of ``W =
min(sliding_window or max_seq, max_seq)`` slots, ``'shared_k'`` /
``'shared_v'`` (G, B, W, KV, hd) bf16.  The SSM families' state does not
grow with the context: this is what makes long_500k runnable.
``decode_step`` writes each layer's new K/V into slot ``pos % S`` (the
ring's ``pos % W``; MLA's latent into slot ``pos``) and each Mamba-2 state
in place (JAX threads a new
cache through its scan; the values are the same) and returns the cache;
RWKV's entries are replaced by the step's, as JAX's are, so the carries
take x's dtype (float32 in a float32 model after the first step).
``prefill`` returns the last token's logits and fills no cache, exactly
as the JAX function does; a caller fills the cache with ``decode_step``
over the prompt.  Nor does anything fill ``xk`` / ``xv`` (the JAX
package's docstring says prefill does; its code does not): a caller
writes each decoder layer's ``encoder_out @ xattn.wk`` / ``wv`` there.
Everything runs under ``torch.inference_mode()`` (``no_grad`` for a
model of DTensors).  ``cache_axes`` gives
the entries' logical axes (metadata, as in JAX).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike, is_dtensor, resolve_device
from ..models import layers as L
from ..models import ssm as S
from ..models import transformer as M
from ..models.config import ModelConfig

bf16 = torch.bfloat16


@torch.inference_mode()
def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    M.check_family(cfg)
    device = resolve_device(device)
    LN, hd = cfg.n_layers, cfg.resolved_head_dim
    if cfg.family == "mla_moe":
        m = cfg.mla
        return {
            "c": torch.zeros((LN, batch, max_seq, m.kv_lora_rank), dtype=bf16,
                             device=device),
            "kr": torch.zeros((LN, batch, max_seq, 1, m.rope_head_dim),
                              dtype=bf16, device=device),
        }
    if cfg.family == "rwkv6":
        H = cfg.d_model // cfg.ssm.head_dim
        shd = cfg.ssm.head_dim
        return {
            "tm_state": torch.zeros((LN, batch, H, shd, shd),
                                    dtype=torch.float32, device=device),
            "tm_x": torch.zeros((LN, batch, cfg.d_model), dtype=bf16,
                                device=device),
            "cm_x": torch.zeros((LN, batch, cfg.d_model), dtype=bf16,
                                device=device),
        }
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.expand * cfg.d_model
        H = d_inner // cfg.ssm.head_dim
        W = min(cfg.sliding_window or max_seq, max_seq)
        n_groups = cfg.n_layers // cfg.shared_attn_period
        ring = (n_groups, batch, W, cfg.n_kv_heads, hd)
        return {
            "ssm": torch.zeros((LN, batch, H, cfg.ssm.head_dim,
                                cfg.ssm.d_state), dtype=torch.float32,
                               device=device),
            "shared_k": torch.zeros(ring, dtype=bf16, device=device),
            "shared_v": torch.zeros(ring, dtype=bf16, device=device),
        }
    shape = (LN, batch, max_seq, cfg.n_kv_heads, hd)
    # encdec: the cross-KV, to be filled from the encoder states.
    names = ("k", "v", "xk", "xv") if cfg.family == "encdec" else ("k", "v")
    return {n: torch.zeros(shape, dtype=bf16, device=device) for n in names}


def cache_axes(cfg: ModelConfig, model_size: int = 16
               ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of :func:`init_cache`'s entries (batch on data;
    ``launch.sharding`` maps them).  KV caches shard heads on the model
    axis when ``model_size`` divides the KV heads; otherwise they shard the
    SEQUENCE dim over the model axis (distributed-softmax decode)."""
    heads_ok = cfg.n_kv_heads % model_size == 0
    seq_ax = None if heads_ok else "seq_model"
    head_ax = "kv_heads_cache" if heads_ok else None
    if cfg.family == "mla_moe":
        # MLA latent has no head dim -> always sequence-shard
        return {"c": ("layers", "batch", "seq_model", None),
                "kr": ("layers", "batch", "seq_model", None, None)}
    if cfg.family == "rwkv6":
        return {"tm_state": ("layers", "batch", "ssm_heads", None, None),
                "tm_x": ("layers", "batch", "embed_vec"),
                "cm_x": ("layers", "batch", "embed_vec")}
    if cfg.family == "hybrid":
        return {"ssm": ("layers", "batch", "ssm_heads", None, None),
                "shared_k": ("layers", "batch", seq_ax, head_ax, None),
                "shared_v": ("layers", "batch", seq_ax, head_ax, None)}
    if cfg.family == "encdec":
        return {k: ("layers", "batch", seq_ax, head_ax, None)
                for k in ("k", "v", "xk", "xv")}
    return {k: ("layers", "batch", seq_ax, head_ax, None)
            for k in ("k", "v")}


def _serving(fn):
    """``fn(model, ...)`` under ``inference_mode``; under ``no_grad`` for a
    model of DTensors (a step on a mesh), whose views cannot take an
    inference tensor's version counter."""
    @functools.wraps(fn)
    def run(model, *args, **kwargs):
        with (torch.no_grad() if is_dtensor(model.embedding)
              else torch.inference_mode()):
            return fn(model, *args, **kwargs)
    return run


@_serving
def decode_step(model: M.Transformer, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """One token for every sequence.  tokens: (B,1) int; pos: (B,) int
    (current length of each sequence).  Returns (logits (B,1,V), cache).
    encdec: cross attention over all of ``xk`` / ``xv`` (no length mask,
    as in JAX), q without RoPE; moe and mla_moe: the routed FFN at this
    step's T = B tokens; mla_moe: ``mla_decode`` against the latent cache;
    rwkv6 and hybrid: :func:`_rwkv6_step` / :func:`_hybrid_step`."""
    M.check_family(cfg)
    x = M.embed(model, tokens)                            # (B,1,D)
    if cfg.family == "rwkv6":
        x = _rwkv6_step(model, cache, x, cfg)
        return _logits(model, x, cfg), cache
    if cfg.family == "hybrid":
        x = _hybrid_step(model, cache, x, pos, cfg)
        return _logits(model, x, cfg), cache
    encdec = cfg.family == "encdec"
    mla = cfg.family == "mla_moe"
    layers = model.dec_layers if encdec else model.layers
    names = ("c", "kr") if mla else ("k", "v")
    attend = L.mla_decode if mla else L.attention_decode
    for i, layer in enumerate(layers):
        lc = {n: cache[n][i] for n in names}
        h, _ = attend(layer.attn, L.rmsnorm(layer.ln1.scale, x), cfg, lc,
                      pos)
        x = x + h
        if encdec:
            # cross-attention against the precomputed encoder KV
            B, hd = x.shape[0], cfg.resolved_head_dim
            xq = L.rmsnorm(layer.ln_x.scale, x)
            q = L.split_heads(xq @ layer.xattn.wq, cfg.n_heads, hd)
            o = L.decode_attention(q, cache["xk"][i], cache["xv"][i])
            x = x + L.out_proj(o, layer.xattn.wo)
        h_in = L.rmsnorm(layer.ln2.scale, x)
        if cfg.moe is not None:
            h, _ = L.moe_apply(layer.ffn, h_in, cfg)
        else:
            h = L.mlp_apply(layer.ffn, h_in)
        x = x + h
    return _logits(model, x, cfg), cache


def _logits(model: M.Transformer, x, cfg: ModelConfig):
    return M.logits_fn(model, L.rmsnorm(model.final_norm.scale, x), cfg)


def _rwkv6_step(model: M.Transformer, cache, x, cfg: ModelConfig):
    """Each RWKV-6 layer's time-mix and channel-mix over one token from its
    cached carries and state; the cache's three entries are replaced by
    the new ones, stacked over layers (their dtypes are the step's)."""
    new = {"tm_state": [], "tm_x": [], "cm_x": []}
    for i, layer in enumerate(model.layers):
        h, tm_x, tm_state = S.rwkv6_time_mix_scan(
            layer.tm, L.rmsnorm(layer.ln1.scale, x), cfg, cache["tm_x"][i],
            cache["tm_state"][i])
        x = x + h
        h, cm_x = S.rwkv6_channel_mix(
            layer.cm, L.rmsnorm(layer.ln2.scale, x), cache["cm_x"][i])
        x = x + h
        for k, t in (("tm_state", tm_state), ("tm_x", tm_x), ("cm_x", cm_x)):
            new[k].append(t)
    cache.update({k: torch.stack(ts) for k, ts in new.items()})
    return x


def _hybrid_step(model: M.Transformer, cache, x, pos, cfg: ModelConfig):
    """Zamba2 over one token: per group the shared block, decoding against
    that group's ring (slot ``pos % W``, the last ``min(pos + 1, W)``
    positions), then the group's Mamba-2 steps; the layers left over
    after the last group.  The rings and states are written in place."""
    period = cfg.shared_attn_period
    n_groups = cfg.n_layers // period
    sp = model.shared

    def mamba(x, lo, hi):
        for i in range(lo, hi):
            layer = model.layers[i]
            h, state = S.mamba2_step(
                layer.mamba, L.rmsnorm(layer.ln1.scale, x), cache["ssm"][i],
                cfg)
            cache["ssm"][i] = state
            x = x + h
        return x

    for gi in range(n_groups):
        ring = {"k": cache["shared_k"][gi], "v": cache["shared_v"][gi]}
        h, _ = L.attention_decode(sp.attn, L.rmsnorm(sp.ln1.scale, x), cfg,
                                  ring, pos, window=cfg.sliding_window)
        x = x + h
        x = x + L.mlp_apply(sp.ffn, L.rmsnorm(sp.ln2.scale, x))
        x = mamba(x, gi * period, (gi + 1) * period)
    return mamba(x, n_groups * period, cfg.n_layers)


@_serving
def prefill(model: M.Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int) -> torch.Tensor:
    """Run the full prompt; return the last token's logits (B,1,V).
    ``max_seq`` is the JAX signature's; no cache is filled.  A hybrid
    config runs :func:`~repro_torch.models.transformer.hybrid_forward`."""
    if cfg.family == "hybrid":
        hidden, _ = M.hybrid_forward(model, tokens, cfg)
    else:
        hidden, _ = M.forward(model, tokens, cfg)
    return M.logits_fn(model, hidden[:, -1:], cfg)


__all__ = ["init_cache", "cache_axes", "decode_step", "prefill"]
