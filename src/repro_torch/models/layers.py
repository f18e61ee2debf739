# Port of repro/models/layers.py (the JAX package), dense subset: norms, RoPE / M-RoPE, GQA attention, SwiGLU.
"""Core dense-decoder layers: RMSNorm, RoPE / M-RoPE, GQA attention, SwiGLU.

Each block is an ``nn.Module`` whose parameters carry the JAX tree's names
and the JAX layout ``(d_in, d_out)``: the port computes ``x @ W`` as
``attention_qkv`` and ``mlp_apply`` do, and transposes nothing into
``nn.Linear``'s layout.  Beside each module stands the plain function that
takes it, under the JAX function's name, so the two packages compare
function by function.

Prefill attention goes through :func:`flash_attention`, the wrapper of the
CUDA kernel (its plain version for CPU tensors); single-token decode
attention is plain torch.  MLA and MoE are not ported yet: the model
raises for their families (``transformer.check_family``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig
from .params import P

f32 = torch.float32


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> Dict[str, P]:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    h = x.to(f32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    out = h * torch.rsqrt(var + eps)
    return (out * scale.to(f32)).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm weight ``scale``."""

    def __init__(self, d: int, *, device, dtype):
        super().__init__()
        self.scale = _param((d,), device, dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as float32 on ``device``, made once: a copy from
    host memory on every call would wait for the device's queue."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=f32,
                           device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None):
    """x: (B, S, H, hd); positions: (B, S) or (3, B, S) for M-RoPE.
    Split-half rotation with float64 frequencies cast to float32 and
    float32 angles.

    M-RoPE (Qwen2-VL): the head_dim/2 frequency channels are split into
    ``mrope_sections``, each driven by its own position axis (temporal,
    height, width).  With text-only position ids all three axes coincide
    and M-RoPE degenerates to standard RoPE.  (B, S) positions ignore the
    sections, as in the JAX function."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)         # (hd/2,)
    if positions.dim() == 2:                                   # (B, S)
        angles = positions[..., None].to(f32) * freqs          # (B,S,hd/2)
    else:                                                      # (3, B, S)
        if mrope_sections is None:
            raise ValueError("(3, B, S) positions need mrope_sections")
        parts, start = [], 0
        for axis, sec in enumerate(mrope_sections):
            parts.append(positions[axis][..., None].to(f32)
                         * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)                      # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL uses [16, 24, 24] for head_dim 128; scale proportionally."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def decode_attention(q, k, v, cache_len: Optional[torch.Tensor] = None):
    """Single-step attention in the grouped (KV, G) layout.
    q: (B,1,H,hd), k/v: (B,S,KV,hd); keys at or past ``cache_len`` (B,)
    are masked with -1e30."""
    B, _, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qr = q[:, 0].reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qr.to(f32), k.to(f32))
    s = s * scale
    if cache_len is not None:
        valid = (torch.arange(S, device=q.device)[None, :]
                 < cache_len[:, None])
        s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.to(f32))
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def attention_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": P((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wv": P((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wo": P((cfg.n_heads * hd, d), ("heads", "embed")),
    }


class Attention(nn.Module):
    """GQA attention weights ``wq``, ``wk``, ``wv``, ``wo`` (JAX layout)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        for name, p in attention_spec(cfg).items():
            setattr(self, name, _param(p.shape, device, dtype))


def attention_qkv(attn: Attention, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ attn.wq).reshape(B, S, cfg.n_heads, hd)
    k = (x @ attn.wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ attn.wv).reshape(B, S, cfg.n_kv_heads, hd)
    sections = default_mrope_sections(hd) if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attention_apply(attn: Attention, x, cfg: ModelConfig, positions, *,
                    window: Optional[int] = None):
    q, k, v = attention_qkv(attn, x, cfg, positions)
    o = flash_attention(q, k, v, causal=True,
                        window=window or cfg.sliding_window)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ attn.wo


def attention_decode(attn: Attention, x, cfg: ModelConfig, cache, pos, *,
                     window: Optional[int] = None):
    """x: (B,1,D); cache: {'k','v'}: (B,S,KV,hd); pos: (B,) int.

    Writes the new K/V into slot ``pos % S`` of the cache in place (the
    JAX function selects with ``where`` over the whole cache; the result
    is the same) and returns ``(out (B,1,D), cache)``.  ``window`` is
    accepted for the JAX signature; as there, the ring buffer alone bounds
    what a step sees."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = (x @ attn.wq).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ attn.wk).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ attn.wv).reshape(B, 1, cfg.n_kv_heads, hd)
    # One text position per request: M-RoPE's three axes would coincide,
    # which is plain RoPE, so the vlm family takes this path too.
    posb = pos[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    k_all, v_all = cache["k"], cache["v"]
    S = k_all.shape[1]
    slot = (pos % S).long()             # ring buffer; plain append otherwise
    rows = torch.arange(B, device=x.device)
    k_all[rows, slot] = k[:, 0].to(k_all.dtype)
    v_all[rows, slot] = v[:, 0].to(v_all.dtype)
    o = decode_attention(q, k_all, v_all,
                         cache_len=torch.clamp(pos + 1, max=S))
    return o.reshape(B, 1, -1) @ attn.wo, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d: int, f: int) -> Dict[str, P]:
    return {
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed")),
    }


class SwiGLU(nn.Module):
    """SwiGLU weights ``w_gate``, ``w_up``, ``w_down`` (JAX layout)."""

    def __init__(self, d: int, f: int, *, device, dtype):
        super().__init__()
        for name, p in mlp_spec(d, f).items():
            setattr(self, name, _param(p.shape, device, dtype))


def mlp_apply(ffn: SwiGLU, x):
    """silu(x @ w_gate) * (x @ w_up) in float32, cast back, @ w_down."""
    g = (x @ ffn.w_gate).to(f32)
    u = (x @ ffn.w_up).to(f32)
    h = (F.silu(g) * u).to(x.dtype)
    return h @ ffn.w_down


__all__ = [
    "rmsnorm_spec", "rmsnorm", "RMSNorm", "rope_freqs", "apply_rope",
    "default_mrope_sections", "flash_attention", "decode_attention",
    "attention_spec", "Attention", "attention_qkv", "attention_apply",
    "attention_decode", "mlp_spec", "SwiGLU", "mlp_apply",
]
