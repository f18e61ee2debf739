# Port of repro/models/layers.py (the JAX package): norms, RoPE / M-RoPE, GQA and MLA attention, SwiGLU, MoE.
"""Core layers: RMSNorm, RoPE / M-RoPE, GQA and MLA attention, SwiGLU, MoE.

Each block is an ``nn.Module`` whose parameters carry the JAX tree's names
and the JAX layout ``(d_in, d_out)``: the port computes ``x @ W`` as
``attention_qkv`` and ``mlp_apply`` do, and transposes nothing into
``nn.Linear``'s layout.  Beside each module stands the plain function that
takes it, under the JAX function's name, so the two packages compare
function by function.

Prefill attention goes through :func:`flash_attention`, the wrapper of the
CUDA kernel (its plain version for CPU tensors); MLA's (DeepSeek-V2) with
q/k at nope + rope against v at its own width.  Single-token decode
attention is plain torch; MLA decodes against its latent cache, expanded
through ``wkv_b`` at every step as in JAX.  The MoE's expert products are
batched matmuls, as the JAX package computes them outside any Pallas
kernel.

The activation pins sit where JAX's ``flags.constrain`` calls do: q, k and
v before attention (:func:`pin_qkv`), the decode scores, the decode
caches, and the SwiGLU's hidden and output (Megatron column -> row).
They act on DTensors while ``flags`` holds mesh axes, and on nothing
else.  A DTensor cache takes each decode step's new entry through JAX's
``where`` over the whole cache (an index write into a sequence-sharded
cache would gather it); a plain cache is written at its slot.
"""
from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import is_dtensor
from ..kernels.flash_attention import flash_attention
from . import flags
from .config import MLAConfig, ModelConfig, MoEConfig
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
    qr = _divisible(q[:, 0], 1, KV).reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qr.to(f32), k.to(f32))
    s = s * scale
    if cache_len is not None:
        valid = (torch.arange(S, device=q.device)[None, :]
                 < cache_len[:, None])
        s = torch.where(valid[:, None, None, :], s, -1e30)
    s = flags.constrain(s, "batch", "kv_heads", None, "kv_seq")
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


def _divisible(x, d: int, n: int):
    """A DTensor ``x`` whose dim ``d`` is sharded over more ranks than
    divide ``n`` (the leading size it is about to be split into) made
    whole over the mesh axes that do not (GSPMD reshards such a reshape
    itself; DTensor refuses it); any other ``x`` as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pl, ways = list(x.placements), 1
    for m, p in enumerate(pl):
        if p.is_shard(d):
            if n % (ways * mesh.size(m)):
                pl[m] = Replicate()
            else:
                ways *= mesh.size(m)
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def split_heads(x, n: int, hd: int):
    """x (..., n * hd) -> (..., n, hd) (a DTensor first through
    :func:`_divisible`)."""
    x = _divisible(x, x.dim() - 1, n)
    return x.reshape(*x.shape[:-1], n, hd)


def out_proj(o, wo):
    """Attention's output projection ``o (B, S, H, hd_v) @ wo``, pinned
    (batch, ...): the row-parallel product's reduction over the heads'
    axis, made before the residual add (a pin the JAX package leaves to
    GSPMD; without it DTensor keeps the residual a Partial sum and meets
    the next column-parallel weight by gathering it, so every rank would
    run the whole SwiGLU)."""
    B, S = o.shape[:2]
    y = o.reshape(B, S, -1) @ wo
    return flags.constrain(y, "batch", None, None)


def pin_qkv(q, k, v):
    """JAX's pins on attention's inputs (its ``flash_attention``): q batch
    and heads; k and v batch, and heads only where KV == H (a GQA k / v
    pinned on heads would make the backward reduce the expanded
    gradient)."""
    q = flags.constrain(q, "batch", None, "heads", None)
    kv_pin = "heads" if k.shape[2] == q.shape[2] else None
    k = flags.constrain(k, "batch", None, kv_pin, None)
    v = flags.constrain(v, "batch", None, kv_pin, None)
    return q, k, v


def _write_slot(cache_t, new, slot, rows, inside=None):
    """``cache_t[rows, slot] = new`` in place (where ``inside``, (B, 1)
    bool, else the old entry); on a DTensor cache through a ``where``
    over the sequence dim, JAX's update."""
    new = new.to(cache_t.dtype)
    if is_dtensor(cache_t):
        S = cache_t.shape[1]
        sel = (torch.arange(S, device=slot.device)[None, :]
               == slot[:, None])
        if inside is not None:
            sel = sel & inside
        sel = sel.reshape(sel.shape + (1,) * (cache_t.dim() - 2))
        cache_t.copy_(torch.where(sel, new[:, None], cache_t))
        return
    if inside is not None:
        new = torch.where(inside.reshape(inside.shape + (1,) * (new.dim()
                                                                - 2)),
                          new, cache_t[rows, slot])
    cache_t[rows, slot] = new


def attention_qkv(attn: Attention, x, cfg: ModelConfig, positions):
    hd = cfg.resolved_head_dim
    q = split_heads(x @ attn.wq, cfg.n_heads, hd)
    k = split_heads(x @ attn.wk, cfg.n_kv_heads, hd)
    v = split_heads(x @ attn.wv, cfg.n_kv_heads, hd)
    sections = default_mrope_sections(hd) if cfg.mrope else None
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def attention_apply(attn: Attention, x, cfg: ModelConfig, positions, *,
                    window: Optional[int] = None):
    q, k, v = pin_qkv(*attention_qkv(attn, x, cfg, positions))
    o = flash_attention(q, k, v, causal=True,
                        window=window or cfg.sliding_window)
    return out_proj(o, attn.wo)


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
    q = split_heads(x @ attn.wq, cfg.n_heads, hd)
    k = split_heads(x @ attn.wk, cfg.n_kv_heads, hd)
    v = split_heads(x @ attn.wv, cfg.n_kv_heads, hd)
    # One text position per request: M-RoPE's three axes would coincide,
    # which is plain RoPE, so the vlm family takes this path too.
    posb = pos[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    k_all, v_all = cache["k"], cache["v"]
    S = k_all.shape[1]
    slot = (pos % S).long()             # ring buffer; plain append otherwise
    rows = torch.arange(B, device=x.device)
    _write_slot(k_all, k[:, 0], slot, rows)
    _write_slot(v_all, v[:, 0], slot, rows)
    k_all = flags.constrain(k_all, "batch", "kv_seq", "kv_heads", None)
    v_all = flags.constrain(v_all, "batch", "kv_seq", "kv_heads", None)
    o = decode_attention(q, k_all, v_all,
                         cache_len=torch.clamp(pos + 1, max=S))
    return out_proj(o, attn.wo), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention)
# ---------------------------------------------------------------------------

def mla_spec(cfg: ModelConfig) -> Dict[str, P]:
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "wq_a": P((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": P((m.q_lora_rank,), ("q_lora",), init="ones"),
        "wq_b": P((m.q_lora_rank, H * qk), ("q_lora", "heads")),
        "wkv_a": P((d, m.kv_lora_rank + m.rope_head_dim),
                   ("embed", "kv_lora")),
        "kv_norm": P((m.kv_lora_rank,), ("kv_lora",), init="ones"),
        "wkv_b": P((m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
                   ("kv_lora", "heads")),
        "wo": P((H * m.v_head_dim, d), ("heads", "embed")),
    }


class MLA(nn.Module):
    """MLA weights under the JAX names, in its layout: ``wq_a``, ``q_norm``
    (an RMSNorm scale), ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``,
    ``wo``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        for name, p in mla_spec(cfg).items():
            setattr(self, name, _param(p.shape, device, dtype))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two dtypes' promoted type, as jnp's ``@`` computes
    a bf16 cache times float32 weights (or the reverse) in float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mla_q(mla: MLA, x, cfg: ModelConfig, positions):
    """q (B, S, H, nope + rope): the nope part and the rotated rope part."""
    m: MLAConfig = cfg.mla
    qk_n = m.nope_head_dim
    q_lat = rmsnorm(mla.q_norm, x @ mla.wq_a)
    q = split_heads(q_lat @ mla.wq_b, cfg.n_heads, qk_n + m.rope_head_dim)
    q_rope = apply_rope(q[..., qk_n:], positions, cfg.rope_theta)
    return torch.cat([q[..., :qk_n], q_rope], dim=-1)


def _mla_latent(mla: MLA, x, cfg: ModelConfig, positions):
    """The latent ``c`` (B, S, kv_lora), normed, and the rotated shared key
    ``k_rope`` (B, S, 1, rope)."""
    kv_lora = cfg.mla.kv_lora_rank
    ckv = x @ mla.wkv_a                            # (B, S, kv_lora + rope)
    c = rmsnorm(mla.kv_norm, ckv[..., :kv_lora])
    k_rope = apply_rope(ckv[..., None, kv_lora:], positions, cfg.rope_theta)
    return c, k_rope


def _mla_kv(mla: MLA, c, k_rope, cfg: ModelConfig):
    """k (B, S, H, nope + rope) and v (B, S, H, v_head_dim) from the latent:
    ``c @ wkv_b`` split into k's nope part and v, and ``k_rope`` repeated
    over the H heads and concatenated, materialised as in JAX (the kernel
    reads k through a TMA map, never a stride-0 view)."""
    m: MLAConfig = cfg.mla
    B, S = c.shape[:2]
    H, qk_n = cfg.n_heads, m.nope_head_dim
    kv = split_heads(_matmul(c, mla.wkv_b), H, qk_n + m.v_head_dim)
    k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
    k_rope = k_rope.to(k_nope.dtype).expand(B, S, H, m.rope_head_dim)
    return torch.cat([k_nope, k_rope], dim=-1), v


def _mla_qkv(mla: MLA, x, cfg: ModelConfig, positions):
    """(q, k, v, c, k_rope) of the JAX function: q and k at nope + rope, v
    at v_head_dim, the latent and the shared rotated key."""
    q = _mla_q(mla, x, cfg, positions)
    c, k_rope = _mla_latent(mla, x, cfg, positions)
    k, v = _mla_kv(mla, c, k_rope, cfg)
    return q, k, v, c, k_rope


def mla_apply(mla: MLA, x, cfg: ModelConfig, positions):
    """Causal MLA over x (B, S, D): the kernel's wrapper with q/k at nope +
    rope against v at v_head_dim (scale 1 / sqrt(nope + rope))."""
    q, k, v = pin_qkv(*_mla_qkv(mla, x, cfg, positions)[:3])
    o = flash_attention(q, k, v, causal=True)
    return out_proj(o, mla.wo)


def mla_decode(mla: MLA, x, cfg: ModelConfig, cache, pos):
    """x: (B,1,D); cache: the *latent* ``{'c': (B,S,kv_lora), 'kr':
    (B,S,1,rope)}``; pos: (B,) int.

    Writes the new latent and rotated key into slot ``pos`` in place (no
    ring: as in JAX, a position at or past S writes nothing), then expands
    the whole cache through ``wkv_b`` and attends over the first
    ``min(pos + 1, S)`` positions with the plain ``decode_attention``.
    Returns ``(out (B,1,D), cache)``."""
    q = _mla_q(mla, x, cfg, pos[:, None])
    c_new, kr_new = _mla_latent(mla, x, cfg, pos[:, None])
    c_all, kr_all = cache["c"], cache["kr"]
    B, S = c_all.shape[:2]
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(pos, max=S - 1).long()
    inside = (pos < S)[:, None]
    _write_slot(c_all, c_new[:, 0], slot, rows, inside)
    _write_slot(kr_all, kr_new[:, 0], slot, rows, inside)
    c_all = flags.constrain(c_all, "batch", "kv_seq", None)
    kr_all = flags.constrain(kr_all, "batch", "kv_seq", None, None)
    k, v = _mla_kv(mla, c_all, kr_all, cfg)
    o = decode_attention(q, k, v, cache_len=torch.clamp(pos + 1, max=S))
    return out_proj(o, mla.wo), cache


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
    """silu(x @ w_gate) * (x @ w_up) in float32, cast back, @ w_down.  The
    hidden is pinned (batch, ..., mlp on the heads' axes) and the output
    (batch, ...): Megatron's column -> row parallel product."""
    hid = ("batch",) + (None,) * (x.dim() - 2) + ("heads",)
    g = flags.constrain((x @ ffn.w_gate).to(f32), *hid)
    u = flags.constrain((x @ ffn.w_up).to(f32), *hid)
    h = (F.silu(g) * u).to(x.dtype)
    out = h @ ffn.w_down
    return flags.constrain(out, "batch", *(None,) * (out.dim() - 1))


# ---------------------------------------------------------------------------
# Mixture of Experts (scatter dispatch with static capacity)
# ---------------------------------------------------------------------------

def moe_spec(cfg: ModelConfig) -> Dict[str, P]:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    f = m.d_ff_expert or cfg.d_ff
    spec = {
        "router": P((d, m.n_experts), ("embed", "experts_vec")),
        "w_gate": P((m.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_up": P((m.n_experts, d, f), ("experts", "embed", "mlp")),
        "w_down": P((m.n_experts, f, d), ("experts", "mlp", "embed")),
    }
    if m.n_shared:
        spec["shared"] = mlp_spec(d, f * m.n_shared)
    return spec


class MoE(nn.Module):
    """MoE weights: ``router`` (d, E), the stacked experts ``w_gate`` /
    ``w_up`` (E, d, f) and ``w_down`` (E, f, d), and the ``shared``
    SwiGLU when the config has shared experts."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        for name, p in moe_spec(cfg).items():
            if name == "shared":
                f = p["w_gate"].shape[1]
                self.shared = SwiGLU(cfg.d_model, f, device=device,
                                     dtype=dtype)
            else:
                setattr(self, name, _param(p.shape, device, dtype))


def moe_route(moe: MoE, xt: torch.Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None):
    """Top-k routing of the tokens ``xt`` (T, D) with a static capacity of
    ``C = max(1, ceil(T * K / E * cf))`` tokens per expert.

    Returns ``(probs (T, E) float32, top_p (T, K) renormalised, flat_e
    (T*K,), slot (T*K,), keep (T*K,), C)``: entry j of the flattened
    (token, choice) pairs goes to expert ``flat_e[j]`` at slot ``flat_e *
    C + rank`` when ``keep`` (its rank among the expert's pairs, in token
    order, is below C), else to the drop bin ``E * C``.  Ties go to the
    lowest expert index, as ``jax.lax.top_k``'s do (a stable descending
    sort; ``torch.topk`` promises no order), and ranks come from a stable
    sort by expert, as in the JAX function."""
    m: MoEConfig = cfg.moe
    T = xt.shape[0]
    E, K = m.n_experts, m.top_k
    cf = capacity_factor or m.capacity_factor
    C = max(1, int(np.ceil(T * K / E * cf)))
    logits = (xt @ moe.router).to(f32)                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]               # (T, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)                              # (T*K,)
    slot, keep = moe_slots(flat_e, E, C)
    return probs, top_p, flat_e, slot, keep, C


def moe_slots(flat_e: torch.Tensor, E: int, C: int):
    """The buffer slots of the (token, choice) pairs routed to the experts
    ``flat_e`` (T*K,): ``(slot, keep)``, as :func:`moe_route` returns
    them (ranks from a stable sort by expert; the drop bin ``E * C``)."""
    n = flat_e.shape[0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    run_start = torch.searchsorted(
        sorted_e, torch.arange(E, device=flat_e.device, dtype=sorted_e.dtype))
    rank_sorted = torch.arange(n, device=flat_e.device) - run_start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)     # E*C = drop bin
    return slot, keep


def _moe_dispatch(xt, moe, cfg: ModelConfig, capacity_factor):
    """Routing of the tokens ``xt`` (T, D) by ``moe``'s router
    (:func:`moe_route`) and their dispatch: ``(h (E, C, D) the experts'
    inputs, keep, slot, top_p, aux)`` (:func:`moe_apply`)."""
    m: MoEConfig = cfg.moe
    T, D = xt.shape
    E, K = m.n_experts, m.top_k
    probs, top_p, flat_e, slot, keep, C = moe_route(moe, xt, cfg,
                                                    capacity_factor)
    x_rep = xt.repeat_interleave(K, dim=0)                  # (T*K, D)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, x_rep)
    me = probs.mean(dim=0)                                  # (E,)
    ce = torch.zeros((E,), dtype=f32, device=xt.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=f32)) / T
    aux = E * torch.sum(me * ce)
    return buf[:-1].reshape(E, C, D), keep, slot, top_p, aux


def _moe_experts(moe: MoE, h, dtype):
    """The experts' SwiGLU over their inputs h (E, C, D) as batched
    matmuls, SiLU * up in float32."""
    g = F.silu(torch.bmm(h, moe.w_gate).to(f32))
    u = torch.bmm(h, moe.w_up).to(f32)
    return torch.bmm((g * u).to(dtype), moe.w_down)


def _moe_combine(y, keep, slot, top_p, K: int):
    """Each kept pair's expert output from y (E, C, D), times its weight
    in y's dtype, summed over the K choices: (T, D)."""
    E, C, D = y.shape
    y_slots = y.reshape(E * C, D)
    gathered = torch.where(keep[:, None],
                           y_slots[torch.clamp(slot, max=E * C - 1)],
                           torch.zeros((), dtype=y.dtype, device=y.device))
    weighted = gathered * top_p.reshape(-1)[:, None].to(y.dtype)
    return weighted.reshape(-1, K, D).sum(dim=1)


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: Optional[float] = None):
    """x: (B, S, D) -> (out (B, S, D), aux ()).  Routing by
    :func:`moe_route`; the kept pairs are scattered into an (E*C + 1, D)
    buffer in x's dtype (each kept slot gets exactly one token, so the
    add is exact), the experts run as batched matmuls with SiLU * up in
    float32, and each pair's output, times its renormalised weight in x's
    dtype, is summed over the K choices in x's dtype; then the shared
    expert.  ``aux = E * sum(mean probs * assignment share)``, the JAX
    function's load-balance term.

    On DTensors (a step on a mesh) the routing, dispatch and combine run
    whole on every rank (``local_map`` over replicated operands: DTensor
    has no rule for the routing's sort and searchsorted, and the capacity
    is the global batch's) and the experts' products on DTensors, the
    expert stacks sharded as their rules say."""
    m: MoEConfig = cfg.moe
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map
        mesh = x.device_mesh
        R = [Replicate()] * mesh.ndim
        h, keep, slot, top_p, aux = local_map(
            lambda a, r: _moe_dispatch(a, SimpleNamespace(router=r), cfg,
                                       capacity_factor),
            out_placements=(R,) * 5, in_placements=(R, R),
            device_mesh=mesh, redistribute_inputs=True)(xt, moe.router)
        y = _moe_experts(moe, h, x.dtype)
        out = local_map(lambda *a: _moe_combine(*a, m.top_k),
                        out_placements=R, in_placements=(R,) * 4,
                        device_mesh=mesh, redistribute_inputs=True)(
            y, keep, slot, top_p)
    else:
        h, keep, slot, top_p, aux = _moe_dispatch(xt, moe, cfg,
                                                  capacity_factor)
        out = _moe_combine(_moe_experts(moe, h, x.dtype), keep, slot,
                           top_p, m.top_k)
    if m.n_shared:
        out = out + mlp_apply(moe.shared, xt)
    return out.reshape(B, S, D), aux


__all__ = [
    "rmsnorm_spec", "rmsnorm", "RMSNorm", "rope_freqs", "apply_rope",
    "default_mrope_sections", "flash_attention", "decode_attention",
    "attention_spec", "Attention", "split_heads", "out_proj", "pin_qkv",
    "attention_qkv", "attention_apply",
    "attention_decode", "mla_spec", "MLA", "mla_apply", "mla_decode",
    "mlp_spec", "SwiGLU", "mlp_apply", "moe_spec",
    "MoE", "moe_route", "moe_slots", "moe_apply",
]
