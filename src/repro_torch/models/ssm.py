# Port of repro/models/ssm.py (the JAX package): Mamba-2 (SSD) and RWKV-6 (Finch).
"""Sub-quadratic sequence mixers: Mamba-2 (SSD) and RWKV-6 (Finch).

Both come in two forms sharing parameters, as in the JAX package:
  * ``*_scan``  — the chunked / sequence form for prefill,
  * ``*_step``  — the single-token recurrent form for decode (the "KV
    cache" is a fixed-size state, independent of context length, which is
    why these architectures run the long_500k cell).

Each block is an ``nn.Module`` holding its parameters under the JAX tree's
names (``Mamba2``: ``in_proj``, ``dt_bias``, ``A_log``, ``D``, ``norm``,
``out_proj``; ``RWKVTimeMix``: ``tm.*``; ``RWKVChannelMix``: ``cm.*``),
beside the plain function of the JAX name that takes it.  The arithmetic is
the reference's: what it computes in float32 stays float32, what it
computes in x's dtype stays there, ``_segsum`` takes differences of one
cumsum.  The JAX package's ``lax.scan``s (the inter-chunk recurrence, the
per-token WKV recurrence) are Python loops here; neither has a Pallas
kernel there.  ``mamba2_scan``'s four-operand einsums are written as fixed
pairwise contractions, so every machine contracts in the same order.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig, SSMConfig
from .layers import _param
from .params import P

f32 = torch.float32
bf16 = torch.bfloat16


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no cutoff."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class _Block(nn.Module):
    """Parameters named and shaped by a flat spec."""

    def __init__(self, spec: Dict[str, P], *, device, dtype):
        super().__init__()
        for name, p in spec.items():
            setattr(self, name, _param(p.shape, device, dtype))


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def mamba2_spec(cfg: ModelConfig) -> Dict[str, P]:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    return {
        "in_proj": P((d, 2 * d_inner + 2 * s.d_state + H),
                     ("embed", "ssm_in")),
        "dt_bias": P((H,), ("ssm_heads",), init="zeros"),
        "A_log": P((H,), ("ssm_heads",), init="zeros"),
        "D": P((H,), ("ssm_heads",), init="ones"),
        "norm": P((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": P((d_inner, d), ("ssm_inner", "embed")),
    }


class Mamba2(_Block):
    """Mamba-2 weights ``in_proj``, ``dt_bias``, ``A_log``, ``D``, ``norm``,
    ``out_proj`` (JAX layout)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__(mamba2_spec(cfg), device=device, dtype=dtype)


# _cumsum's block: XLA's CPU backend sums a cumulative sum in blocks of
# 16 (its reduce-window rewrite), which is the order of the JAX package's
# jnp.cumsum on the CPU.
CUMSUM_BLOCK = 16


def _cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum along ``dim`` in one fixed order of float32 adds, the
    same on every device: within blocks of CUMSUM_BLOCK left to right, then
    the blocks' totals the same way (recursively), each block's carry added
    to its sums.  This is the JAX package's order on the CPU (its values bit
    for bit); a device's own cumsum has another, and at the reference
    init's decays (sums of -dt to ~-400, differenced in ``_segsum``) the
    order moves the chunked form by ~1e-5."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    if n <= CUMSUM_BLOCK:
        out = [a[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + a[..., i])
        return torch.stack(out, dim=-1).movedim(-1, dim)
    nb = -(-n // CUMSUM_BLOCK)
    blocks = F.pad(a, (0, nb * CUMSUM_BLOCK - n)).reshape(
        *a.shape[:-1], nb, CUMSUM_BLOCK)
    within = _cumsum(blocks, -1)
    carry = F.pad(_cumsum(within[..., -1], -1)[..., :-1], (1, 0))
    out = (carry[..., None] + within).reshape(*a.shape[:-1], -1)
    return out[..., :n].movedim(-1, dim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., c) -> cumulative log-decay matrix L[i,j] = sum_{j<k<=i} a_k,
    lower-triangular (-inf above diagonal)."""
    return _segsum_of(_cumsum(a, -1))


def _segsum_of(cs: torch.Tensor) -> torch.Tensor:
    """``_segsum`` from the cumsum ``cs`` of a."""
    c = cs.shape[-1]
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((c, c), dtype=torch.bool, device=cs.device).tril()
    return torch.where(mask, L, -torch.inf)


def _mamba2_in(mamba: Mamba2, x2: torch.Tensor, cfg: ModelConfig):
    """The input projection of x2 (..., D) split into (z, xs, Bm, Cm, dt),
    dt as float32 softplus(dt + dt_bias), and A = -exp(A_log)."""
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * x2.shape[-1]
    N = s.d_state
    zxbcdt = x2 @ mamba.in_proj
    z, xs, Bm, Cm, dt = torch.split(
        zxbcdt, [d_inner, d_inner, N, N, zxbcdt.shape[-1] - 2 * d_inner
                 - 2 * N], dim=-1)
    dt = _softplus(dt.to(f32) + mamba.dt_bias.to(f32))
    A = -torch.exp(mamba.A_log.to(f32))                  # (H,) negative
    return z, xs, Bm, Cm, dt, A


def _mamba2_out(mamba: Mamba2, y: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm (Mamba-2 style) of y (..., d_inner), cast to ``dtype``,
    then the output projection."""
    y = y * _silu(z.to(f32))
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * mamba.norm.to(f32)
    return y.to(dtype) @ mamba.out_proj


def mamba2_scan(mamba: Mamba2, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD. x: (B, S, D) -> (B, S, D).  S % chunk == 0.  The
    cumsum of the log decays is taken once (``_cumsum``, a fixed order) and
    serves ``_segsum``, both decays and each chunk's total (its last entry:
    the chunk's sum in that order, where JAX reduces)."""
    s: SSMConfig = cfg.ssm
    B, S, D = x.shape
    d_inner = s.expand * D
    hd, N = s.head_dim, s.d_state
    H = d_inner // hd
    c = min(s.chunk, S)
    assert S % c == 0, (S, c)
    nc = S // c

    z, xs, Bm, Cm, dt, A = _mamba2_in(mamba, x, cfg)
    xs = xs.reshape(B, S, H, hd)
    a = dt * A                                          # (B,S,H) log decay
    xdt = xs.to(f32) * dt[..., None]                    # input * dt

    # chunk views
    a_c = a.reshape(B, nc, c, H)
    x_c = xdt.reshape(B, nc, c, H, hd)
    B_c = Bm.reshape(B, nc, c, N).to(f32)
    C_c = Cm.reshape(B, nc, c, N).to(f32)

    # 1) intra-chunk (diagonal blocks): "bzln,bzmn,bzhlm,bzmhp->bzlhp" as
    # (C . B) * L, then that over x.
    cs = _cumsum(a_c, 2)                                # (B,nc,c,H)
    L = torch.exp(_segsum_of(cs.permute(0, 1, 3, 2)))  # (B,nc,H,c,c)
    CB = torch.einsum("bzln,bzmn->bzlm", C_c, B_c)
    y_diag = torch.einsum("bzhlm,bzmhp->bzlhp", CB[:, :, None] * L, x_c)
    # 2) chunk-final states: "bzln,bzlh,bzlhp->bzhpn" as B over (decay * x)
    a_sum = cs[:, :, -1]                                # (B,nc,H)
    decay_states = torch.exp(a_sum[:, :, None] - cs)
    states = torch.einsum("bzln,bzlhp->bzhpn", B_c,
                          decay_states[..., None] * x_c)
    # 3) inter-chunk recurrence: the state *entering* each chunk
    st = torch.zeros((B, H, hd, N), dtype=f32, device=x.device)
    decay_chunk = torch.exp(a_sum)                      # (B,nc,H)
    prev = []
    for zi in range(nc):
        prev.append(st)
        st = st * decay_chunk[:, zi, :, None, None] + states[:, zi]
    prev_states = torch.stack(prev, dim=1)              # (B,nc,H,hd,N)
    # 4) state -> output: "bzln,bzlh,bzhpn->bzlhp" as (C . state) * decay
    decay_out = torch.exp(cs)                           # (B,nc,c,H)
    y_off = (torch.einsum("bzln,bzhpn->bzlhp", C_c, prev_states)
             * decay_out[..., None])
    y = (y_diag + y_off).reshape(B, S, H, hd)
    y = y + xs.to(f32) * mamba.D.to(f32)[:, None]
    return _mamba2_out(mamba, y.reshape(B, S, d_inner), z, x.dtype)


def mamba2_init_state(cfg: ModelConfig, batch: int,
                      device: torch.device) -> torch.Tensor:
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    return torch.zeros((batch, H, s.head_dim, s.d_state), dtype=f32,
                       device=device)


def mamba2_step(mamba: Mamba2, x: torch.Tensor, state: torch.Tensor,
                cfg: ModelConfig):
    """Decode step. x: (B, 1, D); state: (B,H,hd,N) float32.  Returns
    (out (B, 1, D), new_state)."""
    s: SSMConfig = cfg.ssm
    B, _, D = x.shape
    d_inner = s.expand * D
    hd = s.head_dim
    H = d_inner // hd
    z, xs, Bm, Cm, dt, A = _mamba2_in(mamba, x[:, 0], cfg)
    xs = xs.reshape(B, H, hd).to(f32)
    decay = torch.exp(dt * A)                           # (B,H)
    xdt = xs * dt[..., None]
    new_state = (state * decay[..., None, None]
                 + xdt[..., None] * Bm.to(f32)[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm.to(f32), new_state)
    y = y + xs * mamba.D.to(f32)[:, None]
    out = _mamba2_out(mamba, y.reshape(B, d_inner), z, x.dtype)
    return out[:, None], new_state


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) time-mix + channel-mix
# ---------------------------------------------------------------------------

def rwkv6_spec(cfg: ModelConfig) -> Dict[str, Dict[str, P]]:
    d = cfg.d_model
    s: SSMConfig = cfg.ssm
    hd = s.head_dim
    H = d // hd
    lora = 64
    return {
        "tm": {  # time-mix
            "mu_r": P((d,), ("embed",), init="zeros"),
            "mu_k": P((d,), ("embed",), init="zeros"),
            "mu_v": P((d,), ("embed",), init="zeros"),
            "mu_g": P((d,), ("embed",), init="zeros"),
            "mu_w": P((d,), ("embed",), init="zeros"),
            "wr": P((d, d), ("embed", "heads")),
            "wk": P((d, d), ("embed", "heads")),
            "wv": P((d, d), ("embed", "heads")),
            "wg": P((d, d), ("embed", "heads")),
            "w0": P((d,), ("heads_vec",), init="zeros"),
            "w_lora_a": P((d, lora), ("embed", None)),
            "w_lora_b": P((lora, d), (None, "heads")),
            "u": P((H, hd), ("ssm_heads", None), init="zeros"),
            "ln_scale": P((d,), ("embed",), init="ones"),
            "wo": P((d, d), ("heads", "embed")),
        },
        "cm": {  # channel-mix
            "mu_k": P((d,), ("embed",), init="zeros"),
            "wk": P((d, cfg.d_ff), ("embed", "mlp")),
            "wv": P((cfg.d_ff, d), ("mlp", "embed")),
            "wr": P((d, d), ("embed", "heads")),
        },
    }


class RWKVTimeMix(_Block):
    """RWKV-6 time-mix weights (the JAX tree's ``tm.*``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__(rwkv6_spec(cfg)["tm"], device=device, dtype=dtype)


class RWKVChannelMix(_Block):
    """RWKV-6 channel-mix weights (the JAX tree's ``cm.*``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__(rwkv6_spec(cfg)["cm"], device=device, dtype=dtype)


def _token_shift(x: torch.Tensor, x_prev_last: torch.Tensor) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 uses the carry (B, D).  Both go to
    their promoted dtype first, as ``jnp.concatenate`` does: a bf16 carry
    joins a float32 x as float32."""
    dtype = torch.promote_types(x.dtype, x_prev_last.dtype)
    return torch.cat([x_prev_last[:, None].to(dtype), x[:, :-1].to(dtype)],
                     dim=1)


def rwkv6_time_mix_scan(tm: RWKVTimeMix, x: torch.Tensor, cfg: ModelConfig,
                        x_last: torch.Tensor, state: torch.Tensor):
    """x: (B,S,D); x_last: (B,D) carry; state: (B,H,hd,hd) float32.
    Returns (out, new_x_last, new_state)."""
    s: SSMConfig = cfg.ssm
    B, S, D = x.shape
    hd = s.head_dim
    H = D // hd
    xs = _token_shift(x, x_last)

    def mix(mu):
        return x + (xs - x) * torch.sigmoid(mu.to(x.dtype))

    r = (mix(tm.mu_r) @ tm.wr).reshape(B, S, H, hd)
    k = (mix(tm.mu_k) @ tm.wk).reshape(B, S, H, hd)
    v = (mix(tm.mu_v) @ tm.wv).reshape(B, S, H, hd)
    g = _silu((mix(tm.mu_g) @ tm.wg).to(f32))
    xw = mix(tm.mu_w)
    w = (tm.w0.to(f32)
         + (torch.tanh((xw @ tm.w_lora_a).to(f32)) @ tm.w_lora_b.to(f32)))
    w = torch.exp(-torch.exp(w.reshape(B, S, H, hd).to(f32)))  # in (0,1)

    u = tm.u.to(f32)[None, :, :, None]                  # (1,H,hd,1)
    st = state                                          # (B,H,hd,hd) [k,v]
    outs = []
    # One token at a time (JAX's lax.scan): "bhk,bhkv->bhv" as a batched
    # (1, hd) @ (hd, hd) matmul.
    for r_t, k_t, v_t, w_t in zip(r.to(f32).unbind(1), k.to(f32).unbind(1),
                                  v.to(f32).unbind(1), w.unbind(1)):
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.matmul(r_t[..., None, :], st + u * kv))
        st = st * w_t[..., None] + kv
    y = torch.cat(outs, dim=2).transpose(1, 2)          # (B,S,H,hd)
    # group norm per head (approx: rmsnorm over head dim), then gate
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + 1e-6)).reshape(B, S, D)
    y = y * tm.ln_scale.to(f32) * g
    out = y.to(x.dtype) @ tm.wo
    return out, x[:, -1], st


def rwkv6_channel_mix(cm: RWKVChannelMix, x: torch.Tensor,
                      x_last: torch.Tensor):
    """Returns (out (B,S,D) in x's dtype, new_x_last)."""
    xs = _token_shift(x, x_last)
    xk = x + (xs - x) * torch.sigmoid(cm.mu_k.to(x.dtype))
    k = torch.square(torch.relu((xk @ cm.wk).to(f32)))
    r = torch.sigmoid((x @ cm.wr).to(f32))
    return ((r * (k.to(x.dtype) @ cm.wv).to(f32)).to(x.dtype),
            x[:, -1])


def rwkv6_init_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    s: SSMConfig = cfg.ssm
    hd = s.head_dim
    H = cfg.d_model // hd
    return {
        "tm_state": torch.zeros((batch, H, hd, hd), dtype=f32,
                                device=device),
        "tm_x": torch.zeros((batch, cfg.d_model), dtype=bf16, device=device),
        "cm_x": torch.zeros((batch, cfg.d_model), dtype=bf16, device=device),
    }


__all__ = ["mamba2_spec", "Mamba2", "mamba2_scan", "mamba2_step",
           "mamba2_init_state", "rwkv6_spec", "RWKVTimeMix",
           "RWKVChannelMix", "rwkv6_time_mix_scan", "rwkv6_channel_mix",
           "rwkv6_init_state"]
