"""Plain PyTorch versions of the mask-scoring kernels.

Port of ``repro/kernels/ref.py``: direct slot-template math over free
masks (bit b set == block b free), no lookup tables.  The CUDA kernels in
``csrc/mask_scores.cu`` compute the same functions with the same float32
operation order, so on equal inputs they agree bit for bit:

  * ``cc_ref``        — Configuration Capability (Eq. 1)
  * ``frag_ref``      — fragmentation metric (Algorithm 4)
  * ``mcc_score_ref`` — post-default-assign CC (Algorithm 6 inner loop)
  * ``ecc_score_ref`` — expectation-weighted CC (Algorithm 7 inner loop)
  * ``mcc_pick_ref`` / ``ecc_pick_ref`` — the replay's MCC/MECC pick: host
    headroom, score, first maximizer (``repro/core/batched.py``
    ``_kernel_pick``), the plain versions of the fused pick kernels

Every function takes (N,) integer masks on any device and a
:class:`repro_torch.core.mig.DeviceModel`.

``flash_attention_ref`` is the plain version of the attention kernels
(``csrc/flash_attention_sm90.cu``, bf16 and float32): a port of
``repro/models/layers.py``'s chunked online-softmax attention
(``_attend_block``, ``_expand_kv``, ``flash_attention``), chunk for chunk.
The kernels compute the same function in their own tiles, so they agree
with it to float32 rounding, not bit for bit.  ``split_bf16x3`` is the
kernels' split of a float32 value into three bf16 terms (of p in
registers; of float32 q, k and v by the split kernel, bit for bit), which
lets their products run on the tensor cores without rounding.
``flash_attention_bwd_ref`` is the plain version of the backward kernels
(``csrc/flash_attention_bwd_sm90.cu``): the gradient of
``flash_attention_ref`` from its output and row log-sum-exp
(``return_lse``), the same formulas in float32 over the same chunks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.mig import A100_40GB, DeviceModel


def _popcount(x: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Population count of the low ``num_bits`` bits."""
    total = torch.zeros_like(x)
    for b in range(num_bits):
        total = total + ((x >> b) & 1)
    return total


def cc_ref(masks: torch.Tensor,
           model: DeviceModel = A100_40GB) -> torch.Tensor:
    """CC(G) = number of (profile, start) slots placeable in free mask G."""
    m = masks.to(torch.int32)
    cc = torch.zeros_like(m)
    for sm in model.slot_masks:
        cc = cc + ((m & sm) == sm).to(torch.int32)
    return cc


def frag_ref(masks: torch.Tensor,
             model: DeviceModel = A100_40GB) -> torch.Tensor:
    """Algorithm 4's Fragmentation: greedily pack each profile in order
    (mutating the working copy across profiles); after each applicable
    profile add (remaining free blocks / profile size) in float32."""
    free = masks.to(torch.int32)
    frag = torch.zeros(free.shape, dtype=torch.float32, device=free.device)
    for pi, p in enumerate(model.profiles):
        applies = _popcount(free, model.num_blocks) >= p.size
        for sm in model.profile_slot_masks[pi]:
            take = (free & sm) == sm
            free = torch.where(take, free & ~sm, free)
        frag = frag + torch.where(
            applies, _popcount(free, model.num_blocks).to(torch.float32)
            / p.size, 0.0)
    return frag


def mcc_score_ref(masks: torch.Tensor, profile_idx: int,
                  model: DeviceModel = A100_40GB) -> torch.Tensor:
    """Best post-assignment CC over the profile's legal starts, -1 where
    the profile can't fit."""
    m = masks.to(torch.int32)
    best = torch.full_like(m, -1)
    for sm in model.profile_slot_masks[profile_idx]:
        fits = (m & sm) == sm
        cc_after = cc_ref(m & ~sm, model)
        best = torch.where(fits, torch.maximum(best, cc_after), best)
    return best


def ecc_score_ref(masks: torch.Tensor, profile_idx: int,
                  probs: torch.Tensor,
                  model: DeviceModel = A100_40GB) -> torch.Tensor:
    """ECC after placing ``profile_idx`` with the default policy:
    sum_p P(p) * |S(G_after, p)| at the CC-maximizing (first-max) start,
    summed in profile order in float32; -1.0 where the profile can't fit.
    ``probs`` is a (num_profiles,) float32 tensor on the masks' device."""
    m = masks.to(torch.int32)
    best_cc = torch.full_like(m, -1)
    best_after = m
    for sm in model.profile_slot_masks[profile_idx]:
        fits = (m & sm) == sm
        after = m & ~sm
        cc_after = torch.where(fits, cc_ref(after, model), -1)
        better = cc_after > best_cc          # strict: keeps FIRST maximizer
        best_after = torch.where(better, after, best_after)
        best_cc = torch.maximum(best_cc, cc_after)
    probs = probs.to(torch.float32)
    ecc = torch.zeros(m.shape, dtype=torch.float32, device=m.device)
    for pi in range(model.num_profiles):
        count = torch.zeros_like(m)
        for sm in model.profile_slot_masks[pi]:
            count = count + ((best_after & sm) == sm).to(torch.int32)
        ecc = ecc + probs[pi] * count.to(torch.float32)
    return torch.where(best_cc >= 0, ecc, -1.0)


def _host_ok(gpu_host, host_used, cap_g, need) -> torch.Tensor:
    """GPUs whose host has headroom for ``need`` (float32, per resource)."""
    return (host_used[gpu_host] + need <= cap_g).all(dim=1)


def _pick(scores: torch.Tensor) -> torch.Tensor:
    """First maximizer of ``scores`` if any is >= 0, else -1 ((1,))."""
    return torch.where((scores >= 0).any(), torch.argmax(scores).reshape(1),
                       -1)


def mcc_pick_ref(free, gpu_host, host_used, cap_g, need, profile_idx: int,
                 model: DeviceModel = A100_40GB) -> torch.Tensor:
    """MCC pick of one arrival: the first GPU maximizing ``mcc_score_ref``
    where the host has headroom, -1 if no such score is >= 0 -> (1,)."""
    ok = _host_ok(gpu_host, host_used, cap_g, need)
    scores = torch.where(ok, mcc_score_ref(free, profile_idx, model), -1)
    return _pick(scores)


def ecc_pick_ref(free, gpu_host, host_used, cap_g, need, profile_idx: int,
                 probs: torch.Tensor,
                 model: DeviceModel = A100_40GB) -> torch.Tensor:
    """MECC pick of one arrival, as :func:`mcc_pick_ref` with
    ``ecc_score_ref`` under ``probs`` -> (1,)."""
    ok = _host_ok(gpu_host, host_used, cap_g, need)
    scores = torch.where(ok, ecc_score_ref(free, profile_idx, probs, model),
                         -1.0)
    return _pick(scores)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest) and back to float32."""
    return x.to(torch.bfloat16).float()


def _attend_block(q, k, v, mask, scale, p_bf16: bool = False):
    """q: (B,Sq,H,hd), k/v: (B,Sk,H,hd) (kv pre-expanded to H heads).
    Returns (out (B,H,Sq,hd_v), m, l), all float32.  ``p_bf16`` (JAX's
    ``flags.ATTN_P_BF16``): p and v rounded to bf16 for p @ v, the product
    accumulated in float32 (the statistics stay float32)."""
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float())
    s = s * scale
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)                               # (B,H,Sq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if p_bf16:
        out = torch.einsum("bhqs,bshd->bhqd", _bf16(p), _bf16(v.float()))
    else:
        out = torch.einsum("bhqs,bshd->bhqd", p, v.float())
    return out, m, l


def _expand_kv(k, H):
    """(B,S,KV,hd) -> (B,S,H,hd) by repeating each kv head G times."""
    KV = k.shape[2]
    if KV == H:
        return k
    return k.repeat_interleave(H // KV, dim=2)


def _chunks(Sq, Sk, q_chunk, k_chunk, causal, window, positions_q0=0):
    """(query chunk, first query position, key chunks it visits) of the
    chunked attention: the causal bound and the window's lower bound in
    key-chunk units, as the JAX function's static chunk skipping."""
    assert Sq % q_chunk == 0 and Sk % k_chunk == 0, (Sq, q_chunk, Sk, k_chunk)
    nk = Sk // k_chunk
    for qi in range(Sq // q_chunk):
        q_pos0 = positions_q0 + qi * q_chunk
        hi = nk if not causal else min(
            nk, (q_pos0 + q_chunk + k_chunk - 1) // k_chunk)
        lo = 0
        if window is not None:
            lo = max(0, (q_pos0 - window) // k_chunk)
        yield qi, q_pos0, range(lo, hi)


def _mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        q_chunk: int = 1024, k_chunk: int = 1024,
                        positions_q0: int = 0, return_lse: bool = False,
                        p_bf16: bool = False):
    """Chunked attention with online softmax (float32 statistics and
    accumulator), output in q's dtype.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    ``positions_q0``: absolute position of q[0].  Query chunk i visits only
    the key chunks inside its causal bound (and from its window's lower
    bound).  Masked scores are -1e30, as in the JAX function.  With
    ``return_lse`` returns ``(out, lse)``: lse (B, H, Sq) float32, each
    row's m + log(l), what the kernels store for the backward.
    ``p_bf16``: JAX's ``ATTN_P_BF16`` function, each chunk's p rounded to
    bf16 against that chunk's own row max (:func:`_attend_block`).
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    hd_v = v.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)

    dev = q.device
    outs, lses = [], []
    for qi, q_pos0, kis in _chunks(Sq, Sk, q_chunk, k_chunk, causal, window,
                                   positions_q0):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        acc = torch.zeros((B, H, q_chunk, hd_v), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, H, q_chunk), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        qpos = q_pos0 + torch.arange(q_chunk, device=dev)
        for ki in kis:
            k_blk = k[:, ki * k_chunk:(ki + 1) * k_chunk]
            v_blk = v[:, ki * k_chunk:(ki + 1) * k_chunk]
            kpos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            mask = _mask(qpos, kpos, causal, window)
            o_b, m_b, l_b = _attend_block(q_blk, k_blk, v_blk,
                                          mask[None, None], scale, p_bf16)
            m_new = torch.maximum(m, m_b)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(m_b - m_new)
            acc = acc * alpha[..., None] + o_b * beta[..., None]
            l = l * alpha + l_b * beta
            m = m_new
        out_blk = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B,H,q_chunk,hd_v) -> (B,q_chunk,H,hd_v)
        outs.append(out_blk.transpose(1, 2).to(q.dtype))
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0].contiguous()
    if not return_lse:
        return out
    return out, torch.cat(lses, dim=2)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            q_chunk: int = 1024, k_chunk: int = 1024,
                            p_bf16: bool = False):
    """Gradient of :func:`flash_attention_ref` -> (dq, dk, dv) in q's, k's
    and v's dtypes: the plain version of ``flash_attention_bwd_sm90.cu``,
    the same formulas in float32 over the same chunks as the forward.

    o: the forward's output and lse (B, H, Sq) its saved log-sum-exp; do:
    the output's gradient.  D = rowsum(do * o); per visited key chunk P =
    exp(scale q k^T - lse) where the mask keeps the pair, else 0; dV += P^T
    do; dS = P * (do v^T - D); dQ += scale dS K; dK += scale dS^T Q, on the
    expanded K/V, then each KV head's group of query heads summed.

    ``p_bf16``: the gradient of the ``p_bf16`` forward as ``jax.vjp`` of
    JAX's chunked attention forms it with ``ATTN_P_BF16`` (read off its
    jaxpr).  Per chunk pair, with m_b the chunk's row max of the masked
    scores, p = exp(s - m_b) and c = exp(m_b - lse) (the chunk's weight in
    the output, so P = c p): the cotangent of the bf16 p is c (do . bf16(v))
    rounded to bf16 (``dpr``), dS = p (dpr - c D); the chunk's row max
    takes T = c sum bf16(p) dP - sum p dpr (its cotangent through the merge
    weight and through p, which no longer cancel), added to dS at the
    row's maximal scores, split evenly over ties (``reduce_max``'s
    gradient); and each chunk pair's dV, bf16(p)^T (c do), is rounded to
    bf16 before it is summed over query chunks and the group's heads.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    f = torch.float32
    qf, dof = q.to(f), do.to(f)
    kf, vf = _expand_kv(k.to(f), H), _expand_kv(v.to(f), H)
    if p_bf16:
        vf = _bf16(vf)
    D = (dof * o.to(f)).sum(-1).transpose(1, 2)          # (B, H, Sq)
    dq = torch.zeros((B, Sq, H, hd), dtype=f, device=q.device)
    dk = torch.zeros((B, Sk, H, hd), dtype=f, device=q.device)
    dv = torch.zeros((B, Sk, H, hd_v), dtype=f, device=q.device)
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    dev = q.device
    for qi, q_pos0, kis in _chunks(Sq, Sk, q_chunk, k_chunk, causal, window):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        q_blk, do_blk = qf[:, qs], dof[:, qs]
        lse_blk, D_blk = lse[:, :, qs, None], D[:, :, qs, None]
        qpos = q_pos0 + torch.arange(q_chunk, device=dev)
        for ki in kis:
            ks = slice(ki * k_chunk, (ki + 1) * k_chunk)
            k_blk, v_blk = kf[:, ks], vf[:, ks]
            kpos = ki * k_chunk + torch.arange(k_chunk, device=dev)
            mask = _mask(qpos, kpos, causal, window)[None, None]
            s = torch.einsum("bqhd,bshd->bhqs", q_blk, k_blk) * scale
            if p_bf16:
                ds = _p_bf16_block_grad(s, mask, lse_blk, D_blk, do_blk,
                                        v_blk, dv[:, ks])
            else:
                p = torch.where(mask, torch.exp(torch.where(
                    mask, s - lse_blk, 0.0)), 0.0)
                dv[:, ks] += torch.einsum("bhqs,bqhd->bshd", p, do_blk)
                dp = torch.einsum("bqhd,bshd->bhqs", do_blk, v_blk)
                ds = p * (dp - D_blk)
            dq[:, qs] += torch.einsum("bhqs,bshd->bqhd", ds, k_blk) * scale
            dk[:, ks] += torch.einsum("bhqs,bqhd->bshd", ds, q_blk) * scale
    G = H // KV
    dk = dk.reshape(B, Sk, KV, G, hd).sum(3)
    dv = dv.reshape(B, Sk, KV, G, hd_v).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _p_bf16_block_grad(s, mask, lse, D, do, vb, dv_out):
    """dS of one chunk pair of the ``p_bf16`` gradient
    (:func:`flash_attention_bwd_ref`), its dV added into ``dv_out`` (B,
    k_chunk, H, hd_v) in place.  s: the scaled scores (B, H, q, k); lse, D:
    (B, H, q, 1); do: (B, q, H, hd_v); vb: bf16(v) upcast (B, k, H,
    hd_v)."""
    sm = torch.where(mask, s, -1e30)
    m_b = sm.amax(dim=-1, keepdim=True)
    p = torch.exp(sm - m_b)
    c = torch.exp(m_b - lse)
    pb = _bf16(p)
    dp = torch.einsum("bqhd,bshd->bhqs", do, vb)
    dpr = _bf16(c * dp)
    ds = p * (dpr - c * D)
    t = (c * pb * dp - p * dpr).sum(-1, keepdim=True)
    ties = (sm == m_b).float()
    ds = torch.where(mask, ds + ties * (t / ties.sum(-1, keepdim=True)), 0.0)
    c_do = c.squeeze(-1).transpose(1, 2)[..., None] * do
    dv_out += _bf16(torch.einsum("bhqs,bqhd->bshd", pb, c_do))
    return ds


def split_bf16x3(p: torch.Tensor):
    """float32 p -> bf16 (hi, mid, lo): hi = bf16(p), mid = bf16(p - hi),
    lo = bf16(p - hi - mid), each rounded to nearest, the subtractions
    exact in float32.  hi + mid + lo == p exactly for 2^-110 <= |p| <=
    3.39e38 (24 significant bits = 8 + 8 + 8; below, lo is a bf16
    subnormal; above, bf16 rounding overflows), so each term times a bf16
    v is exact in float32 and three bf16 products sum to the float32 p @
    v.  This is what ``fa_fwd_wgmma`` does to p in registers, and
    ``split_bf16x3_kernel`` to float32 q, k and v."""
    p = p.to(torch.float32)
    hi = p.to(torch.bfloat16)
    r = p - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


__all__ = ["cc_ref", "frag_ref", "mcc_score_ref", "ecc_score_ref",
           "mcc_pick_ref", "ecc_pick_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "split_bf16x3"]
