# Port of repro/train/grad_compress.py (the JAX package): the same int8 quantization; the cross-pod sum is an all-reduce over a torch.distributed group.
"""Gradient compression for the cross-pod hop.

At 2+ pods the gradient all-reduce crosses the slow inter-pod links; a
standard trick is hierarchical reduction (reduce-scatter inside the pod,
compressed all-reduce across pods, all-gather back) with int8
quantization on the cross-pod leg only.

``compress`` / ``decompress`` are int8 with a per-tensor float32 scale
(max |x| / 127, at least 1e-12 / 127), ``round`` half to even, clipped to
±127; stochastic rounding adds uniform noise in [-0.5, 0.5) drawn from an
explicit ``torch.Generator`` first (JAX draws from a PRNG key).
``cross_pod_int8`` is JAX's transform: over a ``torch.distributed`` group
(JAX: a named mesh axis) it sums the ranks' int8 values in int32, each
quantized at its own rank's scale, takes the max of the scales, and casts
the int32 sum back to int8 before scaling, as JAX's branch does: that
cast wraps once |sum| > 127 (ROADMAP.md, Queue 3, found in the
reference).  Without a group it is JAX's no-axis fallback, quantize and
dequantize.  Neither package wires it into the train step: JAX's
``make_train_step`` takes no gradient transform.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .optimizer import tree_map

f32 = torch.float32


def compress(x: torch.Tensor, generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 values, float32 0-d scale).  Stochastic rounding if a
    ``generator`` (on x's device) is given."""
    xf = x.to(f32)
    # 127 as a tensor on x's device: CUDA divides by a Python scalar as a
    # product with its reciprocal, which can differ from the quotient in
    # the last place.
    scale = torch.clamp(xf.abs().max(), min=1e-12) / torch.full(
        (), 127.0, device=xf.device)
    y = xf / scale
    if generator is not None:
        y = y + torch.empty_like(y).uniform_(-0.5, 0.5, generator=generator)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = f32) -> torch.Tensor:
    return (q.to(f32) * scale).to(dtype)


def quantization_error(x: torch.Tensor) -> torch.Tensor:
    q, s = compress(x)
    return (decompress(q, s) - x.to(f32)).abs().max()


def cross_pod_int8(grads: Any, group=None) -> Any:
    """Quantize every leaf of ``grads`` (a tensor or nested dict), sum the
    int8 values over ``group``'s ranks in int32 (``all_reduce(SUM)``) and
    take the max scale (``all_reduce(MAX)``), cast the sum to int8 and
    dequantize to the leaf's dtype.  ``group`` None: quantize and
    dequantize."""
    def one(g):
        q, s = compress(g)
        if group is None:
            return decompress(q, s, g.dtype)
        import torch.distributed as dist
        q32 = q.to(torch.int32)
        dist.all_reduce(q32, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        return decompress(q32.to(torch.int8), s, g.dtype)
    return tree_map(one, grads)


__all__ = ["compress", "decompress", "cross_pod_int8",
           "quantization_error"]
