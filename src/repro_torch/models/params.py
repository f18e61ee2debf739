# Port of repro/models/params.py (the JAX package): the same specs, torch init.
"""Parameter-tree utilities: declarative specs -> init / counts.

Every module declares its parameters as a (nested) dict of ``P`` leaves —
shape + logical axis names + initializer.  ``init_tree`` materializes a
spec as a same-structure dict of tensors; ``axes_tree`` gives the
same-structure dict of logical-axis tuples (mapped to mesh axes by
``repro_torch.launch.sharding``); ``param_count`` counts it.

The init rule is the JAX package's exactly: a leaf of rank >= 2 is drawn
with std ``scale / sqrt(shape[0])``, a vector with ``scale /
sqrt(shape[-1])``.  The model calls it on the *stacked* spec, so every
layer matrix has ``fan_in = n_layers`` (the reference model's scale).
The random numbers themselves differ from ``jax.random``'s; tests carry
JAX parameters across with :mod:`.convert` to compare like with like.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_leaf(x) -> bool:
    return isinstance(x, P)


def leaves(spec: Dict[str, Any], prefix: str = "") -> List[Tuple[str, P]]:
    """``(dotted name, P)`` for every leaf, in sorted key order (the order
    ``jax.tree.flatten`` visits a dict)."""
    out = []
    for k in sorted(spec):
        v = spec[k]
        name = f"{prefix}{k}"
        if is_leaf(v):
            out.append((name, v))
        else:
            out.extend(leaves(v, name + "."))
    return out


def init_tensor(p: P, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
    std = p.scale / math.sqrt(fan_in)
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    # In place: the draw of a stacked leaf can be tens of GB (Scout's
    # (8, 16, 5120, 8192) expert stack is 21.5 GB in float32).
    return x.mul_(std).to(device=device, dtype=dtype)


def init_tree(spec: Dict[str, Any], generator: torch.Generator,
              dtype: torch.dtype = torch.bfloat16,
              device: torch.device = torch.device("cpu")) -> Dict[str, Any]:
    """Materialize ``spec`` leaf by leaf, in sorted key order, from
    ``generator`` (which may live on the CPU or on ``device``)."""
    out: Dict[str, Any] = {}
    for k in sorted(spec):
        v = spec[k]
        out[k] = (init_tensor(v, generator, dtype, device) if is_leaf(v)
                  else init_tree(v, generator, dtype, device))
    return out


def axes_tree(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's logical axes, keys in sorted order (as ``jax.tree.map``
    rebuilds a dict)."""
    return {k: spec[k].axes if is_leaf(spec[k]) else axes_tree(spec[k])
            for k in sorted(spec)}


def param_count(spec: Dict[str, Any]) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(spec))


__all__ = ["P", "init_tree", "init_tensor", "axes_tree", "param_count",
           "is_leaf", "leaves"]
