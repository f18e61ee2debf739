# Port of repro/train/optimizer.py (the JAX package): AdamW with global-norm clipping, the same rules, over trees of torch tensors updated in place.
"""AdamW with global-norm clipping: float32 moments over bf16 params.

Plain functions over trees (nested dicts of tensors, flattened as JAX
flattens them: dict keys sorted), not ``torch.optim.AdamW``, which keeps
its moments in the parameter dtype and rounds in another order.  The rules
are the JAX function's: float32 moments; the learning rate from the step
before the increment, the bias corrections from the step after it; clip
scale ``min(1, clip / max(gnorm, 1e-9))``; weight decay added to the update
before the learning rate, on every leaf; ``p.float() - lr * delta`` cast
back to the parameter dtype.  ``adamw_update`` writes the new parameters
and moments into the given tensors (the JAX function returns new trees):
the model's layer parameters are views of its stacked tensors, so the
stacked tree a checkpoint saves is the trained one.  Everything stays on
the device: the step counter and every scalar are 0-d tensors, and nothing
reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    m: Any                 # the params' tree, float32
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in JAX's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def adamw_init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=f32, device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l.to(f32) ** 2)
                          for l in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state: OptState, params
                 ) -> Tuple[OptState, torch.Tensor]:
    """One AdamW step: ``params``, ``opt_state.m`` and ``.v`` are updated in
    place.  Returns (the new OptState, the pre-clip grad norm)."""
    step = opt_state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, opt_state.step)
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(f32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(f32))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state.m), tree_leaves(opt_state.v)):
        g = g.to(f32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return OptState(step, opt_state.m, opt_state.v), gnorm


__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "global_norm", "tree_leaves", "tree_map"]
