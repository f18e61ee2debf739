# Port of repro/models/flags.py (the JAX package): the remat and cross-entropy switches; the mesh and XLA-cost switches are identities.
"""Lowering-mode flags of the training path.

``REMAT_MODE``: how each layer body is rematerialised under grad by
:func:`remat_wrap`: ``"full"`` (checkpoint everything, recompute the whole
body in the backward: the baseline, least memory), ``"dots"`` (save the
matmul outputs, recompute the cheap elementwise tail), ``"none"`` (no
remat: most memory, fewest FLOPs).  ``CE_MODE``: ``"dense"`` materialises
the logits; ``"chunked"`` is the fused lm-head + online-logsumexp cross
entropy over vocab chunks (``train.step.chunked_cross_entropy``).

The JAX module's activation axes (``BATCH_AXES`` / ``HEAD_AXES`` /
``KV_HEAD_AXES`` / ``KV_SEQ_AXES``, which its ``lower_cell`` sets for
``with_sharding_constraint``) have no counterpart: the port runs no GSPMD,
so :func:`constrain` returns its tensor unchanged, and the axes wait for a
mesh of more than one card (ROADMAP.md, Queue 2 item 10).  Its other
switches are about XLA's cost model and its jnp attention:
``COST_UNROLL`` / :func:`unroll` (scan unrolling for ``cost_analysis``;
the port's loops are Python loops, and the meta count of
``launch.dryrun`` sees every iteration) and ``ATTN_P_BF16`` (a bf16 p
tile; the port's attention kernel keeps p in float32, the JAX default).
``unroll`` is an identity, and ``COST_UNROLL`` and ``ATTN_P_BF16`` are not
ported.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_MODE = "full"
CE_MODE = "dense"

# "dots": the outputs saved for the backward are those of the plain
# matrix products, JAX's dots_with_no_batch_dims_saveable (x @ W lowers to
# aten.mm; the batched products, attention's and the MoE experts', are
# recomputed as in JAX).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(body: Callable) -> Callable:
    """``body`` rematerialised per ``REMAT_MODE`` when it runs under grad
    (``torch.utils.checkpoint``, non-reentrant); as it is otherwise."""
    if REMAT_MODE == "none":
        return body
    if REMAT_MODE not in ("full", "dots"):
        raise ValueError(f"REMAT_MODE {REMAT_MODE!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        if REMAT_MODE == "dots":
            return checkpoint(
                body, *args, use_reentrant=False,
                context_fn=lambda: create_selective_checkpoint_contexts(
                    _dots_policy))
        return checkpoint(body, *args, use_reentrant=False)
    return wrapped


def unroll(length: int) -> int:
    """Scan unroll factor: the port's loops are Python loops, so 1."""
    return 1


def constrain(x, *dim_axes):
    """JAX's ``with_sharding_constraint``: the port runs no GSPMD, so
    ``x`` unchanged."""
    return x


__all__ = ["REMAT_MODE", "CE_MODE", "remat_wrap", "unroll", "constrain"]
