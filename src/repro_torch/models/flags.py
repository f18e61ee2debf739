# Port of repro/models/flags.py (the JAX package): the remat and cross-entropy switches, and the activation axes, which pin DTensor activations on a mesh; the XLA-cost switches are identities.
"""Lowering-mode flags of the training path.

``REMAT_MODE``: how each layer body is rematerialised under grad by
:func:`remat_wrap`: ``"full"`` (checkpoint everything, recompute the whole
body in the backward: the baseline, least memory), ``"dots"`` (save the
matmul outputs, recompute the cheap elementwise tail), ``"none"`` (no
remat: most memory, fewest FLOPs).  ``CE_MODE``: ``"dense"`` materialises
the logits; ``"chunked"`` is the fused lm-head + online-logsumexp cross
entropy over vocab chunks (``train.step.chunked_cross_entropy``).

The activation axes (``BATCH_AXES`` / ``HEAD_AXES`` / ``KV_HEAD_AXES`` /
``KV_SEQ_AXES``) are JAX's: ``None`` (the default: one card, no mesh)
turns every pin off; ``launch.dryrun.lower_cell`` and a step that
``registry.make_step`` builds on a mesh set them for the step
(:func:`activation_axes`), as JAX's ``lower_cell`` does.  Where one is set
and the tensor is a ``torch.distributed`` DTensor, :func:`constrain`
redistributes it to the placements that ``PS(*parts)`` names on its mesh
(``launch.sharding.placements``): the counterpart of
``with_sharding_constraint``, with the collectives DTensor picks for the
move.  A plain tensor, or any tensor while no axis is set, is returned
unchanged, so every single-card path is untouched.  Two things differ
from GSPMD: a mesh axis that does not divide the dimension is dropped
(the dimension replicated over it, as ``logical_to_pspec`` does for
parameters; GSPMD would pad), and a mesh axis already used by an earlier
dimension is dropped.

Its other switches are about XLA's cost model and its jnp attention:
``COST_UNROLL`` / :func:`unroll` (scan unrolling for ``cost_analysis``;
the port's loops are Python loops, and the meta count of
``launch.dryrun`` sees every iteration) and ``ATTN_P_BF16`` (a bf16 p
tile; the port's attention kernel keeps p in float32, the JAX default).
``unroll`` is an identity, and ``COST_UNROLL`` and ``ATTN_P_BF16`` are not
ported.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import is_dtensor
from ..launch.sharding import placements

REMAT_MODE = "full"
CE_MODE = "dense"

# Mesh axes of the activation pins (JAX's names and meanings): the batch
# dim's, the heads', the kv heads' (set only where the kv heads divide the
# model axis) and the decode cache's sequence dim (where they do not).
BATCH_AXES = None
HEAD_AXES = None
KV_HEAD_AXES = None
KV_SEQ_AXES = None

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


@contextlib.contextmanager
def activation_axes(batch=None, heads=None, kv_heads=None, kv_seq=None):
    """``BATCH_AXES`` / ``HEAD_AXES`` / ``KV_HEAD_AXES`` / ``KV_SEQ_AXES``
    set for the block and restored after it, also when it raises."""
    global BATCH_AXES, HEAD_AXES, KV_HEAD_AXES, KV_SEQ_AXES
    old = BATCH_AXES, HEAD_AXES, KV_HEAD_AXES, KV_SEQ_AXES
    BATCH_AXES, HEAD_AXES, KV_HEAD_AXES, KV_SEQ_AXES = (batch, heads,
                                                        kv_heads, kv_seq)
    try:
        yield
    finally:
        BATCH_AXES, HEAD_AXES, KV_HEAD_AXES, KV_SEQ_AXES = old


def _axes_of(d):
    return {"batch": BATCH_AXES, "heads": HEAD_AXES,
            "kv_heads": KV_HEAD_AXES, "kv_seq": KV_SEQ_AXES}.get(d)


def pinned_spec(shape: Tuple[int, ...], dim_axes, mesh
                ) -> Tuple[Optional[object], ...]:
    """The spec ``constrain(x, *dim_axes)`` pins an ``x`` of ``shape`` to
    on ``mesh`` (a DeviceMesh): per dim the mesh axes its logical name
    holds, less those the mesh lacks, those an earlier dim took, and all
    of them where their size does not divide the dim."""
    names = mesh.mesh_dim_names
    used, parts = set(), []
    for n, d in zip(shape, dim_axes):
        axes = _axes_of(d)
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        axes = tuple(a for a in axes if a in names and a not in used)
        size = 1
        for a in axes:
            size *= mesh.size(names.index(a))
        if not axes or n % size:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def pinned_placements(x, *dim_axes):
    """DTensor placements of :func:`pinned_spec` on ``x``'s mesh."""
    mesh = x.device_mesh
    return placements(pinned_spec(tuple(x.shape), dim_axes, mesh),
                      mesh.mesh_dim_names)


def pins_on() -> bool:
    return BATCH_AXES is not None or HEAD_AXES is not None


def constrain(x, *dim_axes):
    """JAX's ``with_sharding_constraint(x, PS(*parts))``: a DTensor ``x``
    redistributed to :func:`pinned_placements` while an axis is set, and
    its gradient redistributed to them in the backward; ``dim_axes``
    entries ``"batch"``, ``"heads"``, ``"kv_heads"``, ``"kv_seq"`` or None
    (unsharded).  Otherwise ``x`` unchanged."""
    if not pins_on() or not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    want = tuple(pinned_placements(x, *dim_axes))
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    # The gradient is pinned too, as JAX's constraint pins the cotangent:
    # from_local's backward moves the incoming gradient to ``want``.
    return DTensor.from_local(x.to_local(grad_placements=want),
                              x.device_mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


__all__ = ["REMAT_MODE", "CE_MODE", "BATCH_AXES", "HEAD_AXES",
           "KV_HEAD_AXES", "KV_SEQ_AXES", "activation_axes", "pinned_spec",
           "pinned_placements", "pins_on", "remat_wrap", "unroll",
           "constrain"]
