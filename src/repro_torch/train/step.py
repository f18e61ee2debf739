# Port of repro/train/step.py (the JAX package): causal-LM loss, micro-batched float32 gradient accumulation, AdamW.
"""Training step: causal-LM loss, micro-batched gradient accumulation,
AdamW.

``make_train_step(cfg)`` builds ``train_step(model, opt_state, batch) ->
(opt_state, metrics)``: autograd through :func:`lm_loss` (the attention
through its kernels' backward, ``kernels.flash_attention``; each layer body
rematerialised per ``models.flags.REMAT_MODE``), then
:func:`..train.optimizer.adamw_update` on the model's stacked parameter
tree, in place.  ``n_micro > 1`` splits the batch along its leading axis
and accumulates float32 gradients ``g / n_micro`` micro-batch by
micro-batch, as the JAX step's ``lax.scan`` does; memory scales with
1 / n_micro, FLOPs unchanged.  Metrics are 0-d tensors (``loss``, ``aux``,
``grad_norm``); the step reads nothing back to the host.

The gold logit is gathered (``gather``), never through a one-hot: the JAX
function's one-hot contraction ``x * 1 + sum(0 * others)`` is that value
exactly.  On DTensors (a step on a mesh) it is that contraction, as a
``where`` and a sum over the vocab, which DTensor shards like the logits
(its rule for a gather over a sharded vocab is the embedding's and fails
here).  Parameters, gradients and moments may be DTensors: each is
accumulated and updated under its own placements.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..models import flags
from ..models import transformer as M
from ..models.config import ModelConfig
from .optimizer import (AdamWConfig, OptState, adamw_update, tree_leaves,
                        tree_map)

f32 = torch.float32

AUX_WEIGHT = 0.01   # MoE load-balance loss weight


def _gold(logits, labels):
    """``logits[..., labels]`` (labels in range): a gather, or on a DTensor
    the one-hot contraction (the module docstring)."""
    if is_dtensor(logits):
        V = logits.shape[-1]
        hit = labels[..., None] == torch.arange(V, device=labels.device)
        return torch.where(hit, logits, 0.0).sum(dim=-1)
    return logits.gather(-1, labels[..., None])[..., 0]


def _mean_nll(nll, mask):
    if mask is None:
        return nll.mean()
    mask = mask.to(f32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_cross_entropy(hidden, weight, labels, *, tied: bool,
                          chunk: int = 8192, mask=None):
    """Fused lm-head + CE over vocab chunks with an online logsumexp: the
    full (B, S, V) logits are never materialised.  ``weight``: the
    embedding (V, D) when tied, else lm_head (D, V)."""
    B, S, D = hidden.shape
    w = weight if tied else weight.T              # (V, D)
    V = w.shape[0]
    pad = (-V) % chunk
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    nc = w.shape[0] // chunk
    dev = hidden.device
    m = torch.full((B, S), -1e30, dtype=f32, device=dev)
    s = torch.zeros((B, S), dtype=f32, device=dev)
    g = torch.zeros((B, S), dtype=f32, device=dev)
    labels = labels.long()
    for ci in range(nc):
        w_c = w[ci * chunk:(ci + 1) * chunk]
        logits_c = (hidden @ w_c.T).to(f32)       # (B, S, chunk)
        base = ci * chunk
        valid = base + torch.arange(chunk, device=dev) < V
        logits_c = torch.where(valid, logits_c, -1e30)
        m_c = logits_c.amax(dim=-1)
        m_new = torch.maximum(m, m_c)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits_c - m_new[..., None]).sum(dim=-1)
        local = labels - base
        gold = _gold(logits_c, local.clamp(0, chunk - 1))
        in_chunk = ((local >= 0) & (local < chunk)).to(f32)
        g = g + in_chunk * gold
        m = m_new
    nll = (m + torch.log(torch.clamp(s, min=1e-30))) - g
    return _mean_nll(nll, mask)


def cross_entropy(logits, labels, mask=None):
    """logits (B, S, V) any float dtype; labels (B, S) int. float32 math."""
    logits = logits.to(f32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, labels.long())
    return _mean_nll(lse - gold, mask)


def lm_loss(model, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """(loss + AUX_WEIGHT * aux, (loss, aux)) of ``batch`` under every
    family's forward.  Whisper's frames go in at the model's dtype (JAX
    keeps the first norm's output at the frames' bf16 under a float32
    model; the tests feed both packages float32 frames there)."""
    kw = {}
    if cfg.family == "vlm" and "mrope_positions" in batch:
        kw["mrope_positions"] = batch["mrope_positions"]
    if cfg.family == "encdec":
        enc = M.encode(model, batch["frames"].to(model.embedding.dtype), cfg)
        hidden, aux = M.forward(model, batch["tokens"], cfg, encoder_out=enc)
    elif cfg.family == "hybrid":
        hidden, aux = M.hybrid_forward(model, batch["tokens"], cfg)
    else:
        hidden, aux = M.forward(model, batch["tokens"], cfg, **kw)
    if flags.CE_MODE == "chunked":
        weight = (model.embedding if cfg.tie_embeddings else model.lm_head)
        loss = chunked_cross_entropy(hidden, weight, batch["labels"],
                                     tied=cfg.tie_embeddings,
                                     mask=batch.get("mask"))
    else:
        logits = M.logits_fn(model, hidden, cfg)
        loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + AUX_WEIGHT * aux, (loss, aux)


def split_micro(batch: Dict[str, torch.Tensor], n_micro: int):
    """The micro-batches: each entry cut into ``n_micro`` equal parts along
    its batch axis (axis 1 of the vlm family's (3, B, S)
    ``mrope_positions``; JAX's ``split_micro`` cuts its leading axis, 3,
    which no n_micro > 1 but 3 divides)."""
    def cut(name, x):
        axis = 1 if name == "mrope_positions" else 0
        b = x.shape[axis]
        assert b % n_micro == 0, (name, b, n_micro)
        return x.chunk(n_micro, dim=axis)
    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n_micro)]


def _placed_as(y, like):
    """``y`` under ``like``'s placements where both are DTensors (a
    gradient may come back Partial or otherwise laid out)."""
    if is_dtensor(y) and tuple(y.placements) != tuple(like.placements):
        return y.redistribute(like.device_mesh, like.placements)
    return y


def _backward(model, batch, cfg):
    """Gradients of ``lm_loss`` at ``batch`` -> (stacked grad tree, loss,
    aux)."""
    M.zero_grads(model)
    loss_t, (loss, aux) = lm_loss(model, batch, cfg)
    loss_t.backward()
    return M.stacked_grads(model), loss.detach(), aux.detach()


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    n_micro: int = 1):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``;
    ``model`` trainable (``transformer.make_trainable``), updated in
    place."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model, opt_state: OptState, batch):
        if n_micro == 1:
            grads, loss, aux = _backward(model, batch, cfg)
        else:
            grads = None
            loss = aux = 0.0
            for mb in split_micro(batch, n_micro):
                g, l, a = _backward(model, mb, cfg)
                if grads is None:
                    grads = tree_map(lambda x: torch.zeros_like(
                        x, dtype=f32), g)
                for acc, y in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.copy_(acc + _placed_as(y, acc).to(f32) / n_micro)
                del g
                loss = loss + l / n_micro
                aux = aux + a / n_micro
        M.zero_grads(model)
        opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state,
                                        M.stacked_params(model))
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}
        return opt_state, metrics

    return train_step


__all__ = ["make_train_step", "lm_loss", "cross_entropy",
           "chunked_cross_entropy", "split_micro", "AUX_WEIGHT"]
