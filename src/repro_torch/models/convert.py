"""Carry a JAX parameter tree across into the port's ``Transformer``.

The JAX package's ``init_params`` returns a nested dict shaped like
``stacked_model_spec``; ``jax.tree.map(np.asarray, params)`` turns it into
numpy arrays, which :func:`params_from_numpy` loads.  Names map one to one
(``params["layers"]["attn"]["wq"][i]`` is ``layers.{i}.attn.wq``; an MoE's
``params["layers"]["ffn"]["w_gate"][i]``, (E, d, f), is
``layers.{i}.ffn.w_gate``; Whisper's ``enc_layers`` / ``dec_layers``
likewise), the ``(d_in, d_out)`` layout is kept, and each stacked layers
axis is split into its ``ModuleList``.  With a ``DeviceMesh`` (``mesh=``)
the tree is committed to it under ``rules`` as ``registry.shard_model``
commits a model: each parameter a DTensor, as JAX's ``in_shardings`` put
its arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .transformer import Transformer, load_stacked


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 included: numpy's bfloat16 (ml_dtypes, what
    ``np.asarray`` of a JAX bf16 array gives) is not a dtype torch reads,
    so its bits go across as uint16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_tensors(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device, dtype) for k, v in tree.items()}
    t = tensor_from_numpy(tree)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None, mesh=None,
                      rules=None) -> Transformer:
    """A ``Transformer`` holding ``tree``'s values on ``device`` (None: the
    CUDA device), in ``dtype`` (None: the arrays' own); on ``mesh`` (a
    ``DeviceMesh`` of ``device``'s type) under ``rules`` where given."""
    device = resolve_device(device)
    tensors = _to_tensors(tree, device, dtype)
    model_dtype = dtype or tensors["embedding"].dtype
    model = load_stacked(Transformer(cfg, device="meta", dtype=model_dtype),
                         tensors)
    if mesh is None:
        return model
    from .registry import shard_model
    return shard_model(model, cfg, mesh, rules)


__all__ = ["params_from_numpy", "tensor_from_numpy"]
