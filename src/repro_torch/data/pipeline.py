# Port of repro/data/pipeline.py (the JAX package): the same numpy draws, returned as torch tensors on a device.
"""Deterministic synthetic token pipeline.

Step-indexed PRNG: batch ``i`` is a pure function of (seed, step), so a
restarted job resumes mid-stream with no duplicated or skipped batches
(the checkpoint stores only the step counter).  The draws are the JAX
package's numpy draws, unchanged, so the tokens (and Whisper's frames)
equal its batches exactly; the arrays go to ``device`` as torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # synthetic zipf-ish unigram LM so losses are non-trivial
    zipf_a: float = 1.1


def batch_for_step(cfg: ModelConfig, shape: ShapeConfig, step: int,
                   data_cfg: DataConfig = DataConfig(),
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Pure function (config, step) -> training batch on ``device`` (None:
    the CUDA device): ``tokens`` / ``labels`` (B, S) int32, the encdec
    family's ``frames`` (B, S, D) bf16, the vlm family's
    ``mrope_positions`` (3, B, S) int32."""
    device = resolve_device(device)
    rng = np.random.default_rng(
        np.random.SeedSequence([data_cfg.seed, step]))
    B, S = shape.global_batch, shape.seq_len
    # zipf-distributed tokens clipped to vocab
    toks = rng.zipf(data_cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
    toks = np.minimum(toks, cfg.vocab - 1).astype(np.int32)
    batch = {
        "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
        "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
    }
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, S, cfg.d_model), np.float32)
        batch["frames"] = torch.from_numpy(frames).to(torch.bfloat16)
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
        batch["mrope_positions"] = torch.from_numpy(
            np.ascontiguousarray(np.broadcast_to(pos[None], (3, B, S))))
    return {k: v.to(device) for k, v in batch.items()}


def stream(cfg: ModelConfig, shape: ShapeConfig, start_step: int = 0,
           data_cfg: DataConfig = DataConfig(),
           device: DeviceLike = None) -> Iterator[Dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, shape, step, data_cfg, device)
        step += 1


__all__ = ["DataConfig", "batch_for_step", "stream"]
