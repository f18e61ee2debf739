"""Batched mask scorers on (N,) masks — port of ``repro/kernels/ops.py``.

Each function takes masks of any integer dtype (numpy or torch), with N
not a multiple of anything, moves them to ``device`` as int32 and calls
the kernel wrapper in :mod:`.mask_scores`.  ``device=None`` means the
CUDA device (see :func:`repro_torch.device.resolve_device`); pass
``device="cpu"`` for the plain versions.
"""
from __future__ import annotations

import torch

from ..core.mig import A100_40GB, DeviceModel
from ..device import DeviceLike, resolve_device
from . import mask_scores


def _masks(masks, device: DeviceLike) -> torch.Tensor:
    return torch.as_tensor(masks).to(device=resolve_device(device),
                                     dtype=torch.int32).reshape(-1)


def cc_scores(masks, *, model: DeviceModel = A100_40GB,
              device: DeviceLike = None) -> torch.Tensor:
    """Batched CC (Eq. 1) -> (N,) int32."""
    return mask_scores.cc(_masks(masks, device), model)


def frag_scores(masks, *, model: DeviceModel = A100_40GB,
                device: DeviceLike = None) -> torch.Tensor:
    """Batched Algorithm-4 fragmentation -> (N,) float32."""
    return mask_scores.frag(_masks(masks, device), model)


def mcc_scores(masks, profile_idx: int, *, model: DeviceModel = A100_40GB,
               device: DeviceLike = None) -> torch.Tensor:
    """Batched Algorithm-6 scores (post-assign CC; -1 = no fit)."""
    return mask_scores.mcc(_masks(masks, device), profile_idx, model)


def ecc_scores(masks, profile_idx: int, probs, *,
               model: DeviceModel = A100_40GB,
               device: DeviceLike = None) -> torch.Tensor:
    """Batched Algorithm-7 scores; ``probs`` is (num_profiles,) float32
    (probabilities or integer counts)."""
    m = _masks(masks, device)
    w = torch.as_tensor(probs).to(device=m.device, dtype=torch.float32)
    return mask_scores.ecc(m, profile_idx, w, model)


__all__ = ["cc_scores", "frag_scores", "mcc_scores", "ecc_scores"]
