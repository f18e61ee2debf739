"""Plain PyTorch versions of the mask-scoring kernels.

Port of ``repro/kernels/ref.py``: direct slot-template math over free
masks (bit b set == block b free), no lookup tables.  The CUDA kernels in
``csrc/mask_scores.cu`` compute the same functions with the same float32
operation order, so on equal inputs they agree bit for bit:

  * ``cc_ref``        — Configuration Capability (Eq. 1)
  * ``frag_ref``      — fragmentation metric (Algorithm 4)
  * ``mcc_score_ref`` — post-default-assign CC (Algorithm 6 inner loop)
  * ``ecc_score_ref`` — expectation-weighted CC (Algorithm 7 inner loop)

Every function takes (N,) integer masks on any device and a
:class:`repro_torch.core.mig.DeviceModel`.
"""
from __future__ import annotations

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


__all__ = ["cc_ref", "frag_ref", "mcc_score_ref", "ecc_score_ref"]
