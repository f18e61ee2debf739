"""Wrappers of the CUDA mask scorers (``csrc/mask_scores.cu``).

Port of the Pallas kernels ``repro/kernels/cc_score.py`` (``cc_pallas``),
``frag_score.py`` (``frag_pallas``) and ``policy_score.py``
(``mcc_score_pallas``, ``ecc_score_pallas`` and their engine bridges).

Each wrapper takes a flat (N,) int32 tensor of free masks.  A tensor on
the CPU goes to the plain version in :mod:`.ref`; a CUDA tensor goes to
the kernel, or the wrapper raises.  ``LAUNCHES`` counts kernel launches
per wrapper (plain-version calls are not counted), so a run can show
that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict

import torch

from ..core.mig import DeviceModel
from . import ref
from ._build import load

MAX_SLOTS, MAX_PROFILES = 32, 8          # MRT_MAX_* in mask_scores.cu

LAUNCHES: Dict[str, int] = {"cc": 0, "frag": 0, "mcc": 0, "ecc": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MrtModel(ctypes.Structure):
    """``struct MrtModel`` of mask_scores.cu: a model's slot templates."""
    _fields_ = [("num_blocks", ctypes.c_int),
                ("num_profiles", ctypes.c_int),
                ("num_slots", ctypes.c_int),
                ("slot_mask", ctypes.c_int * MAX_SLOTS),
                ("prof_start", ctypes.c_int * (MAX_PROFILES + 1)),
                ("prof_size", ctypes.c_int * MAX_PROFILES)]


@lru_cache(maxsize=None)
def model_struct(model: DeviceModel) -> MrtModel:
    """The model's slot templates, grouped by profile (the slot order of
    ``DeviceModel.slots`` already is)."""
    if model.num_slots > MAX_SLOTS or model.num_profiles > MAX_PROFILES:
        raise ValueError(f"{model.name}: {model.num_slots} slots / "
                         f"{model.num_profiles} profiles exceed the "
                         f"kernel's {MAX_SLOTS} / {MAX_PROFILES}")
    st = MrtModel(num_blocks=model.num_blocks,
                  num_profiles=model.num_profiles,
                  num_slots=model.num_slots)
    start = 0
    for p, masks in enumerate(model.profile_slot_masks):
        st.prof_start[p] = start
        st.prof_size[p] = model.profiles[p].size
        for m in masks:
            st.slot_mask[start] = m
            start += 1
    st.prof_start[model.num_profiles] = start
    return st


@lru_cache(maxsize=None)
def _lib():
    lib = load("mask_scores")
    P, I64, I, S = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, MrtModel
    for name, args in (("mrt_cc", [P, P, I64, S, P]),
                       ("mrt_frag", [P, P, I64, S, P]),
                       ("mrt_mcc", [P, P, I64, I, S, P]),
                       ("mrt_ecc", [P, P, P, I64, I, S, P])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check_masks(masks: torch.Tensor) -> None:
    if masks.dtype != torch.int32 or masks.dim() != 1:
        raise TypeError(f"masks must be a (N,) int32 tensor, got "
                        f"{tuple(masks.shape)} {masks.dtype}")
    if masks.device.type == "cuda":
        # The C entry points launch on the current device.
        if masks.device.index != torch.cuda.current_device():
            raise ValueError(f"masks on {masks.device}, current device is "
                             f"cuda:{torch.cuda.current_device()}")
    elif masks.device.type != "cpu":
        raise ValueError(f"unsupported device {masks.device}")


def _check_profile(model: DeviceModel, profile: int) -> int:
    profile = int(profile)
    if not 0 <= profile < model.num_profiles:
        raise ValueError(f"profile {profile} out of range for {model.name}")
    return profile


def _launch(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def cc(masks: torch.Tensor, model: DeviceModel) -> torch.Tensor:
    """Eq. 1 CC per mask -> (N,) int32."""
    _check_masks(masks)
    if masks.device.type == "cpu":
        return ref.cc_ref(masks, model)
    masks = masks.contiguous()
    out = torch.empty_like(masks)
    _launch("mrt_cc", masks.data_ptr(), out.data_ptr(), masks.numel(),
            model_struct(model), _stream())
    LAUNCHES["cc"] += 1
    return out


def frag(masks: torch.Tensor, model: DeviceModel) -> torch.Tensor:
    """Alg. 4 fragmentation per mask -> (N,) float32."""
    _check_masks(masks)
    if masks.device.type == "cpu":
        return ref.frag_ref(masks, model)
    masks = masks.contiguous()
    out = torch.empty(masks.shape, dtype=torch.float32, device=masks.device)
    _launch("mrt_frag", masks.data_ptr(), out.data_ptr(), masks.numel(),
            model_struct(model), _stream())
    LAUNCHES["frag"] += 1
    return out


def mcc(masks: torch.Tensor, profile: int,
        model: DeviceModel) -> torch.Tensor:
    """Alg. 6 score per mask: best post-assignment CC of ``profile``,
    -1 where it does not fit -> (N,) int32."""
    _check_masks(masks)
    profile = _check_profile(model, profile)
    if masks.device.type == "cpu":
        return ref.mcc_score_ref(masks, profile, model)
    masks = masks.contiguous()
    out = torch.empty_like(masks)
    _launch("mrt_mcc", masks.data_ptr(), out.data_ptr(), masks.numel(),
            profile, model_struct(model), _stream())
    LAUNCHES["mcc"] += 1
    return out


def ecc(masks: torch.Tensor, profile: int, weights: torch.Tensor,
        model: DeviceModel) -> torch.Tensor:
    """Alg. 7 score per mask: sum_p weights[p] * (slots of p free after
    the default placement of ``profile``), -1.0 where it does not fit ->
    (N,) float32.  ``weights`` is a (num_profiles,) float32 tensor on the
    masks' device."""
    _check_masks(masks)
    profile = _check_profile(model, profile)
    if (weights.dtype != torch.float32
            or tuple(weights.shape) != (model.num_profiles,)
            or weights.device != masks.device):
        raise TypeError(f"weights must be ({model.num_profiles},) float32 "
                        f"on {masks.device}, got {tuple(weights.shape)} "
                        f"{weights.dtype} on {weights.device}")
    if masks.device.type == "cpu":
        return ref.ecc_score_ref(masks, profile, weights, model)
    masks, weights = masks.contiguous(), weights.contiguous()
    out = torch.empty(masks.shape, dtype=torch.float32, device=masks.device)
    _launch("mrt_ecc", masks.data_ptr(), weights.data_ptr(), out.data_ptr(),
            masks.numel(), profile, model_struct(model), _stream())
    LAUNCHES["ecc"] += 1
    return out


__all__ = ["cc", "frag", "mcc", "ecc", "LAUNCHES", "reset_launches",
           "MrtModel", "model_struct"]
