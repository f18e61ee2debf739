"""Wrappers of the CUDA mask scorers (``csrc/mask_scores.cu``).

Port of the Pallas kernels ``repro/kernels/cc_score.py`` (``cc_pallas``),
``frag_score.py`` (``frag_pallas``) and ``policy_score.py``
(``mcc_score_pallas``, ``ecc_score_pallas`` and their engine bridges).
``mcc_pick`` / ``ecc_pick`` fuse the replay's whole kernel-path pick
(host headroom, score, first maximizer) into one launch.

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
MAX_PROFILE_SLOTS = 8                    # MRT_MAX_BLOCKS: starts per profile
PICK_PER_CTA = 512 * 4                   # MRT_PICK_THREADS * MRT_PICK_ITEMS

LAUNCHES: Dict[str, int] = {"cc": 0, "frag": 0, "mcc": 0, "ecc": 0,
                            "mcc_pick": 0, "ecc_pick": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MrtModel(ctypes.Structure):
    """``struct MrtModel`` of mask_scores.cu: a model's slot templates
    (``slot_shift[s]`` is 4 x the profile of slot s: the kernels count
    each profile's fitting slots in a 4-bit field)."""
    _fields_ = [("num_blocks", ctypes.c_int),
                ("num_profiles", ctypes.c_int),
                ("num_slots", ctypes.c_int),
                ("slot_mask", ctypes.c_int * MAX_SLOTS),
                ("prof_start", ctypes.c_int * (MAX_PROFILES + 1)),
                ("prof_size", ctypes.c_int * MAX_PROFILES),
                ("slot_shift", ctypes.c_int * MAX_SLOTS)]


@lru_cache(maxsize=None)
def model_struct(model: DeviceModel) -> MrtModel:
    """The model's slot templates, grouped by profile (the slot order of
    ``DeviceModel.slots`` already is)."""
    per_profile = max(len(m) for m in model.profile_slot_masks)
    if (model.num_slots > MAX_SLOTS or model.num_profiles > MAX_PROFILES
            or per_profile > MAX_PROFILE_SLOTS):
        raise ValueError(f"{model.name}: {model.num_slots} slots / "
                         f"{model.num_profiles} profiles / {per_profile} "
                         f"slots of one profile exceed the kernel's "
                         f"{MAX_SLOTS} / {MAX_PROFILES} / "
                         f"{MAX_PROFILE_SLOTS}")
    st = MrtModel(num_blocks=model.num_blocks,
                  num_profiles=model.num_profiles,
                  num_slots=model.num_slots)
    start = 0
    for p, masks in enumerate(model.profile_slot_masks):
        st.prof_start[p] = start
        st.prof_size[p] = model.profiles[p].size
        for m in masks:
            st.slot_mask[start] = m
            st.slot_shift[start] = 4 * p
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
                       ("mrt_ecc", [P, P, P, I64, I, S, P]),
                       ("mrt_mcc_pick", [P, P, P, P, P, I64, I, S, P, P, P]),
                       ("mrt_ecc_pick",
                        [P, P, P, P, P, P, I64, I, S, P, P, P])):
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


def _check_weights(weights: torch.Tensor, model: DeviceModel,
                   device: torch.device) -> None:
    if (weights.dtype != torch.float32
            or tuple(weights.shape) != (model.num_profiles,)
            or weights.device != device):
        raise TypeError(f"weights must be ({model.num_profiles},) float32 "
                        f"on {device}, got {tuple(weights.shape)} "
                        f"{weights.dtype} on {weights.device}")


def ecc(masks: torch.Tensor, profile: int, weights: torch.Tensor,
        model: DeviceModel) -> torch.Tensor:
    """Alg. 7 score per mask: sum_p weights[p] * (slots of p free after
    the default placement of ``profile``), -1.0 where it does not fit ->
    (N,) float32.  ``weights`` is a (num_profiles,) float32 tensor on the
    masks' device."""
    _check_masks(masks)
    profile = _check_profile(model, profile)
    _check_weights(weights, model, masks.device)
    if masks.device.type == "cpu":
        return ref.ecc_score_ref(masks, profile, weights, model)
    masks, weights = masks.contiguous(), weights.contiguous()
    out = torch.empty(masks.shape, dtype=torch.float32, device=masks.device)
    _launch("mrt_ecc", masks.data_ptr(), weights.data_ptr(), out.data_ptr(),
            masks.numel(), profile, model_struct(model), _stream())
    LAUNCHES["ecc"] += 1
    return out


def _scratch(free: torch.Tensor):
    """Two zeroed 64-bit words (max key, ticket) of one pick's own for
    its cross-CTA reduction, or None where one CTA covers the fleet (the
    replay's case: one launch and nothing else)."""
    if free.numel() <= PICK_PER_CTA:
        return None
    return torch.zeros(2, dtype=torch.int64, device=free.device)


def _check_fleet(free, gpu_host, host_used, cap_g, need) -> None:
    _check_masks(free)
    G = free.shape[0]
    if not 1 <= G < 2 ** 31 or host_used.shape[0] < 1:
        raise ValueError(f"a pick needs 1 <= G < 2^31 GPUs and a host, got "
                         f"{G} GPUs, {host_used.shape[0]} hosts")
    for name, t, dtype, shape in (
            ("gpu_host", gpu_host, torch.int64, (G,)),
            ("host_used", host_used, torch.float32, (host_used.shape[0], 2)),
            ("cap_g", cap_g, torch.float32, (G, 2)),
            ("need", need, torch.float32, (2,))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != free.device or not t.is_contiguous()
                or t.data_ptr() % 8):
            raise TypeError(f"{name} must be a contiguous, 8-byte aligned "
                            f"{shape} {dtype} tensor on {free.device}, got "
                            f"{tuple(t.shape)} {t.dtype} on {t.device}")


def mcc_pick(free: torch.Tensor, gpu_host: torch.Tensor,
             host_used: torch.Tensor, cap_g: torch.Tensor,
             need: torch.Tensor, profile: int,
             model: DeviceModel) -> torch.Tensor:
    """The MCC pick of one arrival -> (1,) int64: the first GPU maximizing
    the Alg. 6 score among those whose host has headroom for ``need``
    (``host_used[gpu_host] + need <= cap_g`` in float32 for both
    resources) and whose score is >= 0, else -1.

    free (G,) int32; gpu_host (G,) int64; host_used (H, 2) float32;
    cap_g (G, 2) float32; need (2,) float32, all on one device."""
    _check_fleet(free, gpu_host, host_used, cap_g, need)
    profile = _check_profile(model, profile)
    if free.device.type == "cpu":
        return ref.mcc_pick_ref(free, gpu_host, host_used, cap_g, need,
                                profile, model)
    free = free.contiguous()
    pick = torch.empty(1, dtype=torch.int64, device=free.device)
    scratch = _scratch(free)
    _launch("mrt_mcc_pick", free.data_ptr(), gpu_host.data_ptr(),
            host_used.data_ptr(), cap_g.data_ptr(), need.data_ptr(),
            free.numel(), profile, model_struct(model),
            None if scratch is None else scratch.data_ptr(),
            pick.data_ptr(), _stream())
    LAUNCHES["mcc_pick"] += 1
    return pick


def ecc_pick(free: torch.Tensor, gpu_host: torch.Tensor,
             host_used: torch.Tensor, cap_g: torch.Tensor,
             need: torch.Tensor, profile: int, weights: torch.Tensor,
             model: DeviceModel) -> torch.Tensor:
    """The MECC pick of one arrival -> (1,) int64: as :func:`mcc_pick`
    with the Alg. 7 score under ``weights`` ((num_profiles,) float32)."""
    _check_fleet(free, gpu_host, host_used, cap_g, need)
    profile = _check_profile(model, profile)
    _check_weights(weights, model, free.device)
    if free.device.type == "cpu":
        return ref.ecc_pick_ref(free, gpu_host, host_used, cap_g, need,
                                profile, weights, model)
    free, weights = free.contiguous(), weights.contiguous()
    pick = torch.empty(1, dtype=torch.int64, device=free.device)
    scratch = _scratch(free)
    _launch("mrt_ecc_pick", free.data_ptr(), gpu_host.data_ptr(),
            host_used.data_ptr(), cap_g.data_ptr(), need.data_ptr(),
            weights.data_ptr(), free.numel(), profile, model_struct(model),
            None if scratch is None else scratch.data_ptr(),
            pick.data_ptr(), _stream())
    LAUNCHES["ecc_pick"] += 1
    return pick


__all__ = ["cc", "frag", "mcc", "ecc", "mcc_pick", "ecc_pick", "LAUNCHES",
           "reset_launches", "MrtModel", "model_struct"]
