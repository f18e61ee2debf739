# Copied unchanged from repro/core/tables.py (the JAX package), so the port imports nothing of it.
"""Precomputed MIG tables over a device model's free-mask space.

A GPU's free blocks form a ``num_blocks``-bit mask, so every quantity the
placement policies need — CC, per-profile fit, the default policy's chosen
start block, post-assignment CC, the fragmentation metric — is a function
of at most (mask, profile).  ``ModelTables`` materializes those functions
for one :class:`repro.core.mig.DeviceModel` over its ``1 << num_blocks``
mask space (256 states for 8-block models, 16 for the A30); precomputing
them turns every pool scan into a NumPy gather over the cluster's
free-mask vector.  The Pallas kernels in ``repro.kernels`` compute the
same quantities directly from the model's slot templates on-chip (tables
don't fit the TPU's vector registers as gathers, but the slot popcount
does).

Slot metadata arrays (``slot_mask_arr`` / ``slot_profile`` /
``slot_start``) are derived straight from the ``DeviceModel`` slot
enumeration — the single source shared with ``repro.kernels.ref``.

Module-level constants (``CC_TABLE`` etc.) remain as aliases of the
default model's (A100-40GB) bundle.  All tables are validated against the
object-level implementation in ``repro.core.mig`` (tests/test_tables.py,
tests/test_device_models.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .mig import (DEFAULT_MODEL, DeviceModel, blocks_of, fragmentation,
                  get_cc, gpu_from_free_mask)


@dataclasses.dataclass(frozen=True)
class ModelTables:
    """The §5 mask-indexed tables for one device model (NumPy, host-side)."""
    model: DeviceModel
    num_masks: int
    num_profiles: int
    # Per-slot metadata (shared with the kernel oracles).
    slot_mask_arr: np.ndarray    # (num_slots,) uint8-ish (<= 2^blocks - 1)
    slot_profile: np.ndarray     # (num_slots,) int8
    slot_start: np.ndarray       # (num_slots,) int8
    profile_size: np.ndarray     # (num_profiles,) int8
    # Mask-indexed tables.
    cc: np.ndarray               # (num_masks,) int16
    counts: np.ndarray           # (num_masks, num_profiles) int16  |S(G,p)|
    fits: np.ndarray             # (num_masks, num_profiles) bool
    assign_start: np.ndarray     # (num_masks, num_profiles) int8
    assign_mask: np.ndarray      # (num_masks, num_profiles) uint8
    cc_after: np.ndarray         # (num_masks, num_profiles) int16
    frag: np.ndarray             # (num_masks,) float32
    popcount: np.ndarray         # (num_masks,) int16
    counts_after: np.ndarray     # (num_masks, num_profiles, num_profiles)


def _free_set(mask: int, num_blocks: int):
    return frozenset(b for b in range(num_blocks) if mask & (1 << b))


def _build(model: DeviceModel) -> ModelTables:
    num_masks = model.num_masks
    num_profiles = model.num_profiles
    profiles = model.profiles

    cc = np.zeros(num_masks, dtype=np.int16)
    counts = np.zeros((num_masks, num_profiles), dtype=np.int16)
    fits = np.zeros((num_masks, num_profiles), dtype=bool)
    assign_start = np.full((num_masks, num_profiles), -1, dtype=np.int8)
    assign_mask = np.zeros((num_masks, num_profiles), dtype=np.uint8)
    cc_after = np.full((num_masks, num_profiles), -1, dtype=np.int16)
    frag = np.zeros(num_masks, dtype=np.float32)
    popcount = np.zeros(num_masks, dtype=np.int16)

    for mask in range(num_masks):
        free = _free_set(mask, model.num_blocks)
        popcount[mask] = len(free)
        cc[mask] = get_cc(free, profiles)
        frag[mask] = fragmentation(gpu_from_free_mask(mask, model=model))
        for pi, p in enumerate(profiles):
            n = 0
            best_start, max_cc = -1, -1
            for start in p.start_blocks:
                blocks = blocks_of(p, start)
                if blocks <= free:
                    n += 1
                    c = get_cc(free - blocks, profiles)
                    if c > max_cc:
                        best_start, max_cc = start, c
            counts[mask, pi] = n
            fits[mask, pi] = n > 0
            if best_start >= 0:
                assign_start[mask, pi] = best_start
                bm = 0
                for b in blocks_of(p, best_start):
                    bm |= 1 << b
                assign_mask[mask, pi] = mask & ~bm
                cc_after[mask, pi] = max_cc

    # counts_after[mask, placed_profile, counted_profile]
    counts_after = np.zeros((num_masks, num_profiles, num_profiles),
                            dtype=np.int16)
    for mask in range(num_masks):
        for pi in range(num_profiles):
            if fits[mask, pi]:
                counts_after[mask, pi] = counts[assign_mask[mask, pi]]

    return ModelTables(
        model=model, num_masks=num_masks, num_profiles=num_profiles,
        slot_mask_arr=np.array(model.slot_masks, dtype=np.uint8),
        slot_profile=np.array(model.slot_profile, dtype=np.int8),
        slot_start=np.array(model.slot_starts, dtype=np.int8),
        profile_size=np.array([p.size for p in profiles], dtype=np.int8),
        cc=cc, counts=counts, fits=fits, assign_start=assign_start,
        assign_mask=assign_mask, cc_after=cc_after, frag=frag,
        popcount=popcount, counts_after=counts_after)


_MODEL_TABLES_CACHE: Dict[DeviceModel, ModelTables] = {}


def tables_for_model(model: DeviceModel = DEFAULT_MODEL) -> ModelTables:
    """Cached per-model table bundle (keyed by the model's *value* —
    DeviceModel hashes by its fields — so two models sharing a name but
    not a geometry can never alias each other's tables)."""
    if model not in _MODEL_TABLES_CACHE:
        _MODEL_TABLES_CACHE[model] = _build(model)
    return _MODEL_TABLES_CACHE[model]


# -- legacy module-level aliases (the paper's A100-40GB) --------------------

_T = tables_for_model(DEFAULT_MODEL)

NUM_MASKS = _T.num_masks      # 256
NUM_PROFILES = _T.num_profiles  # 6

SLOT_MASK_ARR: np.ndarray = _T.slot_mask_arr   # (18,)
SLOT_PROFILE: np.ndarray = _T.slot_profile     # (18,)
SLOT_START: np.ndarray = _T.slot_start         # (18,)
PROFILE_SIZE: np.ndarray = _T.profile_size     # (6,)

CC_TABLE: np.ndarray = _T.cc                   # (256,)
COUNTS_TABLE: np.ndarray = _T.counts           # (256, 6)  |S(G,p)|
FITS_TABLE: np.ndarray = _T.fits               # (256, 6)
ASSIGN_START_TABLE: np.ndarray = _T.assign_start   # (256, 6)
ASSIGN_MASK_TABLE: np.ndarray = _T.assign_mask     # (256, 6)
CC_AFTER_TABLE: np.ndarray = _T.cc_after       # (256, 6)
FRAG_TABLE: np.ndarray = _T.frag               # (256,)
POPCOUNT_TABLE: np.ndarray = _T.popcount       # (256,)
COUNTS_AFTER_TABLE: np.ndarray = _T.counts_after   # (256, 6, 6)

__all__ = [
    "ModelTables", "tables_for_model",
    "NUM_MASKS", "NUM_PROFILES", "SLOT_MASK_ARR", "SLOT_PROFILE",
    "SLOT_START", "PROFILE_SIZE", "CC_TABLE", "COUNTS_TABLE", "FITS_TABLE",
    "ASSIGN_START_TABLE", "ASSIGN_MASK_TABLE", "CC_AFTER_TABLE",
    "FRAG_TABLE", "POPCOUNT_TABLE", "COUNTS_AFTER_TABLE",
]
