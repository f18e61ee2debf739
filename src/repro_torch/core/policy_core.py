"""Policy core in PyTorch — port of ``repro/core/policy_core.py``.

The same decision logic (FF/BF/MCC/MECC, Algs. 6-7; GRMU, Algs. 2-5) as
plain functions on tensors.  :class:`Tables` stacks each fleet model's
mask-indexed tables along a leading model axis on one device, so every
lookup is a gather by ``(model_id, free_mask, profile)``.

Exactness rules kept from the reference:

  * scoring is integer-only and ties go to the first maximizer —
    ``torch.argmax`` returns the first maximum on CPU and CUDA, but
    rejects bool input, so masks are cast to int32 first;
  * every tensor used as an index is int64: torch refuses int16 index
    tensors and reads a uint8 one as a boolean mask;
  * host headroom is float32, updated pair by pair in scan order.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .mig import DeviceModel
from .tables import tables_for_model

# Policy identifiers (shared with the JAX package).
FF, BF, MCC, MECC, GRMU = 0, 1, 2, 3, 4
POLICY_IDS = {"FF": FF, "BF": BF, "MCC": MCC, "MECC": MECC, "GRMU": GRMU}
POLICY_NAMES = {v: k for k, v in POLICY_IDS.items()}

# GRMU basket labels (Alg. 2): a GPU is in exactly one.
POOL, HEAVY_BASKET, LIGHT_BASKET = 0, 1, 2


def _stack_host_tables(models: Tuple[DeviceModel, ...]) -> dict:
    """Host-side (numpy) staging of the per-fleet tables, padded to the
    fleet-wide mask space and profile count.  Padded entries are
    never-feasible (``fits`` False, ``assign_start`` -1,
    ``counts_after`` 0).  Same construction as the reference's."""
    mts = [tables_for_model(m) for m in models]
    M = len(mts)
    NM = max(t.num_masks for t in mts)
    NP = max(t.num_profiles for t in mts)

    def pad(rows, fill, dtype):
        """Stack per-model arrays padded to a common trailing shape."""
        shape = (M, NM, NP, NP)[:1 + rows[0].ndim]
        out = np.full(shape, fill, dtype=dtype)
        for i, r in enumerate(rows):
            out[(i,) + tuple(slice(0, s) for s in r.shape)] = r
        return out

    sizes = np.zeros((M, NP), np.int32)
    cons = np.zeros((M, NP), bool)
    for i, (m, t) in enumerate(zip(models, mts)):
        sizes[i, :t.num_profiles] = t.profile_size
        for ci in m.consolidatable:
            cons[i, ci] = True
    return dict(
        num_masks=NM, num_profiles=NP,
        fits=pad([t.fits for t in mts], False, bool),
        pop=pad([t.popcount for t in mts], 0, np.int32),
        cc_after=pad([t.cc_after for t in mts], -1, np.int32),
        counts_after=pad([t.counts_after for t in mts], 0, np.int32),
        assign_mask=pad([t.assign_mask for t in mts], 0, np.int32),
        assign_start=pad([t.assign_start for t in mts], -1, np.int32),
        frag=pad([t.frag for t in mts], 0.0, np.float32),
        sizes=sizes, consolidatable=cons,
        # Per-model scalars.
        full_mask=np.array([m.full_mask for m in models], np.int32),
        heavy=np.array([m.heavy_profile for m in models], np.int32),
        lower_half=np.array([m.lower_half_free for m in models], np.int32),
        upper_half=np.array([m.upper_half_free for m in models], np.int32),
    )


class Tables:
    """Per-fleet mask-indexed tables as tensors on one device."""

    def __init__(self, models: Sequence[DeviceModel], device: torch.device):
        self.models: Tuple[DeviceModel, ...] = tuple(models)
        if not self.models:
            raise ValueError("Tables needs at least one device model")
        host = _stack_host_tables(self.models)
        self.device = torch.device(device)
        self.num_models = len(self.models)
        self.num_masks = host.pop("num_masks")
        self.num_profiles = host.pop("num_profiles")
        self.max_blocks = max(m.num_blocks for m in self.models)
        # (1 << size) - 1 per (model, profile): a departure's block run.
        host["size_mask"] = ((1 << host["sizes"]) - 1).astype(np.int32)
        for name, arr in host.items():
            setattr(self, name, torch.as_tensor(arr, device=self.device))


_TABLES_CACHE: Dict[tuple, Tables] = {}


def tables_for(models: Sequence[DeviceModel], device) -> Tables:
    # Keyed by model values (not names): a custom model reusing a preset
    # name must not alias the preset's tables.
    key = (tuple(models), str(torch.device(device)))
    if key not in _TABLES_CACHE:
        _TABLES_CACHE[key] = Tables(models, device)
    return _TABLES_CACHE[key]


# ---------------------------------------------------------------------------
# Generic helpers
# ---------------------------------------------------------------------------

def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True element, or -1, as a (1,) int64 tensor."""
    idx = torch.argmax(mask.to(torch.int32)).reshape(1)
    return torch.where(mask.any(), idx, -1)


def first_max(scores: torch.Tensor, any_ok: torch.Tensor) -> torch.Tensor:
    """First maximizer of ``scores`` where ``any_ok``, else -1 ((1,))."""
    return torch.where(any_ok, torch.argmax(scores).reshape(1), -1)


# ---------------------------------------------------------------------------
# FF / BF / MCC / MECC (Algs. 6-7)
# ---------------------------------------------------------------------------

def mecc_weights(counts: torch.Tensor) -> torch.Tensor:
    """MECC profile weights: the raw windowed counts (argmax-equivalent
    to the paper's probabilities); empty history degrades to uniform."""
    return torch.where(counts.sum() > 0, counts, torch.ones_like(counts))


def placement_scores(policy, T: Tables, mid, free, prof_g, fits,
                     mecc_w=None):
    """Per-GPU integer score under ``policy``; infeasible GPUs score below
    every feasible one.  ``free`` and ``prof_g`` are int64 (G,)."""
    if policy == FF:
        return fits.to(torch.int32)
    if policy == BF:
        # Minimize leftover free blocks == maximize (size - popcount).
        return torch.where(fits, T.sizes[mid, prof_g] - T.pop[mid, free],
                           -99)
    if policy == MCC:
        return torch.where(fits, T.cc_after[mid, free, prof_g], -1)
    if policy == MECC:
        w = mecc_w.to(T.counts_after.dtype)
        ecc = (T.counts_after[mid, free, prof_g] * w[mid]).sum(dim=-1)
        return torch.where(fits, ecc, -1)
    raise ValueError(f"unknown baseline policy id {policy}")


def select_gpu(policy, T: Tables, mid, free, pids, host_ok, mecc_w=None):
    """Feasibility mask + score + first-maximizer pick.  ``mid`` and
    ``pids`` (the request's per-model profile ids) are int64.  Returns a
    (1,) int64 tensor: the GPU index, or -1 when nothing is feasible."""
    free = free.long()
    prof_g = pids[mid]
    fits = T.fits[mid, free, prof_g] & host_ok
    scores = placement_scores(policy, T, mid, free, prof_g, fits, mecc_w)
    return first_max(scores, fits.any())


# ---------------------------------------------------------------------------
# GRMU allocation (Algs. 2-3)
# ---------------------------------------------------------------------------

def grmu_select(T: Tables, mid, free, pids, is_heavy: bool, host_ok,
                basket, heavy_cap, light_cap):
    """Dual-basket first-fit with capacity-capped growth (Alg. 3).

    ``is_heavy`` is a host value; the caps are device scalars (0-d or
    (1,) int32 tensors, as the replay keeps them, so one captured graph
    serves every capacity) or ints.  A grown GPU joins the
    basket even when the host check then blocks the placement (pick -1,
    ``grew`` True).  Returns ``(pick, grew, grow_idx)``, each (1,)."""
    want = HEAVY_BASKET if is_heavy else LIGHT_BASKET
    cap = heavy_cap if is_heavy else light_cap
    in_basket = basket == want
    fits = T.fits[mid, free.long(), pids[mid]] & host_ok & in_basket
    pick = first_true(fits)
    pool_free = basket == POOL
    grew = (pick < 0) & (in_basket.sum() < cap) & pool_free.any()
    grow_idx = torch.argmax(pool_free.to(torch.int32)).reshape(1)
    grown_pick = torch.where(grew & host_ok[grow_idx], grow_idx, -1)
    return torch.where(pick >= 0, pick, grown_pick), grew, grow_idx


# ---------------------------------------------------------------------------
# GRMU defragmentation (Alg. 4)
# ---------------------------------------------------------------------------

def defrag_target(T: Tables, mid, free, light_mask):
    """Most fragmented light-basket GPU (first maximizer), or -1 when no
    light GPU has positive fragmentation or the maximizer is empty."""
    scores = torch.where(light_mask, T.frag[mid, free.long()], -1.0)
    g = torch.argmax(scores).reshape(1)
    ok = (scores[g] > 0.0) & (free[g] != T.full_mask[mid[g]])
    return torch.where(ok, g, -1)


def repack_gpu(T: Tables, mid_g, profiles_by_block):
    """Replay a GPU's residents through the default policy on a mock GPU.

    ``mid_g`` is the GPU's (1,) model id; ``profiles_by_block`` is a
    (max_blocks,) int64 tensor: the profile (on that model) of the VM
    whose instance starts at block b, or -1.  Returns ``(new_starts
    (max_blocks,), ok, final_mask, moved)``, the last three (1,)."""
    mock = T.full_mask[mid_g]
    ok = torch.ones(1, dtype=torch.bool, device=mid_g.device)
    moved = torch.zeros(1, dtype=torch.int32, device=mid_g.device)
    new_starts = []
    for b in range(T.max_blocks):
        p = profiles_by_block[b:b + 1]
        has = p >= 0
        pp = p.clamp(min=0)
        m = mock.long()
        fit = T.fits[mid_g, m, pp] & has
        ok = ok & (fit | ~has)
        ns = torch.where(fit, T.assign_start[mid_g, m, pp], -1)
        new_starts.append(ns)
        moved = moved + (fit & (ns != b)).to(torch.int32)
        mock = torch.where(fit, T.assign_mask[mid_g, m, pp], mock)
    return torch.cat(new_starts), ok, mock, moved


# ---------------------------------------------------------------------------
# GRMU consolidation (Alg. 5)
# ---------------------------------------------------------------------------

def consolidation_candidates(T: Tables, mid, free, light_mask, vm_count,
                             sole_profile):
    """Half-full, single-VM light GPUs holding a half-GPU instance.
    ``sole_profile`` is the sole VM's profile on its own GPU's model (-1
    where not single-VM)."""
    half = (free == T.lower_half[mid]) | (free == T.upper_half[mid])
    prof_ok = (T.consolidatable[mid, sole_profile.clamp(min=0)]
               & (sole_profile >= 0))
    return light_mask & half & (vm_count == 1) & prof_ok


def consolidation_plan(T: Tables, mid, free, cand, sole_pids, sole_cpu,
                       sole_ram, gpu_host, cpu_used, ram_used, cpu_cap,
                       ram_cap, gpu_host_np: np.ndarray):
    """Greedy pairing of consolidation candidates (Alg. 5's while loop).

    Scans sources in globalIndex order; each source merges onto the
    first later still-available candidate that fits its profile and
    whose host has CPU/RAM headroom.  Host headroom is updated pair by
    pair in scan order.  ``gpu_host_np`` is the host copy of
    ``gpu_host``.  Returns ``(tgt_of, cpu_used, ram_used)``.

    The reference folds over every GPU; this loop visits only the
    candidates, read once from ``cand``.  That is decision-identical: a
    non-candidate starts with ``avail`` False, no step ever sets it
    True, so its iteration changes nothing (``do`` is False, its
    deltas are 0.0 and ``tgt_of`` stays -1)."""
    G = free.shape[0]
    dev = free.device
    gids = torch.arange(G, device=dev)
    free_l = free.long()
    avail = cand.clone()
    tgt_of = torch.full((G,), -1, dtype=torch.int32, device=dev)
    cpu_u, ram_u = cpu_used.clone(), ram_used.clone()
    zero = torch.zeros(1, dtype=cpu_u.dtype, device=dev)
    cpu_cap_g, ram_cap_g = cpu_cap[gpu_host], ram_cap[gpu_host]
    # The candidates come to the host in one copy: one synchronisation.
    for g in np.flatnonzero(cand.cpu().numpy()).tolist():
        # Source g's profile under each candidate target's model.
        p_t = sole_pids[g][mid].clamp(min=0)
        c, r, h = sole_cpu[g:g + 1], sole_ram[g:g + 1], int(gpu_host_np[g])
        host_ok = ((gpu_host == h)
                   | ((cpu_u[gpu_host] + c <= cpu_cap_g)
                      & (ram_u[gpu_host] + r <= ram_cap_g)))
        feasible = avail & (gids > g) & T.fits[mid, free_l, p_t] & host_ok
        tgt = first_true(feasible)
        do = avail[g:g + 1] & (tgt >= 0)
        tgt_c = tgt.clamp(min=0)
        th = gpu_host[tgt_c]
        move = do & (th != h)
        delta_c = torch.where(move, c, zero)
        delta_r = torch.where(move, r, zero)
        cpu_u[h:h + 1] = cpu_u[h:h + 1] - delta_c
        cpu_u[th] = cpu_u[th] + delta_c
        ram_u[h:h + 1] = ram_u[h:h + 1] - delta_r
        ram_u[th] = ram_u[th] + delta_r
        avail = avail & (gids != g) & ~(do & (gids == tgt_c))
        tgt_of[g:g + 1] = torch.where(do, tgt, -1).to(torch.int32)
    return tgt_of, cpu_u, ram_u


__all__ = [
    "FF", "BF", "MCC", "MECC", "GRMU", "POLICY_IDS", "POLICY_NAMES",
    "POOL", "HEAVY_BASKET", "LIGHT_BASKET", "Tables", "tables_for", "first_true", "first_max",
    "mecc_weights", "placement_scores", "select_gpu", "grmu_select",
    "defrag_target", "repack_gpu", "consolidation_candidates",
    "consolidation_plan",
]
