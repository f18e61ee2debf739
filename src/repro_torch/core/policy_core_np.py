# Copied from repro/core/policy_core.py (the JAX package), so the port imports nothing of it; one change: _fori's jax.numpy branch (a deferred import of jax) raises, since the port runs this module on numpy only.
"""Backend-agnostic policy core — every placement policy's semantics, once.

This module is the single source of truth for the *decision logic* of the
paper's policies (FF/BF/MCC/MECC, Algs. 6-7; GRMU, Algs. 2-5).  Every
function is pure, branch-free over traced values, and parameterized over an
array namespace ``xp`` (``numpy`` or ``jax.numpy``), so the same code path
drives both engines:

  * ``repro.core.policies`` / ``repro.core.grmu`` — the object-level
    sequential reference (``xp = numpy``, eager, one VM at a time);
  * ``repro.core.batched`` — the ``lax.scan`` replay engine
    (``xp = jax.numpy``, jit/vmap-able, whole trace on device).

Every function is additionally parameterized over a *fleet* of device
models: :class:`Tables` pads each model's mask-indexed tables to a common
shape and stacks them along a leading model axis, and every scoring /
selection / defrag / consolidation function takes the per-GPU model-id
vector ``mid`` plus per-model profile indices ``pids`` (a VM request is a
vector of profile indices, one per model — Eq. 27-30 map the same GPU
requirement onto each model's profile table).  A homogeneous A100 cluster
is simply the one-model fleet with ``mid == 0`` everywhere, and reproduces
the pre-fleet scores bit for bit.

Scoring is integer-only (MECC uses the raw windowed counts as weights
rather than normalized probabilities — argmax-equivalent since the
normalizer is a positive constant) so both backends tie-break bit-for-bit
identically: ``argmax`` returns the first extremum in globalIndex order in
NumPy and JAX alike, preserving the paper's first-fit / first-maximizer
scan order.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .mig import A100_40GB, DeviceModel
from .tables import tables_for_model

# Policy identifiers (shared by both engines).
FF, BF, MCC, MECC, GRMU = 0, 1, 2, 3, 4
POLICY_IDS = {"FF": FF, "BF": BF, "MCC": MCC, "MECC": MECC, "GRMU": GRMU}
POLICY_NAMES = {v: k for k, v in POLICY_IDS.items()}

# Legacy A100-40GB constants (the single-model fleet's model 0).
HEAVY_PROFILE = A100_40GB.heavy_profile          # 5 — 7g.40gb
LOWER_HALF_FREE = A100_40GB.lower_half_free      # 0x0F
UPPER_HALF_FREE = A100_40GB.upper_half_free      # 0xF0
CONSOLIDATABLE = A100_40GB.consolidatable        # (3, 4)

# GRMU basket labels (Alg. 2): a GPU is in exactly one.
POOL, HEAVY_BASKET, LIGHT_BASKET = 0, 1, 2

DEFAULT_MODELS: Tuple[DeviceModel, ...] = (A100_40GB,)


def _stack_host_tables(models: Tuple[DeviceModel, ...]) -> dict:
    """Host-side (numpy) staging of the per-fleet tables.

    Each model's §5 tables are padded to the fleet-wide maximum mask-space
    (``1 << max(num_blocks)``) and profile count, then stacked along a
    leading model axis, so every lookup is a gather by
    ``(model_id, free_mask, profile)``.  Padded entries are never-feasible
    (``fits`` False, ``assign_start`` -1, ``counts_after`` 0), so out-of-
    model profile indices and masks score below every real option.

    Integer tables are widened to int32 so NumPy and JAX index/compare
    with the same value ranges (JAX would otherwise default differently).

    Deliberately ``xp``-free: table *construction* is host work; the
    ``xp``-parameterized :class:`Tables` only converts the finished
    arrays (repro-lint's backend-purity rule enforces this split).
    """
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

    # sizes is (M, NP): pad rows manually (pad() assumes mask-major).
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
        lower_half=np.array([m.lower_half_free for m in models],
                            np.int32),
        upper_half=np.array([m.upper_half_free for m in models],
                            np.int32),
    )


class Tables:
    """Per-fleet mask-indexed tables materialized in one array namespace.

    All construction happens host-side in :func:`_stack_host_tables`;
    this class only moves the finished arrays into ``xp``'s namespace, so
    the ``xp``-scoped code touches no bare numpy (backend purity).
    """

    def __init__(self, xp, models: Sequence[DeviceModel] = DEFAULT_MODELS):
        self.xp = xp
        self.models: Tuple[DeviceModel, ...] = tuple(models)
        if not self.models:
            raise ValueError("Tables needs at least one device model")
        host = _stack_host_tables(self.models)
        self.num_models = len(self.models)
        self.num_masks = host.pop("num_masks")
        self.num_profiles = host.pop("num_profiles")
        self.max_blocks = max(m.num_blocks for m in self.models)
        for name, arr in host.items():
            setattr(self, name, xp.asarray(arr))


_TABLES_CACHE: dict = {}


def tables_for(xp, models: Sequence[DeviceModel] = DEFAULT_MODELS) -> Tables:
    # Keyed by model values (not names): a custom model reusing a preset
    # name must not alias the preset's tables.
    key = (xp.__name__, tuple(models))
    if key not in _TABLES_CACHE:
        _TABLES_CACHE[key] = Tables(xp, models)
    return _TABLES_CACHE[key]


def heavy_request(models: Sequence[DeviceModel], pids) -> bool:
    """Host-side heavy classification of a request: heavy iff it maps to
    the full-GPU profile on *every* model of the fleet (on the paper's
    single-A100 fleet this is exactly ``profile == 7g.40gb``).  Both
    engines precompute this from the same per-model profile-id vector."""
    return all(m.heavy_profile >= 0 and int(pids[i]) == m.heavy_profile
               for i, m in enumerate(models))


# ---------------------------------------------------------------------------
# Generic helpers (work for numpy eagerly and jax.numpy traced)
# ---------------------------------------------------------------------------

def first_true(xp, mask):
    """Index of the first True element, or -1 (lowest globalIndex wins)."""
    idx = xp.argmax(mask)
    return xp.where(xp.any(mask), idx, -1)


def _set_at(xp, arr, idx, val):
    """Functional single-index update for either backend."""
    if xp is np:
        out = arr.copy()
        out[idx] = val
        return out
    return arr.at[idx].set(val)


def _fori(xp, n, body, init):
    """fori_loop with one body definition for both backends."""
    if xp is np:
        carry = init
        for i in range(n):
            carry = body(i, carry)
        return carry
    raise TypeError("the port runs the policy core on numpy only")


# ---------------------------------------------------------------------------
# FF / BF / MCC / MECC (Algs. 6-7)
# ---------------------------------------------------------------------------

def mecc_weights(xp, counts):
    """MECC profile weights from windowed arrival counts.

    ``counts`` is (num_models, num_profiles): each arrival increments its
    mapped profile on *every* model, so the per-model rows are the same
    windowed history viewed through each model's profile table.  The paper
    weights by empirical probabilities P(p) = count_p / total; because the
    normalizer is a shared positive constant, weighting by raw integer
    counts selects the same argmax — and keeps the scoring exactly
    comparable across float widths.  Empty history degrades to uniform.
    """
    counts = xp.asarray(counts)
    return xp.where(counts.sum() > 0, counts, xp.ones_like(counts))


def placement_scores(policy, xp, T, mid, free, prof_g, fits, mecc_w=None):
    """Per-GPU integer score under ``policy``; infeasible GPUs score below
    every feasible one.  ``prof_g`` is the requested profile per GPU
    (already mapped onto each GPU's model).  The chosen GPU is the first
    maximizer."""
    if policy == FF:
        return fits.astype(xp.int32)
    if policy == BF:
        # Minimize leftover free blocks == maximize (size - popcount).
        return xp.where(fits, T.sizes[mid, prof_g] - T.pop[mid, free], -99)
    if policy == MCC:
        return xp.where(fits, T.cc_after[mid, free, prof_g], -1)
    if policy == MECC:
        w = mecc_w.astype(T.counts_after.dtype)
        ecc = (T.counts_after[mid, free, prof_g] * w[mid]).sum(axis=-1)
        return xp.where(fits, ecc, -1)
    raise ValueError(f"unknown baseline policy id {policy}")


def select_gpu(policy, xp, T, mid, free, pids, host_ok, mecc_w=None):
    """Feasibility-mask + score + first-maximizer pick.  ``pids`` is the
    request's per-model profile-id vector (num_models,).  Returns the GPU
    globalIndex, or -1 when no GPU is feasible (profile or host level)."""
    prof_g = pids[mid]
    fits = T.fits[mid, free, prof_g] & host_ok
    scores = placement_scores(policy, xp, T, mid, free, prof_g, fits,
                              mecc_w)
    return xp.where(xp.any(fits), xp.argmax(scores), -1)


# ---------------------------------------------------------------------------
# GRMU allocation (Algs. 2-3)
# ---------------------------------------------------------------------------

def grmu_select(xp, T, mid, free, pids, is_heavy, host_ok, basket,
                heavy_cap, light_cap):
    """Dual-basket first-fit with capacity-capped growth (Alg. 3).

    ``is_heavy`` is the request's precomputed heavy flag (see
    :func:`heavy_request`).  ``basket`` holds POOL/HEAVY_BASKET/
    LIGHT_BASKET per GPU (any other value = unmanaged, never selectable).
    Growth is allowed while the basket holds strictly fewer GPUs than its
    cap; the grown GPU is the lowest-index pool member.  A grown GPU
    joins the basket even when the host-level CPU/RAM check then blocks
    the placement (the paper's Alg. 3 fetches first, places second) — in
    that case pick is -1 but ``grew`` is still True.

    Returns ``(pick, grew, grow_idx)``.
    """
    is_heavy = xp.asarray(is_heavy)
    want = xp.where(is_heavy, HEAVY_BASKET, LIGHT_BASKET)
    cap = xp.where(is_heavy, heavy_cap, light_cap)
    in_basket = basket == want
    fits = T.fits[mid, free, pids[mid]] & host_ok & in_basket
    pick = first_true(xp, fits)
    pool_free = basket == POOL
    grew = (pick < 0) & (in_basket.sum() < cap) & xp.any(pool_free)
    grow_idx = xp.argmax(pool_free)
    grown_pick = xp.where(grew & host_ok[grow_idx], grow_idx, -1)
    return xp.where(pick >= 0, pick, grown_pick), grew, grow_idx


# ---------------------------------------------------------------------------
# GRMU defragmentation (Alg. 4)
# ---------------------------------------------------------------------------

def defrag_target(xp, T, mid, free, light_mask):
    """Most fragmented light-basket GPU (first maximizer), or -1 when no
    light GPU has positive fragmentation or the maximizer is empty (the
    paper's sequential code aborts outright in that case)."""
    scores = xp.where(light_mask, T.frag[mid, free], -1.0)
    g = xp.argmax(scores)
    ok = (scores[g] > 0.0) & (free[g] != T.full_mask[mid[g]])
    return xp.where(ok, g, -1)


def repack_gpu(xp, T, mid_g, profiles_by_block):
    """Replay a GPU's residents through the default policy on a mock GPU.

    ``mid_g`` is the GPU's model id; ``profiles_by_block`` is a
    (max_blocks,) int array: the profile index (on that model) of the VM
    whose instance *starts* at block b, or -1.  Iterating blocks in
    ascending order replays VMs in current-placement order, exactly like
    the sequential Alg. 4 replay.

    Returns ``(new_starts (max_blocks,), ok, final_mask, moved)``: the
    re-packed start per original start block (-1 where no VM), whether
    every VM re-fit (the paper assumes yes; callers must abort the defrag
    when False), the mock GPU's final free mask, and how many VMs changed
    blocks (the intra-migration count).
    """
    mock = T.full_mask[mid_g]
    ok = xp.asarray(True)
    moved = xp.asarray(0)
    new_starts = []
    for b in range(T.max_blocks):
        p = profiles_by_block[b]
        has = p >= 0
        pp = xp.maximum(p, 0)
        fit = T.fits[mid_g, mock, pp] & has
        ok = ok & (fit | ~has)
        ns = xp.where(fit, T.assign_start[mid_g, mock, pp], -1)
        new_starts.append(ns)
        moved = moved + xp.where(fit & (ns != b), 1, 0)
        mock = xp.where(fit, T.assign_mask[mid_g, mock, pp], mock)
    return xp.stack(new_starts), ok, mock, moved


# ---------------------------------------------------------------------------
# GRMU consolidation (Alg. 5)
# ---------------------------------------------------------------------------

def consolidation_candidates(xp, T, mid, free, light_mask, vm_count,
                             sole_profile):
    """Half-full, single-VM light GPUs holding a half-GPU instance
    (3g/4g.20gb on the A100-40GB).  ``sole_profile`` is the sole VM's
    profile index on its own GPU's model (-1 where not single-VM)."""
    half = (free == T.lower_half[mid]) | (free == T.upper_half[mid])
    prof_ok = (T.consolidatable[mid, xp.maximum(sole_profile, 0)]
               & (sole_profile >= 0))
    return light_mask & half & (vm_count == 1) & prof_ok


def consolidation_plan(xp, T, mid, free, cand, sole_pids, sole_cpu,
                       sole_ram, gpu_host, cpu_used, ram_used, cpu_cap,
                       ram_cap):
    """Greedy pairing of consolidation candidates (Alg. 5's while loop).

    ``sole_pids`` is (G, num_models): each candidate GPU's sole VM mapped
    onto every fleet model (-1 rows where no sole VM), so a source's
    profile is resolved against each potential *target's* model.  Scans
    sources in globalIndex order; each source merges onto the first later
    still-available candidate that fits its profile (4g.20gb only fits a
    free lower half) and whose host has CPU/RAM headroom.  Paired GPUs
    leave the candidate set; a source with no feasible target is dropped
    (it cannot become a target afterwards, matching the paper's
    destructive pop).  Host headroom is updated pair by pair in scan
    order so both engines evolve resource state identically.

    Returns ``(tgt_of, cpu_used, ram_used)`` where ``tgt_of[g]`` is the
    target GPU for source ``g`` or -1.
    """
    G = free.shape[0]
    gids = xp.arange(G)

    def body(g, carry):
        avail, tgt_of, cpu_u, ram_u = carry
        # Source g's profile under each candidate target's model.
        p_t = xp.maximum(sole_pids[g, mid], 0)
        c, r, h = sole_cpu[g], sole_ram[g], gpu_host[g]
        host_ok = ((gpu_host == h)
                   | ((cpu_u[gpu_host] + c <= cpu_cap[gpu_host])
                      & (ram_u[gpu_host] + r <= ram_cap[gpu_host])))
        feasible = avail & (gids > g) & T.fits[mid, free, p_t] & host_ok
        tgt = first_true(xp, feasible)
        do = avail[g] & (tgt >= 0)
        tgt_c = xp.maximum(tgt, 0)
        th = gpu_host[tgt_c]
        move = do & (th != h)
        delta_c = xp.where(move, c, xp.asarray(0.0, dtype=cpu_u.dtype))
        delta_r = xp.where(move, r, xp.asarray(0.0, dtype=ram_u.dtype))
        cpu_u = _set_at(xp, cpu_u, h, cpu_u[h] - delta_c)
        cpu_u = _set_at(xp, cpu_u, th, cpu_u[th] + delta_c)
        ram_u = _set_at(xp, ram_u, h, ram_u[h] - delta_r)
        ram_u = _set_at(xp, ram_u, th, ram_u[th] + delta_r)
        avail = avail & (gids != g) & ~(do & (gids == tgt_c))
        tgt_of = _set_at(xp, tgt_of, g, xp.where(do, tgt, -1))
        return avail, tgt_of, cpu_u, ram_u

    init = (cand, xp.full(G, -1, dtype=xp.int32),
            xp.asarray(cpu_used), xp.asarray(ram_used))
    _, tgt_of, cpu_out, ram_out = _fori(xp, G, body, init)
    return tgt_of, cpu_out, ram_out


__all__ = [
    "FF", "BF", "MCC", "MECC", "GRMU", "POLICY_IDS", "POLICY_NAMES",
    "HEAVY_PROFILE", "POOL", "HEAVY_BASKET", "LIGHT_BASKET",
    "LOWER_HALF_FREE", "UPPER_HALF_FREE", "CONSOLIDATABLE",
    "DEFAULT_MODELS", "Tables", "tables_for", "heavy_request",
    "first_true", "mecc_weights", "placement_scores", "select_gpu",
    "grmu_select", "defrag_target", "repack_gpu",
    "consolidation_candidates", "consolidation_plan",
]
