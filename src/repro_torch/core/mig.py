# Copied unchanged from repro/core/mig.py (the JAX package), so the port imports nothing of it.
"""MIG device models: profiles, placement rules, CC metric, default policy.

Implements §3 (Table 1, Fig. 1), §5 (Eq. 1-2, Algorithm 1) of the paper,
generalized from the paper's single A100-40GB to a ``DeviceModel``
abstraction so heterogeneous fleets (A30 / A100-40GB / A100-80GB /
H100-80GB) run through the same machinery.

A GPU is modeled from the memory-block perspective: ``model.num_blocks``
memory blocks (indices 0..B-1).  A GPU Instance (GI) profile occupies
``size`` contiguous blocks starting at one of its legal start blocks.  A
GPU *configuration* ``G`` is the set of FREE block indices (the paper's
convention in Eq. 1-2: ``S(G, p)`` is computed against free blocks).

Module-level ``NUM_BLOCKS`` / ``PROFILES`` / ``SLOTS`` / ... remain as
aliases of the paper's default model (A100-40GB), so all single-model code
and the paper-replication tests are untouched by the generalization.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Profiles (Table 1 + Algorithm 1 start blocks + Table 5 parameters)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    size: int                     # memory blocks (g_i in Table 5)
    compute: int                  # compute engines (Table 1)
    start_blocks: Tuple[int, ...]  # legal starting blocks (Algorithm 1)

    @property
    def last_start(self) -> int:  # s_i in Table 5
        return max(self.start_blocks)


# ---------------------------------------------------------------------------
# Device models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A MIG-capable GPU model: block count + profile table.

    Everything else the framework needs — slot enumeration, slot masks,
    the heavy (full-GPU) profile, the consolidation-eligible profiles and
    half-full masks (Alg. 5), the mask-space size — is derived here, so
    this class is the single source of truth for per-model geometry
    (``core.tables`` materializes arrays from it and the Pallas kernels
    bake its slot templates in as compile-time constants).

    Profile order matters: it is used consistently for iteration, table
    columns, and kernel templates.
    """
    name: str
    num_blocks: int
    profiles: Tuple[Profile, ...]

    def __post_init__(self) -> None:
        if not 1 <= self.num_blocks <= 8:
            # Free masks travel as uint8 arrays (cluster mirrors, mask
            # tables); more than 8 blocks would truncate silently.
            raise ValueError(
                f"{self.name}: num_blocks must be in [1, 8], got "
                f"{self.num_blocks}")
        for p in self.profiles:
            for s in p.start_blocks:
                if s + p.size > self.num_blocks:
                    raise ValueError(
                        f"{self.name}: profile {p.name} start {s} exceeds "
                        f"{self.num_blocks} blocks")

    # -- geometry ----------------------------------------------------------
    @cached_property
    def full_set(self) -> FrozenSet[int]:
        return frozenset(range(self.num_blocks))

    @cached_property
    def full_mask(self) -> int:
        return (1 << self.num_blocks) - 1

    @cached_property
    def num_masks(self) -> int:
        return 1 << self.num_blocks

    @cached_property
    def num_profiles(self) -> int:
        return len(self.profiles)

    # -- slot enumeration (all legal (profile, start) placements) ----------
    @cached_property
    def slots(self) -> Tuple[Tuple[Profile, int], ...]:
        return tuple((p, s) for p in self.profiles for s in p.start_blocks)

    @cached_property
    def num_slots(self) -> int:
        return len(self.slots)

    @cached_property
    def slot_masks(self) -> Tuple[int, ...]:
        """Block mask per slot (bit b set == block b used)."""
        return tuple(sum(1 << (s + i) for i in range(p.size))
                     for p, s in self.slots)

    @cached_property
    def slot_profile(self) -> Tuple[int, ...]:
        """Profile index per slot."""
        return tuple(self.profiles.index(p) for p, _ in self.slots)

    @cached_property
    def slot_starts(self) -> Tuple[int, ...]:
        return tuple(s for _, s in self.slots)

    @cached_property
    def profile_slot_masks(self) -> Tuple[Tuple[int, ...], ...]:
        """Per profile: the slot masks of its legal placements."""
        return tuple(
            tuple(m for m, pi in zip(self.slot_masks, self.slot_profile)
                  if pi == i)
            for i in range(len(self.profiles)))

    # -- lookups -----------------------------------------------------------
    @cached_property
    def profile_by_name(self) -> Dict[str, Profile]:
        return {p.name: p for p in self.profiles}

    @cached_property
    def profile_index(self) -> Dict[str, int]:
        return {p.name: i for i, p in enumerate(self.profiles)}

    @cached_property
    def max_compute(self) -> int:
        return max(p.compute for p in self.profiles)

    # -- policy-relevant structure ----------------------------------------
    @cached_property
    def heavy_profile(self) -> int:
        """Index of the full-GPU profile (GRMU's heavy class), or -1."""
        for i, p in enumerate(self.profiles):
            if p.size == self.num_blocks:
                return i
        return -1

    @cached_property
    def lower_half_free(self) -> int:
        """Free mask of a GPU whose *upper* half is occupied (Alg. 5)."""
        return (1 << (self.num_blocks // 2)) - 1

    @cached_property
    def upper_half_free(self) -> int:
        """Free mask of a GPU whose *lower* half is occupied (Alg. 5)."""
        half = self.num_blocks // 2
        return ((1 << (self.num_blocks - half)) - 1) << half

    @cached_property
    def consolidatable(self) -> Tuple[int, ...]:
        """Profile indices eligible for Alg. 5 consolidation: the ones
        occupying exactly half the GPU (3g/4g.20gb on the A100-40GB)."""
        return tuple(i for i, p in enumerate(self.profiles)
                     if p.size == self.num_blocks // 2)


# -- presets ----------------------------------------------------------------

A100_40GB = DeviceModel("A100-40GB", 8, (
    Profile("1g.5gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
    Profile("1g.10gb", 2, 1, (0, 2, 4, 6)),
    Profile("2g.10gb", 2, 2, (0, 2, 4)),
    Profile("3g.20gb", 4, 3, (0, 4)),
    Profile("4g.20gb", 4, 4, (0,)),
    Profile("7g.40gb", 8, 7, (0,)),
))

A100_80GB = DeviceModel("A100-80GB", 8, (
    Profile("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
    Profile("1g.20gb", 2, 1, (0, 2, 4, 6)),
    Profile("2g.20gb", 2, 2, (0, 2, 4)),
    Profile("3g.40gb", 4, 3, (0, 4)),
    Profile("4g.40gb", 4, 4, (0,)),
    Profile("7g.80gb", 8, 7, (0,)),
))

H100_80GB = DeviceModel("H100-80GB", 8, (
    Profile("1g.10gb", 1, 1, (0, 1, 2, 3, 4, 5, 6)),
    Profile("1g.20gb", 2, 1, (0, 2, 4, 6)),
    Profile("2g.20gb", 2, 2, (0, 2, 4)),
    Profile("3g.40gb", 4, 3, (0, 4)),
    Profile("4g.40gb", 4, 4, (0,)),
    Profile("7g.80gb", 8, 7, (0,)),
))

A30_24GB = DeviceModel("A30-24GB", 4, (
    Profile("1g.6gb", 1, 1, (0, 1, 2, 3)),
    Profile("1g.12gb", 2, 1, (0, 2)),
    Profile("2g.12gb", 2, 2, (0, 2)),
    Profile("4g.24gb", 4, 4, (0,)),
))

DEVICE_MODELS: Dict[str, DeviceModel] = {
    m.name: m for m in (A30_24GB, A100_40GB, A100_80GB, H100_80GB)
}

DEFAULT_MODEL = A100_40GB


def get_model(name: str) -> DeviceModel:
    try:
        return DEVICE_MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown device model {name!r}; known: "
            f"{sorted(DEVICE_MODELS)}") from None


# -- legacy module-level aliases (the paper's A100-40GB) --------------------

NUM_BLOCKS = DEFAULT_MODEL.num_blocks
FULL_GPU: FrozenSet[int] = DEFAULT_MODEL.full_set
PROFILES: Tuple[Profile, ...] = DEFAULT_MODEL.profiles
PROFILE_BY_NAME: Dict[str, Profile] = DEFAULT_MODEL.profile_by_name
PROFILE_INDEX: Dict[str, int] = DEFAULT_MODEL.profile_index
SLOTS: Tuple[Tuple[Profile, int], ...] = DEFAULT_MODEL.slots
NUM_SLOTS = DEFAULT_MODEL.num_slots  # 18
SLOT_MASKS: Tuple[int, ...] = DEFAULT_MODEL.slot_masks


def blocks_of(profile: Profile, start: int) -> FrozenSet[int]:
    """The block set occupied by ``profile`` placed at ``start``."""
    return frozenset(range(start, start + profile.size))


def mask_of(blocks: FrozenSet[int]) -> int:
    m = 0
    for b in blocks:
        m |= 1 << b
    return m


# ---------------------------------------------------------------------------
# Configuration Capability (Eq. 1)
# ---------------------------------------------------------------------------

def available_starts(free: FrozenSet[int], profile: Profile) -> List[int]:
    """S(G, p): start blocks where ``profile`` fits entirely in free blocks."""
    return [s for s in profile.start_blocks if blocks_of(profile, s) <= free]


def get_cc(free: FrozenSet[int],
           profiles: Optional[Sequence[Profile]] = None) -> int:
    """CC = sum over profiles of |S(G, p)|  (Eq. 1 / Algorithm 1 GetCC)."""
    if profiles is None:
        profiles = PROFILES
    return sum(len(available_starts(free, p)) for p in profiles)


# ---------------------------------------------------------------------------
# GPU state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GPU:
    """A MIG-enabled GPU: free blocks + placed (owner -> (profile, start)).

    ``model`` selects the device geometry; ``free`` defaults to the
    model's full free set.
    """
    global_index: int = 0
    free: Optional[FrozenSet[int]] = None
    placements: Dict[object, Tuple[Profile, int]] = dataclasses.field(
        default_factory=dict)
    model: DeviceModel = DEFAULT_MODEL

    def __post_init__(self) -> None:
        if self.free is None:
            self.free = self.model.full_set

    # -- queries ----------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return len(self.placements) == 0

    @property
    def used_blocks(self) -> int:
        return self.model.num_blocks - len(self.free)

    def cc(self) -> int:
        return get_cc(self.free, self.model.profiles)

    def fits(self, profile: Profile) -> bool:
        return bool(available_starts(self.free, profile))

    def copy(self) -> "GPU":
        return GPU(self.global_index, self.free, dict(self.placements),
                   self.model)

    def half_full(self) -> bool:
        """True if exactly the lower or upper half of blocks is occupied."""
        half = self.model.num_blocks // 2
        used = self.model.full_set - self.free
        return (used == frozenset(range(half))
                or used == frozenset(range(half, self.model.num_blocks)))

    def single_profile(self) -> bool:
        return len(self.placements) == 1

    # -- mutation ---------------------------------------------------------
    def assign(self, owner: object, profile: Profile) -> Optional[int]:
        """Algorithm 1 `Assign`: place ``profile`` at the start block that
        maximizes the post-placement CC.  Ties: the NVIDIA policy scans start
        blocks in ascending order and keeps the FIRST maximizer encountered,
        matching the paper's §7.1 example: on an empty GPU the first 1g.5gb
        lands on block 6 and a second one on block 4 (see test_mig.py).

        Returns the chosen start block, or None if the profile doesn't fit.
        """
        best_start: Optional[int] = None
        best_blocks: Optional[FrozenSet[int]] = None
        max_cc = -1
        for start in profile.start_blocks:
            blocks = blocks_of(profile, start)
            if blocks <= self.free:
                cc = get_cc(self.free - blocks, self.model.profiles)
                if cc > max_cc:
                    best_start, best_blocks, max_cc = start, blocks, cc
        if best_start is None:
            return None
        self.free = self.free - best_blocks
        self.placements[owner] = (profile, best_start)
        return best_start

    def assign_at(self, owner: object, profile: Profile, start: int) -> None:
        """Place at an explicit start (used by ILP solutions / migrations)."""
        blocks = blocks_of(profile, start)
        if not blocks <= self.free:
            raise ValueError(
                f"blocks {sorted(blocks)} not free in {sorted(self.free)}")
        self.free = self.free - blocks
        self.placements[owner] = (profile, start)

    def release(self, owner: object) -> None:
        profile, start = self.placements.pop(owner)
        self.free = self.free | blocks_of(profile, start)

    def free_mask(self) -> int:
        return mask_of(self.free)


def gpu_from_free_mask(free_mask: int, global_index: int = 0,
                       model: DeviceModel = DEFAULT_MODEL) -> GPU:
    """Build a GPU with a given free-block bitmask (placements unknown)."""
    free = frozenset(b for b in range(model.num_blocks)
                     if free_mask & (1 << b))
    return GPU(global_index, free, model=model)


# ---------------------------------------------------------------------------
# Fragmentation metric (Algorithm 4, Function Fragmentation)
# ---------------------------------------------------------------------------

def fragmentation(gpu: GPU) -> float:
    """Greedy per-profile packing residue, summed over applicable profiles.

    For each profile with size <= |free blocks of the working copy|, pack as
    many instances as possible (scanning start blocks in order), then add
    (remaining free blocks / profile size).  NOTE: the working copy gpu'
    carries over between profiles per Algorithm 4 (``gpu'`` is mutated in
    the outer loop), and the size guard compares against the *current*
    free-block count of gpu'.
    """
    free = set(gpu.free)
    frag_val = 0.0
    for profile in gpu.model.profiles:
        if profile.size > len(free):
            continue
        for start in profile.start_blocks:
            blocks = blocks_of(profile, start)
            if blocks <= free:
                free -= blocks
        frag_val += len(free) / profile.size
    return frag_val


__all__ = [
    "NUM_BLOCKS", "FULL_GPU", "Profile", "PROFILES", "PROFILE_BY_NAME",
    "PROFILE_INDEX", "SLOTS", "NUM_SLOTS", "SLOT_MASKS",
    "DeviceModel", "DEVICE_MODELS", "DEFAULT_MODEL", "get_model",
    "A30_24GB", "A100_40GB", "A100_80GB", "H100_80GB",
    "blocks_of", "mask_of", "available_starts", "get_cc", "GPU",
    "gpu_from_free_mask", "fragmentation",
]
