# Copied unchanged from repro/core/enumerate.py (the JAX package), so the port imports nothing of it.
"""Configuration-space analysis of a single MIG GPU (paper §5.1).

A *configuration* is a set of mutually non-overlapping placed GIs,
identified by their (profile, start) slot indices on one
:class:`~repro.core.mig.DeviceModel`.  DFS from the empty GPU adding one
GI at a time reaches every such set; on the paper's A100-40GB (the
default model) this reproduces the paper's counts exactly — 723 unique
configurations, 78 terminal (maximal) ones, and 482 (67%) in
CC-suboptimal arrangements of their own GI multiset (see
tests/test_enumerate.py).  Every function takes the device model as an
argument, so the same machinery enumerates the A30's 4-block space or
the H100's; results are cached per model.

The paper additionally reports 248 default-policy-reachable
configurations; that number depends on an unspecified tie-breaking detail
of the observed NVIDIA driver.  Under our first-maximizer tie-break the
reachable set has 179 configurations (297 if every CC-maximizing tie is
explored); we record the discrepancy here and in EXPERIMENTS.md rather
than force-fit it.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Dict, FrozenSet, List, Set, Tuple

from .mig import DEFAULT_MODEL, DeviceModel, blocks_of, get_cc

Config = FrozenSet[int]  # set of slot indices (model-relative)


def used_mask(config: Config, model: DeviceModel = DEFAULT_MODEL) -> int:
    m = 0
    for i in config:
        m |= model.slot_masks[i]
    return m


def free_blocks(config: Config,
                model: DeviceModel = DEFAULT_MODEL) -> FrozenSet[int]:
    um = used_mask(config, model)
    return frozenset(b for b in range(model.num_blocks)
                     if not (um & (1 << b)))


@functools.lru_cache(maxsize=None)
def all_configurations(model: DeviceModel = DEFAULT_MODEL
                       ) -> FrozenSet[Config]:
    """Every reachable configuration (including the empty GPU)."""
    seen: Set[Config] = set()
    stack: List[Tuple[Config, int]] = [(frozenset(), 0)]
    while stack:
        config, um = stack.pop()
        if config in seen:
            continue
        seen.add(config)
        for i in range(model.num_slots):
            if not (um & model.slot_masks[i]):
                stack.append((config | frozenset([i]),
                              um | model.slot_masks[i]))
    return frozenset(seen)


def is_terminal(config: Config, model: DeviceModel = DEFAULT_MODEL) -> bool:
    um = used_mask(config, model)
    return all(um & model.slot_masks[i] for i in range(model.num_slots))


@functools.lru_cache(maxsize=None)
def terminal_configurations(model: DeviceModel = DEFAULT_MODEL
                            ) -> FrozenSet[Config]:
    return frozenset(c for c in all_configurations(model)
                     if is_terminal(c, model))


def gi_multiset(config: Config,
                model: DeviceModel = DEFAULT_MODEL) -> Tuple[str, ...]:
    return tuple(sorted(model.slots[i][0].name for i in config))


def config_cc(config: Config, model: DeviceModel = DEFAULT_MODEL) -> int:
    return get_cc(free_blocks(config, model), model.profiles)


@functools.lru_cache(maxsize=None)
def suboptimal_configurations(model: DeviceModel = DEFAULT_MODEL
                              ) -> FrozenSet[Config]:
    """Configs whose CC is below the best arrangement of the same multiset."""
    groups: Dict[Tuple[str, ...], List[Config]] = defaultdict(list)
    for c in all_configurations(model):
        groups[gi_multiset(c, model)].append(c)
    sub: Set[Config] = set()
    for cs in groups.values():
        best = max(config_cc(c, model) for c in cs)
        sub.update(c for c in cs if config_cc(c, model) < best)
    return frozenset(sub)


def default_policy_reachable(explore_ties: bool = False,
                             model: DeviceModel = DEFAULT_MODEL
                             ) -> FrozenSet[Config]:
    """Configurations reachable by sequential default-policy placement.

    explore_ties=False uses the deterministic first-maximizer tie-break of
    ``GPU.assign``; True explores every CC-maximizing start (an upper bound
    on any tie-break the driver might use).
    """
    slot_idx = {(model.slots[i][0].name, model.slots[i][1]): i
                for i in range(model.num_slots)}
    seen: Set[Config] = set()
    stack: List[Config] = [frozenset()]
    while stack:
        config = stack.pop()
        if config in seen:
            continue
        seen.add(config)
        free = free_blocks(config, model)
        for p in model.profiles:
            best_starts: List[int] = []
            max_cc = -1
            for start in p.start_blocks:
                blocks = blocks_of(p, start)
                if blocks <= free:
                    cc = get_cc(free - blocks, model.profiles)
                    if cc > max_cc:
                        best_starts, max_cc = [start], cc
                    elif cc == max_cc and explore_ties:
                        best_starts.append(start)
            for start in best_starts:
                stack.append(config | frozenset([slot_idx[(p.name, start)]]))
    return frozenset(seen)


def per_profile_capacity(config: Config,
                         model: DeviceModel = DEFAULT_MODEL
                         ) -> Dict[str, int]:
    """How many of each profile can still be greedily packed (Table 3 style):
    pack instances of one profile alone into the free blocks, per profile."""
    out: Dict[str, int] = {}
    base = free_blocks(config, model)
    for p in model.profiles:
        free = set(base)
        count = 0
        for start in p.start_blocks:
            blocks = blocks_of(p, start)
            if blocks <= free:
                free -= blocks
                count += 1
        out[p.name] = count
    return out


def summary(model: DeviceModel = DEFAULT_MODEL) -> Dict[str, int]:
    return {
        "unique_configurations": len(all_configurations(model)),
        "terminal_configurations": len(terminal_configurations(model)),
        "suboptimal_configurations": len(suboptimal_configurations(model)),
        "default_reachable_first_tie":
            len(default_policy_reachable(False, model)),
        "default_reachable_all_ties":
            len(default_policy_reachable(True, model)),
    }


__all__ = [
    "Config", "all_configurations", "terminal_configurations",
    "suboptimal_configurations", "default_policy_reachable",
    "gi_multiset", "config_cc", "free_blocks", "used_mask",
    "per_profile_capacity", "is_terminal", "summary",
]
