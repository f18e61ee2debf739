# Copied from repro/core/grmu.py (the JAX package), so the port imports nothing of it; one change: it imports the numpy policy core as policy_core_np (the port's policy_core is torch-only).
"""GRMU — GPU Resource Management Unit (paper §7, Algorithms 2-5).

Multi-stage placement:
  * Dual-Basket Pooling (Alg. 2): GPUs live in a pool ordered by
    globalIndex; a capacity-capped *heavy basket* serves full-GPU VMs
    (7g.40gb on the paper's A100-40GB) and a *light basket* serves
    everything else.  Each basket starts with one GPU.
  * Allocation (Alg. 3): first-fit over the chosen basket (globalIndex
    order) with the default CC-maximizing block placement; on failure, grow
    the basket from the pool while strictly below the basket's cap.
  * Defragmentation (Alg. 4): when any VM was rejected in a step, re-pack
    the most fragmented light-basket GPU via the default policy and
    intra-GPU-migrate only the VMs whose blocks changed.
  * Consolidation (Alg. 5): every ``consolidation_interval`` hours, merge
    pairs of half-full single-profile (half-GPU, e.g. 3g/4g.20gb) light
    GPUs; emptied GPUs return to the pool.

This class is the sequential *driver*: all decision logic (basket
selection/growth, defrag target + repack, consolidation candidate pairing)
lives in ``repro.core.policy_core`` and is shared verbatim with the
batched JAX engine; here we only apply the decisions to the object-level
``Cluster``.  Heterogeneous fleets work transparently: requests are heavy
iff they map to the full-GPU profile on every fleet model, and defrag /
consolidation resolve profiles against each GPU's own device model.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..sim.cluster import Cluster, VM
from . import policy_core_np as pc
from .policies import PlacementPolicy


class SortedGpuList:
    """GPU ids kept in globalIndex order (the paper's Add/Get/Remove)."""

    def __init__(self, ids: Optional[List[int]] = None):
        self.ids: List[int] = sorted(ids or [])

    def add(self, gid: int) -> None:
        import bisect
        bisect.insort(self.ids, gid)

    def get(self) -> Optional[int]:
        return self.ids.pop(0) if self.ids else None

    def remove(self, gid: int) -> None:
        self.ids.remove(gid)

    def __len__(self) -> int:
        return len(self.ids)

    def __contains__(self, gid: int) -> bool:
        import bisect
        i = bisect.bisect_left(self.ids, gid)
        return i < len(self.ids) and self.ids[i] == gid

    def __iter__(self):
        return iter(self.ids)


class GRMU(PlacementPolicy):
    """The proposed policy.  ``heavy_capacity_frac`` is the §8.2.1 knob
    (0.30 for the evaluation workload); ``consolidation_interval`` in hours
    (None = disabled, the paper's final choice); ``defrag`` toggles Alg. 4.
    """
    name = "GRMU"

    def __init__(self, cluster: Cluster, heavy_capacity_frac: float = 0.30,
                 consolidation_interval: Optional[float] = None,
                 defrag: bool = True, defrag_trigger: str = "light"):
        """``defrag_trigger``: 'light' (default) runs Alg. 4 only when a
        light-profile VM was rejected — defragmenting the light basket
        cannot help a rejected full-GPU VM, which needs a whole GPU; 'any'
        triggers on every rejection (the literal §7.1 wording)."""
        super().__init__(cluster)
        self.defrag_trigger = defrag_trigger
        num_gpus = cluster.num_gpus
        self.heavy_capacity = int(round(heavy_capacity_frac * num_gpus))
        self.light_capacity = num_gpus - self.heavy_capacity
        self.consolidation_interval = consolidation_interval
        self.defrag_enabled = defrag
        self._last_consolidation = 0.0
        # Alg. 2: pool ordered by globalIndex; one GPU pre-assigned to each.
        self.pool = SortedGpuList(list(range(num_gpus)))
        self.heavy = SortedGpuList()
        self.light = SortedGpuList()
        g = self.pool.get()
        if g is not None:
            self.heavy.add(g)
        g = self.pool.get()
        if g is not None:
            self.light.add(g)

    # -- basket views ---------------------------------------------------------
    def _basket_array(self) -> np.ndarray:
        """Per-GPU basket label for the shared policy core.  GPUs tracked
        by none of the three lists get -1 (never selectable/growable)."""
        arr = np.full(self.cluster.num_gpus, -1, dtype=np.int32)
        arr[list(self.pool)] = pc.POOL
        arr[list(self.heavy)] = pc.HEAVY_BASKET
        arr[list(self.light)] = pc.LIGHT_BASKET
        return arr

    def _light_mask(self) -> np.ndarray:
        mask = np.zeros(self.cluster.num_gpus, dtype=bool)
        mask[list(self.light)] = True
        return mask

    # -- Alg. 3: allocation -------------------------------------------------
    def place(self, vm: VM) -> bool:
        heavy = self._is_heavy(vm)
        basket = self.heavy if heavy else self.light
        free = self.cluster.free_masks
        host_ok = self.cluster.host_fits_vec(vm)
        # Pre-growth quota state: the same flag the batched telemetry
        # captures before its basket rebind (repro.obs.reasons cascade).
        quota_full = (len(basket) >=
                      (self.heavy_capacity if heavy else self.light_capacity))
        pick, grew, _ = pc.grmu_select(
            np, self._T, self._mid, free,
            self._pids(vm), heavy, host_ok,
            self._basket_array(), self.heavy_capacity, self.light_capacity)
        if grew:
            # The grown GPU is the lowest-index pool member == pool.get();
            # it joins the basket even when host resources then block the
            # placement (the GPU stays in the basket, empty).
            basket.add(self.pool.get())
        if pick < 0:
            from ..obs import reasons as obs_reasons
            # free/host_ok predate the (possible) growth above; growth
            # never edits free masks, so slot feasibility is still the
            # decision-time view.
            slot = self._T.fits[self._mid, free, self._pids(vm)[self._mid]]
            self._last_reason = int(obs_reasons.arrival_code(
                np, False, slot.any(), (slot & host_ok).any(),
                bool(grew), quota_full))
            return False
        return self._place_on(vm, int(pick))

    def rejection_reason(self, vm: VM) -> int:
        """The code snapshotted by the failed ``place`` just above —
        growth mutates the baskets, so lazy classification would misread
        ``quota_full``."""
        return self._last_reason

    # -- Alg. 4: defragmentation (intra-GPU migration) ------------------------
    def defragment(self) -> int:
        """Re-pack the most fragmented light GPU; returns #migrations."""
        gid = int(pc.defrag_target(np, self._T, self._mid,
                                   self.cluster.free_masks,
                                   self._light_mask()))
        if gid < 0:
            return 0
        gpu = self.cluster.gpu_index[gid][1]
        mid_g = int(self._mid[gid])
        model = self.cluster.models[mid_g]
        # Residents keyed by current start block (starts are unique per
        # GPU); ascending block order == the sequential replay order.
        prof_by_block = np.full(self._T.max_blocks, -1, dtype=np.int32)
        vm_by_block = {}
        for vm_id, (profile, start) in gpu.placements.items():
            prof_by_block[start] = model.profile_index[profile.name]
            vm_by_block[start] = vm_id
        starts, ok, _, moved = pc.repack_gpu(np, self._T, mid_g,
                                             prof_by_block)
        if not ok or int(moved) == 0:
            # Re-pack painted itself into a corner (the paper assumes the
            # replay always succeeds — abort safely), or nothing moved.
            return 0
        # IntraMigrate: apply via release-all/re-place to avoid transient
        # overlaps (device-level this is a staged copy through spare blocks).
        items = [(vm_by_block[b], gpu.placements[vm_by_block[b]][0],
                  int(starts[b]))
                 for b in range(self._T.max_blocks) if prof_by_block[b] >= 0]
        for vm_id, _, _ in items:
            gpu.release(vm_id)
        for vm_id, prof, new_start in items:
            gpu.assign_at(vm_id, prof, new_start)
        self.cluster._sync(gpu)
        n = int(moved)
        self.intra_migrations += n
        self.migrations += n
        return n

    # -- Alg. 5: light-basket consolidation (inter-GPU migration) -------------
    def consolidate(self) -> int:
        """Merge half-full single-profile light GPUs; returns #migrations."""
        cl = self.cluster
        G = cl.num_gpus
        M = len(cl.models)
        vm_count = np.zeros(G, dtype=np.int32)
        sole_pids = np.full((G, M), -1, dtype=np.int32)
        sole_vm = np.full(G, -1, dtype=np.int64)
        sole_cpu = np.zeros(G, dtype=np.float32)
        sole_ram = np.zeros(G, dtype=np.float32)
        for gid in self.light:
            gpu = cl.gpu_index[gid][1]
            vm_count[gid] = len(gpu.placements)
            if len(gpu.placements) == 1:
                vm_id = next(iter(gpu.placements))
                vm = cl.vms[vm_id]
                sole_pids[gid] = cl.vm_pids(vm)
                sole_vm[gid] = vm_id
                sole_cpu[gid] = np.float32(vm.cpu)
                sole_ram[gid] = np.float32(vm.ram)
        # The sole VM's profile on its *own* GPU's model.
        sole_own = sole_pids[np.arange(G), self._mid]
        cand = pc.consolidation_candidates(np, self._T, self._mid,
                                           cl.free_masks, self._light_mask(),
                                           vm_count, sole_own)
        tgt_of, _, _ = pc.consolidation_plan(
            np, self._T, self._mid, cl.free_masks, cand, sole_pids,
            sole_cpu, sole_ram, cl.gpu_host_id, cl.host_cpu_used,
            cl.host_ram_used, cl.host_cpu_cap, cl.host_ram_cap)
        moved = 0
        for src in np.flatnonzero(tgt_of >= 0):
            src = int(src)
            if cl.migrate_inter(int(sole_vm[src]),
                                cl.gpu_index[int(tgt_of[src])][1]):
                # Freed source returns to the pool (Alg. 5 lines 6-7).
                self.light.remove(src)
                self.pool.add(src)
                moved += 1
        self.inter_migrations += moved
        self.migrations += moved
        return moved

    # -- engine hooks ---------------------------------------------------------
    def on_step_end(self, now: float, rejected: List[VM]) -> None:
        if rejected and self.defrag_enabled:
            if (self.defrag_trigger == "any"
                    or any(not self._is_heavy(v) for v in rejected)):
                self.defragment()
        if (self.consolidation_interval is not None
                and now - self._last_consolidation
                >= self.consolidation_interval):
            self.consolidate()
            self._last_consolidation = now


__all__ = ["GRMU", "SortedGpuList"]
