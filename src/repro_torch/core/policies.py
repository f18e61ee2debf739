# Copied from repro/core/policies.py (the JAX package), so the port imports nothing of it; one change: it imports the numpy policy core as policy_core_np (the port's policy_core is torch-only).
"""Baseline VM placement policies: FF, BF, MCC, MECC (paper §8.3, Algs. 6-7)
plus the rolling-horizon ILP oracle policy (§6 as an online scheduler).

Every heuristic operates at the upper placement level (host/GPU
traversal); the block-level placement inside a chosen GPU is always
NVIDIA's default CC-maximizing policy (Algorithm 1), which cannot be
overridden.  :class:`ILPPolicy` is the exception: it re-solves the
paper's exact model over a bounded window of recent residents at every
decision point, so it may place at — and migrate residents to — any
legal start block.

The heuristic classes are thin *drivers*: scan feasibility, scoring and
pick semantics live in ``repro.core.policy_core`` (shared verbatim with
the batched JAX engine); this module only adapts them to the object-level
``Cluster`` and keeps MECC's arrival history.  Each driver binds the
policy core's :class:`~repro.core.policy_core.Tables` for its cluster's
fleet (one model axis per device model), so the same classes serve
homogeneous and heterogeneous clusters.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..sim.cluster import Cluster, VM
from . import policy_core_np as pc


class PlacementPolicy:
    """Interface used by the simulation engine.

    Subclasses either set ``POLICY_ID`` (a ``policy_core`` baseline id) or
    override ``place`` entirely (GRMU does).
    """
    name = "base"
    POLICY_ID: Optional[int] = None

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.migrations = 0
        self.intra_migrations = 0
        self.inter_migrations = 0
        # Fleet-wide tables + per-GPU model ids for the policy core.
        self._T = pc.tables_for(np, cluster.models)
        self._mid = cluster.gpu_model_id

    # -- helpers ------------------------------------------------------------
    def _pids(self, vm: VM) -> np.ndarray:
        """Per-model profile indices of the request, (num_models,)."""
        return self.cluster.vm_pids(vm)

    def _is_heavy(self, vm: VM) -> bool:
        return pc.heavy_request(self.cluster.models, self._pids(vm))

    def _place_on(self, vm: VM, gpu_idx: int) -> bool:
        gpu = self.cluster.gpu_index[int(gpu_idx)][1]
        return self.cluster.place(vm, gpu) is not None

    def _mecc_weights(self) -> Optional[np.ndarray]:
        return None

    # -- interface -----------------------------------------------------------
    def place(self, vm: VM) -> bool:
        if self.POLICY_ID is None:
            raise NotImplementedError
        pick = pc.select_gpu(self.POLICY_ID, np, self._T, self._mid,
                             self.cluster.free_masks, self._pids(vm),
                             self.cluster.host_fits_vec(vm),
                             self._mecc_weights())
        if pick < 0:
            return False
        return self._place_on(vm, int(pick))

    def rejection_reason(self, vm: VM) -> int:
        """Reason code (``repro.obs.reasons``) for an arrival ``place``
        just returned False on.  A failed baseline place mutates nothing,
        so classifying lazily from current state sees exactly the
        decision-time cluster — the same flags the batched scan's
        telemetry captures.  GRMU overrides this (growth mutates the
        baskets, so it snapshots its flags inside ``place``)."""
        from ..obs import reasons as obs_reasons  # deferred: no cycle
        free = self.cluster.free_masks
        slot = self._T.fits[self._mid, free, self._pids(vm)[self._mid]]
        host_ok = self.cluster.host_fits_vec(vm)
        return int(obs_reasons.arrival_code(
            np, False, slot.any(), (slot & host_ok).any(), False, False))

    def on_arrival_observed(self, vm: VM, now: float) -> None:
        """Called for every arrival (accepted or not) — MECC history."""

    def on_step_end(self, now: float, rejected: List[VM]) -> None:
        """Called once per time step after all arrivals are processed."""

    def on_departure(self, vm: VM, now: float) -> None:
        """Called after a VM's resources are released."""


class FirstFit(PlacementPolicy):
    """FF: scan hosts/GPUs in index order, place on the first fit."""
    name = "FF"
    POLICY_ID = pc.FF


class BestFit(PlacementPolicy):
    """BF: place on the fitting GPU that minimizes leftover free blocks."""
    name = "BF"
    POLICY_ID = pc.BF


class MaxCC(PlacementPolicy):
    """MCC (Algorithm 6): tentative-assign on every GPU, keep the placement
    with the highest post-assignment CC (first maximizer in index order)."""
    name = "MCC"
    POLICY_ID = pc.MCC


class MaxECC(PlacementPolicy):
    """MECC (Algorithm 7): like MCC but each profile's slot count is
    weighted by its empirical arrival frequency over a look-back window
    (n = 24 h gave the lowest prediction error in the paper).

    The windowed counts are kept per (model, profile): each arrival
    increments its Eq. 27-30 profile on every fleet model, so scoring a
    GPU weights that GPU's model's profile counts."""
    name = "MECC"
    POLICY_ID = pc.MECC

    def __init__(self, cluster: Cluster, window_hours: float = 24.0):
        super().__init__(cluster)
        self.window = window_hours
        self.history: Deque[Tuple[float, np.ndarray]] = deque()
        # int32 like the batched engine's in-scan counts (windowed arrival
        # tallies are tiny): both engines weigh MECC with the same dtype.
        self._counts = np.zeros(
            (len(cluster.models), self._T.num_profiles), dtype=np.int32)
        self._m_arange = np.arange(len(cluster.models))

    def on_arrival_observed(self, vm: VM, now: float) -> None:
        pids = self._pids(vm)
        self.history.append((now, pids))
        self._counts[self._m_arange, pids] += 1
        cutoff = now - self.window
        while self.history and self.history[0][0] < cutoff:
            _, old = self.history.popleft()
            self._counts[self._m_arange, old] -= 1

    def _mecc_weights(self) -> np.ndarray:
        return pc.mecc_weights(np, self._counts)


class ILPPolicy(PlacementPolicy):
    """Rolling-horizon oracle: re-solve the §6 ILP at every decision point.

    Both Turkkan et al.'s optimal MIG placement and the FBK online
    fragmentation-aware scheduler use an exact solver as a rolling-horizon
    baseline; this is that sixth policy.  On each arrival the policy
    builds a :class:`~repro.core.ilp.MigILP` mirroring the live cluster
    (per-GPU device models included) and re-solves a *bounded window*:

    * the newest ``window`` residents are movable (``delta = 1`` — their
      PM/GPU reassignments are charged as Eq. 5 migrations and applied to
      the cluster as real migrations);
    * every older resident is *frozen* at its current placement (its
      blocks stay put; it still occupies host CPU/RAM in Eqs. 6-7);
    * residents are ``must_place`` — the solver may never evict a running
      VM to admit a new one;
    * the arriving VM has ``delta = 0`` (per the paper) and is accepted
      iff the solved window places it.

    The window bounds the MILP to O(window) movable variables per solve,
    which is what makes the oracle runnable inside ``sim/engine.py``'s
    step loop; migrations/intra/inter counters follow the same accounting
    as GRMU, so ``SimResult`` rows are directly comparable.  If the
    solver fails (time limit, infeasible) the cluster is left untouched
    and the arrival is rejected.
    """
    name = "ILP"

    def __init__(self, cluster: Cluster, window: int = 8,
                 time_limit: float = 5.0, w_mig: float = 1e2,
                 mip_rel_gap: float = 1e-9,
                 allow_migration: bool = True):
        # mip_rel_gap stays tight by default: the gap's absolute slack
        # (gap * objective) must stay below MigILP.W_Z or the solver may
        # legally stop at an incumbent that shuffles resident blocks,
        # which this policy would then apply and count as migrations.
        # Policy solves are small (stage 1 fully pinned, stage 2 bounded
        # by `window`), so the tight proof is cheap here.
        super().__init__(cluster)
        from .ilp import MigILP  # deferred: keeps scipy optional here
        self._MigILP = MigILP
        self.window = int(window)
        self.time_limit = float(time_limit)
        self.w_mig = float(w_mig)
        self.mip_rel_gap = float(mip_rel_gap)
        self.allow_migration = allow_migration
        self.solves = 0
        # Residents in acceptance order (recency defines the window) and
        # (host, gpu-slot) coordinates per GPU global index.
        self._order: List[int] = []
        self._loc: Dict[int, Tuple[int, int]] = {}
        for h in cluster.hosts:
            for k, g in enumerate(h.gpus):
                self._loc[g.global_index] = (h.host_id, k)

    def _current_assignment(self, vm_id: int) -> Tuple[int, int, int]:
        host, gpu = self.cluster.placements[vm_id]
        _, start = gpu.placements[vm_id]
        j, k = self._loc[gpu.global_index]
        return j, k, int(start)

    def _solve(self, vm: VM, residents: List[int], movable: frozenset,
               prev: Dict[int, Tuple[int, int, int]]):
        ilp = self._MigILP.from_cluster(self.cluster, w_mig=self.w_mig)
        for vid in residents:
            ilp.add_vm(self.cluster.vms[vid], resident_at=prev[vid],
                       delta=1.0, frozen=vid not in movable,
                       must_place=True)
        ilp.add_vm(vm)
        self.solves += 1
        res = ilp.solve(time_limit=self.time_limit,
                        mip_rel_gap=self.mip_rel_gap)
        # A time-limited incumbent (feasible but unproven) is still a
        # legal layout — the policy applies it; only a solve with no
        # integral solution at all rejects the arrival.
        if (not res.feasible or vm.vm_id not in res.accepted
                or any(vid not in res.accepted for vid in residents)):
            return None  # rejected / solver failure: leave state alone
        return res

    def place(self, vm: VM) -> bool:
        cl = self.cluster
        residents = [vid for vid in self._order if vid in cl.placements]
        prev = {vid: self._current_assignment(vid) for vid in residents}
        # Stage 1: can the arrival be admitted with everything frozen?
        # (Cheap — pinned variables presolve away — and keeps the solver
        # from repacking residents gratuitously: z-moves are free in
        # Eq. 5, so an unconstrained solve shuffles blocks arbitrarily.)
        res = self._solve(vm, residents, frozenset(), prev)
        if (res is None and self.allow_migration and residents
                and self.window > 0):
            # Stage 2: unlock the newest `window` residents and let the
            # oracle migrate them to make room.  (The window>0 guard
            # matters: residents[-0:] would unlock *everything*.)
            res = self._solve(vm, residents,
                              frozenset(residents[-self.window:]), prev)
        if res is None:
            return False
        # Apply resident moves first (release-then-place avoids transient
        # overlap: the solved layout is overlap-free, and unmoved blocks
        # never collide with it).
        moved = [(vid, cl.vms[vid]) for vid in residents
                 if res.accepted[vid] != prev[vid]]
        for vid, _ in moved:
            cl.release(vid)  # pops cluster.vms[vid]; object kept above
        for vid, mvm in moved:
            j, k, z = res.accepted[vid]
            cl.place_at(mvm, cl.hosts[j].gpus[k], z)
            if (j, k) == prev[vid][:2]:
                self.intra_migrations += 1
            else:
                self.inter_migrations += 1
            self.migrations += 1
        j, k, z = res.accepted[vm.vm_id]
        cl.place_at(vm, cl.hosts[j].gpus[k], z)
        self._order.append(vm.vm_id)
        return True

    def on_departure(self, vm: VM, now: float) -> None:
        try:
            self._order.remove(vm.vm_id)
        except ValueError:
            pass


# The scalable §8.3 baselines: full-trace benchmarks iterate this dict,
# so the rolling-horizon ILPPolicy (a per-arrival MILP — oracle-scale
# instances only) is deliberately *not* registered here; import it
# directly where the instance size warrants it (benchmarks/ilp_gap.py).
POLICY_REGISTRY = {
    "FF": FirstFit,
    "BF": BestFit,
    "MCC": MaxCC,
    "MECC": MaxECC,
}

__all__ = ["PlacementPolicy", "FirstFit", "BestFit", "MaxCC", "MaxECC",
           "ILPPolicy", "POLICY_REGISTRY"]
