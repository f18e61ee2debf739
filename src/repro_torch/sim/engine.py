# Copied unchanged from repro/sim/engine.py (the JAX package), so the port imports nothing of it.
"""Discrete-time simulation engine (the paper's Cloudy-equivalent, §8).

Each discrete interval (1 h): departures are processed first, then the
step's arrivals are offered to the policy in arrival order, then the
policy's end-of-step hook runs (GRMU defrag on rejection / periodic
consolidation), then hourly metrics are sampled.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional

from ..core.policies import PlacementPolicy
from ..obs import reasons as obs_reasons
from .cluster import Cluster, VM
from .metrics import SimResult


def simulate(cluster: Cluster, policy: PlacementPolicy, vms: List[VM],
             step_hours: float = 1.0,
             horizon: Optional[float] = None,
             progress: Optional[Callable[[float], None]] = None) -> SimResult:
    # Per-profile tallies are keyed by the fleet's *reference* model
    # (cluster.models[0]) — the model VM.profile is expressed in.
    res = SimResult.for_model(policy.name, cluster.models[0])
    res.rejection_reasons = obs_reasons.empty_reason_tally()
    arrivals = sorted(vms, key=lambda v: (v.arrival, v.vm_id))
    if horizon is None:
        horizon = max((v.arrival for v in arrivals), default=0.0) + step_hours
    departures: List[tuple] = []  # heap of (time, vm_id)
    ai = 0
    t = 0.0
    while t < horizon + 1e-9:
        step_end = t + step_hours
        # 1) departures due strictly before the end of this step
        while departures and departures[0][0] <= step_end - 1e-9:
            _, vm_id = heapq.heappop(departures)
            vm = cluster.vms[vm_id]
            cluster.release(vm_id)
            policy.on_departure(vm, t)
        # 2) arrivals in [t, t+step)
        rejected_this_step: List[VM] = []
        while ai < len(arrivals) and arrivals[ai].arrival < step_end - 1e-9:
            vm = arrivals[ai]
            ai += 1
            policy.on_arrival_observed(vm, t)
            res.total_requests += 1
            res.per_profile_total[vm.profile.name] += 1
            if policy.place(vm):
                res.accepted += 1
                res.per_profile_accepted[vm.profile.name] += 1
                res.accepted_ids.append(vm.vm_id)
                heapq.heappush(departures, (vm.departure, vm.vm_id))
            else:
                res.rejected += 1
                code = policy.rejection_reason(vm)
                res.rejection_reasons[obs_reasons.REASON_NAMES[code]] += 1
                rejected_this_step.append(vm)
        # 3) policy end-of-step hook (defrag / consolidation)
        policy.on_step_end(t, rejected_this_step)
        # 4) hourly metrics
        res.hourly_times.append(t)
        res.hourly_acceptance.append(
            res.accepted / max(1, res.total_requests))
        res.hourly_active_hw.append(cluster.active_hardware_rate())
        if progress is not None:
            progress(t)
        t = step_end
    res.migrations = policy.migrations
    res.intra_migrations = getattr(policy, "intra_migrations", 0)
    res.inter_migrations = getattr(policy, "inter_migrations", 0)
    return res


__all__ = ["simulate"]
