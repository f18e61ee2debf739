# Copied unchanged from repro/core/adaptive.py (the JAX package), so the port imports nothing of it.
"""Beyond-paper extension: GRMU with adaptive heavy-basket capacity.

The paper tunes the heavy-basket capacity offline per workload (§8.2.1:
"The parameters are tuned per workload and must be adjusted for each
provider pattern").  AdaptiveGRMU replaces the static cap with a
feedback controller exploiting the Fig. 6 peak structure: one GPU moved
to the light basket yields ~blocks_per_gpu/avg_light_size (~3.5) VM
acceptances, versus 1 for the heavy basket, so whenever the light class
shows non-negligible rejections the cap should SHRINK; only when light
rejections are ~zero (reserved capacity idle) and heavy demand is unmet
should it GROW.  Naive "grow toward the class with more rejections"
oscillates to the 7g-monopolized corner the paper's quota exists to
prevent (measured: acceptance 0.656 -> 0.511) — kept in
benchmarks/adaptive.py as the ablation.

Shrinking only reclaims *empty* heavy GPUs, so the controller never
induces migrations by itself.

Findings (benchmarks/adaptive.py, EXPERIMENTS.md §Beyond-paper): the
controller correctly RECOVERS the offline-tuned 30% set-point from
either side (15% -> 31%, 50% -> 30%), but on the calibrated trace —
where accepted pods are near-permanent — transient over-admissions
during convergence are irreversible, so end-to-end acceptance trails
any reasonable static cap.  Use it as a *shadow/canary* tuner (run it
to find the set-point, then pin the cap), not as a live controller,
unless the workload churns.
"""
from __future__ import annotations

from typing import List, Optional

from ..sim.cluster import Cluster, VM
from .grmu import GRMU


class AdaptiveGRMU(GRMU):
    name = "GRMU-adaptive"

    def __init__(self, cluster: Cluster, heavy_capacity_frac: float = 0.30,
                 adapt_interval: float = 24.0, step_frac: float = 0.02,
                 min_frac: float = 0.10, max_frac: float = 0.60,
                 light_tolerance: float = 0.02, naive: bool = False,
                 **kw):
        super().__init__(cluster, heavy_capacity_frac=heavy_capacity_frac,
                         **kw)
        self.adapt_interval = adapt_interval
        self.step = max(1, int(round(step_frac * cluster.num_gpus)))
        self.min_cap = int(round(min_frac * cluster.num_gpus))
        self.max_cap = int(round(max_frac * cluster.num_gpus))
        self.light_tolerance = light_tolerance
        self.naive = naive                 # ablation: majority-rejection rule
        self._last_adapt = 0.0
        self._heavy_rejected = 0
        self._light_rejected = 0
        self._arrivals = 0
        self.adaptations: List[tuple] = []

    def on_arrival_observed(self, vm: VM, now: float) -> None:
        self._arrivals += 1
        super().on_arrival_observed(vm, now)

    def on_step_end(self, now: float, rejected: List[VM]) -> None:
        for vm in rejected:
            if vm.profile.name == "7g.40gb":
                self._heavy_rejected += 1
            else:
                self._light_rejected += 1
        super().on_step_end(now, rejected)
        if now - self._last_adapt < self.adapt_interval:
            return
        self._last_adapt = now
        h, l, n = self._heavy_rejected, self._light_rejected, self._arrivals
        self._heavy_rejected = self._light_rejected = 0
        self._arrivals = 0
        if h == 0 and l == 0:
            return
        if self.naive:
            grow = h > l
        else:
            # per-GPU marginal: light saturation always wins; grow only
            # when the light reservation is demonstrably idle.
            grow = (l <= self.light_tolerance * max(1, n)) and h > 0
        if grow:
            new_cap = min(self.max_cap, self.heavy_capacity + self.step)
        else:
            new_cap = max(self.min_cap, self.heavy_capacity - self.step)
            # shrinking below current usage only blocks future growth;
            # reclaim EMPTY heavy GPUs so the pool can serve light demand
            if new_cap < len(self.heavy):
                for gid in list(self.heavy):
                    if len(self.heavy) <= new_cap:
                        break
                    gpu = self.cluster.gpu_index[gid][1]
                    if gpu.is_empty:
                        self.heavy.remove(gid)
                        self.pool.add(gid)
        if new_cap != self.heavy_capacity:
            self.adaptations.append((now, self.heavy_capacity, new_cap))
            self.heavy_capacity = new_cap
            self.light_capacity = self.cluster.num_gpus - new_cap


__all__ = ["AdaptiveGRMU"]
