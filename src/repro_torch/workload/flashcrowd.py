# Copied unchanged from repro/workload/flashcrowd.py (the JAX package), so the port imports nothing of it.
"""Flash-crowd arrival workload for the online placement service.

The serving benchmark and driver need an arrival process with a *load
spike*: a Poisson base rate with a burst window whose rate is multiplied
— the classic flash crowd that drives the admission governor through its
degradation ladder.  Arrivals are drawn per-hour from the rate profile
(uniform within the hour), profiles follow the paper's Fig. 5 mix pushed
through the Eq. 27-30 mapping, and durations are lognormal, matching the
synthetic hyperscale generator's statistical shape.  The result lowers
through ``build_events_arrays`` so it can be replayed offline (parity
reference) *and* streamed online via
``repro.serve.requests_from_trace``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.batched import EventTrace, build_events_arrays
from ..core.mig import A100_40GB
from .alibaba import (FIG5_PROFILE_MIX, profile_u_hat,
                      map_gpu_requirement_to_profile)


@dataclasses.dataclass
class FlashCrowdConfig:
    n_vms: int = 2000
    n_gpus: int = 64
    gpus_per_host: int = 4
    horizon_hours: float = 96.0
    # Burst window as fractions of the horizon; the arrival rate inside
    # is ``burst_multiplier``x the base Poisson rate.
    burst_start_frac: float = 0.40
    burst_end_frac: float = 0.55
    burst_multiplier: float = 6.0
    mean_duration_hours: float = 12.0
    duration_sigma: float = 1.0
    host_cpu: float = 96.0
    host_ram: float = 1024.0
    vm_cpu_base: float = 1.0
    vm_ram_base: float = 4.0
    step_hours: float = 1.0
    seed: int = 0


def generate_flash_crowd(cfg: FlashCrowdConfig = FlashCrowdConfig()
                         ) -> EventTrace:
    """Homogeneous A100-40GB fleet + flash-crowd VM stream -> EventTrace."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_vms
    S = int(np.ceil(cfg.horizon_hours / cfg.step_hours))

    # Per-hour rate profile: flat base with the burst window multiplied.
    rate = np.ones(S, np.float64)
    lo = int(cfg.burst_start_frac * S)
    hi = max(int(cfg.burst_end_frac * S), lo + 1)
    rate[lo:hi] *= cfg.burst_multiplier
    hours = rng.choice(S, size=n, p=rate / rate.sum())
    arrivals = np.sort((hours + rng.random(n)) * cfg.step_hours)
    # Keep every arrival strictly inside the horizon's step grid.
    arrivals = np.clip(arrivals, 0.0, cfg.horizon_hours * 0.999)

    names = list(FIG5_PROFILE_MIX.keys())
    mix = np.array([FIG5_PROFILE_MIX[k] for k in names])
    mix = mix / mix.sum()
    uhat = profile_u_hat(A100_40GB)
    base_u = np.array([uhat[A100_40GB.profile_index[k]] for k in names])
    tgt = rng.choice(len(names), size=n, p=mix)
    u = np.clip(base_u[tgt] * np.exp(rng.normal(0.0, 0.08, size=n)),
                1e-4, 1.0)
    pids = map_gpu_requirement_to_profile(
        u, u_max=1.0, model=A100_40GB).astype(np.int16).reshape(n, 1)

    mu = np.log(cfg.mean_duration_hours) - 0.5 * cfg.duration_sigma ** 2
    durations = np.clip(rng.lognormal(mu, cfg.duration_sigma, size=n),
                        0.5, None)

    compute = np.array([p.compute for p in A100_40GB.profiles],
                       np.float64)
    size = np.array([p.size for p in A100_40GB.profiles], np.float64)
    ref_p = pids[:, 0]
    cpu = (cfg.vm_cpu_base
           + 2.0 * compute[ref_p] / A100_40GB.max_compute).astype(
               np.float32)
    ram = (cfg.vm_ram_base
           + 28.0 * size[ref_p] / A100_40GB.num_blocks).astype(
               np.float32)

    n_hosts = (cfg.n_gpus + cfg.gpus_per_host - 1) // cfg.gpus_per_host
    gpu_host_id = np.repeat(np.arange(n_hosts, dtype=np.int32),
                            cfg.gpus_per_host)[:cfg.n_gpus]
    return build_events_arrays(
        arrival=arrivals, duration=durations, cpu=cpu, ram=ram,
        vm_ids=np.arange(n, dtype=np.int64), pids=pids,
        models=(A100_40GB,),
        gpu_model_id=np.zeros(cfg.n_gpus, np.int32),
        gpu_host_id=gpu_host_id,
        cpu_cap=np.full(n_hosts, cfg.host_cpu, np.float32),
        ram_cap=np.full(n_hosts, cfg.host_ram, np.float32),
        step_hours=cfg.step_hours, horizon=cfg.horizon_hours)


def burst_window_hours(cfg: FlashCrowdConfig) -> Tuple[float, float]:
    """The burst window in hours (for reports/plots)."""
    S = int(np.ceil(cfg.horizon_hours / cfg.step_hours))
    lo = int(cfg.burst_start_frac * S)
    hi = max(int(cfg.burst_end_frac * S), lo + 1)
    return lo * cfg.step_hours, hi * cfg.step_hours


__all__ = ["FlashCrowdConfig", "generate_flash_crowd",
           "burst_window_hours"]
