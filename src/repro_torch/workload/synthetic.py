# Copied unchanged from repro/workload/synthetic.py (the JAX package), so the port imports nothing of it.
"""Hyperscale synthetic workloads — million-VM traces as flat arrays.

The Alibaba-shaped generator (``repro.workload.alibaba``) materializes
one ``VM`` object per request, which is fine at trace scale (8k VMs) but
dominates wall-clock and RSS at 1M+.  This module draws the same
statistical shape — Fig. 5 profile mix pushed through the Eq. 27-30
mapping, bursty Poisson arrivals, lognormal durations, the Alibaba 1/2/4
GPU-per-host mix — entirely as numpy arrays and lowers them straight
through ``repro.core.batched.build_events_arrays``, skipping VM objects.
Durations are short relative to the horizon (churn, not saturation), so
the trace exercises the departure/arrival steady state a production
replayer sees rather than the paper's overload regime.

The VM stream is generated **in chunks** (``SyntheticConfig.chunk_vms``)
straight into packed output arrays — no per-VM objects, no full-stream
wide temporaries — so trace construction RSS scales to the benchmark
ladder's 10M-VM / 100k-GPU rung (``benchmarks/batched_engine.py``),
whose replay then streams through ``repro.core.streaming``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.batched import EventTrace, build_events_arrays
from ..core.mig import A100_40GB, DeviceModel, get_model
from .alibaba import (FIG5_PROFILE_MIX, HOST_GPU_MIX, profile_u_hat,
                      map_gpu_requirement_to_profile)


@dataclasses.dataclass
class SyntheticConfig:
    n_vms: int = 1_000_000
    n_gpus: int = 10_000          # target; hosts drawn until reached
    horizon_hours: float = 2048.0
    mean_duration_hours: float = 48.0
    duration_sigma: float = 1.0
    seed: int = 0
    step_hours: float = 1.0
    # VM-stream generation chunk: per-chunk temporaries (float64 draws,
    # profile targets) are O(chunk), so a 10M-VM stream never holds more
    # than one chunk of wide intermediates alongside the packed outputs.
    chunk_vms: int = 1_000_000
    # Host CPU/RAM sized so MIG capacity binds, not the host envelope
    # (a 4-GPU host can run 28 small VMs: cpu <= 84, ram <= 896).
    host_cpu: float = 96.0
    host_ram: float = 1024.0
    # None = the paper's homogeneous A100-40GB fleet.
    fleet: Optional[Dict[str, float]] = None


def synthetic_fleet(cfg: SyntheticConfig
                    ) -> Tuple[Tuple[DeviceModel, ...], np.ndarray,
                               np.ndarray, np.ndarray, np.ndarray]:
    """Draw hosts (Alibaba 1/2/4 GPU mix) until ``n_gpus`` is covered.
    Returns (models, gpu_model_id, gpu_host_id, cpu_cap, ram_cap)."""
    rng = np.random.default_rng([cfg.seed, 0x905])
    counts = np.array(list(HOST_GPU_MIX.keys()))
    probs = np.array(list(HOST_GPU_MIX.values()), np.float64)
    mean_per_host = float(counts @ (probs / probs.sum()))
    n_draw = int(cfg.n_gpus / mean_per_host * 1.1) + 8
    per_host = rng.choice(counts, size=n_draw, p=probs / probs.sum())
    n_hosts = int(np.searchsorted(np.cumsum(per_host), cfg.n_gpus) + 1)
    per_host = per_host[:n_hosts]

    if cfg.fleet is None:
        models: Tuple[DeviceModel, ...] = (A100_40GB,)
        host_mid = np.zeros(n_hosts, np.int32)
    else:
        models = tuple(get_model(n) for n in cfg.fleet)
        fracs = np.array(list(cfg.fleet.values()), np.float64)
        host_mid = rng.choice(len(models), size=n_hosts,
                              p=fracs / fracs.sum()).astype(np.int32)
    gpu_host_id = np.repeat(np.arange(n_hosts, dtype=np.int32),
                            per_host)
    gpu_model_id = host_mid[gpu_host_id]
    cpu_cap = np.full(n_hosts, cfg.host_cpu, np.float32)
    ram_cap = np.full(n_hosts, cfg.host_ram, np.float32)
    return models, gpu_model_id, gpu_host_id, cpu_cap, ram_cap


def generate_vm_arrays(cfg: SyntheticConfig,
                       models: Tuple[DeviceModel, ...]):
    """The VM stream as packed flat arrays, generated **in chunks**.

    Outputs are preallocated once at their final (packed) widths —
    float64 arrival/duration, float32 cpu/ram, int16 per-model profiles
    — and every wide intermediate (exponential/lognormal draws, profile
    targets, the Eq. 27-30 inputs) exists only at ``cfg.chunk_vms``
    length, so generation RSS is O(outputs + chunk) rather than
    O(n_vms × temporaries).  Returns
    ``(arrivals, durations, cpu, ram, pids)``.
    """
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n_vms
    C = max(1, min(int(cfg.chunk_vms), n)) if n else 1

    # Profiles: Fig. 5 mix through the real Eq. 27-30 mapping per model.
    names = list(FIG5_PROFILE_MIX.keys())
    mix = np.array([FIG5_PROFILE_MIX[k] for k in names])
    mix = mix / mix.sum()
    uhat = profile_u_hat(A100_40GB)
    base_u = np.array([uhat[A100_40GB.profile_index[k]] for k in names])
    ref = models[0]
    compute = np.array([p.compute for p in ref.profiles], np.float64)
    size = np.array([p.size for p in ref.profiles], np.float64)
    mu = np.log(cfg.mean_duration_hours) - 0.5 * cfg.duration_sigma ** 2

    arrivals = np.empty(n, np.float64)
    durations = np.empty(n, np.float64)
    cpu = np.empty(n, np.float32)
    ram = np.empty(n, np.float32)
    pids = np.empty((n, len(models)), np.int16)

    for lo in range(0, n, C):
        hi = min(lo + C, n)
        m = hi - lo
        # Arrivals: bursty Poisson inter-arrival gaps (cumsum'd and
        # stretched to the horizon after the loop — same shape as
        # alibaba.generate, minus the IQR pass).
        inter = rng.exponential(cfg.horizon_hours / n, size=m)
        burst = rng.random(m) < 0.05
        inter[burst] *= 8.0
        arrivals[lo:hi] = inter
        tgt = rng.choice(len(names), size=m, p=mix)
        u = np.clip(base_u[tgt] * np.exp(rng.normal(0.0, 0.08, size=m)),
                    1e-4, 1.0)
        for j, mod in enumerate(models):
            pids[lo:hi, j] = map_gpu_requirement_to_profile(
                u, u_max=1.0, model=mod)
        durations[lo:hi] = np.clip(
            rng.lognormal(mu, cfg.duration_sigma, size=m), 0.5, None)
        ref_p = pids[lo:hi, 0]
        cpu[lo:hi] = 1.0 + 2.0 * compute[ref_p] / ref.max_compute
        ram[lo:hi] = 4.0 + 28.0 * size[ref_p] / ref.num_blocks

    if n:
        np.cumsum(arrivals, out=arrivals)
        arrivals *= cfg.horizon_hours * 0.98 / arrivals[-1]
    return arrivals, durations, cpu, ram, pids


def generate_events(cfg: SyntheticConfig = SyntheticConfig()
                    ) -> EventTrace:
    """The full array-native pipeline: fleet + VM stream -> EventTrace."""
    models, gpu_mid, gpu_host, cpu_cap, ram_cap = synthetic_fleet(cfg)
    arrivals, durations, cpu, ram, pids = generate_vm_arrays(cfg, models)
    return build_events_arrays(
        arrival=arrivals, duration=durations, cpu=cpu, ram=ram,
        vm_ids=np.arange(cfg.n_vms, dtype=np.int64), pids=pids,
        models=models,
        gpu_model_id=gpu_mid, gpu_host_id=gpu_host,
        cpu_cap=cpu_cap, ram_cap=ram_cap,
        step_hours=cfg.step_hours, horizon=cfg.horizon_hours)


__all__ = ["SyntheticConfig", "synthetic_fleet", "generate_vm_arrays",
           "generate_events"]
