# Copied unchanged from repro/workload/alibaba.py (the JAX package), so the port imports nothing of it.
"""Synthetic Alibaba-2023-shaped workload (paper §8.1).

The real cluster-trace-gpu-v2023 is not available offline; this module
generates a trace with the same published shape — 1,213 GPU hosts with 1-8
GPUs each, 8,063 MIG-mapped VMs — and implements the paper's pod→profile
mapping math (Eqs. 27-30) and the IQR arrival-outlier filter verbatim, so
swapping in the real CSVs later only changes the ``raw_pods`` source.

Profile mix approximates Fig. 5 (7g.40gb-dominant with a small-profile
tail).  Absolute metric values therefore differ from the paper; the
reproduction targets the paper's relative claims (see DESIGN.md).

Beyond the paper's homogeneous A100-40GB fleet, ``TraceConfig.fleet``
draws each host's device model from a mix (e.g. A30 + A100 + H100): a
pod's raw GPU requirement ``u`` is mapped through Eqs. 27-30 against
*every* fleet model's normalized profile table, producing the per-model
profile-id vector (``VM.profile_ids``) the placement engines consume.
The VM stream itself (arrivals, requirements, durations) is drawn from a
fleet-independent RNG stream, so the *same trace* replays across fleet
mixes (``benchmarks/hetero_sweep.py``).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.mig import A100_40GB, DeviceModel, get_model
from ..sim.cluster import VM, Cluster, make_cluster

# ---------------------------------------------------------------------------
# Eqs. 27-30: pod GPU requirement -> nearest MIG profile
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def profile_u_hat(model: DeviceModel = A100_40GB) -> np.ndarray:
    """Normalized combined profile values Û_k for a device model.

    Eq. 28: U_k = compute_k x memory_k as fractions of the full GPU;
    Eq. 29: Û_k = U_k / max_k U_k.
    """
    u = np.array([(p.compute / model.max_compute)
                  * (p.size / model.num_blocks) for p in model.profiles])
    return u / u.max()


# A100-40GB values (kept for the module's public mapping default).
_PROFILE_U_HAT = profile_u_hat(A100_40GB)


def map_gpu_requirement_to_profile(u: np.ndarray,
                                   u_max: Optional[float] = None,
                                   model: DeviceModel = A100_40GB
                                   ) -> np.ndarray:
    """Eq. 27 + Eq. 30: normalize pod GPU requirements and return the index
    of the closest profile (by normalized combined value) on ``model``.

    ``u_max`` pins Eq. 27's normalizer; by default it is the batch
    maximum (the paper's convention over the full trace)."""
    u = np.asarray(u, dtype=np.float64)
    u_hat = u / (u_max if u_max is not None else u.max())  # Eq. 27
    table = profile_u_hat(model)
    # Eq. 30: argmin_k | Û_k - û |
    return np.argmin(np.abs(table[None, :] - u_hat[:, None]), axis=1)


def iqr_filter(values: np.ndarray) -> np.ndarray:
    """§8.1 IQR outlier removal: keep values within [Q1-1.5*IQR, Q3+1.5*IQR]."""
    q1, q3 = np.percentile(values, [25, 75])
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    return values[(values >= lo) & (values <= hi)]


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

# Fig. 5 profile mix (estimated from the bar chart; 7g.40gb dominant).
# Calibrated so the paper's evaluation regime emerges: demand >> capacity
# with both baskets saturating (see EXPERIMENTS.md §Workload calibration).
FIG5_PROFILE_MIX = {
    "1g.5gb": 0.1856,
    "1g.10gb": 0.0638,
    "2g.10gb": 0.1566,
    "3g.20gb": 0.1160,
    "4g.20gb": 0.0580,
    "7g.40gb": 0.4200,
}

# Host GPU-count mix: Alibaba nodes carry 1-8 GPUs (trace skews small).
HOST_GPU_MIX = {1: 0.70, 2: 0.20, 4: 0.10}

# Example heterogeneous fleets (host-model mixes), usable as
# ``TraceConfig.fleet`` and swept by ``benchmarks/hetero_sweep.py``.
FLEET_PRESETS: Dict[str, Optional[Dict[str, float]]] = {
    "a100": None,                                    # the paper's fleet
    "a30_a100": {"A30-24GB": 0.40, "A100-40GB": 0.60},
    "a100_h100": {"A100-40GB": 0.60, "H100-80GB": 0.40},
    "a30_a100_h100": {"A30-24GB": 0.25, "A100-40GB": 0.50,
                      "H100-80GB": 0.25},
}


@dataclasses.dataclass
class TraceConfig:
    n_hosts: int = 1213
    n_vms: int = 8063
    horizon_hours: float = 720.0          # ~30 days
    # Alibaba-2023 pods are long-running (weeks+); with a 720 h horizon the
    # lognormal below makes most accepted VMs effectively resident, which is
    # what produces the paper's overload regime (39% overall acceptance).
    mean_duration_hours: float = 3000.0
    duration_sigma: float = 1.0
    seed: int = 0
    # Scale knobs for fast tests / sweeps:
    scale: float = 1.0                    # scales hosts & VMs together
    # Heterogeneous fleet: device-model name -> host fraction.  None keeps
    # the paper's homogeneous A100-40GB cluster (and the exact legacy RNG
    # stream).  Host models are drawn from a *separate* RNG stream so the
    # VM trace is identical across fleet mixes of the same seed.
    fleet: Optional[Dict[str, float]] = None


def generate(cfg: TraceConfig = TraceConfig()) -> Tuple[Cluster, List[VM]]:
    rng = np.random.default_rng(cfg.seed)
    n_hosts = max(2, int(cfg.n_hosts * cfg.scale))
    n_vms = max(10, int(cfg.n_vms * cfg.scale))

    # --- hosts -----------------------------------------------------------
    counts = np.array(list(HOST_GPU_MIX.keys()))
    probs = np.array(list(HOST_GPU_MIX.values()))
    gpu_counts = rng.choice(counts, size=n_hosts, p=probs / probs.sum())
    if cfg.fleet is None:
        models: Tuple[DeviceModel, ...] = (A100_40GB,)
        cluster = make_cluster([int(c) for c in gpu_counts])
    else:
        models = tuple(get_model(name) for name in cfg.fleet)
        fracs = np.array(list(cfg.fleet.values()), dtype=np.float64)
        # Separate stream: the VM trace below stays fleet-independent.
        rng_fleet = np.random.default_rng([cfg.seed, 0xF1EE7])
        host_mids = rng_fleet.choice(len(models), size=n_hosts,
                                     p=fracs / fracs.sum())
        cluster = make_cluster(
            [int(c) for c in gpu_counts],
            host_models=[models[int(i)] for i in host_mids],
            models=models)

    # --- arrivals: bursty Poisson mixture, then the paper's IQR filter ----
    # Oversample, IQR-filter inter-arrivals, then trim to n_vms.
    n_raw = int(n_vms * 1.25)
    # Diurnal intensity: base Poisson + bursts.
    inter = rng.exponential(cfg.horizon_hours / n_raw, size=n_raw)
    burst = rng.random(n_raw) < 0.05
    inter[burst] *= 8.0                                   # heavy-tail outliers
    inter = iqr_filter(inter)
    if inter.size < n_vms:                                # top up if over-cut
        extra = rng.exponential(np.median(inter), size=n_vms - inter.size)
        inter = np.concatenate([inter, extra])
    arrivals = np.cumsum(inter[:n_vms])
    arrivals = arrivals / arrivals.max() * cfg.horizon_hours

    # --- pod GPU requirements -> profiles (Eqs. 27-30) --------------------
    # Draw raw utilization u near each A100-40GB profile's U_k with Fig. 5
    # weights, then push through the *actual mapping math* — against every
    # fleet model — so Eqs. 27-30 are exercised end to end.
    names = list(FIG5_PROFILE_MIX.keys())
    mix = np.array([FIG5_PROFILE_MIX[n] for n in names])
    target_idx = rng.choice(len(names), size=n_vms, p=mix / mix.sum())
    base_u = np.array([_PROFILE_U_HAT[A100_40GB.profile_index[n]]
                       for n in names])
    u = base_u[target_idx] * np.exp(rng.normal(0.0, 0.08, size=n_vms))
    u = np.clip(u, 1e-4, 1.0)
    prof_idx = map_gpu_requirement_to_profile(u, u_max=1.0)

    # --- durations: heavy-tailed lognormal --------------------------------
    mu = np.log(cfg.mean_duration_hours) - 0.5 * cfg.duration_sigma ** 2
    durations = rng.lognormal(mu, cfg.duration_sigma, size=n_vms)
    durations = np.clip(durations, 0.5, None)

    # Per-model Eq. 27-30 mapping for heterogeneous fleets.  The reference
    # model (cluster.models[0]) defines VM.profile and the cpu/ram shape.
    ref = cluster.models[0]
    if cfg.fleet is None:
        ref_idx = prof_idx
        all_pids = None
    else:
        pids_per_model = [
            map_gpu_requirement_to_profile(u, u_max=1.0, model=m)
            for m in cluster.models]
        all_pids = np.stack(pids_per_model, axis=1)       # (n_vms, M)
        ref_idx = all_pids[:, 0]

    vms = []
    for i in range(n_vms):
        p = ref.profiles[int(ref_idx[i])]
        vms.append(VM(
            vm_id=i, profile=p,
            arrival=float(arrivals[i]), duration=float(durations[i]),
            cpu=1.0 + 2.0 * p.compute / ref.max_compute,
            ram=4.0 + 28.0 * p.size / ref.num_blocks,
            profile_ids=(tuple(int(x) for x in all_pids[i])
                         if all_pids is not None else None)))
    return cluster, vms


__all__ = ["TraceConfig", "generate", "map_gpu_requirement_to_profile",
           "profile_u_hat", "iqr_filter", "FIG5_PROFILE_MIX",
           "HOST_GPU_MIX", "FLEET_PRESETS"]
