"""Replay inputs for the port-vs-JAX tests (not a test module).

``random_scenario`` and ``hetero_scenario`` are copies of the scenarios in
tests/test_equivalence.py, taking the package whose objects to build, so
that the JAX package and the port replay VM lists built from the same
numpy draws.  ``JAX`` and ``PORT`` name each package's modules.
"""
import types

import numpy as np

from repro.core import batched as jbatched
from repro.core import mig as jmig
from repro.sim import cluster as jcluster
from repro.workload import alibaba as jalibaba
from repro_torch.core import batched as tbatched
from repro_torch.core import mig as tmig
from repro_torch.sim import cluster as tcluster
from repro_torch.workload import alibaba as talibaba

JAX = types.SimpleNamespace(mig=jmig, cluster=jcluster, alibaba=jalibaba,
                            batched=jbatched)
PORT = types.SimpleNamespace(mig=tmig, cluster=tcluster, alibaba=talibaba,
                             batched=tbatched)

HORIZON = 72.0
HETERO_MODELS = ("A30-24GB", "A100-40GB", "H100-80GB")
POLICIES = {"FF": 0, "BF": 1, "MCC": 2, "MECC": 3, "GRMU": 4}


def random_scenario(pkg, seed, n_vms=90, hosts=(2, 1, 4, 1, 2),
                    cpu=9.0, ram=48.0):
    """Small cluster with *tight* host CPU/RAM so host-level rejections
    actually occur, plus short durations so departures matter."""
    rng = np.random.default_rng(seed)
    vms = []
    for i in range(n_vms):
        p = pkg.mig.PROFILES[rng.choice(6, p=[.1, .1, .1, .3, .25, .15])]
        vms.append(pkg.cluster.VM(
            i, p,
            arrival=float(rng.uniform(0, HORIZON * 0.8)),
            duration=float(rng.choice([0.5, 2.0, 5.0, 17.0, 300.0])),
            cpu=float(rng.choice([1.0, 2.0, 4.0, 7.5])),
            ram=float(rng.choice([4.0, 16.0, 31.25]))))
    cluster = pkg.cluster.make_cluster(list(hosts), cpu=cpu, ram=ram)
    return cluster, vms


def hetero_scenario(pkg, seed, n_vms=110, hosts=(2, 1, 4, 1, 2, 2),
                    cpu=9.0, ram=48.0):
    """Mixed A30+A100-40+H100 fleet under the same tight pressure, with
    per-model Eq. 27-30 profile ids biased toward half-GPU profiles."""
    rng = np.random.default_rng(seed)
    models = tuple(pkg.mig.DEVICE_MODELS[n] for n in HETERO_MODELS)
    host_models = [HETERO_MODELS[i % len(HETERO_MODELS)]
                   for i in range(len(hosts))]
    cluster = pkg.cluster.make_cluster(list(hosts), cpu=cpu, ram=ram,
                                       host_models=host_models,
                                       models=models)
    base = pkg.alibaba.profile_u_hat(pkg.mig.DEVICE_MODELS["A100-40GB"])
    tgt = rng.choice(6, size=n_vms, p=[.1, .1, .1, .3, .25, .15])
    u = np.clip(base[tgt] * np.exp(rng.normal(0.0, 0.08, size=n_vms)),
                1e-4, 1.0)
    pids = np.stack([pkg.alibaba.map_gpu_requirement_to_profile(
        u, u_max=1.0, model=m) for m in models], axis=1)
    vms = []
    for i in range(n_vms):
        vms.append(pkg.cluster.VM(
            i, models[0].profiles[int(pids[i, 0])],
            arrival=float(rng.uniform(0, HORIZON * 0.8)),
            duration=float(rng.choice([0.5, 2.0, 5.0, 17.0, 300.0])),
            cpu=float(rng.choice([1.0, 2.0, 4.0, 7.5])),
            ram=float(rng.choice([4.0, 16.0, 31.25])),
            profile_ids=tuple(int(x) for x in pids[i])))
    return cluster, vms


def events_of(pkg, scenario, seed):
    cluster, vms = scenario(pkg, seed)
    return pkg.batched.build_events(vms, cluster)


def replay_both(scenario, seed, policy, port_kw=(), **kw):
    """(JAX result, port result on the CPU) for one scenario and policy;
    ``port_kw`` adds port-only settings (``score_backend``)."""
    pid = POLICIES[policy]
    jev = events_of(JAX, scenario, seed)
    cap = int(round(0.3 * jev.num_gpus))
    jres = jbatched.replay(jev, pid, cap, **kw)
    tev = events_of(PORT, scenario, seed)
    tres = tbatched.replay(tev, pid, cap, device="cpu", **kw,
                           **dict(port_kw))
    return jres, tres


def assert_same_result(jres, tres):
    assert tres.accepted_ids == jres.accepted_ids        # per-VM decisions
    assert tres.total_requests == jres.total_requests
    assert tres.per_profile_total == jres.per_profile_total
    assert tres.per_profile_accepted == jres.per_profile_accepted
    assert tres.hourly_times == jres.hourly_times
    assert tres.hourly_acceptance == jres.hourly_acceptance
    assert tres.hourly_active_hw == jres.hourly_active_hw
    assert tres.active_hw_auc == jres.active_hw_auc
    assert tres.intra_migrations == jres.intra_migrations
    assert tres.inter_migrations == jres.inter_migrations
    assert tres.migrations == jres.migrations
