"""The port's sequential object engine and the heavy-capacity sweep.

``repro_torch.sim.engine``, ``core.policies``, ``core.grmu`` and
``core.ilp`` are copies of the JAX package's (the policies on the numpy
policy core, ``core.policy_core_np``).  On the scenarios of
tests/test_equivalence.py (``tests/_torch_scenarios.py``: tight host
CPU/RAM, departures, the A100 fleet and the mixed A30+A100+H100 one) they
must give the JAX sequential engine's ``SimResult`` field for field, and
the port's own batched replay must give the same: the JAX package's
two-engine contract, held inside the port.  The sweep must equal the JAX
sweep exactly.
"""
import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, assert_same_result, hetero_scenario,
                              random_scenario)
from repro.core import batched as JB
from repro.core.grmu import GRMU as JGRMU
from repro.core.policies import ILPPolicy as JILP
from repro.core.policies import POLICY_REGISTRY as JREGISTRY
from repro.sim.engine import simulate as jsimulate
from repro.workload.alibaba import TraceConfig as JTraceConfig
from repro.workload.alibaba import generate as jgenerate
from repro_torch.core import batched as B
from repro_torch.core.grmu import GRMU
from repro_torch.core.policies import ILPPolicy, POLICY_REGISTRY
from repro_torch.sim.engine import simulate
from repro_torch.workload.alibaba import TraceConfig, generate

torch.set_num_threads(1)

PIDS = {"FF": B.FF, "BF": B.BF, "MCC": B.MCC, "MECC": B.MECC,
        "GRMU": B.GRMU}
GRMU_KW = {"db": dict(defrag=False, consolidation_interval=None),
           "full": dict(defrag=True, consolidation_interval=6.0),
           "any": dict(defrag=True, defrag_trigger="any",
                       consolidation_interval=12.0)}


def _sequential(pkg, scenario, seed, policy, kw):
    cluster, vms = scenario(pkg, seed)
    if policy == "GRMU":
        grmu = GRMU if pkg is PORT else JGRMU
        pol = grmu(cluster, heavy_capacity_frac=0.3, **kw)
    else:
        pol = (POLICY_REGISTRY if pkg is PORT else JREGISTRY)[policy](
            cluster)
    return (simulate if pkg is PORT else jsimulate)(cluster, pol, vms)


CASES = ([(random_scenario, s, p, {}) for p in ("FF", "BF", "MCC", "MECC")
          for s in (0, 1)]
         + [(random_scenario, s, "GRMU", GRMU_KW[k]) for s in (0, 5)
            for k in GRMU_KW]
         + [(random_scenario, s, "GRMU", GRMU_KW["full"]) for s in (1, 3)]
         + [(hetero_scenario, s, p, GRMU_KW["full"] if p == "GRMU" else {})
            for p in PIDS for s in (0, 1)])


def _id(case):
    scenario, seed, policy, kw = case
    name = next((k for k, v in GRMU_KW.items() if v == kw), "")
    tail = f"-{name}" if name else ""
    return f"{scenario.__name__[:-9]}-{seed}-{policy}{tail}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_sequential_engine_equals_jax_and_the_batched_replay(case):
    scenario, seed, policy, kw = case
    res = _sequential(PORT, scenario, seed, policy, kw)
    jres = _sequential(JAX, scenario, seed, policy, kw)
    assert_same_result(jres, res)
    assert res.rejected == jres.rejected
    assert res.rejection_reasons == jres.rejection_reasons
    cluster, vms = scenario(PORT, seed)
    events = B.build_events(vms, cluster)
    bres = B.replay(events, PIDS[policy], int(round(0.3 * cluster.num_gpus)),
                    device="cpu", **kw)
    assert_same_result(res, bres)


def test_grmu_migration_paths_are_exercised():
    """The GRMU cases above are not vacuous: defrag and consolidation
    move VMs on these seeds."""
    intra = inter = 0
    for seed in (1, 3):
        res = _sequential(PORT, random_scenario, seed, "GRMU",
                          GRMU_KW["full"])
        intra += res.intra_migrations
        inter += res.inter_migrations
    assert intra > 0 and inter > 0


def _ilp_case(pkg):
    rng = np.random.default_rng(11)
    cluster = pkg.cluster.make_cluster([2, 1, 2], cpu=24.0, ram=96.0)
    model = cluster.models[0]
    vms = []
    for i in range(15):
        pid = int(rng.integers(0, model.num_profiles))
        vms.append(pkg.cluster.VM(
            vm_id=100 + i, profile=model.profiles[pid],
            arrival=float(rng.uniform(0, 10)),
            duration=float(rng.uniform(2, 8)), cpu=2.0, ram=4.0,
            profile_ids=(pid,)))
    return cluster, sorted(vms, key=lambda v: (v.arrival, v.vm_id))


@pytest.mark.parametrize("window", [2, 4])
def test_ilp_policy_equals_jax(window):
    """The rolling-horizon MILP policy (``core.ilp`` through
    ``scipy.optimize.milp``) decides and migrates as the JAX package's."""
    results = []
    for pkg, ilp, sim in ((PORT, ILPPolicy, simulate),
                          (JAX, JILP, jsimulate)):
        cluster, vms = _ilp_case(pkg)
        results.append(sim(cluster, ilp(cluster, window=window,
                                        time_limit=2.0), vms,
                           horizon=20.0))
    res, jres = results
    assert_same_result(jres, res)
    assert res.accepted > 0


def test_sweep_equals_the_jax_sweep():
    """tests/test_batched.py's sweep: scale 0.03, capacities 0.2 / 0.3 /
    0.5 of the GPUs, GRMU at the DB point; exactly the JAX numbers."""
    cluster, vms = generate(TraceConfig(scale=0.03, seed=5))
    jcluster, jvms = jgenerate(JTraceConfig(scale=0.03, seed=5))
    fracs = np.array([0.2, 0.3, 0.5])
    got = B.sweep_heavy_capacity(B.build_events(vms, cluster), fracs,
                                 device="cpu")
    want = JB.sweep_heavy_capacity(JB.build_events(jvms, jcluster), fracs)
    assert got.dtype == want.dtype and got.shape == (3, 6)
    np.testing.assert_array_equal(got, want)
    # larger heavy basket never hurts 7g.40gb acceptance
    assert got[0, 5] <= got[1, 5] <= got[2, 5]


def test_sweep_with_full_grmu_equals_per_capacity_replays():
    """With defrag and consolidation on, each row of the sweep is the
    replay at that capacity (one runner serves every capacity)."""
    cluster, vms = generate(TraceConfig(scale=0.02, seed=2))
    events = B.build_events(vms, cluster)
    kw = dict(defrag=True, consolidation_interval=6.0)
    fracs = (0.1, 0.4)
    got = B.sweep_heavy_capacity(events, fracs, device="cpu", **kw)
    for row, f in zip(got, fracs):
        res = B.replay(events, B.GRMU, int(round(f * events.num_gpus)),
                       device="cpu", **kw)
        assert [res.per_profile_accepted[p.name]
                for p in events.models[0].profiles] == row.tolist()


def test_sweep_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    cluster, vms = generate(TraceConfig(scale=0.01, seed=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.sweep_heavy_capacity(B.build_events(vms, cluster), (0.3,))
