"""The port's copy of the adaptive heavy-basket controller
(``repro_torch.core.adaptive``) through the port's sequential engine:
the JAX package's tests (tests/test_adaptive.py) on the copy, and the
copy against the JAX package's ``AdaptiveGRMU`` decision for decision.
"""
import pytest

from repro.core.adaptive import AdaptiveGRMU as JAdaptiveGRMU
from repro.sim.engine import simulate as jsimulate
from repro.workload.alibaba import TraceConfig as JTraceConfig
from repro.workload.alibaba import generate as jgenerate
from repro_torch.core.adaptive import AdaptiveGRMU
from repro_torch.core.mig import PROFILE_BY_NAME
from repro_torch.sim.cluster import VM, make_cluster
from repro_torch.sim.engine import simulate
from repro_torch.workload.alibaba import TraceConfig, generate


def test_grows_when_light_idle_and_heavy_starved():
    cluster = make_cluster([1] * 20)
    pol = AdaptiveGRMU(cluster, heavy_capacity_frac=0.10,
                       adapt_interval=1.0, step_frac=0.10)
    vms = [VM(i, PROFILE_BY_NAME["7g.40gb"], arrival=float(i % 5),
              duration=1e9, cpu=0, ram=0) for i in range(12)]
    simulate(cluster, pol, vms, horizon=10.0)
    # heavy-only workload, zero light rejections -> cap must have grown
    assert pol.heavy_capacity > pol.min_cap
    assert len(pol.adaptations) >= 1
    assert all(new > old for _, old, new in pol.adaptations)


def test_shrinks_when_light_rejections_appear():
    cluster = make_cluster([1] * 10)
    pol = AdaptiveGRMU(cluster, heavy_capacity_frac=0.60,
                       adapt_interval=1.0, step_frac=0.10,
                       defrag=False)
    # saturate light capacity -> light rejections -> shrink
    vms = ([VM(i, PROFILE_BY_NAME["3g.20gb"], arrival=0.0, duration=1e9,
               cpu=0, ram=0) for i in range(30)]
           + [VM(100 + i, PROFILE_BY_NAME["1g.5gb"], arrival=float(1 + i),
                 duration=1e9, cpu=0, ram=0) for i in range(30)])
    simulate(cluster, pol, vms, horizon=12.0)
    assert any(new < old for _, old, new in pol.adaptations)


def test_converges_to_tuned_setpoint_small_scale():
    """From a mistuned 50% start, the final cap approaches the tuned 30%."""
    cluster, vms = generate(TraceConfig(scale=0.08, seed=2))
    pol = AdaptiveGRMU(cluster, heavy_capacity_frac=0.50,
                       adapt_interval=24.0)
    simulate(cluster, pol, vms)
    final_frac = pol.heavy_capacity / cluster.num_gpus
    assert final_frac <= 0.42, final_frac   # moved decisively toward 0.30


@pytest.mark.parametrize("start,naive", [(0.50, False), (0.15, False),
                                         (0.50, True)])
def test_adaptive_grmu_equals_jax(start, naive):
    """The copy through the port's engine equals the JAX package's
    ``AdaptiveGRMU`` through its engine: accepted VMs, every adaptation
    (time, old cap, new cap), migrations and the final cap."""
    cfg = dict(heavy_capacity_frac=start, adapt_interval=24.0, naive=naive)
    cluster, vms = generate(TraceConfig(scale=0.08, seed=2))
    pol = AdaptiveGRMU(cluster, **cfg)
    res = simulate(cluster, pol, vms)
    jcluster, jvms = jgenerate(JTraceConfig(scale=0.08, seed=2))
    jpol = JAdaptiveGRMU(jcluster, **cfg)
    jres = jsimulate(jcluster, jpol, jvms)
    assert res.accepted_ids == jres.accepted_ids
    assert pol.adaptations == jpol.adaptations and pol.adaptations
    assert (res.intra_migrations, res.inter_migrations) == (
        jres.intra_migrations, jres.inter_migrations)
    assert res.hourly_active_hw == jres.hourly_active_hw
    assert pol.heavy_capacity == jpol.heavy_capacity
