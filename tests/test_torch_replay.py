"""Port replay (``repro_torch.core.batched``, CPU) vs the JAX replay.

Both packages replay VM lists built from the same numpy draws; per-VM
decisions, per-profile counts, hourly series and migration counts must
be equal exactly, for all five policies on the paper's A100 fleet, MCC
and MECC through both scoring backends, and GRMU with defrag and
consolidation on seeds where they fire.  The mixed A30+A100+H100 fleet
and the state carry-across are in tests/test_torch_replay_hetero.py.
"""
import pytest
import torch

from _torch_scenarios import (JAX, PORT, assert_same_result, events_of,
                              random_scenario, replay_both)
from repro.workload.alibaba import TraceConfig as JTraceConfig
from repro_torch.core import batched as B
from repro_torch.workload.alibaba import TraceConfig, generate

torch.set_num_threads(1)

GRMU_CFGS = {
    "db": dict(defrag=False, consolidation_interval=None),
    "defrag": dict(defrag=True, consolidation_interval=None),
    "cons6": dict(defrag=True, consolidation_interval=6.0),
    "any12": dict(defrag=True, defrag_trigger="any",
                  consolidation_interval=12.0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["FF", "BF"])
def test_ff_bf_match_jax(policy, seed):
    jres, tres = replay_both(random_scenario, seed, policy)
    assert_same_result(jres, tres)
    assert jres.rejected > 0          # host-level pressure is real


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["MCC", "MECC"])
def test_mcc_mecc_match_jax_on_both_backends(policy, seed):
    """The JAX replay scores through its tables on the CPU; the port
    must give its decisions through the tables and through the kernels'
    plain versions alike."""
    jres, tres = replay_both(random_scenario, seed, policy,
                             port_kw=dict(score_backend="tables"))
    assert_same_result(jres, tres)
    kres = B.replay(events_of(PORT, random_scenario, seed),
                    B.MCC if policy == "MCC" else B.MECC,
                    device="cpu", score_backend="kernel")
    assert_same_result(jres, kres)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cfg", sorted(GRMU_CFGS))
def test_grmu_matches_jax(cfg, seed):
    jres, tres = replay_both(random_scenario, seed, "GRMU", **GRMU_CFGS[cfg])
    assert_same_result(jres, tres)


def test_grmu_defrag_and_consolidation_fire():
    """Seeds on which both migration paths run, so the equalities above
    are not vacuous for Algs. 4-5."""
    intra = inter = 0
    for seed in (1, 3):
        jres, tres = replay_both(random_scenario, seed, "GRMU",
                                 **GRMU_CFGS["cons6"])
        assert_same_result(jres, tres)
        intra += tres.intra_migrations
        inter += tres.inter_migrations
    assert intra > 0 and inter > 0


def test_alibaba_anchor_grmu_db():
    """TraceConfig(scale=0.1, seed=1), GRMU at the DB point: 516 of 806
    accepted, as the JAX package's BENCH_batched_engine.json records."""
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    events = B.build_events(vms, cluster)
    res = B.replay(events, B.GRMU, device="cpu", **GRMU_CFGS["db"])
    assert (res.accepted, res.total_requests) == (516, 806)
    jcluster, jvms = JAX.alibaba.generate(JTraceConfig(scale=0.1, seed=1))
    jres = JAX.batched.replay(JAX.batched.build_events(jvms, jcluster),
                              JAX.batched.GRMU, **GRMU_CFGS["db"])
    assert_same_result(jres, res)


def test_score_backend_resolution():
    events = events_of(PORT, random_scenario, 0)
    st = B.replay_statics(events, B.MCC)
    assert st.score_backend == "kernel"
    assert B.replay_statics(events, B.FF).score_backend == "tables"
    with pytest.raises(ValueError):
        B.replay_statics(events, B.FF, score_backend="kernel")
    with pytest.raises(ValueError):
        B.replay_statics(events, B.MCC, score_backend="pallas")
    assert B.replay_statics(events, B.MCC, telemetry=True).telemetry
    assert not st.telemetry
    # Sharded statics score through the tables, as the JAX package's.
    sharded = B.replay_statics(events, B.MCC, num_shards=2)
    assert (sharded.score_backend, sharded.num_shards) == ("tables", 2)
    assert B.replay_statics(events, B.MCC).num_shards == 0
    with pytest.raises(ValueError, match="sharded"):
        B.replay_statics(events, B.MCC, score_backend="kernel",
                         num_shards=1)
