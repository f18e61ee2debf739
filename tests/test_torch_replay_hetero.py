"""Port replay vs the JAX replay on a mixed A30+A100+H100 fleet, and the
replay state carried across from JAX to the port mid-trace.

The carry-across: the JAX scan runs the first half of the events, its
carry is handed to the port (``state_from_numpy``), the port runs the
rest, and the final state must equal the JAX scan's single run over all
events, key by key (shape, dtype and values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, assert_same_result, events_of,
                              hetero_scenario, random_scenario, replay_both)
from repro.core import batched as JB
from repro_torch.core import batched as B

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["FF", "BF", "MCC", "MECC"])
def test_hetero_baselines_match_jax(policy, seed):
    jres, tres = replay_both(hetero_scenario, seed, policy)
    assert_same_result(jres, tres)
    assert jres.rejected > 0


@pytest.mark.parametrize("cfg", [
    dict(defrag=False, consolidation_interval=None),
    dict(defrag=True, consolidation_interval=6.0),
    dict(defrag=True, defrag_trigger="any", consolidation_interval=12.0),
])
def test_hetero_grmu_matches_jax(cfg):
    intra = inter = 0
    for seed in (0, 1):
        jres, tres = replay_both(hetero_scenario, seed, "GRMU", **cfg)
        assert_same_result(jres, tres)
        intra += tres.intra_migrations
        inter += tres.inter_migrations
    if cfg["defrag"]:
        assert intra > 0 and inter > 0   # Algs. 4-5 ran on the mixed fleet


def test_trace_arrays_match_jax():
    for scenario in (random_scenario, hetero_scenario):
        want = JB.trace_arrays(events_of(JAX, scenario, 1))
        got = B.trace_arrays(events_of(PORT, scenario, 1))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("scenario,policy,cfg", [
    (random_scenario, JB.MECC, {}),
    (hetero_scenario, JB.GRMU, dict(defrag=True,
                                    consolidation_interval=6.0)),
], ids=["mecc-a100", "grmu-hetero"])
def test_jax_half_run_continued_by_port(scenario, policy, cfg):
    seed = 1
    jev = events_of(JAX, scenario, seed)
    cap = int(round(0.3 * jev.num_gpus))
    jst = JB.replay_statics(jev, policy, score_backend="tables", **cfg)
    tr = {k: jnp.asarray(v) for k, v in JB.trace_arrays(jev).items()}
    half = len(jev.kind) // 2
    tr_half = dict(tr, **{k: tr[k][:half] for k in JB.EVENT_KEYS})
    carry = JB._scan_body(jst, JB.init_state(jev, jst), tr_half, cap)
    want = JB._scan_body(jst, JB.init_state(jev, jst), tr, cap)
    want = {k: np.asarray(v) for k, v in want.items()}

    tev = events_of(PORT, scenario, seed)
    st = B.replay_statics(tev, policy, **cfg)
    trace = B.trace_from_numpy(B.trace_arrays(tev), "cpu")
    state = B.state_from_numpy({k: np.asarray(v) for k, v in carry.items()},
                               "cpu")
    got = B.state_to_numpy(B.run_events(st, state, trace, cap, start=half))

    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # And the port's own fresh state matches the JAX initial carry.
    fresh = B.state_to_numpy(B.init_state(tev, st, "cpu"))
    jfresh = {k: np.asarray(v) for k, v in JB.init_state(jev, jst).items()}
    assert fresh.keys() == jfresh.keys()
    for k in jfresh:
        assert fresh[k].dtype == jfresh[k].dtype, k
        np.testing.assert_array_equal(fresh[k], jfresh[k], err_msg=k)
