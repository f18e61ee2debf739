"""Sharded-fleet replay of the port (``repro_torch.core.sharded``, CPU,
gloo) vs the JAX package's replay.

Ports of tests/test_sharded.py, the sharded telemetry tests of
tests/test_obs.py and the sharded chunked test of tests/test_streaming.py.
The sharded replay must equal the unsharded one decision for decision,
and the JAX replay: per-VM decisions, hourly series and migration counts,
no tolerance.  K = 1 runs in this process (a one-rank group the port
initialises itself); K = 2 and K = 4 run in fresh processes, one per rank
(``sharded.spawn_fleet``, which also checks that every rank returns the
same outputs).  Both packages replay VM lists built from the same numpy
draws (tests/_torch_scenarios.py); the mixed fleet's 12 GPUs pad to 16
for every K here, so one JAX replay per policy serves all of them.  One
rank over NCCL on the card is in tests/test_torch_gpu.py.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, POLICIES, assert_same_result,
                              events_of, hetero_scenario, random_scenario)
from _torch_sharded_ranks import fail_on_rank, fleet_outputs
from repro.core import sharded as JSH
from repro.core.bucketing import pad_events as jpad_events
from repro.obs import inscan as jinscan
from repro_torch.core import batched as B
from repro_torch.core import sharded as SH
from repro_torch.core import streaming as ST
from repro_torch.core.bucketing import pad_events
from repro_torch.obs import inscan

torch.set_num_threads(1)

GRMU_KW = dict(defrag=True, consolidation_interval=6.0)
CFG = {name: (GRMU_KW if name == "GRMU" else {}) for name in POLICIES}
CHUNK = 32


def port_padded():
    return pad_events(events_of(PORT, hetero_scenario, 0), shards=4)


@functools.lru_cache(maxsize=None)
def jax_padded():
    return jpad_events(events_of(JAX, hetero_scenario, 0), shards=4)


def cap_of(events):
    return B.default_heavy_capacity(events)


@functools.lru_cache(maxsize=None)
def jax_replay(policy, telemetry=False):
    jev = jax_padded()
    if telemetry:
        return jinscan.replay_with_telemetry(jev, POLICIES[policy],
                                             cap_of(jev), **CFG[policy])
    return JAX.batched.replay(jev, POLICIES[policy], cap_of(jev),
                              **CFG[policy])


def test_every_k_pads_the_mixed_fleet_alike():
    ev = events_of(PORT, hetero_scenario, 0)
    assert ev.num_gpus == 12
    shapes = {len(pad_events(ev, shards=k).gpu_model_id) for k in (1, 2, 4)}
    assert shapes == {16}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_sharded_k1_equals_unsharded_and_jax(policy):
    """K = 1 runs the whole sharded path (the slice, the all-gather, the
    reconcile) in this process."""
    pid, kw = POLICIES[policy], CFG[policy]
    pv = port_padded()
    cap = cap_of(pv)
    got = SH.replay_sharded(pv, pid, cap, num_shards=1, device="cpu", **kw)
    assert_same_result(B.replay(pv, pid, cap, device="cpu", **kw), got)
    assert_same_result(jax_replay(policy), got)
    assert_same_result(JSH.replay_sharded(jax_padded(), pid, cap,
                                          num_shards=1, **kw), got)
    if policy == "GRMU":
        assert got.intra_migrations > 0 and got.inter_migrations > 0


def test_sharded_k1_runs_the_shard_path_and_no_kernel():
    run = SH.make_sharded_replay(port_padded(), B.MECC, device="cpu")
    shard = run.runner.step.shard
    assert (shard.num_shards, shard.rank, shard.local) == (1, 0,
                                                           slice(0, 16))
    assert run.runner.st.score_backend == "tables"
    assert tuple(shard.recv.shape) == (3,)


def test_sharded_refusals():
    tev = events_of(PORT, random_scenario, 0)
    with pytest.raises(ValueError, match="world size 1"):
        SH.make_sharded_replay(pad_events(tev, shards=2), B.FF,
                               num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="world size 1"):
        ST.make_chunked_replay(tev, B.FF, chunk_events=CHUNK, num_shards=4,
                               device="cpu")
    with pytest.raises(ValueError, match="sharded path"):
        SH.make_sharded_replay(pad_events(tev), B.MCC, num_shards=1,
                               device="cpu", score_backend="kernel")
    with pytest.raises(ValueError, match="process group"):
        B.make_replay(tev, B.FF, device="cpu", num_shards=1)
    with pytest.raises(ValueError, match="power of two"):
        ST.make_chunked_replay(tev, B.FF, num_shards=3, device="cpu")
    assert SH.rank_device("cpu", 3) == torch.device("cpu")


def test_sharded_replay_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SH.replay_sharded(port_padded(), B.FF, num_shards=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SH.spawn_fleet(fail_on_rank, 1, -1)


# ---------------------------------------------------------------------------
# K = 2 and K = 4: one process per rank
# ---------------------------------------------------------------------------

RANK_RUNS = {
    2: [("FF", B.FF, {}, None), ("MECC", B.MECC, {}, None),
        ("GRMU", B.GRMU, GRMU_KW, None),
        ("FF-telemetry", B.FF, dict(telemetry=True), None),
        ("GRMU-telemetry", B.GRMU, dict(GRMU_KW, telemetry=True), None),
        ("GRMU-chunked", B.GRMU, GRMU_KW, CHUNK),
        ("MECC-chunked", B.MECC, {}, CHUNK)],
    4: [("FF", B.FF, {}, None), ("MECC", B.MECC, {}, None),
        ("GRMU", B.GRMU, GRMU_KW, None)],
}


@functools.lru_cache(maxsize=None)
def fleet(k):
    """Every run of ``RANK_RUNS[k]`` on a fleet of ``k`` spawned ranks
    (rank 0's outputs; spawn_fleet holds the others equal to them)."""
    pv = port_padded()
    return SH.spawn_fleet(fleet_outputs, k, pv,
                          events_of(PORT, random_scenario, 0), cap_of(pv),
                          RANK_RUNS[k], device="cpu", timeout=300)


@pytest.mark.parametrize("k,policy", [(2, "FF"), (2, "MECC"), (2, "GRMU"),
                                      (4, "FF"), (4, "MECC"), (4, "GRMU")])
def test_sharded_ranks_equal_jax(k, policy):
    got, _, graphs = fleet(k)[policy]
    assert graphs == 0                     # the CPU runs the step eagerly
    assert_same_result(jax_replay(policy), got)


def test_sharded_fleet_refuses_gpus_k_does_not_divide():
    # random_scenario's 10 GPUs divide over 2 ranks, not over 4.
    assert fleet(2)["indivisible"] is None
    assert "pad_events(ev, shards=4)" in fleet(4)["indivisible"]


def test_spawn_fleet_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        SH.spawn_fleet(fail_on_rank, 2, 1, device="cpu", timeout=120)


# ---------------------------------------------------------------------------
# Telemetry under shards (tests/test_obs.py) and chunks
# (tests/test_streaming.py)
# ---------------------------------------------------------------------------

def assert_same_telemetry(want_out, got_out, events):
    for key in inscan.TELE_KEYS:
        a, b = np.asarray(want_out[key]), got_out[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert (inscan.telemetry_from_arrays(events, got_out).to_json_dict()
            == jinscan.telemetry_from_arrays(
                jax_padded(), {k: np.asarray(v) for k, v in
                               want_out.items()}).to_json_dict())


@functools.lru_cache(maxsize=None)
def jax_telemetry_out(policy):
    jev = jax_padded()
    out = JAX.batched.make_replay(jev, POLICIES[policy], telemetry=True,
                                  **CFG[policy])(cap_of(jev))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("policy", ["FF", "GRMU"])
def test_sharded_telemetry_equals_unsharded(policy, k):
    pv = port_padded()
    if k == 1:
        run = SH.make_sharded_replay(pv, POLICIES[policy], 1, "cpu",
                                     telemetry=True, **CFG[policy])
        out = {key: v.numpy() for key, v in run(cap_of(pv)).items()}
        got = B.result_from_arrays(pv, POLICIES[policy], out)
    else:
        got, out, _ = fleet(2)[f"{policy}-telemetry"]
    jres, _ = jax_replay(policy, telemetry=True)
    assert_same_result(jres, got)
    assert got.rejection_reasons == jres.rejection_reasons
    assert sum(got.rejection_reasons.values()) == got.rejected > 0
    assert_same_telemetry(jax_telemetry_out(policy), out, pv)
    unsharded, tele = inscan.replay_with_telemetry(pv, POLICIES[policy],
                                                   device="cpu",
                                                   **CFG[policy])
    assert_same_result(unsharded, got)
    assert (inscan.telemetry_from_arrays(pv, out).to_json_dict()
            == tele.to_json_dict())


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("policy", ["GRMU", "MECC"])
def test_sharded_chunked_replay_matches(policy, k):
    """Chunks of 32 events cut GRMU's defrag and consolidation step-ends
    and MECC's windows across chunks."""
    if k == 1:
        tev = events_of(PORT, hetero_scenario, 0)
        got = ST.replay_chunked(tev, POLICIES[policy], cap_of(tev),
                                chunk_events=CHUNK, num_shards=1,
                                device="cpu", **CFG[policy])
    else:
        got, _, _ = fleet(2)[f"{policy}-chunked"]
    assert_same_result(jax_replay(policy), got)
