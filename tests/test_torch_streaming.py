"""Port chunk-streamed replay, bucketing and the synthetic workload (CPU)
vs the JAX package.

``replay_chunked`` must equal the port's unchunked ``replay`` and the JAX
replay decision for decision, with telemetry too, at chunk sizes small
enough to split GRMU's defrag and consolidation step-ends and MECC's
window expiries across chunks.  The port's ``pad_events``,
``split_trace`` and ``replay_bytes`` equal the JAX package's; padding is
decision-neutral; ``generate_events`` equals the JAX generator field by
field, and a small synthetic trace replays to the JAX decisions.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, POLICIES, assert_same_result,
                              events_of, hetero_scenario, random_scenario)
from repro.core import bucketing as jbucketing
from repro.core import streaming as jstreaming
from repro.obs import inscan as jinscan
from repro.workload import synthetic as jsynthetic
from repro_torch.core import batched as B
from repro_torch.core import bucketing, streaming as ST
from repro_torch.obs import inscan
from repro_torch.workload import synthetic

torch.set_num_threads(1)

GRMU_KW = dict(defrag=True, consolidation_interval=6.0)
SCENARIOS = {"a100": random_scenario, "mixed": hetero_scenario}


@functools.lru_cache(maxsize=None)
def jax_replay(scenario, seed, policy, telemetry=False):
    jev = events_of(JAX, SCENARIOS[scenario], seed)
    kw = GRMU_KW if policy == "GRMU" else {}
    cap = int(round(0.3 * jev.num_gpus))
    if telemetry:
        return jinscan.replay_with_telemetry(jev, POLICIES[policy], cap,
                                             **kw)
    return JAX.batched.replay(jev, POLICIES[policy], cap, **kw)


def chunked_three_ways(scenario, seed, policy, chunk):
    """(JAX, port unchunked, port chunked) results."""
    tev = events_of(PORT, SCENARIOS[scenario], seed)
    kw = GRMU_KW if policy == "GRMU" else {}
    cap = int(round(0.3 * tev.num_gpus))
    r0 = B.replay(tev, POLICIES[policy], cap, device="cpu", **kw)
    r1 = ST.replay_chunked(tev, POLICIES[policy], cap, chunk_events=chunk,
                           device="cpu", **kw)
    jres = jax_replay(scenario, seed, policy)
    assert_same_result(r0, r1)
    assert_same_result(jres, r1)
    return jres, r0, r1


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_chunked_equals_unchunked_and_jax_mixed_fleet(policy):
    chunked_three_ways("mixed", 0, policy, 32)


@pytest.mark.parametrize("chunk", [16, 64])
def test_tiny_chunks_split_defrag_and_consolidation(chunk):
    _, r0, _ = chunked_three_ways("mixed", 1, "GRMU", chunk)
    assert r0.intra_migrations > 0 and r0.inter_migrations > 0


@pytest.mark.parametrize("chunk", [16, 64])
def test_tiny_chunks_split_mecc_windows(chunk):
    chunked_three_ways("a100", 1, "MECC", chunk)


@pytest.mark.parametrize("policy", ["GRMU", "MECC"])
@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_telemetry_equals_unchunked_and_jax(policy, chunk):
    """The step rows land at their step's index whichever chunk holds the
    step-end, and the codes whichever chunk holds the arrival."""
    jres, jtele = jax_replay("mixed", 1, policy, telemetry=True)
    tev = events_of(PORT, hetero_scenario, 1)
    kw = GRMU_KW if policy == "GRMU" else {}
    cap = int(round(0.3 * tev.num_gpus))
    run = ST.make_chunked_replay(tev, POLICIES[policy], chunk_events=chunk,
                                 device="cpu", telemetry=True, **kw)
    out = {k: v.numpy() for k, v in run(cap).items()}
    res = B.result_from_arrays(run.events, POLICIES[policy], out)
    tele = inscan.telemetry_from_arrays(run.events, out)
    assert_same_result(jres, res)
    assert res.rejection_reasons == jres.rejection_reasons
    assert tele.to_json_dict() == jtele.to_json_dict()
    off = ST.replay_chunked(tev, POLICIES[policy], cap, chunk_events=chunk,
                            device="cpu", **kw)
    assert_same_result(off, res)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_padding_is_decision_neutral(policy):
    """Every dimension padded to its pow2 bucket (the fleet to 16 GPUs
    with a free mask of 0, outside GRMU's baskets): the same decisions."""
    tev = events_of(PORT, hetero_scenario, 0)
    kw = GRMU_KW if policy == "GRMU" else {}
    cap = int(round(0.3 * tev.num_gpus))
    pv = bucketing.pad_events(tev, min_gpus=16)
    assert len(pv.gpu_model_id) == 16 > tev.num_gpus
    assert_same_result(B.replay(tev, POLICIES[policy], cap, device="cpu",
                                **kw),
                       B.replay(pv, POLICIES[policy], cap, device="cpu",
                                **kw))


def _same_trace(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "models":
            assert [m.name for m in x] == [m.name for m in y]
        elif isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kw", [
    {}, dict(event_multiple=64), dict(shards=4), dict(min_gpus=128),
    dict(min_shape=(3000, 200, 20, 9, 300, 90)),
    dict(event_multiple=16, min_events=1000)],
    ids=["pow2", "multiple", "shards", "lanes", "min_shape", "min_events"])
def test_pad_events_equals_jax(kw):
    tev = events_of(PORT, hetero_scenario, 0)
    jev = events_of(JAX, hetero_scenario, 0)
    _same_trace(tev, jev)
    got, want = bucketing.pad_events(tev, **kw), jbucketing.pad_events(jev,
                                                                       **kw)
    _same_trace(got, want)
    assert bucketing.bucket_shape(got) == jbucketing.bucket_shape(want)
    assert bucketing.bucket_shape(bucketing.pad_events(got, **kw)) == \
        bucketing.bucket_shape(got)


def test_event_multiple_need_not_be_a_power_of_two():
    """The port compiles nothing per shape, so a chunk of 1,000 events is
    as good as any; the rounding is the JAX package's."""
    tev = events_of(PORT, random_scenario, 0)
    pv = bucketing.pad_events(tev, event_multiple=100)
    assert len(pv.kind) % 100 == 0 and len(pv.kind) - len(tev.kind) < 100
    run = ST.make_chunked_replay(tev, B.FF, chunk_events=100, device="cpu")
    assert run.num_chunks == len(run.events.kind) // 100
    with pytest.raises(ValueError):
        bucketing.pad_events(tev, event_multiple=-8)
    with pytest.raises(ValueError):
        ST.make_chunked_replay(tev, B.FF, chunk_events=0, device="cpu")
    with pytest.raises(ValueError):
        bucketing.pad_events(tev, shards=3)
    # A chunked one-rank fleet runs (tests/test_torch_sharded.py holds it
    # and K = 2 against the JAX replay).
    run = ST.make_chunked_replay(tev, B.FF, chunk_events=100, num_shards=1,
                                 device="cpu")
    assert run.runner.step.shard.num_shards == 1
    assert_same_result(B.result_from_arrays(run.events, B.FF, {
        k: v.numpy() for k, v in run(3).items()}),
        B.replay(tev, B.FF, 3, device="cpu"))


def test_chunked_replay_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    tev = events_of(PORT, random_scenario, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ST.replay_chunked(tev, B.FF, chunk_events=64)


@pytest.mark.parametrize("chunk", [None, 8, 100])
def test_split_trace_and_replay_bytes_equal_jax(chunk):
    tev = events_of(PORT, random_scenario, 0)
    jev = events_of(JAX, random_scenario, 0)
    evs, rest = ST.split_trace(B.trace_arrays(tev))
    jevs, jrest = jstreaming.split_trace(JAX.batched.trace_arrays(jev))
    assert B.EVENT_KEYS == JAX.batched.EVENT_KEYS
    assert evs.keys() == jevs.keys() and rest.keys() == jrest.keys()
    for k in evs:
        np.testing.assert_array_equal(evs[k], jevs[k])
    assert ST.replay_bytes(tev, chunk) == jstreaming.replay_bytes(jev, chunk)


SYNTH_CFGS = {
    "a100": dict(n_vms=2500, n_gpus=40, seed=3, horizon_hours=96.0,
                 mean_duration_hours=12.0, chunk_vms=700),
    "mixed": dict(n_vms=1500, n_gpus=24, seed=5, horizon_hours=64.0,
                  fleet={"A30-24GB": 0.3, "A100-40GB": 0.4,
                         "H100-80GB": 0.3}, chunk_vms=512),
}


@pytest.mark.parametrize("name", sorted(SYNTH_CFGS))
def test_generate_events_equals_jax(name):
    cfg = SYNTH_CFGS[name]
    got = synthetic.generate_events(synthetic.SyntheticConfig(**cfg))
    want = jsynthetic.generate_events(jsynthetic.SyntheticConfig(**cfg))
    _same_trace(got, want)
    fleet = synthetic.synthetic_fleet(synthetic.SyntheticConfig(**cfg))
    jfleet = jsynthetic.synthetic_fleet(jsynthetic.SyntheticConfig(**cfg))
    assert [m.name for m in fleet[0]] == [m.name for m in jfleet[0]]
    for a, b in zip(fleet[1:], jfleet[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy,kw", [
    ("GRMU", dict(defrag=False, consolidation_interval=None)),
    ("MECC", {})], ids=["GRMU-DB", "MECC"])
def test_small_synthetic_trace_replays_to_jax_decisions(policy, kw):
    """The ladder's way: padded to a multiple of the chunk and streamed."""
    cfg = SYNTH_CFGS["a100"]
    tev = bucketing.pad_events(
        synthetic.generate_events(synthetic.SyntheticConfig(**cfg)),
        event_multiple=512)
    jev = jbucketing.pad_events(
        jsynthetic.generate_events(jsynthetic.SyntheticConfig(**cfg)),
        event_multiple=512)
    cap = B.default_heavy_capacity(tev)
    jres = JAX.batched.replay(jev, POLICIES[policy], cap, **kw)
    res = ST.replay_chunked(tev, POLICIES[policy], cap, chunk_events=512,
                            device="cpu", **kw)
    assert_same_result(jres, res)
    assert 0 < res.rejected < res.total_requests
