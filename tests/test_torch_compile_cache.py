"""The port's replay compile cache (``repro_torch.core.compile_cache``)
and its device-indexed replay step, on the CPU.

The cache tests port the JAX package's: hits, misses and entries, with
telemetry statics as their own entry, and the LRU eviction counter
(tests/test_obs.py); two traces in one shape bucket sharing one runner
(tests/test_bucketing.py); the chunk step and finalize built once per
chunk bucket (tests/test_streaming.py); and the recorder's ``cache``
record in a recorded chunked replay, in the JAX recorder's form.

The step tests hold the device-indexed step (events read at a device
cursor, MECC's fixed-width expiry, GRMU's caps as device scalars and its
defrag gated on the device ``rej``) against the JAX replay, exactly:
MECC with a window where some arrival expires exactly W observations and
with one where no arrival expires any, GRMU with defrag at two heavy
capacities through one cache entry, and telemetry on.  On the CPU a
runner runs the step eagerly, so these tests also cover the operations
the card's graphs capture.
"""
import json

import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, assert_same_result, events_of,
                              random_scenario)
from repro.core import compile_cache as jcompile_cache
from repro.core import streaming as JST
from repro.obs import inscan as jinscan
from repro.obs import recorder as jrecorder
from repro_torch.core import batched as B
from repro_torch.core import compile_cache as CC
from repro_torch.core import streaming as ST
from repro_torch.core.bucketing import bucket_shape, pad_events
from repro_torch.obs import inscan, recorder

torch.set_num_threads(1)


def _cap(events):
    return int(round(0.3 * events.num_gpus))


# ---------------------------------------------------------------------------
# The cache (ports of the JAX package's cache tests)
# ---------------------------------------------------------------------------

def test_cache_counts_hits_misses_and_distinct_telemetry_statics():
    ev = events_of(PORT, random_scenario, 0)
    # A never-before-seen statics bucket: unique MECC window.
    kw = dict(mecc_window=23.25)
    before = CC.cache_stats()
    B.replay(ev, B.MECC, _cap(ev), device="cpu", **kw)
    after_first = CC.cache_stats()
    assert after_first["misses"] > before["misses"]
    B.replay(ev, B.MECC, _cap(ev), device="cpu", **kw)
    after_second = CC.cache_stats()
    assert after_second["misses"] == after_first["misses"]
    assert after_second["hits"] > after_first["hits"]
    # telemetry=True is a distinct ReplayStatics -> its own cache entry.
    B.replay(ev, B.MECC, _cap(ev), device="cpu", telemetry=True, **kw)
    after_tele = CC.cache_stats()
    assert after_tele["misses"] > after_second["misses"]
    assert after_tele["entries"] > after_second["entries"]


class _Value:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_cache_lru_eviction_counter():
    """Hermetic LRU check on an emptied cache (evicted runners just
    rebuild on the next miss, so clearing is safe); an evicted value is
    closed, as an evicted runner frees its graphs."""
    prev = CC.set_max_entries(None)
    try:
        CC.clear_cache()
        CC.set_max_entries(2)
        key = lambda k: ("obs-test-evict", k)
        CC.cached_replay_fn(key(0), lambda: "f0")
        one = CC.cached_replay_fn(key(1), _Value)
        CC.cached_replay_fn(key(0), lambda: "f0")  # refresh 0
        CC.cached_replay_fn(key(2), lambda: "f2")  # evicts 1
        stats = CC.cache_stats()
        assert stats == {"hits": 1, "misses": 3, "evictions": 1,
                         "entries": 2}
        assert one.closed
        # Key 0 survived (it was refreshed); key 1 was the LRU victim.
        CC.cached_replay_fn(key(0), lambda: "f0")
        assert CC.cache_stats()["misses"] == 3
        CC.cached_replay_fn(key(1), lambda: "f1")
        assert CC.cache_stats()["misses"] == 4
        assert CC.cache_stats()["evictions"] == 2
    finally:
        CC.set_max_entries(prev)
        CC.clear_cache()


def test_evicted_runner_replays_again():
    """A run whose runner the cache evicted (and closed) still replays,
    with the same outputs."""
    ev0 = events_of(PORT, random_scenario, 0)
    ev1 = pad_events(ev0)                      # another bucket
    prev = CC.set_max_entries(None)
    try:
        CC.clear_cache()
        CC.set_max_entries(1)
        run = B.make_replay(ev0, B.FF, "cpu")
        want = run(0)
        B.make_replay(ev1, B.FF, "cpu")(0)     # evicts run's runner
        assert CC.cache_stats()["evictions"] == 1
        got = run(0)
        assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        CC.set_max_entries(prev)
        CC.clear_cache()


def test_same_bucket_same_statics_reuses_runner():
    """Two different traces in one shape bucket share one runner: the
    second make_replay is a cache hit."""
    caps, runs = [], []
    before = dict(CC.cache_stats())
    for seed in (0, 1):
        pv = pad_events(events_of(PORT, random_scenario, seed))
        caps.append(bucket_shape(pv)[1:])
        runs.append(B.make_replay(pv, B.FF, "cpu"))
        runs[-1](0)
    after = CC.cache_stats()
    assert caps[0] == caps[1]            # same bucket by construction
    assert runs[0].runner is runs[1].runner
    assert after["misses"] - before["misses"] <= 1
    assert after["hits"] >= before["hits"] + 1


def test_chunk_bucket_shares_one_runner():
    """Two traces of different raw length that land in the same chunk
    bucket reuse one chunk step and one finalize."""
    before = dict(CC.cache_stats())
    shapes = []
    for seed in (0, 1):
        ev = events_of(PORT, random_scenario, seed)
        run = ST.make_chunked_replay(ev, B.FF, chunk_events=128,
                                     device="cpu")
        shapes.append(bucket_shape(run.events)[1:])
        assert bool((run(0)["accepted"] >= 0).all())
    after = CC.cache_stats()
    assert shapes[0] == shapes[1]          # same non-event bucket
    # chunk step + finalize build once; the second trace hits both.
    assert after["misses"] - before["misses"] <= 2
    assert after["hits"] >= before["hits"] + 2


def test_recorded_chunked_replay_writes_the_jax_cache_record(tmp_path):
    """A recorded chunked replay ends with a ``cache`` record holding the
    JAX recorder's fields."""
    records = {}
    for name, rec_mod, replay, ev in (
            ("jax", jrecorder, JST.replay_chunked,
             events_of(JAX, random_scenario, 0)),
            ("port", recorder, ST.replay_chunked,
             events_of(PORT, random_scenario, 0))):
        path = tmp_path / f"{name}.jsonl"
        kw = {} if name == "jax" else dict(device="cpu")
        with rec_mod.record(path, run_id=name):
            replay(ev, B.GRMU, _cap(ev), chunk_events=64, **kw)
        records[name] = [json.loads(line)
                         for line in path.read_text().splitlines()]
    kinds = {n: [r["kind"] for r in recs] for n, recs in records.items()}
    assert kinds["port"] == kinds["jax"]
    assert kinds["port"][-1] == "cache"
    j, t = records["jax"][-1], records["port"][-1]
    assert set(t) == set(j)
    assert t["entries"] == CC.cache_stats()["entries"]
    assert jcompile_cache.cache_stats()["entries"] == j["entries"]


def test_no_persistent_cache():
    """Captured graphs cannot outlive their process: nothing persists."""
    assert CC.ensure_persistent_cache() == ""
    assert CC.ensure_persistent_cache("/nonexistent") == ""


# ---------------------------------------------------------------------------
# The device-indexed step vs the JAX replay
# ---------------------------------------------------------------------------

def _while_loop_expiries(events, window):
    """Per arrival, the observations the JAX scan's expiry ``while_loop``
    visits, by its own loop."""
    at = np.asarray(events.arr_times, np.float32)
    ptr, out = 0, []
    for k, t in zip(events.kind, events.time):
        if k == B.ARRIVAL:
            cutoff = np.float32(t) - np.float32(window)
            p0 = ptr
            while ptr < len(at) and at[ptr] < cutoff:
                ptr += 1
            out.append(ptr - p0)
    return out


def _window_expiring(events, want_pow2):
    """A MECC window under which the most observations one arrival
    expires is a power of two >= 2 (so exactly W), or, without
    ``want_pow2``, a window under which no arrival expires any."""
    if not want_pow2:
        return 1e6
    for w in np.arange(0.5, 30.0, 0.5):
        k = max(_while_loop_expiries(events, w))
        if k >= 2 and k & (k - 1) == 0:
            return float(w)
    raise AssertionError("no window with a power-of-two expiry count")


def _jax_out(jev, policy, cap, **kw):
    out = JAX.batched.make_replay(jev, policy, **kw)(cap)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same_outputs(jev, tev, policy, jout, tout, telemetry):
    assert_same_result(JAX.batched.result_from_arrays(jev, policy, jout),
                       B.result_from_arrays(tev, policy, tout))
    if telemetry:
        for key in inscan.TELE_KEYS:
            np.testing.assert_array_equal(tout[key], jout[key],
                                          err_msg=key)
        jt = jinscan.telemetry_from_arrays(jev, jout)
        tt = inscan.telemetry_from_arrays(tev, tout)
        assert tt.to_json_dict() == jt.to_json_dict()


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("backend", ["tables", "kernel"])
@pytest.mark.parametrize("expiring", ["exactly_w", "none"])
def test_mecc_fixed_width_expiry_matches_jax(expiring, backend, telemetry):
    tev = events_of(PORT, random_scenario, 1)
    jev = events_of(JAX, random_scenario, 1)
    window = _window_expiring(tev, expiring == "exactly_w")
    k = max(_while_loop_expiries(tev, window))
    st = B.replay_statics(tev, B.MECC, mecc_window=window)
    trace = B.trace_from_numpy(B.trace_arrays(tev), "cpu")
    # W is the largest count, rounded up to a power of two (0 for none).
    assert B.expiry_width(trace, st) == k
    assert (k >= 2) == (expiring == "exactly_w")
    cap = _cap(tev)
    tout = {k: v.numpy() for k, v in B.make_replay(
        tev, B.MECC, "cpu", mecc_window=window, score_backend=backend,
        telemetry=telemetry)(cap).items()}
    jout = _jax_out(jev, B.MECC, cap, mecc_window=window,
                    telemetry=telemetry)
    _assert_same_outputs(jev, tev, B.MECC, jout, tout, telemetry)


@pytest.mark.parametrize("telemetry", [False, True])
def test_grmu_gated_defrag_two_caps_one_cache_entry(telemetry):
    """GRMU with defrag (trigger "any", a statics no other test uses) at
    heavy capacities 1 and 3 through one runner: the caps are device
    scalars, so the second capacity builds nothing."""
    tev = events_of(PORT, random_scenario, 2)
    jev = events_of(JAX, random_scenario, 2)
    kw = dict(defrag=True, defrag_trigger="any", telemetry=telemetry)
    runners, intra = [], []
    for cap in (1, 3):
        before = CC.cache_stats()
        run = B.make_replay(tev, B.GRMU, "cpu", **kw)
        runners.append(run.runner)
        tout = {k: v.numpy() for k, v in run(cap).items()}
        jout = _jax_out(jev, B.GRMU, cap, **kw)
        _assert_same_outputs(jev, tev, B.GRMU, jout, tout, telemetry)
        intra.append(int(tout["intra"]))
    assert CC.cache_stats()["misses"] == before["misses"]   # 2nd: a hit
    assert runners[0] is runners[1]
    assert min(intra) > 0 and intra[0] != intra[1]   # defrag fires, per cap


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("policy", ["FF", "BF", "MCC", "MECC", "GRMU"])
def test_runner_equals_the_eager_loop(policy, telemetry):
    """make_replay's runner and ``run_events`` on a fresh state give the
    same outputs (on the card the runner replays graphs; here both run
    the step eagerly, through different buffers)."""
    pid = getattr(B, policy)
    ev = events_of(PORT, random_scenario, 3)
    kw = dict(telemetry=telemetry)
    if policy == "GRMU":
        kw.update(defrag=True, consolidation_interval=6.0)
    got = B.make_replay(ev, pid, "cpu", **kw)(_cap(ev))
    st = B.replay_statics(ev, pid, **kw)
    state = B.run_events(st, B.init_state(ev, st, "cpu"),
                         B.trace_from_numpy(B.trace_arrays(ev), "cpu"),
                         _cap(ev))
    want = B._finalize(st, state)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_plan_keys_hold_the_host_values():
    """One key per non-PAD event: arrivals by (profile, pick profile,
    heavy), one departure key, step-ends by whether they consolidate."""
    ev = pad_events(events_of(PORT, random_scenario, 1))
    trace = B.trace_from_numpy(B.trace_arrays(ev), "cpu")
    st = B.replay_statics(ev, B.GRMU, consolidation_interval=6.0)
    plan = B.plan_events(st, trace, last_cons=0.0)
    real = ev.kind != B.PAD
    assert len(plan.keys) == int(real.sum()) == plan.hi - plan.lo
    arr = [k for k in plan.keys if k[0] == B.ARRIVAL]
    assert [k[1] for k in arr] == ev.profile[ev.kind == B.ARRIVAL].tolist()
    assert [k[3] for k in arr] == ev.vm_heavy[
        ev.vm_index[ev.kind == B.ARRIVAL]].tolist()
    cons = [k[1] for k in plan.keys if k[0] == B.STEP_END]
    assert len(cons) == len(ev.step_times) and 0 < sum(cons) < len(cons)
    assert {k for k in plan.keys if k[0] == B.DEPARTURE} == {(B.DEPARTURE,)}
