"""The port's online placement service against the JAX package's.

Every test of tests/test_serve.py, on the same fixture, run on the port
(``repro_torch.serve``, on the CPU) and held against the JAX service, the
JAX offline replay and the port's offline replay, exactly: per decision
(accepted, GPU, start block, tier), accepted ids in arrival order and
migration counts.  Then what only the port can get wrong: services of one
configuration share a replay runner (its static buffers), so two of them
interleaved batch by batch must each equal its solo run; MECC's expiry
width grows with the stream; a checkpoint the JAX service wrote restores
into the port's service and continues to the JAX decisions; the mixed
A30+A100+H100 fleet; and the command line's smoke run.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import repro.workload.synthetic as jsyn
import repro_torch.workload.synthetic as tsyn
from _torch_scenarios import JAX, PORT, events_of, hetero_scenario
from repro.core import batched as JB
from repro.core.bucketing import pad_events as jpad_events
from repro.serve import PlacementService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import requests_from_trace as jrequests
from repro_torch.core import batched as B
from repro_torch.core.bucketing import pad_events
from repro_torch.obs import recorder as obs_recorder
from repro_torch.serve import (Arrival, BoundedRequestQueue,
                               PlacementService, ServeConfig,
                               requests_from_trace)
from repro_torch.serve import placement as P

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings(
    "ignore:Some donated buffers were not usable")

SYN = dict(n_vms=200, n_gpus=12, horizon_hours=30.0,
           mean_duration_hours=6.0, seed=5)


@pytest.fixture(scope="module")
def trace():
    """tests/test_serve.py's stream: 200 VMs on a 12-GPU homogeneous
    fleet, dense enough to reject some arrivals; both packages' events
    and requests from the same draws."""
    jev = jsyn.generate_events(jsyn.SyntheticConfig(**SYN))
    tev = tsyn.generate_events(tsyn.SyntheticConfig(**SYN))
    jreqs, horizon = jrequests(jev)
    reqs, h2 = requests_from_trace(tev)
    assert h2 == horizon and len(reqs) == len(jreqs)
    return dict(jev=jev, tev=tev, jreqs=jreqs, reqs=reqs, horizon=horizon)


def _stream(svc, reqs, horizon):
    for r in reqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)
    return svc


def _port(trace, **cfg):
    return _stream(PlacementService.for_trace(
        trace["tev"], ServeConfig(**cfg), device="cpu"), trace["reqs"],
        trace["horizon"])


def _jax(trace, **cfg):
    return _stream(JService.for_trace(trace["jev"], JConfig(**cfg)),
                   trace["jreqs"], trace["horizon"])


class _JServiceLeavingSnapshot(JService):
    """The JAX service with its tier-switch snapshot taken of the tier
    being left.  The JAX ``_switch_tier`` snapshots after the governor
    has moved, by the new tier's backend: array -> array reads the old
    state by accident, but leaving or entering the ILP tier raises
    (``_snapshot`` finds no state of the other backend).  The port
    snapshots the leaving tier; this is the reference it is held to on
    such ladders."""
    _leaving = None

    def _switch_tier(self, kind, old, new):
        self._leaving = old
        try:
            super()._switch_tier(kind, old, new)
        finally:
            self._leaving = None

    def _snapshot(self):
        if self._leaving is None:
            return super()._snapshot()
        new, self.governor.tier = self.governor.tier, self._leaving
        try:
            return super()._snapshot()
        finally:
            self.governor.tier = new


def _decisions(svc):
    return {v: (d.accepted, d.gpu, d.start, d.tier)
            for v, d in svc.decisions.items()}


def assert_same_service(port, jax_svc):
    assert _decisions(port) == _decisions(jax_svc)
    assert port.accepted_ids() == jax_svc.accepted_ids()
    assert port.migrations() == jax_svc.migrations()
    assert port.tier_name == jax_svc.tier_name
    assert port.tier_occupancy == jax_svc.tier_occupancy
    assert ([e["event"] for e in port.switch_events]
            == [e["event"] for e in jax_svc.switch_events])


# ---------------------------------------------------------------------------
# Queue bounding / backpressure
# ---------------------------------------------------------------------------

def test_queue_bounds_and_counters():
    q = BoundedRequestQueue(capacity=4)
    reqs = [Arrival(vm_id=i, time=float(i), profile_ids=(0,))
            for i in range(6)]
    assert [q.submit(r) for r in reqs] == [True] * 4 + [False] * 2
    assert len(q) == 4 and q.fill == 1.0 and q.dropped == 2
    assert q.high_watermark == 4
    assert q.pop()[0].vm_id == 0       # FIFO of (request, enqueue-time)
    assert q.submit(reqs[4])           # space freed -> accepted again
    assert q.accepted_total == 5


def test_service_backpressure(trace):
    reqs = trace["reqs"]
    cfg = dict(policy="FF", micro_batch=4, queue_capacity=4)
    svc = PlacementService.for_trace(trace["tev"], ServeConfig(**cfg),
                                     device="cpu")
    rejected = 0
    for r in reqs:
        while not svc.submit(r):
            rejected += 1
            svc.drain(max_batches=1)   # shed: drain one batch, retry
    svc.drain()
    svc.flush(trace["horizon"])
    assert rejected > 0                # the tiny queue really filled
    assert svc.queue.high_watermark <= 4
    # shed-and-retry loses nothing: every arrival got a decision
    n_arr = sum(1 for r in reqs if isinstance(r, Arrival))
    assert len(svc.decisions) == n_arr
    assert_same_service(svc, _jax(trace, **cfg))


# ---------------------------------------------------------------------------
# Online == offline == JAX (all registry policies), batch-size invariance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["FF", "BF", "MCC", "MECC", "GRMU"])
def test_online_matches_offline(policy, trace):
    """The port's service == the JAX offline replay == the port's offline
    replay == the JAX service, decision for decision."""
    pid = JB.__dict__[policy]
    jres = JB.replay(jpad_events(trace["jev"]), pid)
    tres = B.replay(pad_events(trace["tev"]), pid, device="cpu")
    svc = _port(trace, policy=policy, micro_batch=16)
    assert svc.accepted_ids() == list(jres.accepted_ids)
    assert svc.accepted_ids() == list(tres.accepted_ids)
    assert svc.stats()["accepted"] == jres.accepted
    assert_same_service(svc, _jax(trace, policy=policy, micro_batch=16))


@pytest.mark.parametrize("micro_batch", [1, 8, 64])
def test_micro_batch_size_invariant(micro_batch, trace):
    """Decisions cannot depend on how the stream is chopped into
    micro-batches: the decision step is a position-independent fold."""
    jres = JB.replay(jpad_events(trace["jev"]), JB.GRMU)
    svc = _port(trace, policy="GRMU", micro_batch=micro_batch)
    assert svc.accepted_ids() == list(jres.accepted_ids)
    assert_same_service(svc, _jax(trace, policy="GRMU",
                                  micro_batch=micro_batch))


def test_online_grmu_consolidation_migrations(trace):
    """With periodic consolidation on, the online service reproduces the
    offline accepted set AND migration counts."""
    jres = JB.replay(jpad_events(trace["jev"]), JB.GRMU,
                     consolidation_interval=6.0)
    svc = _port(trace, policy="GRMU", micro_batch=16,
                consolidation_interval=6.0)
    assert svc.accepted_ids() == list(jres.accepted_ids)
    assert svc.migrations() == (jres.intra_migrations,
                                jres.inter_migrations)
    assert jres.intra_migrations + jres.inter_migrations > 0
    assert_same_service(svc, _jax(trace, policy="GRMU", micro_batch=16,
                                  consolidation_interval=6.0))


def test_service_series_equal_the_offline_replay(trace):
    """The final snapshot's hourly series and counts, read through
    ``batched._finalize`` / ``result_from_arrays``, equal the offline
    replay's whole result (GRMU with consolidation)."""
    tev = trace["tev"]
    svc = _port(trace, policy="GRMU", micro_batch=16,
                consolidation_interval=6.0)
    st = svc._statics["GRMU"]
    snap = {k: torch.as_tensor(v) for k, v in svc._snapshot().items()}
    out = {k: v.numpy() for k, v in B._finalize(st, snap).items()}
    got = B.result_from_arrays(tev, B.GRMU, out)
    want = B.replay(tev, B.GRMU, device="cpu", consolidation_interval=6.0)
    assert got.accepted_ids == want.accepted_ids == svc.accepted_ids()
    assert got.hourly_acceptance == want.hourly_acceptance
    assert got.hourly_active_hw == want.hourly_active_hw
    assert got.per_profile_accepted == want.per_profile_accepted
    assert (got.intra_migrations, got.inter_migrations) == (
        want.intra_migrations, want.inter_migrations)


def _ilp_vms(pkg):
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
    return cluster, vms


def test_ilp_tier_matches_sequential_engine():
    """The ILP (object-backend) tier replays the sequential engine's
    ILPPolicy decisions exactly, on a mixed 5-GPU cluster: the port's
    tier == the port's sequential engine == the JAX sequential engine ==
    the JAX service's ILP tier."""
    from repro.core.policies import ILPPolicy as JILP
    from repro.sim.engine import simulate as jsimulate
    from repro_torch.core.policies import ILPPolicy
    from repro_torch.sim.engine import simulate

    horizon = 20.0
    refs = []
    for pkg, ilp, sim in ((PORT, ILPPolicy, simulate),
                          (JAX, JILP, jsimulate)):
        cluster, vms = _ilp_vms(pkg)
        refs.append(sim(cluster, ilp(cluster, window=4, time_limit=2.0),
                        sorted(vms, key=lambda v: (v.arrival, v.vm_id)),
                        horizon=horizon))
    ref, jref = refs
    assert ref.accepted_ids == jref.accepted_ids
    assert (ref.intra_migrations, ref.inter_migrations) == (
        jref.intra_migrations, jref.inter_migrations)

    cfg = dict(tiers=("ILP",), micro_batch=8, ilp_window=4,
               ilp_time_limit=2.0)
    cluster, vms = _ilp_vms(PORT)
    events = B.build_events(vms, cluster, step_hours=1.0, horizon=horizon)
    reqs, h = requests_from_trace(events)
    svc = _stream(PlacementService.for_trace(
        events, ServeConfig(**cfg), device="cpu"), reqs, h)
    assert svc.accepted_ids() == list(ref.accepted_ids)
    assert svc.migrations() == (ref.intra_migrations, ref.inter_migrations)
    jcluster, jvms = _ilp_vms(JAX)
    jevents = JB.build_events(jvms, jcluster, step_hours=1.0,
                              horizon=horizon)
    jreqs, _ = jrequests(jevents)
    assert_same_service(svc, _stream(JService.for_trace(
        jevents, JConfig(**cfg)), jreqs, h))


def test_ilp_grmu_ff_ladder_equals_jax(trace):
    """The ``("ILP", "GRMU", "FF")`` ladder at ``slo_s=0``: the snapshot
    moves object tier -> array tier -> array tier.  The JAX service
    raises on leaving the ILP tier; the port equals it with the switch
    snapshot taken of the leaving tier (``_JServiceLeavingSnapshot``)."""
    cfg = dict(tiers=("ILP", "GRMU", "FF"), micro_batch=16, slo_s=0.0,
               ilp_window=4, ilp_time_limit=2.0)
    svc = _port(trace, **cfg)
    assert [e["to"] for e in svc.switch_events] == ["GRMU", "FF"]
    with pytest.raises(AttributeError):
        _jax(trace, **cfg)
    jsvc = _stream(_JServiceLeavingSnapshot.for_trace(
        trace["jev"], JConfig(**cfg)), trace["jreqs"], trace["horizon"])
    assert_same_service(svc, jsvc)


# ---------------------------------------------------------------------------
# Graceful degradation + recovery, through the flight recorder
# ---------------------------------------------------------------------------

def test_degradation_on_slo_breach(trace):
    """An unmeetable SLO (0 s) breaches on the first governed batch:
    the service degrades GRMU -> FF, serves the rest on FF, and the
    switch lands in the flight recorder as a `service` record."""
    cfg = dict(tiers=("GRMU", "FF"), micro_batch=16, slo_s=0.0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rec.jsonl")
        with obs_recorder.record(path):
            svc = _port(trace, **cfg)
        assert svc.tier_name == "FF"
        assert [e["event"] for e in svc.switch_events] == ["degrade"]
        occ = svc.tier_occupancy
        assert occ["GRMU"] >= 1 and occ["FF"] > occ["GRMU"]
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        service = [r for r in recs if r["kind"] == "service"]
        assert any(r["event"] == "degrade" and r["from"] == "GRMU"
                   and r["to"] == "FF" for r in service)
        spans = [r for r in recs if r["kind"] == "span"]
        assert spans and all(r["name"] == "serve.batch" for r in spans)
    assert_same_service(svc, _jax(trace, **cfg))


def test_recovery_after_healthy_batches(trace):
    """Degrade under slo_s=0, then lift the SLO: after `recover_after`
    consecutive healthy batches the governor climbs back to GRMU."""
    reqs = trace["reqs"]
    cfg = dict(tiers=("GRMU", "FF"), micro_batch=16, slo_s=0.0,
               recover_after=2)
    svc = PlacementService.for_trace(trace["tev"], ServeConfig(**cfg),
                                     device="cpu")
    jsvc = JService.for_trace(trace["jev"], JConfig(**cfg))
    half = len(reqs) // 2
    for s, rs in ((svc, reqs), (jsvc, trace["jreqs"])):
        for r in rs[:half]:
            assert s.submit(r)
        s.drain()
        assert s.tier_name == "FF"
        s.governor.slo_s = 1e9           # operator relaxes the SLO
        for r in rs[half:]:
            assert s.submit(r)
        s.drain()
        s.flush(trace["horizon"])
        assert s.tier_name == "GRMU"
        assert [e["event"] for e in s.switch_events] == ["degrade",
                                                         "recover"]
    assert_same_service(svc, jsvc)


# ---------------------------------------------------------------------------
# Checkpoint / restore mid-stream
# ---------------------------------------------------------------------------

def test_checkpoint_restore_roundtrip(trace):
    """Checkpoint after half the stream, restore into a FRESH service,
    feed the second half: decisions equal an uninterrupted run.  The
    three services share one runner, as the JAX test's share one
    compiled step."""
    reqs, horizon = trace["reqs"], trace["horizon"]
    cfg = ServeConfig(policy="GRMU", micro_batch=16,
                      consolidation_interval=6.0)
    ref = _stream(PlacementService.for_trace(trace["tev"], cfg,
                                             device="cpu"), reqs, horizon)
    half = len(reqs) // 2
    with tempfile.TemporaryDirectory() as d:
        a = PlacementService.for_trace(trace["tev"], cfg, device="cpu")
        for r in reqs[:half]:
            assert a.submit(r)
        a.drain()                       # queue must be empty to snapshot
        a.checkpoint(d)
        b = PlacementService.for_trace(trace["tev"], cfg, device="cpu")
        assert b.restore(d)
        for r in reqs[half:]:
            assert b.submit(r)
        b.drain()
        b.flush(horizon)
    assert b.accepted_ids() == ref.accepted_ids()
    assert b.migrations() == ref.migrations()
    assert a.runner is b.runner is ref.runner
    # decisions{} is per-process latency bookkeeping, not restored state:
    # the resumed service only holds decisions for the second half.
    n_second = sum(1 for r in reqs[half:] if isinstance(r, Arrival))
    assert len(b.decisions) == n_second
    assert {v: _decisions(ref)[v] for v in _decisions(b)} == _decisions(b)


def test_checkpoint_refuses_nonempty_queue(trace):
    svc = PlacementService.for_trace(
        trace["tev"], ServeConfig(policy="FF", micro_batch=16),
        device="cpu")
    assert svc.submit(trace["reqs"][0])
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            svc.checkpoint(d)          # undrained requests would be lost
        svc.drain()
        assert svc.checkpoint(d)


@pytest.mark.parametrize("policy,kw", [
    ("GRMU", dict(consolidation_interval=6.0)),
    ("MECC", dict(mecc_window=4.0))])
def test_jax_checkpoint_restores_into_the_port(policy, kw, trace):
    """A checkpoint the JAX service wrote at half the stream restores
    into the port's service, which then continues to the JAX service's
    decisions (the checkpoint layout and leaf order are shared)."""
    reqs, jreqs, horizon = trace["reqs"], trace["jreqs"], trace["horizon"]
    cfg = dict(policy=policy, micro_batch=16, **kw)
    jref = _jax(trace, **cfg)
    half = len(reqs) // 2
    with tempfile.TemporaryDirectory() as d:
        a = JService.for_trace(trace["jev"], JConfig(**cfg))
        for r in jreqs[:half]:
            assert a.submit(r)
        a.drain()
        a.checkpoint(d)
        b = PlacementService.for_trace(trace["tev"], ServeConfig(**cfg),
                                       device="cpu")
        assert b.restore(d)
        for r in reqs[half:]:
            assert b.submit(r)
        b.drain()
        b.flush(horizon)
    assert b.accepted_ids() == jref.accepted_ids()
    assert b.migrations() == jref.migrations()
    got = _decisions(b)
    assert got == {v: _decisions(jref)[v] for v in got}


# ---------------------------------------------------------------------------
# What only the port can get wrong: shared runners, MECC's width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,kw", [
    ("GRMU", dict(consolidation_interval=6.0)), ("MECC", {})])
def test_interleaved_services_equal_their_solo_runs(policy, kw, trace):
    """Two services of one configuration share one runner (its static
    state and resident tables); drained batch by batch in turns, the
    second one batch behind, each must equal its solo run."""
    reqs, horizon = trace["reqs"], trace["horizon"]
    cfg = ServeConfig(policy=policy, micro_batch=16, queue_capacity=4096,
                      **kw)
    solo = _stream(PlacementService.for_trace(trace["tev"], cfg,
                                              device="cpu"), reqs, horizon)
    a, b = (PlacementService.for_trace(trace["tev"], cfg, device="cpu")
            for _ in range(2))
    for s in (a, b):
        for r in reqs:
            assert s.submit(r)
    a.drain(max_batches=1)
    while len(a.queue) or len(b.queue):
        b.drain(max_batches=1)
        a.drain(max_batches=1)
    for s in (a, b):
        s.flush(horizon)
    assert a.runner is b.runner is solo.runner
    for s in (a, b):
        assert _decisions(s) == _decisions(solo)
        assert s.accepted_ids() == solo.accepted_ids()
        assert s.migrations() == solo.migrations()


def _growing_stream(pkg):
    """VMs arriving 1, 2, 3, 5, 9, 17, 33, 1, 1 per hour, each staying
    100 h: with a 1 h MECC window the first arrival of each hour expires
    the hour before last, so the expiry count grows past 1, 2, 4, 8, 16
    and 32."""
    cluster = pkg.cluster.make_cluster([4] * 6, cpu=1e4, ram=1e4)
    model = cluster.models[0]
    vms, vid = [], 0
    for hour, n in enumerate((1, 2, 3, 5, 9, 17, 33, 1, 1)):
        for j in range(n):
            p = (vid * 7 + hour) % model.num_profiles
            vms.append(pkg.cluster.VM(
                vid, model.profiles[p], arrival=hour + j / (2.0 * n),
                duration=100.0, cpu=1.0, ram=1.0))
            vid += 1
    return pkg.batched.build_events(vms, cluster, horizon=12.0)


def test_mecc_expiry_width_grows_within_one_service():
    """MECC's expiry is a fixed-width masked scatter; the service computes
    each batch's expiry count on the host and moves to a runner of a
    wider W as the count grows (1, 2, 4, ..., 64), with the decisions
    of the JAX service and of both offline replays."""
    tev, jev = _growing_stream(PORT), _growing_stream(JAX)
    reqs, horizon = requests_from_trace(tev)
    jreqs, _ = jrequests(jev)
    cfg = dict(policy="MECC", micro_batch=1, mecc_window=1.0)
    svc = PlacementService.for_trace(tev, ServeConfig(**cfg), device="cpu")
    for r in reqs:
        assert svc.submit(r)
    widths = []
    while len(svc.queue):
        svc.drain(max_batches=1)
        widths.append(svc._carry.width)
    svc.flush(horizon)
    assert sorted(set(widths)) == [0, 1, 2, 4, 8, 16, 32, 64]
    assert svc.runner.step.width == 64
    jres = JB.replay(jev, JB.MECC, mecc_window=1.0)
    tres = B.replay(tev, B.MECC, device="cpu", mecc_window=1.0)
    assert svc.accepted_ids() == list(jres.accepted_ids)
    assert svc.accepted_ids() == list(tres.accepted_ids)
    jsvc = _stream(JService.for_trace(jev, JConfig(**cfg)), jreqs, horizon)
    assert_same_service(svc, jsvc)
    assert int(svc._snapshot()["mecc_ptr"]) == svc._carry.mecc_ptr > 0


@pytest.mark.parametrize("policy", ["MECC", "GRMU"])
def test_mixed_fleet_service_equals_jax(policy):
    """A30+A100+H100 fleet (``hetero_scenario``): per-model profiles on
    the tables path; the port's service == the JAX service == the JAX
    offline replay."""
    kw = dict(consolidation_interval=6.0) if policy == "GRMU" else {}
    tev, jev = (events_of(pkg, hetero_scenario, 1) for pkg in (PORT, JAX))
    reqs, horizon = requests_from_trace(tev)
    jreqs, _ = jrequests(jev)
    cfg = dict(policy=policy, micro_batch=16, **kw)
    svc = _stream(PlacementService.for_trace(tev, ServeConfig(**cfg),
                                             device="cpu"), reqs, horizon)
    jsvc = _stream(JService.for_trace(jev, JConfig(**cfg)), jreqs, horizon)
    assert svc._statics[policy].score_backend == "tables"
    jres = JB.replay(jpad_events(jev), JB.__dict__[policy], **kw)
    assert svc.accepted_ids() == list(jres.accepted_ids)
    assert svc.migrations() == (jres.intra_migrations,
                                jres.inter_migrations)
    assert_same_service(svc, jsvc)


def test_single_model_mcc_mecc_tiers_take_the_kernel_path(trace):
    """On a single-model fleet the MCC and MECC tiers resolve
    ``score_backend="auto"`` to the pick kernels, as the offline replay
    does (their plain versions on the CPU)."""
    svc = PlacementService.for_trace(
        trace["tev"], ServeConfig(tiers=("MCC", "MECC", "GRMU")),
        device="cpu")
    assert [svc._statics[n].score_backend for n in ("MCC", "MECC", "GRMU")
            ] == ["kernel", "kernel", "tables"]


def test_decision_step_refuses_telemetry_statics(trace):
    st = B.replay_statics(trace["tev"], B.FF, telemetry=True)
    with pytest.raises(ValueError, match="telemetry"):
        B.make_decision_step(st)


def test_service_device_rule(trace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PlacementService.for_trace(trace["tev"], ServeConfig())
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--smoke"])


def test_serve_command_line_smoke_on_the_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("online == offline decisions: True")
    assert P.ILP_TIER == "ILP"
