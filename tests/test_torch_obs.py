"""Port telemetry and flight recorder (``repro_torch.obs``, CPU) vs the
JAX package's ``repro.obs``.

Both packages replay VM lists built from the same numpy draws
(tests/_torch_scenarios.py) with telemetry on.  The ``TELE_KEYS`` output
arrays, every ``ReplayTelemetry`` field (its float64 series from the
same numpy code) and the ``SimResult`` with its rejection reasons must be
equal exactly: all five policies on the A100 and the mixed fleet, MCC
and MECC through both scoring backends, GRMU in its four settings.
Telemetry on must leave every decision as it is off; the reasons must
equal the JAX sequential engine's; the padded scale-0.1 GRMU DB anchor
reads 70 / 0 / 220 / 0.  The recorder's JSONL round trip and the report
(byte for byte the JAX report's rendering) close the file.
"""
import functools
import json

import numpy as np
import pytest
import torch

from _torch_scenarios import (JAX, PORT, POLICIES, assert_same_result,
                              events_of, hetero_scenario, random_scenario)
from repro.core.grmu import GRMU as JGRMU
from repro.core.policies import POLICY_REGISTRY
from repro.obs import inscan as jinscan
from repro.obs import reasons as jreasons
from repro.obs import report as jreport
from repro.sim.engine import simulate
from repro_torch.core import batched as B
from repro_torch.core import streaming as ST
from repro_torch.core.bucketing import pad_events
from repro_torch.obs import inscan, reasons, recorder, report
from repro_torch.workload.alibaba import TraceConfig, generate

torch.set_num_threads(1)

SCENARIOS = {"a100": random_scenario, "mixed": hetero_scenario}
GRMU_CFGS = {
    "db": dict(defrag=False, consolidation_interval=None),
    "defrag": dict(defrag=True, consolidation_interval=None),
    "cons6": dict(defrag=True, consolidation_interval=6.0),
    "any12": dict(defrag=True, defrag_trigger="any",
                  consolidation_interval=12.0),
}
POLICY_CFG = {"GRMU": GRMU_CFGS["cons6"]}


@functools.lru_cache(maxsize=None)
def jax_telemetry(scenario, seed, policy, cfg=()):
    """The JAX package's ``replay_with_telemetry`` (result, telemetry and
    the raw output arrays) on one scenario, computed once per module."""
    jev = events_of(JAX, SCENARIOS[scenario], seed)
    cap = int(round(0.3 * jev.num_gpus))
    out = JAX.batched.make_replay(jev, POLICIES[policy], telemetry=True,
                                  **dict(cfg))(cap)
    out = {k: np.asarray(v) for k, v in out.items()}
    return (JAX.batched.result_from_arrays(jev, POLICIES[policy], out),
            jinscan.telemetry_from_arrays(jev, out), out)


def port_telemetry(scenario, seed, policy, cfg=(), **port_kw):
    tev = events_of(PORT, SCENARIOS[scenario], seed)
    cap = int(round(0.3 * tev.num_gpus))
    out = B.make_replay(tev, POLICIES[policy], "cpu", telemetry=True,
                        **dict(cfg), **port_kw)(cap)
    out = {k: v.numpy() for k, v in out.items()}
    return (B.result_from_arrays(tev, POLICIES[policy], out),
            inscan.telemetry_from_arrays(tev, out), out, tev, cap)


def assert_same_telemetry(jt, tt):
    for f in ("model_names", "rejection_reasons"):
        assert getattr(tt, f) == getattr(jt, f), f
    for f in ("vm_reason", "step_times", "rej_hourly", "intra_hourly",
              "inter_hourly", "basket_hourly", "free_hist", "frag_mean",
              "util", "active_gpus"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tt.to_json_dict() == jt.to_json_dict()


def check_against_jax(scenario, seed, policy, cfg=(), **port_kw):
    jres, jtele, jout = jax_telemetry(scenario, seed, policy, cfg)
    tres, ttele, tout, tev, cap = port_telemetry(scenario, seed, policy,
                                                 cfg, **port_kw)
    for k in inscan.TELE_KEYS:
        assert tout[k].dtype == jout[k].dtype, k
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
    assert_same_result(jres, tres)
    assert tres.rejection_reasons == jres.rejection_reasons
    assert sum(tres.rejection_reasons.values()) == tres.rejected
    assert_same_telemetry(jtele, ttele)
    # Telemetry reads decision state only: off decides the same.
    off = B.replay(tev, POLICIES[policy], cap, device="cpu", **dict(cfg),
                   **port_kw)
    assert_same_result(off, tres)
    assert off.rejection_reasons == {}
    return tres, ttele


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_telemetry_matches_jax(scenario, policy):
    cfg = tuple(sorted(POLICY_CFG.get(policy, {}).items()))
    res, tele = check_against_jax(scenario, 1, policy, cfg)
    assert res.rejected > 0
    if policy != "GRMU":
        assert (tele.basket_hourly == 0).all()
        assert (tele.intra_hourly == 0).all()


@pytest.mark.parametrize("backend", ["tables", "kernel"])
@pytest.mark.parametrize("policy", ["MCC", "MECC"])
def test_mcc_mecc_telemetry_matches_jax_on_both_backends(policy, backend):
    """The kernel path's fused pick keeps its host headroom to itself;
    with telemetry the replay computes it beside the pick."""
    check_against_jax("a100", 1, policy, score_backend=backend)


@pytest.mark.parametrize("cfg", sorted(GRMU_CFGS))
def test_grmu_telemetry_matches_jax(cfg):
    res, tele = check_against_jax("a100", 1, "GRMU",
                                  tuple(sorted(GRMU_CFGS[cfg].items())))
    assert tele.rejection_reasons["basket_quota"] > 0
    # The baskets partition the fleet at every step.
    assert (tele.basket_hourly.sum(axis=1)
            == tele.free_hist.sum(axis=(1, 2))).all()


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_rejection_reasons_match_sequential_engine(policy):
    """The port's in-replay reasons equal the JAX sequential engine's,
    which classifies each rejection on its object state."""
    cluster, vms = hetero_scenario(JAX, 0)
    pol = (JGRMU(cluster, **POLICY_CFG["GRMU"]) if policy == "GRMU"
           else POLICY_REGISTRY[policy](cluster))
    seq = simulate(cluster, pol, vms)
    tev = events_of(PORT, hetero_scenario, 0)
    res, tele = inscan.replay_with_telemetry(
        tev, POLICIES[policy], int(round(0.3 * tev.num_gpus)),
        device="cpu", **POLICY_CFG.get(policy, {}))
    assert res.accepted_ids == seq.accepted_ids
    assert res.rejection_reasons == seq.rejection_reasons
    assert tele.rej_hourly[-1].tolist() == [
        seq.rejection_reasons[n] for n in reasons.REJECTION_REASONS]


def test_padded_alibaba_anchor_grmu_db():
    """GRMU at the DB point on the pow2-padded TraceConfig(scale=0.1,
    seed=1) trace: the reasons BENCH_batched_engine.json records."""
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    ev = pad_events(B.build_events(vms, cluster))
    res, tele = inscan.replay_with_telemetry(ev, B.GRMU, device="cpu",
                                             **GRMU_CFGS["db"])
    assert res.accepted == 516
    want = {"no_slot": 70, "capacity": 0, "basket_quota": 220, "frozen": 0}
    assert res.rejection_reasons == tele.rejection_reasons == want
    assert (tele.vm_reason >= 0).all() and len(tele.step_times) == len(
        tele.free_hist)


def test_code_table_is_the_reason_cascade():
    """The replay's code lookup equals ``arrival_code`` of the JAX
    package's taxonomy for every combination of its flags; an accepted
    arrival is ``ACCEPTED`` whatever the flags."""
    table, cols = inscan.device_tables("cpu")
    table = table.numpy()
    assert cols.tolist() == list(inscan.BASKET_COLS) == [1, 2, 0]
    assert len(table) == 12
    for best in (0, 1, 2):
        for grew in (0, 1):
            for quota in (0, 1):
                flags = (np.bool_(best >= 1), np.bool_(best >= 2),
                         np.bool_(grew), np.bool_(quota))
                want = jreasons.arrival_code(np, np.bool_(False), *flags)
                assert table[best * 4 + grew * 2 + quota] == want
                assert jreasons.arrival_code(np, np.bool_(True), *flags) \
                    == reasons.ACCEPTED


def test_step_rows_and_masks_layout():
    res, tele, out, tev, _ = port_telemetry("mixed", 1, "GRMU",
                                            tuple(POLICY_CFG["GRMU"].items()))
    S, G = len(tev.step_times), len(tev.gpu_model_id)
    assert out["tele_steps"].shape == (S, inscan.NUM_STEP_COLS)
    assert out["tele_masks"].shape == (S, G)
    assert out["tele_masks"].dtype == np.uint8
    assert out["tele_rej"][0] == res.accepted
    assert out["tele_rej"][1:].sum() == res.rejected
    assert tele.intra_hourly[-1] == res.intra_migrations
    assert tele.inter_hourly[-1] == res.inter_migrations


# ---------------------------------------------------------------------------
# Recorder and report
# ---------------------------------------------------------------------------

def _recorded_run(path):
    tev = events_of(PORT, hetero_scenario, 0)
    cap = int(round(0.3 * tev.num_gpus))
    with recorder.record(path, run_id="t1",
                         meta={"policy": "GRMU"}) as rec:
        assert recorder.active() is rec
        res = ST.replay_chunked(tev, B.GRMU, cap, chunk_events=64,
                                device="cpu", telemetry=True,
                                **POLICY_CFG["GRMU"])
        _, tele = inscan.replay_with_telemetry(tev, B.GRMU, cap,
                                               device="cpu",
                                               **POLICY_CFG["GRMU"])
        rec.result(res)
        rec.telemetry(tele)
    assert recorder.active() is None
    n_chunks = ST.make_chunked_replay(tev, B.GRMU, chunk_events=64,
                                      device="cpu").num_chunks
    return res, n_chunks


def test_recorder_jsonl_roundtrip_and_report(tmp_path, capsys):
    path = tmp_path / "obs.jsonl"
    res, n_chunks = _recorded_run(path)
    runs = report.load([str(path)])
    assert len(runs) == 1 and runs[0]["run_id"] == "t1"
    spans = report._agg_spans(runs[0]["spans"])
    assert spans["chunk.step"]["count"] == n_chunks
    assert spans["chunk.prefetch"]["count"] == n_chunks
    assert spans["finalize"]["count"] == 1
    assert spans["chunk.step"]["bytes"] > 0
    # The recorded chunked replay writes the compile cache's record.
    assert set(runs[0]["cache"]) == {"hits", "misses", "evictions",
                                     "entries"}
    assert runs[0]["cache"]["entries"] >= 2  # chunk step and finalize
    summ = report.summarize(runs[0])
    assert summ["acceptance_rate"] == res.summary()["acceptance_rate"]
    assert summ["rejection_reasons"] == res.rejection_reasons
    assert summ["final_baskets"] is not None
    text = report.render_text(runs[0])
    assert "util[" in text and "chunk.step" in text
    # The port's report renders the file byte for byte as the JAX one.
    for argv in ([str(path)], [str(path), "--json"]):
        assert report.main(argv) == 0
        got = capsys.readouterr().out
        assert jreport.main(argv) == 0
        assert got == capsys.readouterr().out


def test_report_rejects_newer_schema(tmp_path):
    p = tmp_path / "future.jsonl"
    p.write_text(json.dumps({"schema": inscan.SCHEMA_VERSION + 1,
                             "kind": "meta", "run_id": "x"}) + "\n")
    with pytest.raises(ValueError, match="newer"):
        report.load([str(p)])


def test_unrecorded_chunked_replay_writes_no_file(tmp_path):
    tev = events_of(PORT, random_scenario, 0)
    assert recorder.active() is None
    ST.replay_chunked(tev, B.FF, chunk_events=64, device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_trace_env_writes_a_chrome_trace(tmp_path, monkeypatch):
    """``REPRO_TRACE=1`` runs a ``torch.profiler`` session for the
    recorder's lifetime; its Chrome trace holds the spans' ranges."""
    monkeypatch.setenv("REPRO_TRACE", "1")
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path / "trace"))
    tev = events_of(PORT, random_scenario, 0)
    with recorder.record(tmp_path / "run.jsonl", run_id="tr"):
        ST.replay_chunked(tev, B.FF, chunk_events=256, device="cpu")
    trace = json.loads((tmp_path / "trace" / "tr.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"chunk.step", "chunk.prefetch", "finalize"} <= names
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert kinds[:2] == ["meta", "trace_started"]
