"""The port's boundary: what it imports, what it copies, where it runs.

  * importing ``repro_torch`` and every module of it loads neither
    ``jax`` nor any ``repro`` module (checked in a fresh interpreter), and
    no file of the port, ``chip_smoke.py``, ``replay_rate.py``,
    ``attention_rate.py`` or ``mask_probe.py`` names them in an import;
  * the two timing tools run each checkout in a process of its own;
  * the modules copied from the JAX package behave like their originals,
    and their text is the original's apart from the lines their header
    names;
  * the device rule: ``device=None`` means CUDA and raises without a card;
  * ``chip_smoke.py``'s digests are those of the JAX replay at full scale
    (decisions, and telemetry) and of the JAX ladder's synthetic rung.
"""
import ast
import difflib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_scenarios import JAX, PORT, events_of, hetero_scenario
from repro.core import batched as JB
from repro.core import streaming as JS
from repro.core.bucketing import pad_events as jpad_events
from repro.core import mig as jmig
from repro.core import policy_core as jpc
from repro.core import tables as jtables
from repro.workload import alibaba as jalibaba
from repro.workload import synthetic as jsynthetic
from repro_torch.core import batched as B
from repro_torch.core import mig, policy_core as pc, tables
from repro_torch.core.bucketing import pad_events
from repro_torch.device import resolve_device
from repro_torch.workload import alibaba

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        rel = path.relative_to(PORT_DIR.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_repro():
    mods = _port_modules()
    for m in ("repro_torch.serve.placement", "repro_torch.serve.queue",
              "repro_torch.launch.checkpoint", "repro_torch.launch.serve",
              "repro_torch.core.policies", "repro_torch.core.grmu",
              "repro_torch.core.ilp", "repro_torch.core.policy_core_np",
              "repro_torch.sim.engine", "repro_torch.workload.flashcrowd"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_repro():
    files = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                              ROOT / "replay_rate.py",
                                              ROOT / "attention_rate.py",
                                              ROOT / "mask_probe.py"]
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def _root_script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT))
    return mod


@pytest.mark.parametrize("tool,extra", [
    ("replay_rate", ["--policies", "MCC", "--reps", "2"]),
    ("attention_rate", []),
    ("replay_rate", ["--policies", "MCC", "--reps", "2", "--telemetry"])])
def test_timing_tool_runs_each_root_in_its_own_process(tool, extra,
                                                       monkeypatch):
    """Given A B B A, a timing tool starts one process per root, in that
    order, on its own command line with ``--worker INDEX``; the worker
    gets that root and the options; without CUDA it exits 1."""
    mod = _root_script(tool)
    argv = [f"{tool}.py", "A", "B", "B", "A", *extra]
    monkeypatch.setattr(sys, "argv", argv)
    opts = getattr(mod, "options", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.in_turns(mod.__doc__, mod.worker, opts) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    started = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, check: started.append(cmd))
    assert mod.in_turns(mod.__doc__, mod.worker, opts) == 0
    assert started == [[sys.executable, *argv, "--worker", str(i)]
                       for i in range(4)]
    seen = []
    monkeypatch.setattr(sys, "argv", started[2])
    assert mod.in_turns(mod.__doc__, lambda root, args: seen.append(
        (root, vars(args))), opts) == 0
    (root, args), = seen
    assert root == Path("B").resolve() and args["worker"] == 2
    if extra:
        assert (args["policies"], args["reps"], args["telemetry"]) == (
            "MCC", 2, "--telemetry" in extra)


@pytest.mark.parametrize("name", sorted(mig.DEVICE_MODELS))
def test_copied_tables_equal_originals(name):
    got = tables.tables_for_model(mig.DEVICE_MODELS[name])
    want = jtables.tables_for_model(jmig.DEVICE_MODELS[name])
    for field in ("slot_mask_arr", "slot_profile", "slot_start",
                  "profile_size", "cc", "counts", "fits", "assign_start",
                  "assign_mask", "cc_after", "frag", "popcount",
                  "counts_after"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


# Modules the port carries as copies, by path under the package; the
# changed ones with the number of their lines that differ from the
# original (the changes their header names).
COPIES = ("core/ilp.py", "core/mig.py", "core/tables.py", "models/config.py",
          "obs/reasons.py", "serve/queue.py", "sim/cluster.py",
          "sim/engine.py", "sim/metrics.py", "workload/alibaba.py",
          "workload/flashcrowd.py", "workload/synthetic.py")
CHANGED_COPIES = {"configs/tinyllama_1_1b.py": 1, "core/bucketing.py": 4,
                  "core/grmu.py": 1, "core/policies.py": 1,
                  "core/policy_core_np.py": 1, "obs/report.py": 3}
# Copies under another name: the port's own policy_core is torch-only,
# so the numpy-generic original is policy_core_np.
RENAMED_COPIES = {"core/policy_core_np.py": "core/policy_core.py"}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_text_equals_original(rel):
    port = (PORT_DIR / rel).read_text().splitlines()
    assert port[0] == (f"# Copied unchanged from repro/{rel} (the JAX "
                       "package), so the port imports nothing of it.")
    assert port[1:] == (ROOT / "src" / "repro" / rel).read_text(
    ).splitlines()


@pytest.mark.parametrize("rel", sorted(CHANGED_COPIES))
def test_copied_module_changes_only_what_its_header_names(rel):
    src = RENAMED_COPIES.get(rel, rel)
    port = (PORT_DIR / rel).read_text().splitlines()
    orig = (ROOT / "src" / "repro" / src).read_text().splitlines()
    assert port[0].startswith(f"# Copied from repro/{src} (the JAX package)")
    added = [ln for ln in difflib.ndiff(orig, port[1:])
             if ln.startswith("+ ")]
    assert len(added) == CHANGED_COPIES[rel], added


@pytest.mark.parametrize("fleet", [(), ("A30-24GB", "A100-40GB",
                                        "H100-80GB")],
                         ids=["a100", "mixed"])
def test_stacked_fleet_tables_equal_originals(fleet):
    models = tuple(mig.DEVICE_MODELS[n] for n in fleet) or (mig.A100_40GB,)
    jmodels = tuple(jmig.DEVICE_MODELS[m.name] for m in models)
    got = pc._stack_host_tables(models)
    want = jpc._stack_host_tables(jmodels)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("preset", ["a100", "a30_a100_h100"])
def test_copied_generate_equals_original(preset):
    fleet = alibaba.FLEET_PRESETS[preset]
    c, vms = alibaba.generate(alibaba.TraceConfig(scale=0.05, seed=3,
                                                  fleet=fleet))
    jc, jvms = jalibaba.generate(jalibaba.TraceConfig(scale=0.05, seed=3,
                                                      fleet=fleet))
    assert [m.name for m in c.models] == [m.name for m in jc.models]
    for attr in ("gpu_model_id", "gpu_host_id", "host_cpu_cap",
                 "host_ram_cap", "free_masks"):
        np.testing.assert_array_equal(getattr(c, attr), getattr(jc, attr))
    assert len(vms) == len(jvms)
    for v, j in zip(vms, jvms):
        assert (v.vm_id, v.profile.name, v.arrival, v.duration, v.cpu,
                v.ram, v.profile_ids) == (
            j.vm_id, j.profile.name, j.arrival, j.duration, j.cpu, j.ram,
            j.profile_ids)


def test_device_none_means_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    c, vms = alibaba.generate(alibaba.TraceConfig(scale=0.01, seed=1))
    events = B.build_events(vms, c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.replay(events, B.FF)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.make_replay(events, B.MCC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        B.trace_from_numpy(B.trace_arrays(events))
    assert resolve_device("cpu") == torch.device("cpu")
    assert B.replay(events, B.FF, device="cpu").total_requests == len(vms)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_digests_are_the_jax_replay_at_full_scale():
    smoke = _chip_smoke()
    jc, jvms = jalibaba.generate(jalibaba.TraceConfig(scale=1.0, seed=1))
    events = JB.build_events(jvms, jc)
    assert (len(events.kind), events.num_gpus) == (9326, 1860)
    cfgs = {"FF": (JB.FF, {}), "BF": (JB.BF, {}), "MCC": (JB.MCC, {}),
            "MECC": (JB.MECC, {}), "GRMU": (JB.GRMU, smoke.GRMU_FULL)}
    assert cfgs.keys() == smoke.DIGESTS.keys()
    for name, (pol, kw) in cfgs.items():
        res = JB.replay(events, pol, **kw)
        assert smoke.result_digest(res) == smoke.DIGESTS[name], name


def test_chip_smoke_telemetry_digests_are_the_jax_replay_at_full_scale():
    """Phase 4b (a): the telemetry arrays of the JAX replay with
    telemetry on, whose decisions are still those of ``DIGESTS``."""
    smoke = _chip_smoke()
    jc, jvms = jalibaba.generate(jalibaba.TraceConfig(scale=1.0, seed=1))
    events = JB.build_events(jvms, jc)
    cap = JB.default_heavy_capacity(events)
    cfgs = {"FF": (JB.FF, {}), "BF": (JB.BF, {}), "MCC": (JB.MCC, {}),
            "MECC": (JB.MECC, {}), "GRMU": (JB.GRMU, smoke.GRMU_FULL)}
    assert cfgs.keys() == smoke.TELE_DIGESTS.keys()
    for name, (pol, kw) in cfgs.items():
        out = {k: np.asarray(v) for k, v in jax.device_get(
            JB.make_replay(events, pol, telemetry=True, **kw)(cap)).items()}
        res = JB.result_from_arrays(events, pol, out)
        assert smoke.result_digest(res) == smoke.DIGESTS[name], name
        assert smoke.telemetry_digest(events, out) == \
            smoke.TELE_DIGESTS[name], name


def test_chip_smoke_synth_digests_are_the_jax_ladder_rung():
    """Phase 4b (d): the JAX ladder's synth:20000x512 rung, padded to a
    multiple of its 4,096-event chunk and streamed as the ladder streams
    it; GRMU DB accepts BENCH_batched_engine.json's 17,862."""
    smoke = _chip_smoke()
    ev = jsynthetic.generate_events(
        jsynthetic.SyntheticConfig(**smoke.SYNTH_CFG))
    assert (len(ev.kind), ev.num_gpus) == (41824, 512)
    pv = jpad_events(ev, event_multiple=smoke.SYNTH_CHUNK)
    cap = JB.default_heavy_capacity(pv)
    cfgs = {"GRMU-DB": (JB.GRMU, smoke.GRMU_DB), "MECC": (JB.MECC, {})}
    assert cfgs.keys() == smoke.SYNTH_DIGESTS.keys()
    for name, (pol, kw) in cfgs.items():
        res = JS.replay_chunked(pv, pol, cap, chunk_events=smoke.SYNTH_CHUNK,
                                **kw)
        assert smoke.result_digest(res) == smoke.SYNTH_DIGESTS[name], name
        if name == "GRMU-DB":
            assert res.accepted == smoke.SYNTH_ACCEPTED_GRMU_DB


def test_chip_smoke_telemetry_digest_reads_the_port_as_the_jax_package():
    """The digest of the port's telemetry arrays is the digest of the JAX
    package's on the same trace (unpadded and padded)."""
    smoke = _chip_smoke()
    kw = dict(defrag=True, consolidation_interval=6.0)
    jev = events_of(JAX, hetero_scenario, 1)
    tev = events_of(PORT, hetero_scenario, 1)
    cap = JB.default_heavy_capacity(jev)
    want = smoke.telemetry_digest(jev, {
        k: np.asarray(v) for k, v in JB.make_replay(
            jev, JB.GRMU, telemetry=True, **kw)(cap).items()})
    for ev in (tev, pad_events(tev)):
        out = B.make_replay(ev, B.GRMU, "cpu", telemetry=True, **kw)(cap)
        assert smoke.telemetry_digest(
            ev, {k: v.numpy() for k, v in out.items()}) == want


@pytest.mark.parametrize("dtype_name,bound_ms,bound_by", [
    ("bfloat16", 0.2780, "operations"),   # 989 TFLOP/s bf16 tensor cores
    ("float32", 1.6680, "operations"),    # six bf16 plane products each
])
def test_chip_smoke_attention_bound_at_the_prefill_shape(dtype_name,
                                                         bound_ms, bound_by):
    """The bound chip_smoke.py reports for each attention kernel: the
    causal pairs' 4 * B * H * hd flops at its dtype's peak (float32: the
    bf16 tensor cores' over the six plane products per float32 product),
    against q, k, v and o read or written once."""
    smoke = _chip_smoke()
    B, S = smoke.PREFILL_B, smoke.PREFILL_S
    assert smoke.attention_pairs(S, S, True, None) == S * (S + 1) // 2
    assert smoke.attention_pairs(300, 300, True, 96) == sum(
        min(i + 1, 96) for i in range(300))
    got, by = smoke.attention_bound_ms(B, S, S, 32, 4, 64, True, None,
                                       dtype_name)
    assert by == bound_by and got == pytest.approx(bound_ms, rel=1e-3)


def test_chip_smoke_split_bound_and_route_launches():
    """The split's bound is its bytes (4 read, 6 written per element) at
    3.35 TB/s; a float32 wrapper call launches the float32 kernel once and
    the split three times, a bf16 one the bf16 kernel once."""
    from repro_torch.kernels import flash_attention as FA
    smoke = _chip_smoke()
    n = smoke.PREFILL_B * smoke.PREFILL_S * 32 * 64
    got, by = smoke.split_bound_ms(n)
    assert by == "bytes" and got == pytest.approx(10 * n / 3.35e9)
    assert smoke.route_launches(FA, torch.float32) == {
        "flash_attention": 0, "flash_attention_f32": 1, "split_bf16x3": 3}
    assert smoke.route_launches(FA, torch.bfloat16) == {
        "flash_attention": 1, "flash_attention_f32": 0, "split_bf16x3": 0}
    assert smoke.F32_ATTN_CASES["long_noncausal"] == (
        1, 1024, 16384, 8, 2, 64, False, None)


@pytest.mark.parametrize("name,n,hosts,nbytes", [
    ("mcc", 1860, 0, 8 * 1860),
    ("ecc", 1860, 0, 8 * 1860 + 4 * 6),
    ("cc", 1 << 20, 0, 8 << 20),
    ("frag", 1 << 20, 0, 8 << 20),
    ("mcc_pick", 1860, 1213, 20 * 1860 + 8 * 1213 + 8 + 8),
    ("ecc_pick", 1 << 20, 1 << 18, 20 * (1 << 20) + 8 * (1 << 18) + 8
     + 4 * 6 + 8),
])
def test_chip_smoke_mask_kernel_bound_is_the_bytes_floor(name, n, hosts,
                                                         nbytes):
    """The mask kernels' bound is the bytes their inputs and outputs hold
    at 3.35 TB/s, whatever the kernel does with them."""
    from repro_torch.core.mig import A100_40GB
    smoke = _chip_smoke()
    got, by = smoke.bound_ms(name, n, A100_40GB, hosts)
    assert by == "bytes"
    assert got == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_chip_smoke_float64_attention_and_its_error_measure(causal, window):
    """Phase 5b's truth is the plain version's function in float64, and its
    error measure sees a rounding to nearest as unbiased and a shrink
    toward zero as biased."""
    from repro_torch.kernels import ref
    smoke = _chip_smoke()
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((2, 48, 4, 32), (2, 48, 2, 32),
                                             (2, 48, 2, 32)))
    truth = smoke.attention_f64(q, k, v, causal, window, q_chunk=16)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    assert truth.dtype == torch.float64 and truth.shape == q.shape
    torch.testing.assert_close(truth, want.double(), rtol=1e-5, atol=1e-6)
    rounded = smoke.error_vs_truth(torch, truth.to(torch.bfloat16), truth)
    assert rounded["flips"] == 0 and rounded["n_over_half_ulp"] == 0
    assert rounded["max_half_ulps"] <= 1.0
    shrunk = smoke.error_vs_truth(
        torch, (truth * (1 - 2.0 ** -9)).to(torch.bfloat16), truth)
    assert shrunk["flips"] > 0 and shrunk["flips_up_share"] == 0.0
    assert shrunk["mean_half_ulps"] < rounded["mean_half_ulps"]


@pytest.mark.parametrize("n,hosts", [(1860, 1213), (1 << 20, (1 << 20) // 3)])
def test_chip_smoke_times_picks_on_a_fleet_with_a_gpu_on_every_host(n,
                                                                     hosts):
    """The picks' bytes floor counts one used row per host, so the fleet
    they are timed on leaves no host without a GPU: GPUs numbered host by
    host, as many on each host as an even split gives."""
    from repro_torch.core.mig import A100_40GB
    smoke = _chip_smoke()
    (free, gpu_host, used, cap_g, need), got = smoke.timed_fleet(A100_40GB,
                                                                 n)
    per_host = np.bincount(gpu_host, minlength=hosts)
    assert got == hosts == len(used) == len(per_host)
    assert per_host.min() == n // hosts and per_host.max() <= n // hosts + 1
    assert (np.diff(gpu_host) >= 0).all()
    same_host = gpu_host[1:] == gpu_host[:-1]
    assert (cap_g[1:] == cap_g[:-1])[same_host].all()


def test_chip_smoke_sweep_is_the_jax_sweep_at_full_scale():
    """Phase 6 (e): the JAX sweep (vmapped GRMU DB replays) over
    ``SWEEP_FRACS`` of the full-scale trace's GPUs."""
    smoke = _chip_smoke()
    jc, jvms = jalibaba.generate(jalibaba.TraceConfig(scale=1.0, seed=1))
    events = JB.build_events(jvms, jc)
    got = JB.sweep_heavy_capacity(events, np.asarray(smoke.SWEEP_FRACS))
    assert got.tolist() == smoke.SWEEP_ACCEPTED
    assert got.sum(axis=1).tolist() == [5124, 5230, 5296, 5119, 4920]


def test_chip_smoke_service_streams_are_the_replay_traces():
    """Phase 6's request streams: the full-scale trace's (8,604 requests,
    8,063 arrivals) and the flash crowd at BENCH_serve.json's size, where
    the JAX service accepts 373 online and offline."""
    import json
    from repro.serve import (PlacementService, ServeConfig,
                             requests_from_trace)
    from repro.workload.flashcrowd import (FlashCrowdConfig,
                                           generate_flash_crowd)
    smoke = _chip_smoke()
    jc, jvms = jalibaba.generate(jalibaba.TraceConfig(scale=1.0, seed=1))
    reqs, _ = requests_from_trace(JB.build_events(jvms, jc))
    n_arr = sum(type(r).__name__ == "Arrival" for r in reqs)
    assert (len(reqs), n_arr) == (smoke.SERVE_REQUESTS,
                                  smoke.SERVE_ARRIVALS)
    bench = json.loads((ROOT / "BENCH_serve.json").read_text())
    cfg = smoke.FLASH_CFG
    assert (cfg["n_vms"], cfg["n_gpus"], bench["micro_batch"]) == (
        bench["n_vms"], bench["n_gpus"], smoke.SERVE_BATCH)
    fc = generate_flash_crowd(FlashCrowdConfig(**cfg))
    freqs, h = requests_from_trace(fc)
    assert len(freqs) == bench["n_requests"]
    svc = PlacementService.for_trace(fc, ServeConfig(
        policy="GRMU", micro_batch=smoke.SERVE_BATCH))
    for r in freqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(h)
    assert svc.stats()["accepted"] == smoke.FLASH_ACCEPTED == bench[
        "accepted_online"]
