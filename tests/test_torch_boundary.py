"""The port's boundary: what it imports, what it copies, where it runs.

  * importing ``repro_torch`` and every module of it loads neither
    ``jax`` nor any ``repro`` or ``tools`` module (checked in a fresh
    interpreter), and no file of the port, ``chip_smoke.py``,
    ``replay_rate.py``, ``attention_rate.py``, ``mask_probe.py`` or
    ``cut_probe.py`` names them in an import;
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
              "repro_torch.sim.engine", "repro_torch.workload.flashcrowd",
              "repro_torch.core.sharded", "repro_torch.core.adaptive",
              "repro_torch.core.podsched", "repro_torch.core.enumerate",
              "repro_torch.lint.graph_gate", "repro_torch.lint.__main__"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'tools'))\n"
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
                                              ROOT / "mask_probe.py",
                                              ROOT / "cut_probe.py"]
    assert len(files) > 10
    assert PORT_DIR / "lint" / "graph_gate.py" in files
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro", "tools"}, (path, roots)


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
COPIES = ("core/adaptive.py", "core/enumerate.py", "core/ilp.py",
          "core/mig.py", "core/podsched.py", "core/tables.py",
          "models/config.py",
          "obs/reasons.py", "serve/queue.py", "sim/cluster.py",
          "sim/engine.py", "sim/metrics.py", "workload/alibaba.py",
          "workload/flashcrowd.py", "workload/synthetic.py")
CHANGED_COPIES = {"configs/deepseek_7b.py": 1,
                  "configs/deepseek_v2_236b.py": 1,
                  "configs/llama4_scout_17b_a16e.py": 1,
                  "configs/mistral_nemo_12b.py": 1,
                  "configs/qwen2_vl_2b.py": 1, "configs/stablelm_3b.py": 1,
                  "configs/tinyllama_1_1b.py": 1,
                  "configs/whisper_base.py": 1, "configs/rwkv6_3b.py": 1,
                  "configs/zamba2_7b.py": 1, "core/bucketing.py": 4,
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


# The JAX lint's framework-free modules the port's lint carries as
# copies, with the number of lines that differ (the ratchet's path and
# command, the port's).
LINT_COPIES = {"common.py": 1, "ratchet.py": 2}


@pytest.mark.parametrize("name", sorted(LINT_COPIES))
def test_lint_copies_change_only_the_ratchets_path(name):
    port = (PORT_DIR / "lint" / name).read_text().splitlines()
    orig = (ROOT / "tools" / "lint" / name).read_text().splitlines()
    assert port[0].startswith(f"# Port of tools/lint/{name} (the JAX "
                              "package's repro-lint)")
    added = [ln for ln in difflib.ndiff(orig, port[1:])
             if ln.startswith("+ ")]
    assert len(added) == LINT_COPIES[name], added
    assert all("repro_torch" in ln for ln in added), added


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


@pytest.mark.parametrize("arch,shape,bound_ms", [
    ("deepseek_7b", (4, 4096, 32, 32, 128), 0.5563),
    ("mistral_nemo_12b", (4, 4096, 32, 8, 128), 0.5563),
    ("stablelm_3b", (4, 4096, 32, 32, 80), 0.3477),
    ("qwen2_vl_2b", (4, 4096, 12, 2, 128), 0.2086),
])
def test_chip_smoke_zoo_attention_shapes_and_bounds(arch, shape, bound_ms):
    """Phase 5c's models are ported architectures; phase 2b times the bf16
    kernel at each one's prefill shape (B 4, S 4096, its heads), where the
    causal bound is operations at 989 TFLOP/s."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    smoke = _chip_smoke()
    assert set(smoke.ZOO) <= set(ARCH_IDS) and smoke.ZOO_F32 in smoke.ZOO
    assert smoke.ARCH not in smoke.ZOO and arch in smoke.ZOO
    assert smoke.zoo_attention_shape(get_config(arch)) == shape
    B, S, H, KV, hd = shape
    got, by = smoke.attention_bound_ms(B, S, S, H, KV, hd, True, None,
                                       "bfloat16")
    assert by == "operations" and got == pytest.approx(bound_ms, rel=1e-3)
    # Phase 2b's cases launch every head dim the kernels take.
    assert sorted({c[5] for c in smoke.ATTN_CASES.values()}) == sorted(
        HEAD_DIMS)


@pytest.mark.parametrize("name,bound_ms,bound_by", [
    ("whisper_base prefill", 0.1390, "operations"),
    ("whisper_base encode", 0.03727, "operations"),
    ("whisper_base decoder", 0.004382, "bytes"),
    ("whisper_base cross", 0.01113, "operations"),
    ("llama4_scout_17b_a16e", 0.6950, "operations"),
])
def test_chip_smoke_5d_attention_shapes_and_bounds(name, bound_ms, bound_by):
    """Phase 2b holds and times the bf16 kernel at every attention shape of
    phase 5d's path: Whisper's encoder over the prefill cell's 4 x 4096
    frames and over 8 x 1,500, both non-causal, its decoder's causal self
    attention over 448 tokens and its cross attention (448 tokens over the
    1,500 frames, non-causal), and Scout's causal prefill, each with its
    model's heads; each bound is over the pairs the mask keeps (operations
    at 989 TFLOP/s, or bytes at 3.35 TB/s for the decoder's short causal
    rows), and the plain version's chunks divide the lengths."""
    from repro_torch.configs import get_config
    smoke = _chip_smoke()
    B, Sq, Sk, H, KV, hd, causal = smoke.MODEL_ATTN_SHAPES[name]
    cfg = get_config(name.split()[0])
    assert (H, KV, hd) == (cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim)
    assert causal == (cfg.family == "moe" or name.endswith("decoder"))
    if name.endswith("prefill"):
        assert (B, Sq, Sk) == (smoke.PREFILL_B, smoke.PREFILL_S,
                               smoke.PREFILL_S)
    got, by = smoke.attention_bound_ms(B, Sq, Sk, H, KV, hd, causal, None,
                                       "bfloat16")
    assert by == bound_by and got == pytest.approx(bound_ms, rel=1e-3)
    for n in (Sq, Sk):
        assert n % smoke.plain_chunk(n) == 0 and smoke.plain_chunk(n) <= 1024
    assert [smoke.plain_chunk(n) for n in (1500, 448, 4096, 1000, 333)] == [
        750, 448, 1024, 1000, 333]


def test_chip_smoke_windowed_prefill_shape_and_bound():
    """Phase 5e prefills a windowed model at S twice its window with the
    cell's tokens per call (Zamba2-7B: 2 x 8,192; at 4,096 its 4,096-key
    window masks nothing), and phase 2b times the kernel there: 25,167,872
    kept pairs a sequence, 7.22e11 flop, 0.730 ms at 989 TFLOP/s.  Launches
    per forward: the shared block's 13 groups, none for RWKV-6."""
    from repro_torch.configs import get_config
    smoke = _chip_smoke()
    zamba, rwkv = get_config(smoke.ZAMBA2), get_config(smoke.RWKV6)
    assert smoke.prefill_shape(zamba) == (2, 8192)
    assert smoke.prefill_shape(rwkv) == (smoke.PREFILL_B, smoke.PREFILL_S)
    assert smoke.zoo_attention_shape(zamba) == (2, 8192, 32, 32, 112)
    pairs = smoke.attention_pairs(8192, 8192, True, 4096)
    assert pairs == 25_167_872
    assert 4.0 * 2 * 32 * 112 * pairs == pytest.approx(7.22e11, rel=1e-3)
    got, by = smoke.attention_bound_ms(2, 8192, 8192, 32, 32, 112, True,
                                       4096, "bfloat16")
    assert by == "operations" and got == pytest.approx(0.7299, rel=1e-3)
    assert [smoke.attention_calls(get_config(a)) for a in (
        smoke.ZAMBA2, smoke.RWKV6, smoke.ARCH)] == [13, 0, 22]
    mask = smoke.band_mask(torch, 6, 6, 2, "cpu")
    assert mask.sum(1).tolist() == [1, 2, 2, 2, 2, 2]
    assert int(smoke.band_mask(torch, 8192, 8192, 4096, "cpu").sum()) == pairs


def test_chip_smoke_mla_prefill_shape_and_bound():
    """Phase 2b holds and times the kernel at DeepSeek-V2's prefill (B 4,
    S 4096, H = KV = 128, causal) with q/k at 192 against v at 128: 2 * B
    * H * (192 + 128) flops a kept pair, 2.749e12, 2.780 ms at 989
    TFLOP/s, against ~2.68 GB of bf16 q, k, v and o (0.80 ms); float32's
    six plane passes at B 1.  The pair is the wrapper's, and the model's
    prefill attention runs at it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import HEAD_DIM_PAIRS
    smoke = _chip_smoke()
    cfg = get_config(smoke.DSV2)
    B, Sq, Sk, H, KV, hd, causal = smoke.MODEL_ATTN_SHAPES[smoke.DSV2]
    assert (B, Sq, Sk, H, KV, hd, causal) == (
        smoke.PREFILL_B, smoke.PREFILL_S, smoke.PREFILL_S, 128, 128,
        (192, 128), True)
    assert smoke.attention_head_dims(cfg) == hd
    assert smoke.zoo_attention_shape(cfg) == (B, Sq, H, KV, hd)
    assert hd in HEAD_DIM_PAIRS
    assert {smoke.head_dims_of(c[5]) for c in smoke.PAIR_ATTN_CASES.values()
            } == set(HEAD_DIM_PAIRS)
    pairs = smoke.attention_pairs(Sq, Sk, True, None)
    assert 2.0 * B * H * (192 + 128) * pairs == pytest.approx(2.749e12,
                                                               rel=1e-3)
    got, by = smoke.attention_bound_ms(B, Sq, Sk, H, KV, hd, True, None,
                                       "bfloat16")
    assert by == "operations" and got == pytest.approx(2.780, rel=1e-3)
    nbytes = 2 * (B * Sq * H * 320 + B * Sk * KV * 320)
    assert nbytes == pytest.approx(2.68e9, rel=2e-3)
    got, by = smoke.attention_bound_ms(1, Sq, Sk, H, KV, hd, True, None,
                                       "float32")
    assert by == "operations" and got == pytest.approx(6 * 2.780 / 4,
                                                       rel=1e-3)


@pytest.mark.parametrize("hd", [16, 64, 80, 112, 128])
def test_chip_smoke_attention_bound_at_equal_widths_is_unchanged(hd):
    """A pair of equal widths is the int: 4 * B * H * hd flops a kept pair
    and q, k, v, o of hd each, the numbers before MLA's pair was added."""
    smoke = _chip_smoke()
    for args in ((4, 4096, 4096, 32, 8), (8, 448, 1500, 8, 8)):
        for dtype_name in ("bfloat16", "float32"):
            for causal, window in ((True, None), (False, None), (True, 96)):
                a = smoke.attention_bound_ms(*args, hd, causal, window,
                                             dtype_name)
                b = smoke.attention_bound_ms(*args, (hd, hd), causal, window,
                                             dtype_name)
                assert a == b
    B, S, H, KV = 4, 4096, 32, 8
    flops = 4.0 * B * H * hd * smoke.attention_pairs(S, S, True, None)
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    want = max(flops / 989e12, nbytes / 3.35e12) * 1e3
    got, _ = smoke.attention_bound_ms(B, S, S, H, KV, hd, True, None,
                                      "bfloat16")
    assert got == pytest.approx(want, rel=1e-12)


def test_chip_smoke_dsv2_cut_and_kernel_paths():
    """Phase 5f serves DeepSeek-V2 at full width cut to DSV2_LAYERS = 4
    layers: 16,412,759,040 parameters (32.8 GB in bf16), 4 launches a
    prefill; the kernels line's bf16 paths gain it and its float32 paths
    its narrow variant, whose head dims are the pair."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    smoke = _chip_smoke()
    full = get_config(smoke.DSV2)
    cfg = full.scaled(n_layers=smoke.DSV2_LAYERS)
    assert smoke.DSV2_LAYERS == 4
    assert registry.total_param_count(cfg) == 16_412_759_040
    assert registry.total_param_count(full) == 238_851_281_920
    assert smoke.attention_calls(cfg) == 4
    assert smoke.prefill_shape(cfg) == (smoke.PREFILL_B, smoke.PREFILL_S)
    small = smoke.mla_small_config()
    assert smoke.attention_head_dims(small) == (192, 128)
    assert (small.n_layers, small.mla.kv_lora_rank) == (2, 64)
    run = {"flash_attention": 1, "flash_attention_f32": 0,
           "split_bf16x3": 0}
    bf16, f32 = smoke.attention_paths(
        run, run, {**{a: run for a in smoke.ZOO},
                   f"{smoke.ZOO_F32} float32": run},
        {"whisper_base prefill": run, smoke.SCOUT: run},
        {smoke.ZAMBA2: run, smoke.RWKV6: run},
        {smoke.DSV2: run, f"{smoke.DSV2} float32 narrow": run})
    assert smoke.DSV2 in bf16
    assert f"{smoke.DSV2} float32 narrow" in f32
    assert {smoke.attention_head_dims(get_config(a.split()[0]))
            for a in f32 if a.startswith(smoke.DSV2)} == {(192, 128)}


def test_chip_smoke_subquadratic_variants_are_the_cpu_tests():
    """Phase 5e's float32 card-vs-CPU models are
    tests/test_torch_subquadratic.py's variants at the models' head dims,
    and the hybrid's ring wraps within its decode steps."""
    import test_torch_subquadratic as T
    smoke = _chip_smoke()
    for arch, name in ((smoke.RWKV6, "rwkv.hd64"),
                       (smoke.ZAMBA2, "hybrid.hd112")):
        assert smoke.subq_small_config(arch) == T.CONFIGS[name][0][0]
    hybrid = smoke.subq_small_config(smoke.ZAMBA2)
    assert hybrid.sliding_window < smoke.SUBQ_SMALL_STEPS
    assert smoke.SUBQ_SMALL_S % hybrid.ssm.chunk == 0
    assert smoke.LONG_PROMPT <= 4096 and smoke.ZOO_PROMPT % 32 == 0


def test_chip_smoke_backward_and_train_step_launches():
    """A backward wrapper call launches its dtype's entry once, float32
    after four splits (q, k, v, do); a full-width TinyLlama train step
    (22 layers x 2 micro-batches) launches 88 forward, 44 backward and,
    in float32, 440 splits (three a forward, four a backward); phase 2c
    times the same kernels by name."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    smoke = _chip_smoke()
    zero = {k: 0 for k in FA.LAUNCHES}
    assert smoke.bwd_launches(FA, True, calls=2) == {
        **zero, "flash_attention_bwd_f32": 2, "split_bf16x3": 8}
    assert smoke.bwd_launches(FA, False) == {**zero,
                                             "flash_attention_bwd": 1}
    n = get_config(smoke.ARCH).n_layers * smoke.TRAIN_MICRO
    assert n == 44
    assert smoke.train_step_launches(FA, True, n) == {
        **zero, "flash_attention_f32": 88, "split_bf16x3": 440,
        "flash_attention_bwd_f32": 44}
    assert smoke.train_step_launches(FA, False, n) == {
        **zero, "flash_attention": 88, "flash_attention_bwd": 44}
    assert smoke.BWD_KERNELS["float32"] == {
        "split_bf16x3_kernel": 4, "fa_bwd_dq_wgmma": 1,
        "fa_bwd_dkdv_wgmma": 1}
    assert smoke.BWD_KERNELS["bfloat16"] == {"fa_bwd_dq_wgmma": 1,
                                             "fa_bwd_dkdv_wgmma": 1}


@pytest.mark.parametrize("traces, ok", [
    ([20], True), ([19, 20], True), ([19, 19, 20], True),
    ([19, 19, 19], False), ([16, 16, 16], False), ([24, 24, 24], False)])
def test_chip_smoke_bwd_kernel_ms_retakes_a_trace_that_lost_a_record(
        monkeypatch, traces, ok):
    """Phase 2c's per-kernel times: a profiler trace whose float32 split
    count is off (a lost record) is taken again, up to three traces; the
    first trace with every kernel's exact count gives the ms a call, and a
    count that is off in all three (a wrapper launching the wrong kernels)
    fails."""
    smoke = _chip_smoke()
    seen = []

    def device_ops(torch_, run, n_top=10):
        splits = traces[len(seen)]
        seen.append(splits)
        by_name = {"split_bf16x3_kernel": (splits, 2.0 * splits),
                   "fa_bwd_dq_wgmma<64>": (5, 50.0),
                   "fa_bwd_dkdv_wgmma<64>": (5, 100.0)}
        top = [[name, c, t] for name, (c, t) in by_name.items()]

        def us(part):
            return sum(t for name, (_, t) in by_name.items() if part in name)
        return us, sum(t for _, _, t in top), top
    monkeypatch.setattr(smoke, "device_ops", device_ops)
    if ok:
        got = smoke.bwd_kernel_ms(torch, lambda: None, "float32", n=5)
        assert got == {"split_bf16x3_kernel": 2.0 * 20 / 1e3 / 5,
                       "fa_bwd_dq_wgmma": 50.0 / 1e3 / 5,
                       "fa_bwd_dkdv_wgmma": 100.0 / 1e3 / 5}
    else:
        with pytest.raises(AssertionError, match="all 3 traces"):
            smoke.bwd_kernel_ms(torch, lambda: None, "float32", n=5)
    assert seen == traces


def test_chip_smoke_split_bound_and_route_launches():
    """The split's bound is its bytes (4 read, 6 written per element) at
    3.35 TB/s; a float32 wrapper call launches the float32 kernel once and
    the split three times, a bf16 one the bf16 kernel once, and neither
    the backward."""
    from repro_torch.kernels import flash_attention as FA
    smoke = _chip_smoke()
    n = smoke.PREFILL_B * smoke.PREFILL_S * 32 * 64
    got, by = smoke.split_bound_ms(n)
    assert by == "bytes" and got == pytest.approx(10 * n / 3.35e9)
    bwd = {"flash_attention_bwd": 0, "flash_attention_bwd_f32": 0}
    assert smoke.route_launches(FA, torch.float32) == {
        "flash_attention": 0, "flash_attention_f32": 1, "split_bf16x3": 3,
        **bwd}
    assert smoke.route_launches(FA, torch.bfloat16) == {
        "flash_attention": 1, "flash_attention_f32": 0, "split_bf16x3": 0,
        **bwd}
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
