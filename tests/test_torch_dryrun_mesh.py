"""The production-mesh dry-run (``launch.dryrun.lower_cell(multi_pod=)``,
``roofline``, ``hillclimb``'s layout variants) on a fake group of 256 /
512 ranks, against the JAX package's shardings and the one-card count.

Every fake-group side runs in a subprocess of its own (one process holds
one default process group; pytest's workers run other tests that make
real ones), and so does every JAX side that needs 512 placeholder host
devices.

  * local shapes: for every arch, on 16x16 and 2x16x16 under each of
    JAX's rule sets (default, no FSDP, pure DP with its batch over every
    axis), the local shard shape of every parameter and AdamW moment
    (``registry.shard_model`` / ``shard_opt_state``), of every input of
    each supported cell (``shard_batch``) and of every decode cache entry
    (``shard_cache``) equals JAX's ``NamedSharding(mesh,
    spec).shard_shape`` of its spec (src/repro/launch/dryrun.py);
  * flops: chips x the per-device flops equal the one-card count for the
    ``train_4k`` and ``prefill_32k`` cells whose sharded dims divide (the
    dense archs with heads, kv heads or their groups, d_ff and vocab all
    cut evenly), at depth 1; so do the attention flops alone: no
    attention call is replicated (JAX's pins exist to stop GSPMD from
    replicating it 16x, src/repro/models/flags.py:25);
  * collectives: a column -> row parallel product on a hand-built
    DTensor program counts one all-reduce of its output's local bytes;
    pure DP's ``train_4k`` of a dense config whose every parameter is cut
    256 ways reduce-scatters its gradients (FSDP's gradient reduction) over
    the two mesh axes in turn: 17 times its parameters' bytes, the tied
    embedding's twice (two reads, two gathers);
  * ``lower_cell`` of TinyLlama's ``train_4k`` (depth 2) on both meshes:
    chips 256 / 512, non-zero collective bytes under JAX's kinds only, the
    argument bytes those of the local shards;
  * ``hillclimb``'s layout variants counted on the mesh (``roofline
    --multi-pod``: tests/test_torch_roofline.py's CLI test); a shard the attention kernels do not take (local q heads
    no whole kv group serves) is rejected on ``meta`` as on the card;
    ``fake_device_mesh`` refuses a process holding a real group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(code, devices=None, timeout=900):
    """``code`` in a fresh Python (PYTHONPATH=src, JAX on the CPU with
    ``devices`` placeholder devices); its last stdout line, as JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


JAX_SHAPES = r"""
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, get_config
from repro.launch import hillclimb as HC, sharding as SH
from repro.launch.dryrun import _batch_shardings, _cache_shardings
from repro.launch.mesh import make_production_mesh
from repro.models import registry as R
from repro.models.config import SHAPES
from repro.models.transformer import param_axes
RULES = {"default": SH.DEFAULT_RULES, "no_fsdp": HC.NO_FSDP_RULES,
         "pure_dp": HC.PURE_DP_RULES}
out = {}
def leaves(prefix, specs, shards):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    sh = jax.tree_util.tree_leaves(
        shards, is_leaf=lambda x: isinstance(x, NamedSharding))
    for (path, s), n in zip(flat, sh):
        key = "".join("/" + str(getattr(p, "key", p)) for p in path)
        try:
            out[prefix + key] = list(n.shard_shape(tuple(s.shape)))
        except ValueError:          # a spec that does not divide the dim
            out[prefix + key] = "indivisible"
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    name = "2x16x16" if mp else "16x16"
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = R.abstract_params(cfg)
        for rn, rules in RULES.items():
            dp = (("pod", "data", "model") if rn == "pure_dp" else
                  (("pod", "data") if mp else ("data",)))
            dp = tuple(a for a in dp if a in mesh.axis_names)
            p_shard = SH.tree_shardings(param_axes(cfg), params, mesh,
                                        rules)
            leaves(f"{name}|{rn}|{arch}|params", params, p_shard)
            for shape_name, shape in SHAPES.items():
                if not R.cell_supported(cfg, shape)[0]:
                    continue
                specs = R.input_specs(cfg, shape_name)
                tag = f"{name}|{rn}|{arch}|{shape_name}"
                if shape.kind == "decode":
                    cache = specs["cache"]
                    leaves(tag + "|cache", cache,
                           _cache_shardings(mesh, cfg, cache))
                    for k in ("tokens", "pos"):
                        leaves(f"{tag}|{k}", specs[k], SH.batch_sharding(
                            mesh, specs[k], axes=dp))
                else:
                    leaves(tag + "|batch", specs,
                           _batch_shardings(mesh, specs, cfg, dp))
print(json.dumps(out))
"""

PORT_SHAPES = r"""
import json, torch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as D, mesh as MS, sharding as SH
from repro_torch.models import registry as R, transformer as M
from repro_torch.models.config import SHAPES
RULES = {"default": SH.DEFAULT_RULES, "no_fsdp": SH.NO_FSDP_RULES,
         "pure_dp": SH.PURE_DP_RULES}
out = {}
def leaves(prefix, tree, p=""):
    if isinstance(tree, dict):
        for k in tree:
            leaves(prefix, tree[k], f"{p}/{k}")
        return
    out[prefix + p] = list(tree.to_local().shape)
for mp in (False, True):
    ms = MS.make_production_mesh(multi_pod=mp)
    dm = MS.fake_device_mesh(ms)
    name = "2x16x16" if mp else "16x16"
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params, opt = R.abstract_train_state(cfg)
        for rn, rules in RULES.items():
            dp = (("pod", "data", "model") if rn == "pure_dp" else None)
            model = R.shard_model(D.meta_model(cfg, params), cfg, dm, rules)
            leaves(f"{name}|{rn}|{arch}|params", M.stacked_params(model))
            sopt = R.shard_opt_state(opt, cfg, dm, rules)
            leaves(f"{name}|{rn}|{arch}|m", sopt.m)
            leaves(f"{name}|{rn}|{arch}|v", sopt.v)
            for shape_name, shape in SHAPES.items():
                if not R.cell_supported(cfg, shape)[0]:
                    continue
                specs = R.input_specs(cfg, shape_name)
                tag = f"{name}|{rn}|{arch}|{shape_name}"
                if shape.kind == "decode":
                    leaves(tag + "|cache", R.shard_cache(specs.pop("cache"),
                                                         cfg, dm))
                    prefix = tag + "|"
                else:
                    prefix = tag + "|batch/"
                for k, v in specs.items():
                    try:
                        got = R.shard_batch({k: v}, dm, dp)[k]
                        out[prefix + k] = list(got.to_local().shape)
                    except ValueError:      # the spec does not divide
                        out[prefix + k] = "indivisible"
print(json.dumps(out))
"""


def test_local_shapes_equal_jax_shard_shapes_for_every_arch():
    want = _run(JAX_SHAPES, devices=512)
    got = _run(PORT_SHAPES)
    # The moments take the parameters' specs, as JAX's opt_shard does.
    for k in [k for k in want if "|params/" in k]:
        for moment in ("m", "v"):
            want[k.replace("|params/", f"|{moment}/")] = want[k]
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:10]
    assert len(want) > 3000
    # JAX's own batch spec of pure DP's mrope_positions (3, 256, S) over
    # 512 ranks: neither package shards it.
    assert {k for k, v in want.items() if v == "indivisible"} == {
        k for k in want if k.startswith("2x16x16|pure_dp|qwen2_vl_2b")
        and k.endswith("mrope_positions")}


FLOPS = r"""
import json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
out = {}
for arch in ("tinyllama_1_1b", "deepseek_7b", "mistral_nemo_12b",
             "stablelm_3b"):
    cfg = get_config(arch).scaled(n_layers=1)
    for shape in ("train_4k", "prefill_32k"):
        meshes = (None, False, True) if arch == "tinyllama_1_1b" else (
            None, False)
        for mp in meshes:
            r = D.lower_cell(arch, shape, multi_pod=mp, cfg_override=cfg)
            out[f"{arch}|{shape}|{r['mesh']}"] = {
                k: r[k] for k in ("hlo_flops", "flops_by_peak", "chips",
                                  "attention_calls")}
print(json.dumps(out))
"""


def test_mesh_flops_equal_the_one_card_count():
    got = _run(FLOPS)
    n = 0
    for key, r in got.items():
        arch, shape, mesh = key.split("|")
        if mesh == "1":
            continue
        one = got[f"{arch}|{shape}|1"]
        assert r["chips"] in (256, 512)
        assert r["hlo_flops"] == pytest.approx(one["hlo_flops"], rel=1e-12)
        for k, f in one["flops_by_peak"].items():
            # attention: every call at its local shape, none replicated
            assert r["flops_by_peak"][k] == pytest.approx(f, rel=1e-12), key
        assert r["attention_calls"] == one["attention_calls"]
        n += 1
    assert n == 10


COLLECTIVES = r"""
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D, mesh as MS, sharding as SH
dm = MS.fake_device_mesh(MS.make_production_mesh())
B, Dm, F = 64, 1024, 4096
x = DTensor.from_local(torch.empty(B // 16, Dm, device="meta"), dm,
                       [Shard(0), Replicate()], run_check=False)
w1 = DTensor.from_local(torch.empty(Dm, F // 16, device="meta"), dm,
                        [Replicate(), Shard(1)], run_check=False)
w2 = DTensor.from_local(torch.empty(F // 16, Dm, device="meta"), dm,
                        [Replicate(), Shard(0)], run_check=False)
def mlp(x, w1, w2):
    y = (x @ w1) @ w2
    return y.redistribute(dm, [Shard(0), Replicate()])
row = D.count_step(mlp, x, w1, w2)["collectives"]
cfg = get_config("tinyllama_1_1b").scaled(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512)
dp = D.lower_cell("tinyllama_1_1b", "train_4k", multi_pod=False,
                  cfg_override=cfg, dtype=torch.float32,
                  rules=SH.PURE_DP_RULES,
                  batch_axes_override=("pod", "data", "model"),
                  head_axes_override=None)
from repro_torch.models import registry as R
from repro_torch.train.optimizer import tree_leaves
n = sum(p.numel() for p in tree_leaves(R.abstract_params(cfg)))
assert cfg.tie_embeddings
print(json.dumps({"row": row, "pure_dp": dp["collectives"],
                  "param_bytes": 4 * n,
                  "embedding_bytes": 4 * cfg.vocab * cfg.d_model}))
"""


def test_collective_bytes_match_closed_forms():
    got = _run(COLLECTIVES)
    # one all-reduce of the output's local shard: (64 / 16) x 1024 floats
    assert got["row"] == {"all-reduce": 4 * 1024 * 4}
    # FSDP's gradient reduction: DTensor reduce-scatters every parameter's
    # gradient over the two mesh axes in turn, "data" then "model", its
    # results a 16th and then a 256th of the gradient; times 256 ranks,
    # (16 + 1) times the parameters' bytes.  The tied embedding is read
    # twice (the lookup, the logits), each read a gather and so a
    # reduction of its own.
    assert got["pure_dp"]["reduce-scatter"] == 17 * (
        got["param_bytes"] + got["embedding_bytes"])
    assert "all-gather" in got["pure_dp"]


def test_lower_cell_on_both_meshes():
    code = r"""
import json, math
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D, mesh as MS, sharding as SH
from repro_torch.models import registry as R
from repro_torch.models.config import SHAPES
from repro_torch.models.transformer import param_axes
from repro_torch.train.optimizer import tree_leaves
cfg = get_config("tinyllama_1_1b").scaled(n_layers=2)
out = {}
for mp in (False, True):
    r = D.lower_cell("tinyllama_1_1b", "train_4k", multi_pod=mp,
                     cfg_override=cfg)
    ms = MS.make_production_mesh(multi_pod=mp)
    params = R.abstract_params(cfg)
    specs = SH.tree_shardings(param_axes(cfg), params, ms)
    flat = []
    def walk(s, p):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(s[k], p[k])
        else:
            flat.append(math.prod(SH.shard_shape(s, tuple(p.shape), ms)))
    walk(specs, params)
    shape = SHAPES["train_4k"]
    dp = ms.size // ms.shape["model"]
    local_batch = 2 * 4 * shape.global_batch // dp * shape.seq_len
    r["want_argument"] = sum(flat) * (2 + 4 + 4) + 4 + local_batch
    out[r["mesh"]] = r
print(json.dumps(out))
"""
    got = _run(code)
    kinds = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"}
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        r = got[mesh]
        assert r["chips"] == chips and not r["skipped"]
        assert r["collective_bytes"] > 0 and set(r["collectives"]) <= kinds
        assert r["collective_bytes"] == sum(r["collectives"].values())
        assert r["collective_s"] > 0
        assert r["per_device_bytes"]["argument"] == r["want_argument"]
        pd = r["per_device_bytes"]
        assert pd["peak"] == pd["argument"] + pd["temp"]


def test_hillclimb_counts_layout_variants_on_the_mesh():
    code = r"""
import json
from repro_torch.launch import hillclimb as HC
rows = [HC.run_variant("tinyllama_1_1b", "decode_32k", v)
        for v in ("baseline", "no_fsdp", "pure_dp")]
print(json.dumps([{k: r[k] for k in ("variant", "mesh", "chips",
                                      "collective_bytes")} for r in rows]))
"""
    rows = {r["variant"]: r for r in _run(code)}
    assert rows["baseline"]["mesh"] == "1"
    assert rows["baseline"]["collective_bytes"] == 0
    for v in ("no_fsdp", "pure_dp"):
        assert rows[v]["mesh"] == "16x16" and rows[v]["chips"] == 256
        assert rows[v]["collective_bytes"] > 0


def test_meta_route_rejects_shards_the_kernels_do_not_take():
    """48 q heads over 16 ranks are 3 a rank; 24 kv heads (groups of 2) do
    not divide the model axis, so each rank would need 1.5 kv heads: the
    card's wrapper raises, and so does the count on ``meta``."""
    code = r"""
import json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
cfg = get_config("tinyllama_1_1b").scaled(n_layers=1, d_model=3072,
                                          n_heads=48, n_kv_heads=24)
try:
    D.lower_cell("tinyllama_1_1b", "prefill_32k", multi_pod=False,
                 cfg_override=cfg)
    print(json.dumps("counted"))
except ValueError as e:
    print(json.dumps(str(e)))
"""
    assert "H % KV == 0 on every shard" in _run(code)


def test_fake_mesh_refuses_a_process_with_a_real_group():
    code = r"""
import json, os, tempfile
import torch.distributed as dist
from repro_torch.launch import mesh as MS
dist.init_process_group("gloo", init_method="file://" + tempfile.mktemp(),
                        rank=0, world_size=1)
try:
    MS.fake_device_mesh(MS.make_production_mesh())
    print(json.dumps("no error"))
except RuntimeError as e:
    print(json.dumps(str(e)))
"""
    assert "process of its own" in _run(code)
