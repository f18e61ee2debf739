"""The sharded step: the port's train, prefill and decode steps on a
``DeviceMesh`` of DTensors (``registry.make_step(mesh=)``) against the
unsharded port step and JAX's jitted step under the same shardings.

  * ``models.flags``: ``constrain`` leaves a plain tensor, and any tensor
    while no axis is set, unchanged; ``pinned_spec`` drops a mesh axis the
    mesh lacks, one an earlier dim took, and one that does not divide;
  * on 2 x 2 gloo ranks (``sharded.spawn_fleet``, rank functions in
    ``tests/_torch_sharded_step_ranks.py``) a two-layer float32 dense
    config (its kv heads sharded, and with one kv head: the GQA path where
    each rank takes its q heads' kv head) and the MoE config go through a
    train step of 2 micro-batches, a prefill and three decode steps; every
    output (loss, grad norm, parameters, AdamW's moments, logits) equals
    the unsharded port step within SHARD_TOL of its max |want|: the same
    arithmetic but for the all-reduces' summation order;
  * the dense config's sharded outputs also equal JAX's jitted train,
    prefill and decode steps with ``in_shardings`` from JAX's own rules on
    a 2 x 2 mesh of 4 host devices (a subprocess with
    ``--xla_force_host_platform_device_count=4``), within JAX_TOL (the
    loss within LOSS_RTOL; the parameters where |m| exceeds PARAM_KEEP of
    its max, within PARAM_ATOL * lr: tests/test_torch_train.py's rule);
  * the local shard of every parameter on a 2 x 2 gloo mesh is
    ``sharding.shard_shape`` of its spec, and ``convert.params_from_numpy
    (mesh=)`` commits the same shards;
  * on the card (``gpu`` marker; skipped here) the sharded prefill on a
    one-rank NCCL mesh equals the plain prefill bit for bit.

Tolerances: SHARD_TOL 1e-4 of max |want| (measured at most 3.2e-5, a
moment of the one-kv-head config); JAX_TOL 1e-4 (GRAD_TOL of
tests/test_torch_train.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_step_ranks as RK
from repro_torch.core import sharded
from repro_torch.launch import mesh as MS
from repro_torch.models import flags

ROOT = Path(__file__).resolve().parents[1]
SHARD_TOL = 1e-4
JAX_TOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_KEEP, PARAM_ATOL, LR = 1e-2, 0.05, 3e-4
CASES = {"dense": ("tinyllama_1_1b", {}),
         "dense one kv head": ("tinyllama_1_1b", {"n_kv_heads": 1}),
         "moe": ("llama4_scout_17b_a16e", {})}


class _Mesh:
    """A DeviceMesh stand-in: axis names and sizes."""

    def __init__(self, sizes, names):
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


def test_constrain_is_an_identity_off_the_mesh():
    x = torch.ones(4, 8)
    assert flags.constrain(x, "batch", None) is x
    with flags.activation_axes(batch=("data",), heads="model"):
        assert flags.constrain(x, "batch", None) is x
    assert flags.BATCH_AXES is None and flags.HEAD_AXES is None


def test_pinned_spec():
    mesh = _Mesh((2, 4), ("data", "model"))
    with flags.activation_axes(batch=("pod", "data"), heads="model",
                               kv_seq="model"):
        assert flags.pinned_spec((4, 8, 8, 2), ("batch", None, "heads",
                                                None), mesh) == (
            "data", None, "model", None)
        # 6 heads: 4 does not divide them; the batch's 3 not by 2.
        assert flags.pinned_spec((3, 8, 6), ("batch", None, "heads"),
                                 mesh) == (None, None, None)
        # "model" taken by the heads: the sequence stays whole.
        assert flags.pinned_spec((2, 8, 4), ("batch", "heads", "kv_seq"),
                                 mesh) == ("data", "model", None)


@pytest.fixture(scope="module")
def runs():
    """{case: (unsharded, 2 x 2 gloo)} outputs, each run once."""
    out = {}
    for case, (arch, ov) in CASES.items():
        want = RK.plain_steps(arch, ov, 0)
        got = sharded.spawn_fleet(RK.mesh_steps, 4, arch, ov, 0, (2, 2),
                                  device="cpu", timeout=300)
        out[case] = (want, got)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_the_unsharded_step(runs, case):
    want, got = runs[case]
    assert set(got) == set(want)
    assert any(k.startswith("decode logits") for k in want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) <= SHARD_TOL, (k, _rel(got[k], want[k]))


JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.configs import get_smoke_config
from repro.launch import sharding as SH
from repro.models import flags, registry as R, transformer as M
from repro.models.config import ShapeConfig
from repro.serve import llm_decode as D
from repro.train.optimizer import adamw_init

args = json.loads(sys.argv[1])
cfg = get_smoke_config(args["arch"]).scaled(**args["overrides"])
data = dict(np.load(args["inputs"]))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
mesh.__enter__()             # JAX's lower_cell runs its steps in the mesh
def tree(prefix):
    out = {}
    for k, v in data.items():
        if not k.startswith(prefix + " /"):
            continue
        node, path = out, k[len(prefix) + 2:].split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    return out
params = tree("param")
axes = M.param_axes(cfg)
p_shard = SH.tree_shardings(axes, params, mesh)
flags.BATCH_AXES, flags.HEAD_AXES = ("data",), "model"
heads_ok = cfg.n_kv_heads % 2 == 0
flags.KV_HEAD_AXES = "model" if heads_ok else None
flags.KV_SEQ_AXES = None if heads_ok else "model"
def batch_shard(x):
    return SH.batch_sharding(mesh, x, axes=("data",))
out = {}
opt = adamw_init(params)
o_shard = type(opt)(step=NamedSharding(mesh, PS()), m=p_shard, v=p_shard)
batch = {"tokens": data["train tokens"], "labels": data["train labels"]}
tr = args["train"]
step = jax.jit(R.make_step(cfg, ShapeConfig("t", tr[0], tr[1], "train"),
                           n_micro=args["n_micro"]),
               in_shardings=(p_shard, o_shard,
                             {k: batch_shard(v) for k, v in batch.items()}))
new_p, new_o, met = step(params, opt, batch)
out["train loss"] = np.asarray(met["loss"], np.float32)
for prefix, t in (("param", new_p), ("m", new_o.m), ("v", new_o.v)):
    for path, leaf in jax.tree_util.tree_leaves_with_path(t):
        key = "/" + "/".join(p.key for p in path)
        out[f"{prefix} {key}"] = np.asarray(leaf, np.float32)
pf = args["prefill"]
tokens = data["prefill tokens"]
prefill = jax.jit(R.make_step(cfg, ShapeConfig("p", pf[0], pf[1],
                                                "prefill")),
                  in_shardings=(p_shard, {"tokens": batch_shard(tokens)}))
out["prefill logits"] = np.asarray(prefill(params, {"tokens": tokens}),
                                   np.float32)
dc = args["decode"]
B, S = dc[1], dc[0]
cache = jax.tree.map(lambda c: c.astype(jnp.float32),
                     D.init_cache(cfg, B, S))
c_axes = D.cache_axes(cfg, model_size=2)
c_shard = {k: NamedSharding(mesh, SH.logical_to_pspec(
    c_axes[k], tuple(cache[k].shape), mesh)) for k in cache}
dec = jax.jit(R.make_step(cfg, ShapeConfig("d", S, B, "decode")),
              in_shardings=(p_shard, {"cache": c_shard,
                                      "tokens": batch_shard(
                                          np.zeros((B, 1), np.int32)),
                                      "pos": batch_shard(
                                          np.zeros((B,), np.int32))}))
nxt = data["decode tokens"]
for t in range(nxt.shape[1]):
    logits, cache = dec(params, {"cache": cache,
                                 "tokens": nxt[:, t:t + 1],
                                 "pos": np.full((B,), t, np.int32)})
    out[f"decode logits {t}"] = np.asarray(logits, np.float32)
np.savez(args["out"], **out)
"""


def test_sharded_step_equals_jax_sharded_step(runs, tmp_path):
    arch, ov = CASES["dense"]
    cfg = RK.config(arch, ov)
    inputs = dict(RK.cell_inputs(cfg, 0))
    inputs.update({f"param {p}": a for p, a in RK.init_tree(cfg, 0).items()})
    np.savez(tmp_path / "in.npz", **inputs)
    args = {"arch": arch, "overrides": ov, "inputs": str(tmp_path / "in.npz"),
            "out": str(tmp_path / "out.npz"), "n_micro": RK.N_MICRO,
            **{k: [s.seq_len, s.global_batch] for k, s in (
                ("train", RK.TRAIN), ("prefill", RK.PREFILL),
                ("decode", RK.DECODE))}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                           json.dumps(args)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    got = runs["dense"][1]
    np.testing.assert_allclose(got["train loss"], want["train loss"],
                               rtol=LOSS_RTOL)
    for k, w in want.items():
        if k.startswith(("m ", "v ")) or "logits" in k:
            assert _rel(got[k], w) <= JAX_TOL, (k, _rel(got[k], w))
        elif k.startswith("param "):
            m = want["m " + k[len("param "):]]
            keep = np.abs(m) > PARAM_KEEP * np.abs(m).max()
            np.testing.assert_allclose(got[k][keep], w[keep], rtol=0,
                                       atol=PARAM_ATOL * LR, err_msg=k)


def test_local_shards_are_the_specs_shard_shapes():
    arch, ov = CASES["dense"]
    got = sharded.spawn_fleet(RK.local_shapes, 4, arch, ov, (2, 2),
                              device="cpu", timeout=300)
    assert got and all(local == want and same
                       for local, want, same in got.values())
    # The embedding (vocab on model, embed on data) is cut both ways.
    assert got["/embedding"][0] == (128, 32)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("batch_axes,head_axes",
                         [(None, "model"), (("pod", "data", "model"), None)])
def test_cell_axes_are_jax_lower_cells(multi_pod, batch_axes, head_axes):
    """``registry.cell_axes`` sets what JAX's ``lower_cell`` sets
    (src/repro/launch/dryrun.py:182-199), for every cell."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import registry as R
    from repro_torch.models.config import SHAPES
    mesh = MS.make_production_mesh(multi_pod=multi_pod)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            dp_axes = (tuple(a for a in batch_axes if a in mesh.axis_names)
                       if batch_axes is not None else
                       (("pod", "data") if multi_pod else ("data",)))
            dp = int(np.prod([mesh.shape[a] for a in dp_axes]))
            heads_ok = (head_axes is not None
                        and cfg.n_kv_heads % mesh.shape["model"] == 0)
            want = {"batch": dp_axes if shape.global_batch % dp == 0
                    else None, "heads": head_axes,
                    "kv_heads": "model" if heads_ok else None,
                    "kv_seq": ("model" if (cfg.family == "mla_moe"
                                           or not heads_ok) else None)}
            assert R.cell_axes(cfg, shape, mesh, batch_axes=batch_axes,
                               head_axes=head_axes) == want, (arch, shape)


@pytest.mark.gpu
def test_sharded_prefill_on_a_one_rank_nccl_mesh_is_bit_exact():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models import registry as R
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    cfg = RK.config("tinyllama_1_1b", {}).scaled(d_model=256, n_heads=4,
                                                  n_kv_heads=2)
    shape = ShapeConfig("p", 256, 2, "prefill")
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(0))

    def draw():
        return M.init_params(cfg, torch.Generator("cuda").manual_seed(1),
                             torch.bfloat16)
    want = R.make_step(cfg, shape)(draw(), {"tokens": tokens})
    dm = MS.device_mesh(MS.MeshShape((1, 1), ("data", "model")))
    try:
        got = R.make_step(cfg, shape, mesh=dm)(
            R.shard_model(draw(), cfg, dm), {"tokens": tokens})
        assert torch.equal(got.to_local(), want)
    finally:
        torch.distributed.destroy_process_group()
