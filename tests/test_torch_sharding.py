"""The port's mesh / sharding / elastic metadata (``repro_torch.launch.
{mesh,sharding,elastic}``, ``transformer.param_axes``,
``llm_decode.cache_axes``) vs the JAX package's.

JAX's sharding functions read only a mesh's ``.shape`` and
``.axis_names``, so both packages get the port's ``MeshShape`` stand-in
for the production (16, 16) and (2, 16, 16) meshes and no device is
needed; a JAX ``PartitionSpec`` is the tuple the port returns.  JAX's
``validate_divisibility`` builds a real mesh, so at 256 devices it runs in
a subprocess with 256 placeholder host devices.  ``apply_rescale`` runs on
K = 1 and K = 2 gloo ranks (``sharded.spawn_fleet``) and must give the
values bit for bit, each rank holding its slice.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _torch_pod_ranks import rescale_outputs
from repro.configs import get_config as jget_config
from repro.launch import elastic as JEL
from repro.launch import hillclimb as JHC
from repro.launch import sharding as JSH
from repro.models import registry as JR
from repro.models import transformer as JM
from repro.serve import llm_decode as JD
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import sharded
from repro_torch.launch import elastic, mesh as MS, sharding as SH
from repro_torch.models import registry as R
from repro_torch.models import transformer as M
from repro_torch.serve import llm_decode as D

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": MS.make_production_mesh(),
          "2x16x16": MS.make_production_mesh(multi_pod=True)}
RULES = {"default": (SH.DEFAULT_RULES, JSH.DEFAULT_RULES),
         "no_fsdp": (SH.NO_FSDP_RULES, JHC.NO_FSDP_RULES),
         "pure_dp": (SH.PURE_DP_RULES, JHC.PURE_DP_RULES)}


def _leaves(axes, shapes, prefix=""):
    if isinstance(axes, tuple):
        yield prefix, axes, tuple(shapes.shape)
        return
    for k in axes:
        yield from _leaves(axes[k], shapes[k], f"{prefix}/{k}")


def test_mesh_shapes():
    m = MESHES["2x16x16"]
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert MS.batch_axes(m) == ("pod", "data")
    assert MS.batch_axes(MESHES["16x16"]) == ("data",)
    e = MS.make_mesh_for_devices(24, 16)
    assert e.shape == {"data": 1, "model": 16}
    assert MS.make_mesh_for_devices(4).shape == {"data": 1, "model": 4}


def test_rule_tables_equal_jax():
    for port, jax_rules in RULES.values():
        assert port == jax_rules


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_jax(arch):
    assert M.param_axes(get_config(arch)) == JM.param_axes(
        jget_config(arch))


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_to_pspec_equal_jax_for_every_leaf(arch, mesh, rules):
    cfg = get_config(arch)
    port_rules, jax_rules = RULES[rules]
    m = MESHES[mesh]
    leaves = list(_leaves(M.param_axes(cfg), R.abstract_params(cfg)))
    assert leaves
    for path, axes, shape in leaves:
        got = SH.logical_to_pspec(axes, shape, m, port_rules)
        want = JSH.logical_to_pspec(axes, shape, m, jax_rules)
        assert got == tuple(want), (path, axes, shape)
    # tree_shardings maps the same tree to the same specs.
    specs = SH.tree_shardings(M.param_axes(cfg), R.abstract_params(cfg), m,
                              port_rules)
    for path, axes, shape in leaves:
        node = specs
        for k in path.strip("/").split("/"):
            node = node[k]
        assert node == SH.logical_to_pspec(axes, shape, m, port_rules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_explain_sharding_rows_equal_jax(arch):
    cfg = get_config(arch)
    m = MESHES["16x16"]
    got = SH.explain_sharding(M.param_axes(cfg), R.abstract_params(cfg), m)
    want = JSH.explain_sharding(JM.param_axes(jget_config(arch)),
                                JR.abstract_params(jget_config(arch)), m)
    assert [(p, a, s, tuple(spec)) for p, a, s, spec in want] == got


@pytest.mark.parametrize("model_size", [16, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_equal_jax(arch, model_size):
    cfg = get_config(arch)
    got = D.cache_axes(cfg, model_size)
    assert got == JD.cache_axes(jget_config(arch), model_size)
    cache = R.decode_input_specs(cfg, R.SHAPES["decode_32k"])["cache"]
    assert set(got) == set(cache)
    assert all(len(got[k]) == cache[k].dim() for k in got)


@pytest.fixture
def named_sharding_stand_in(monkeypatch):
    """JAX's ``batch_sharding`` wraps its spec in a ``NamedSharding``,
    which needs a real mesh: a stand-in that keeps the spec."""
    class Named:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec
    monkeypatch.setattr(JSH, "NamedSharding", Named)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_jax(mesh, named_sharding_stand_in):
    m = MESHES[mesh]
    for shape, dim, axes in (((256, 4096), 0, None),
                             ((3, 256, 4096), 1, None),
                             ((1, 4096), 0, None),
                             ((256, 1), 0, ("data",)),
                             ((512, 8), 0, ("pod", "data", "model")),
                             ((), 0, None)):
        s = torch.empty(shape, device="meta")
        want = JSH.batch_sharding(m, s, dim, axes=axes).spec
        assert SH.batch_sharding(m, s, dim, axes=axes) == tuple(want)
        if shape:
            assert SH.batch_pspec(m, len(shape), dim, axes) == tuple(
                JSH.batch_pspec(m, len(shape), dim, axes))


def test_placements():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert SH.placements((None, "model"), names) == [
        Replicate(), Replicate(), Shard(1)]
    assert SH.placements((("pod", "data"), None, "model"), names) == [
        Shard(0), Shard(0), Shard(2)]
    assert SH.placements((), names) == [Replicate()] * 3


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_validate_divisibility_equal_jax_on_one_device(arch):
    cfg = get_config(arch)
    got = elastic.validate_divisibility(cfg, n_devices=1, model_parallel=1)
    assert got == JEL.validate_divisibility(jget_config(arch), n_devices=1,
                                            model_parallel=1)
    assert all(got.values())


def test_validate_divisibility_equal_jax_at_256_devices():
    code = (
        "import json\n"
        "from repro.configs import ARCH_IDS, get_config\n"
        "from repro.launch.elastic import validate_divisibility\n"
        "print(json.dumps({a: [validate_divisibility(get_config(a), n, mp)"
        " for n, mp in ((256, 16), (192, 16), (256, 8))]"
        " for a in ARCH_IDS}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {a: [elastic.validate_divisibility(get_config(a), n, mp)
               for n, mp in ((256, 16), (192, 16), (256, 8))]
           for a in ARCH_IDS}
    assert got == want
    assert not all(all(c.values()) for runs in got.values() for c in runs)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "deepseek_v2_236b",
                                  "whisper_base"])
def test_plan_rescale_is_metadata_and_equals_jax(arch):
    cfg = get_config(arch)
    shapes = R.abstract_params(cfg)
    mesh, specs = elastic.plan_rescale(cfg, shapes, n_devices=1,
                                       model_parallel=1)
    assert isinstance(mesh, MS.MeshShape) and mesh.size == 1

    def no_tensors(t):
        if isinstance(t, dict):
            return all(no_tensors(v) for v in t.values())
        return isinstance(t, tuple) and not any(
            isinstance(x, torch.Tensor) for x in t)
    assert no_tensors(specs)
    jmesh, jspecs = JEL.plan_rescale(jget_config(arch),
                                     JR.abstract_params(jget_config(arch)),
                                     n_devices=1, model_parallel=1)
    assert dict(jmesh.shape) == mesh.shape

    def same(a, b):
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        return a == tuple(b.spec)
    assert same(specs, jspecs)


def test_device_mesh_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MS.device_mesh(MS.make_mesh_for_devices(1, 1))


@pytest.mark.parametrize("k", [1, 2])
def test_apply_rescale_over_gloo_ranks_is_bit_exact(k):
    got = sharded.spawn_fleet(rescale_outputs, k, "tinyllama_1_1b", 0,
                              device="cpu", timeout=240)
    assert got
    n_sharded = 0
    for path, (full_eq, local_eq, placements, want, shard) in got.items():
        assert full_eq and local_eq, path
        assert placements == want, path
        n_sharded += shard
    assert n_sharded > 0
