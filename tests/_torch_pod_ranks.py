"""Rank functions of tests/test_torch_sharding.py and
tests/test_torch_grad_compress.py (not a test module).

``repro_torch.core.sharded.spawn_fleet`` runs a function here on every
rank of a fresh process group and checks that the ranks' results are
equal.  This module imports nothing of the JAX package, so a rank starts
without it.
"""
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.launch import elastic, mesh as MS, sharding as SH
from repro_torch.models import transformer as M
from repro_torch.train import grad_compress as GC


def rescale_outputs(arch, seed, device):
    """A smoke config's parameters (drawn from ``seed`` on the CPU) planned
    for the group's world size and committed with ``apply_rescale`` to a
    live mesh of that shape: ``{path: (equal bit for bit after
    full_tensor, the local shard equals its slice, placements, the
    placements the spec gives, any Shard)}``."""
    k = dist.get_world_size()
    cfg = get_smoke_config(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(seed),
                          torch.float32, device="cpu")
    tree = M.stacked_params(model)
    shape, specs = elastic.plan_rescale(cfg, tree, n_devices=k)
    dm = MS.device_mesh(shape, device)
    moved = elastic.apply_rescale(tree, specs, dm)
    out = {}

    def walk(a, b, spec, prefix=""):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], spec[key], f"{prefix}/{key}")
            return
        full = b.full_tensor()
        local = b.to_local()
        want_local = a
        for d, part in enumerate(spec):
            if part is None:
                continue
            assert isinstance(part, str), part   # one mesh axis at K <= 2
            n = shape.shape[part]
            coord = dm.get_coordinate()[dm.mesh_dim_names.index(part)]
            step = a.shape[d] // n
            want_local = want_local.narrow(d, coord * step, step)
        out[prefix] = (torch.equal(full, a), torch.equal(local, want_local),
                       [str(p) for p in b.placements],
                       [str(p) for p in SH.placements(
                           spec, dm.mesh_dim_names)],
                       any(p.is_shard() for p in b.placements))
    walk(tree, moved, specs)
    return out


def cross_pod_outputs(per_rank, device):
    """``cross_pod_int8`` over the group of this rank's tree (float32
    numpy arrays ``per_rank[rank]``) -> the result as numpy arrays."""
    tree = {k: torch.from_numpy(v).to(device)
            for k, v in per_rank[dist.get_rank()].items()}
    got = GC.cross_pod_int8(tree, group=dist.group.WORLD)
    return {k: v.cpu().numpy() for k, v in got.items()}
