"""Rank functions of tests/test_torch_sharded_step.py (not a test module).

``repro_torch.core.sharded.spawn_fleet`` runs a function here on every
rank of a fresh gloo group and checks that the ranks' results are equal.
This module imports nothing of the JAX package, so a rank starts without
it.  Each function runs the same cell unsharded (``plain_steps``, in one
process) or on a (data, model) ``DeviceMesh`` of the group's ranks
(``mesh_steps``), from a model drawn on the CPU from ``seed``, and returns
numpy arrays: a DTensor's whole value (``full_tensor``), so every rank
returns the same.
"""
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy
from repro_torch.models import transformer as M
from repro_torch.models.config import ShapeConfig
from repro_torch.serve import llm_decode as D
from repro_torch.train.optimizer import adamw_init

# The cell every function runs: a train step of TRAIN over N_MICRO
# micro-batches, a prefill of PREFILL, DECODE_STEPS decode steps of
# DECODE's batch against a cache of its length.
TRAIN = ShapeConfig("train cut", 32, 4, "train")
N_MICRO = 2
PREFILL = ShapeConfig("prefill cut", 32, 4, "prefill")
DECODE = ShapeConfig("decode cut", 16, 4, "decode")
DECODE_STEPS = 3


def config(arch, overrides):
    return get_smoke_config(arch).scaled(**overrides)


def _whole(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def cell_inputs(cfg, seed):
    """The cell's inputs as numpy arrays: the train batch (``train
    tokens`` / ``train labels``, ``batch_for_step`` of ``DataConfig(seed)``),
    the prefill tokens and the decode tokens (from a CPU generator seeded
    ``seed + 1``)."""
    batch = batch_for_step(cfg, TRAIN, 0, DataConfig(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL.global_batch,
                                          PREFILL.seq_len), generator=gen)
    nxt = torch.randint(0, cfg.vocab, (DECODE.global_batch, DECODE_STEPS),
                        generator=gen)
    out = {f"train {k}": v.numpy() for k, v in batch.items()}
    out["prefill tokens"] = tokens.to(torch.int32).numpy()
    out["decode tokens"] = nxt.to(torch.int32).numpy()
    return out


def init_tree(cfg, seed):
    """The stacked parameter tree drawn on the CPU from ``seed``, as
    {path: numpy array} (float32)."""
    model = M.init_params(cfg, torch.Generator().manual_seed(seed),
                          torch.float32, device="cpu")
    return {p: t.numpy() for p, t in _flat(M.stacked_params(model))}


def _cell(cfg, seed, device, mesh=None, rules=None):
    """The train / prefill / decode outputs of ``cfg`` on ``device``,
    on ``mesh`` (a DeviceMesh) where given."""
    def draw():
        # Two draws: a committed DTensor may share its tensor's storage,
        # and the train step updates its model in place.
        model = M.init_params(cfg, torch.Generator().manual_seed(seed),
                              torch.float32, device=device)
        return model if mesh is None else R.shard_model(model, cfg, mesh,
                                                        rules)
    served, model = draw(), M.make_trainable(draw())
    opt = adamw_init(M.stacked_params(model))      # zeros of its shapes
    if mesh is not None:
        opt = R.shard_opt_state(opt, cfg, mesh, rules)
    out = {}
    inp = {k: torch.from_numpy(v) for k, v in cell_inputs(cfg, seed).items()}
    step = R.make_step(cfg, TRAIN, n_micro=N_MICRO, device=device,
                       mesh=mesh)
    batch = {k.split()[1]: v for k, v in inp.items()
             if k.startswith("train ")}
    opt, metrics = step(model, opt, batch)
    for k, v in metrics.items():
        out[f"train {k}"] = _whole(v)
    for prefix, tree in (("param", M.stacked_params(model)),
                         ("m", opt.m), ("v", opt.v)):
        for path, t in _flat(tree):
            out[f"{prefix} {path}"] = _whole(t)
    prefill = R.make_step(cfg, PREFILL, device=device, mesh=mesh)
    out["prefill logits"] = _whole(prefill(served, {
        "tokens": inp["prefill tokens"]}))
    decode = R.make_step(cfg, DECODE, device=device, mesh=mesh)
    B, S = DECODE.global_batch, DECODE.seq_len
    cache = {k: v.float() for k, v in D.init_cache(cfg, B, S,
                                                   device=device).items()}
    nxt = inp["decode tokens"]
    for t in range(DECODE_STEPS):
        logits, cache = decode(served, {
            "cache": cache, "tokens": nxt[:, t:t + 1],
            "pos": torch.full((B,), t, dtype=torch.int32)})
        out[f"decode logits {t}"] = _whole(logits)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
        return
    yield prefix, tree


def plain_steps(arch, overrides, seed):
    """The cell unsharded, on the CPU."""
    return _cell(config(arch, overrides), seed, "cpu")


def mesh_steps(arch, overrides, seed, shape, device, rules=None):
    """The cell on a ``shape`` (data, model) mesh of the group's ranks
    (gloo on the CPU), with the parameters under ``rules``."""
    dm = MS.device_mesh(MS.MeshShape(shape, ("data", "model")), device)
    return _cell(config(arch, overrides), seed, device, dm, rules)


def local_shapes(arch, overrides, shape, device):
    """Per parameter leaf, its DTensor's local shard shape on a ``shape``
    mesh, ``sharding.shard_shape``'s, and whether
    ``convert.params_from_numpy(mesh=)`` commits the same local shard
    under the same placements: {path: (shape, shape, bool)}."""
    dm = MS.device_mesh(MS.MeshShape(shape, ("data", "model")), device)
    cfg = config(arch, overrides)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, device=device)
    arrays = {}
    for p, t in _flat(M.stacked_params(model)):
        node = arrays
        for k in p.strip("/").split("/")[:-1]:
            node = node.setdefault(k, {})
        node[p.rsplit("/", 1)[1]] = t.numpy().copy()
    tree = M.stacked_params(R.shard_model(model, cfg, dm))
    converted = dict(_flat(M.stacked_params(params_from_numpy(
        arrays, cfg, device, mesh=dm))))
    specs = SH.tree_shardings(M.param_axes(cfg), tree,
                              MS.mesh_shape_of(dm))
    spec_of = dict(_flat(specs))
    return {p: (tuple(t.to_local().shape),
                SH.shard_shape(spec_of[p], tuple(t.shape), dm),
                torch.equal(converted[p].to_local(), t.to_local())
                and converted[p].placements == t.placements)
            for p, t in _flat(tree)}


__all__ = ["plain_steps", "mesh_steps", "local_shapes", "config",
           "cell_inputs", "init_tree", "TRAIN", "PREFILL", "DECODE",
           "N_MICRO", "DECODE_STEPS"]
