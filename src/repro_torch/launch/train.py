# Port of repro/launch/train.py (the JAX package): the same flags and log lines, plus --device; the loop is a function of its own.
"""End-to-end training entry point with checkpoint/restart.

    python -m repro_torch.launch.train --arch tinyllama_1_1b --smoke \
        --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt --device cpu

(run from ``src/`` or with it on ``PYTHONPATH``; ``--device`` defaults to
the CUDA card).  Kill the process at any point and rerun the same command:
it resumes from the newest valid checkpoint with an identical data stream
(step-indexed PRNG; ``repro_torch.data.pipeline``).  A checkpoint is
``{"p": stacked parameter tree, "o": OptState}`` through
``repro_torch.launch.checkpoint``, the JAX launcher's layout, so either
package restores the other's train state.  :func:`train_loop` is the loop
itself, which ``chip_smoke.py`` drives on the card.

``--mesh D,M`` runs the step on a (data, model) ``DeviceMesh`` of this
process group's ranks (``mesh.device_mesh``; one process makes the
one-rank group of a 1,1 mesh): parameters and AdamW's moments DTensors
under ``sharding.DEFAULT_RULES``, each batch committed over ``data``,
the attention kernels on local shards (``registry.mesh_step``).  Its
checkpoints are not ported: ``--ckpt-dir`` refuses a mesh.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataConfig, batch_for_step
from ..device import resolve_device
from ..models import transformer as M
from ..models.config import ModelConfig, ShapeConfig
from ..train.optimizer import AdamWConfig, OptState, adamw_init, tree_leaves
from ..train.step import make_train_step
from . import checkpoint as ckpt


def train_state(model, opt_state: OptState):
    """The checkpointed tree: ``{"p": stacked params, "o": opt_state}``."""
    return {"p": M.stacked_params(model), "o": opt_state}


def restore(ckpt_dir: str, model, opt_state: OptState):
    """Restore the newest valid checkpoint into ``model`` (in place) ->
    (start step, OptState), or None when there is none."""
    got = ckpt.restore_latest(ckpt_dir, train_state(model, opt_state))
    if got is None:
        return None
    step, tree = got
    with torch.no_grad():
        for p, saved in zip(tree_leaves(M.stacked_params(model)),
                            tree_leaves(tree["p"])):
            p.copy_(saved)
    return step, tree["o"]


def train_loop(cfg: ModelConfig, shape: ShapeConfig, model, opt_state,
               step_fn, *, start_step: int, steps: int, data_cfg: DataConfig,
               device, log_every: int = 10, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 20, log: Callable[[str], None] = print,
               on_step: Optional[Callable] = None):
    """Steps ``start_step`` .. ``steps - 1`` of ``step_fn`` on the
    step-indexed batches, logging every ``log_every`` steps and the last
    (which reads the loss back to the host), checkpointing every
    ``ckpt_every`` and at the end.  ``on_step(step, metrics)`` runs after
    each step.  Returns (opt_state, 0), or (opt_state, 1) on a non-finite
    loss."""
    t0 = time.time()
    for step in range(start_step, steps):
        batch = batch_for_step(cfg, shape, step, data_cfg, device)
        opt_state, metrics = step_fn(model, opt_state, batch)
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t0
            tok_s = ((step - start_step + 1) * shape.global_batch
                     * shape.seq_len / dt)
            log(f"[train] step={step} loss={loss:.4f} gnorm={gn:.3f} "
                f"tok/s={tok_s:.0f}")
            if not np.isfinite(loss):
                log("[train] non-finite loss; aborting")
                return opt_state, 1
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, train_state(model, opt_state))
            ckpt.prune(ckpt_dir, keep=3)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, train_state(model, opt_state))
    return opt_state, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--mesh", default=None,
                    help="D,M: run on a (data, model) DeviceMesh")
    args = ap.parse_args(argv)
    if args.mesh and args.ckpt_dir:
        ap.error("--ckpt-dir does not take a --mesh run")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20))
    device = resolve_device(args.device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = M.make_trainable(M.init_params(cfg, gen, device=device))
    opt_state = adamw_init(M.stacked_params(model))
    start_step = 0
    if args.ckpt_dir:
        restored = restore(args.ckpt_dir, model, opt_state)
        if restored is not None:
            start_step, opt_state = restored
            print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.micro)
    if args.mesh:
        from ..models import registry as R
        from .mesh import MeshShape, device_mesh
        sizes = tuple(int(n) for n in args.mesh.split(","))
        dm = device_mesh(MeshShape(sizes, ("data", "model")), device)
        model = M.make_trainable(R.shard_model(model, cfg, dm))
        opt_state = R.shard_opt_state(opt_state, cfg, dm)
        step_fn = R.mesh_step(step_fn, cfg, shape, dm)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch}x{args.seq} steps={args.steps}", flush=True)
    _, rc = train_loop(
        cfg, shape, model, opt_state, step_fn, start_step=start_step,
        steps=args.steps, data_cfg=DataConfig(args.seed), device=device,
        log_every=args.log_every, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log=lambda s: print(s, flush=True))
    if rc:
        return rc
    print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
