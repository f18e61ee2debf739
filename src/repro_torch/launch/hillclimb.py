# Port of repro/launch/hillclimb.py (the JAX package): its variants (layout, remat, micro-batches, chunked CE, bf16 p) over launch/roofline.py's meta count, on one card or the production meshes, and a --measure mode that runs a one-card variant's train step on the card.
"""Hillclimb: named optimization variants of one (arch x shape)
cell and their roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch tinyllama-1.1b --shape train_4k \\
        [--variants baseline,remat_dots,...] [--pod | --multi-pod] \\
        [--json out.json]

counts each variant on ``meta`` (any machine); with ``--measure`` it also
runs the variant's train step (``--batch`` / ``--seq`` cut the cell,
``--steps`` timed steps after a warm-up) on ``--device`` (default: the
CUDA card; ``--device cpu`` to run on the CPU) and reports tokens/s,
device ms a step (CUDA events), ``torch.cuda.max_memory_allocated()``
beside the meta fit, and the attention kernels' launches a step.

Variants compose orthogonal knobs, JAX's: the sharding rules
(``sharding.NO_FSDP_RULES`` / ``PURE_DP_RULES``, with pure DP's batch
over every mesh axis and no heads axis), remat policy (full /
dots-saveable / none), micro-batching (``n_micro`` grad-accumulation
splits), the chunked cross entropy and the bf16-p attention
(``flags.ATTN_P_BF16``: on the card the attention kernels' p_bf16 routes;
its meta count is the baseline's, since p never leaves the kernels'
registers and so has no bytes to halve).  A variant is counted on one card
(``dryrun.MESH_NAME``) unless it sets a layout knob, which only a mesh
has: it is counted on the 16 x 16 production mesh (``--multi-pod``: 2 x
16 x 16), in this process's fake group (``mesh.fake_device_mesh``).
``--pod`` / ``--multi-pod`` count every variant on that mesh.
``--measure`` runs one-card variants only: one card has one layout, and
it refuses a layout variant.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Dict

import torch

from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataConfig, batch_for_step
from ..device import DeviceLike, resolve_device
from ..kernels import flash_attention as FA
from ..models import flags
from ..models import registry as R
from ..models import transformer as M
from ..models.config import SHAPES, ShapeConfig
from ..train.optimizer import adamw_init
from .dryrun import add_mesh_args, lower_cell
from .roofline import roofline_cell
from .sharding import NO_FSDP_RULES, PURE_DP_RULES

_PURE_DP = dict(rules=PURE_DP_RULES, batch_axes=("pod", "data", "model"),
                head_axes=None)
# name -> dict(rules, remat, micro, batch_axes, head_axes, ce, p_bf16):
# JAX's.
VARIANTS = {
    "baseline":       dict(),
    "no_fsdp":        dict(rules=NO_FSDP_RULES),
    "remat_dots":     dict(remat="dots"),
    "remat_none":     dict(remat="none"),
    "micro4":         dict(micro=4),
    "micro16":        dict(micro=16),
    "no_fsdp+dots":   dict(rules=NO_FSDP_RULES, remat="dots"),
    "no_fsdp+none":   dict(rules=NO_FSDP_RULES, remat="none"),
    "pure_dp":        dict(_PURE_DP),
    "pure_dp+dots":   dict(_PURE_DP, remat="dots"),
    "pure_dp+none":   dict(_PURE_DP, remat="none"),
    "pure_dp+none+micro4": dict(_PURE_DP, remat="none", micro=4),
    "pure_dp+none+ce":  dict(_PURE_DP, remat="none", ce="chunked"),
    "pure_dp+none+ce+pbf16": dict(_PURE_DP, remat="none", ce="chunked",
                                  p_bf16=True),
    "ce_chunked":       dict(ce="chunked"),
    "p_bf16":           dict(p_bf16=True),
    "ce+pbf16":         dict(ce="chunked", p_bf16=True),
}
# The knobs only a mesh has.
LAYOUT_KNOBS = ("rules", "batch_axes", "head_axes")
# A variant runs on the card only where its meta fit is at most this share
# of the card's memory (the rest: the allocator's rounding, cuBLAS's
# workspace, what the process already holds).
FIT_SHARE = 0.9


@contextlib.contextmanager
def variant_flags(remat: str = "full", ce: str = "dense",
                  p_bf16: bool = False):
    """``flags.REMAT_MODE`` / ``CE_MODE`` / ``ATTN_P_BF16`` set for the
    block and restored after it, also when it raises."""
    old = flags.REMAT_MODE, flags.CE_MODE, flags.ATTN_P_BF16
    flags.REMAT_MODE, flags.CE_MODE, flags.ATTN_P_BF16 = remat, ce, p_bf16
    try:
        yield
    finally:
        flags.REMAT_MODE, flags.CE_MODE, flags.ATTN_P_BF16 = old


def _knobs(name):
    """(remat, ce, micro, p_bf16) of the variant."""
    v = VARIANTS[name]
    return (v.get("remat", "full"), v.get("ce", "dense"), v.get("micro", 1),
            v.get("p_bf16", False))


def is_layout(name) -> bool:
    """Whether the variant sets a layout knob (counted on a mesh)."""
    return any(k in VARIANTS[name] for k in LAYOUT_KNOBS)


def run_variant(arch, shape, name, *, multi_pod=None):
    """The variant's roofline (``roofline.roofline_cell``): on one card,
    or for a layout variant (or any, with ``multi_pod`` False / True) on
    the 16 x 16 / 2 x 16 x 16 mesh."""
    v = VARIANTS[name]
    remat, ce, micro, p_bf16 = _knobs(name)
    if multi_pod is None and is_layout(name):
        multi_pod = False
    with variant_flags(remat, ce, p_bf16):
        r = roofline_cell(arch, shape, n_micro=micro, multi_pod=multi_pod,
                          rules=v.get("rules"),
                          batch_axes=v.get("batch_axes"),
                          head_axes=v.get("head_axes", "model"))
    r["variant"] = name
    return r


def fit_variant(cfg, shape, *, remat="full", ce="dense", n_micro=1,
                p_bf16=False, dtype=torch.bfloat16) -> Dict[str, Any]:
    """``dryrun.lower_cell`` of the train step at full depth under these
    knobs: its counted flops, terms and memory fit."""
    with variant_flags(remat, ce, p_bf16):
        return lower_cell(cfg.name, shape, n_micro=n_micro,
                          cfg_override=cfg, dtype=dtype)


def measure(cfg, shape, *, remat="full", ce="dense", n_micro=1,
            p_bf16=False, steps: int = 2, seed: int = 0,
            device: DeviceLike = None,
            dtype=torch.bfloat16) -> Dict[str, Any]:
    """Run the train step of ``cfg`` at ``shape`` under these knobs on
    ``device`` (None: the CUDA card; raises without one): a model drawn
    from a generator seeded ``seed`` on the device, AdamW's defaults, one
    warm-up step and ``steps`` timed ones on the step-indexed batches of
    ``DataConfig(seed)``.  On the card a variant whose meta fit exceeds
    ``FIT_SHARE`` of the card's memory is not run (``"fits": False``).
    Returns the fit, the counted flops and terms, and for a run:
    tokens/s, host s a step, device ms a step (CUDA events), the bytes
    allocated before the model and the peak after
    (``max_memory_allocated``, reset first), the attention launches of
    each timed step and every step's loss (the warm-up's first)."""
    device = resolve_device(device)
    fit = fit_variant(cfg, shape, remat=remat, ce=ce, n_micro=n_micro,
                      p_bf16=p_bf16, dtype=dtype)
    out = {"remat": remat, "ce": ce, "n_micro": n_micro, "p_bf16": p_bf16,
           "global_batch": shape.global_batch, "seq": shape.seq_len,
           "counted_flops": fit["hlo_flops"],
           "fit_bytes": fit["per_device_bytes"],
           **{k: fit[k] for k in ("compute_s", "memory_s", "dominant")}}
    cuda = device.type == "cuda"
    if cuda:
        total = torch.cuda.get_device_properties(device).total_memory
        out["fits"] = fit["per_device_bytes"]["peak"] <= FIT_SHARE * total
        if not out["fits"]:
            return out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        out["start_bytes"] = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = M.make_trainable(M.init_params(cfg, gen, dtype=dtype,
                                           device=device))
    opt = adamw_init(M.stacked_params(model))
    step_fn = R.make_step(cfg, shape, n_micro=n_micro, device=device)
    data = DataConfig(seed)
    losses, launches, host_s, dev_ms = [], [], [], []
    with variant_flags(remat, ce, p_bf16):
        for step in range(1 + steps):
            batch = batch_for_step(cfg, shape, step, data, device)
            FA.reset_launches()
            if cuda:
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
            t0 = time.perf_counter()
            opt, metrics = step_fn(model, opt, batch)
            if cuda:
                ev[1].record()
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses.append(float(metrics["loss"]))
            if step:
                host_s.append(t1 - t0)
                launches.append({k: n for k, n in FA.LAUNCHES.items() if n})
                if cuda:
                    dev_ms.append(ev[0].elapsed_time(ev[1]))
    tokens = shape.global_batch * shape.seq_len
    out.update(
        fits=True, losses=losses, launches_per_step=launches,
        step_s=sum(host_s) / steps,
        tokens_per_s=steps * tokens / sum(host_s),
        device_ms=sum(dev_ms) / steps if cuda else None,
        peak_bytes=(torch.cuda.max_memory_allocated(device) if cuda
                    else None))
    del model, opt
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--json", default=None)
    ap.add_argument("--measure", action="store_true",
                    help="also run each variant's train step")
    ap.add_argument("--smoke", action="store_true",
                    help="--measure: the reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: the shape's)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="--measure: torch device (default: the CUDA card)")
    add_mesh_args(ap)
    args = ap.parse_args(argv)
    multi_pod = (True if args.multi_pod else False if args.pod else None)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = ShapeConfig(f"{shape.name} cut", args.seq or shape.seq_len,
                            args.batch or shape.global_batch, shape.kind)
    results = []
    for name in args.variants.split(","):
        try:
            if args.measure:
                if is_layout(name):
                    raise ValueError(
                        f"{name} is a layout variant: one card has one "
                        "layout, so --measure runs one-card variants only")
                remat, ce, micro, p_bf16 = _knobs(name)
                r = dict(measure(cfg, shape, remat=remat, ce=ce,
                                 n_micro=micro, p_bf16=p_bf16,
                                 steps=args.steps, device=args.device),
                         variant=name)
            else:
                r = run_variant(args.arch, shape, name, multi_pod=multi_pod)
        except Exception as e:  # noqa: BLE001
            r = {"variant": name, "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        if "error" in r:
            print(f"[ERR ] {name:22s} {r['error'][:90]}", flush=True)
        elif r.get("skipped"):
            print(f"[SKIP] {name:22s} {r['reason'][:70]}", flush=True)
        elif args.measure:
            ran = (f"tok/s={r['tokens_per_s']:.0f} "
                   f"device_ms={r['device_ms']} peak={r['peak_bytes']}"
                   if r["fits"] else "does not fit")
            print(f"[OK  ] {name:22s} flops={r['counted_flops']:.4g} "
                  f"fit={r['fit_bytes']['peak']} {ran}", flush=True)
        else:
            print(f"[OK  ] {name:22s} {r['mesh']:8s} "
                  f"dom={r['dominant']:10s} "
                  f"c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
                  f"x={r['collective_s']:.4f} "
                  f"bound={max(r['compute_s'], r['memory_s'], r['collective_s']):.4f} "
                  f"roofline={r['roofline_fraction']:.4f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
