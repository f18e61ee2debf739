# Port of repro/launch/roofline.py (the JAX package): a cell's roofline from the meta count of launch/dryrun.py at one H100's peaks, on one card or on the production meshes, at full depth or from JAX's depth variants and combiners.
"""Roofline per cell.

XLA's cost model counts a while-loop body once, so JAX lowers unrolled
*depth variants* of each cell and extrapolates exactly:

    per_layer = f(d2) - f(d1)              (d2 - d1 layers apart)
    total     = f(d1) + (L - d1) * per_layer

applied to flops, bytes and collective bytes independently.  Hybrid
(Zamba2) decomposes into shared-block + per-mamba-layer costs via three
depth variants; enc-dec scales both stacks together.

The port's meta count (``launch/dryrun.py``) sees every layer, so on one
card (``multi_pod=None``) a cell is counted at full depth
(``dryrun.lower_cell``), in seconds for every family but one.  RWKV-6's
time mix is a per-token loop, each token's ops dispatched on ``meta``:
its full-depth ``train_4k`` count takes about 27 minutes on one CPU
core, its two depth variants under 3 (PERF.md §6).  Its cells
(``COMBINE_FAMILIES``) are counted at JAX's depth variants and combined,
which equals the direct count exactly (tests/test_torch_roofline.py; at
full width, PERF.md §6).

On a production mesh (``multi_pod`` False / True, ``--pod`` /
``--multi-pod``) DTensor's dispatch of every op on ``meta`` is slow in
Python, so every cell is counted at its depth variants, as JAX counts
it; there the collectives by kind and the per-device bytes (arguments,
temp, peak) are extrapolated the same way, each linear in the depth.

Usage (any machine)::

    PYTHONPATH=src python -m repro_torch.launch.roofline [--arch A]
        [--shape S] [--micro N] [--pod | --multi-pod | --both-meshes]
        [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..models import registry as R
from ..models.config import SHAPES
from .dryrun import (COLLECTIVES, PEAK_FLOPS, PEAKS, add_mesh_args,
                     lower_cell, mesh_name, meshes_of, roofline_terms)

# Families counted at their depth variants: a full-depth meta count of
# their cells takes tens of minutes (the docstring).
COMBINE_FAMILIES = ("rwkv6",)


# A depth variant's cost vector: flops of each ``PEAKS`` class, bytes,
# collective bytes by kind, per-device bytes.
_KEYS = sorted(PEAKS)
_KINDS = sorted(set(COLLECTIVES.values()))
_PER_DEVICE = ("argument", "output", "temp", "peak")


def _measure(arch, shape, cfg, n_micro, **mesh_kw):
    r = lower_cell(arch, shape, n_micro=n_micro, cfg_override=cfg,
                   **mesh_kw)
    if r.get("skipped"):
        return None
    return np.array([r["flops_by_peak"].get(k, 0.0) for k in _KEYS]
                    + [r["hlo_bytes"]]
                    + [r["collectives"].get(k, 0.0) for k in _KINDS]
                    + [float(r["per_device_bytes"][k]) for k in _PER_DEVICE])


def depth_variants(cfg):
    """Returns (variants, combiner) where variants is a list of depth-
    reduced configs and combiner maps their cost vectors to the full-depth
    estimate."""
    fam = cfg.family
    if fam == "hybrid":
        p = cfg.shared_attn_period
        L = cfg.n_layers
        n_groups, rem = L // p, L % p
        v = [cfg.scaled(n_layers=p), cfg.scaled(n_layers=2 * p),
             cfg.scaled(n_layers=p + 1)]

        def combine(c):
            group = c[1] - c[0]          # shared block + p mamba layers
            mamba = c[2] - c[0]          # one mamba layer
            base = c[0] - group
            return base + n_groups * group + rem * mamba
        return v, combine
    if fam == "encdec":
        v = [cfg.scaled(n_layers=1, n_enc_layers=1),
             cfg.scaled(n_layers=2, n_enc_layers=2)]

        def combine(c):
            pair = c[1] - c[0]
            return c[0] + (cfg.n_layers - 1) * pair
        return v, combine
    v = [cfg.scaled(n_layers=1), cfg.scaled(n_layers=2)]

    def combine(c):
        layer = c[1] - c[0]
        return c[0] + (cfg.n_layers - 1) * layer
    return v, combine


def combined_costs(arch, shape, cfg, n_micro=1, **mesh_kw):
    """(flops by ``PEAKS`` class, bytes, collective bytes by kind,
    per-device bytes) of ``cfg`` at full depth from its depth variants'
    meta counts, or None where a variant is unsupported."""
    variants, combine = depth_variants(cfg)
    costs = []
    for vcfg in variants:
        c = _measure(arch, shape, vcfg, n_micro, **mesh_kw)
        if c is None:
            return None
        costs.append(c)
    est = np.maximum(combine(costs), 0.0)   # clamp extrapolation noise
    n = len(_KEYS)
    by_peak = {k: float(f) for k, f in zip(_KEYS, est) if f}
    coll = {k: float(b) for k, b in zip(_KINDS, est[n + 1:]) if b}
    per_device = {k: int(round(b)) for k, b in
                  zip(_PER_DEVICE, est[n + 1 + len(_KINDS):])}
    return by_peak, float(est[n]), coll, per_device


def roofline_cell(arch: str, shape_name, *, multi_pod=None,
                  n_micro: int = 1, rules=None, batch_axes=None,
                  head_axes="model") -> Dict[str, Any]:
    """``shape_name``: a ``SHAPES`` name or a ``ShapeConfig``.
    ``multi_pod``: None one card, False / True the 16 x 16 / 2 x 16 x 16
    mesh with ``rules``, ``batch_axes`` and ``head_axes`` (JAX's
    arguments, ``dryrun.lower_cell``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    name = mesh_name(multi_pod)
    ok, why = R.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "skipped": True, "reason": why}
    t0 = time.time()
    mesh_kw = {}
    if multi_pod is not None:
        mesh_kw = dict(multi_pod=multi_pod, rules=rules,
                       batch_axes_override=batch_axes,
                       head_axes_override=head_axes)
    combined = multi_pod is not None or cfg.family in COMBINE_FAMILIES
    if combined:
        got = combined_costs(arch, shape, cfg, n_micro, **mesh_kw)
        if got is None:
            return {"arch": arch, "shape": shape_name, "mesh": name,
                    "skipped": True, "reason": "variant unsupported"}
        by_peak, hbm_bytes, colls, per_device = got
        chips = 1 if multi_pod is None else (512 if multi_pod else 256)
    else:
        r = lower_cell(arch, shape, n_micro=n_micro)
        by_peak, hbm_bytes, colls, per_device, chips = (
            r["flops_by_peak"], r["hlo_bytes"], r["collectives"],
            r["per_device_bytes"], r["chips"])
    coll = sum(colls.values())
    flops = sum(by_peak.values())
    terms = roofline_terms(by_peak, hbm_bytes, coll, chips)
    mf = R.model_flops(cfg, shape)
    bound_s = max(terms["compute_s"], terms["memory_s"],
                  terms["collective_s"])
    # roofline fraction: useful model FLOPs per second achievable at the
    # binding term, relative to peak compute
    achievable_flops_per_s = (mf / bound_s) if bound_s > 0 else 0.0
    frac = achievable_flops_per_s / (chips * PEAK_FLOPS)
    return {
        "arch": arch, "shape": shape_name, "mesh": name,
        "chips": chips, "skipped": False,
        "hlo_flops": flops, "hlo_bytes": hbm_bytes,
        "collective_bytes": coll, "collectives": colls,
        "flops_by_peak": by_peak, "per_device_bytes": per_device,
        "counted_at": "depth variants" if combined else "full depth",
        "model_flops": mf,
        "useful_flops_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": frac,
        "measure_s": round(time.time() - t0, 1),
        **terms,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--json", default=None)
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes_of(args):
                try:
                    r = roofline_cell(arch, shape, multi_pod=mp,
                                      n_micro=args.micro)
                except Exception as e:  # noqa: BLE001
                    r = {"arch": arch, "shape": shape,
                         "mesh": mesh_name(mp),
                         "error": f"{type(e).__name__}: {e}"}
                results.append(r)
                tag = f"{arch:24s} {shape:12s} {r['mesh']:8s}"
                if r.get("skipped"):
                    print(f"[SKIP] {tag} {r['reason'][:60]}", flush=True)
                elif "error" in r:
                    print(f"[ERR ] {tag} {r['error'][:90]}", flush=True)
                else:
                    print(f"[OK  ] {tag} dom={r['dominant']:10s} "
                          f"c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
                          f"x={r['collective_s']:.4f} "
                          f"useful={r['useful_flops_ratio']:.2f} "
                          f"roofline={r['roofline_fraction']:.3f}",
                          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
