# Port of repro/launch/dryrun.py (the JAX package): a cell's step run once on the meta device under a count of its flops, bytes and live memory, with the roofline terms at one H100's peaks.
"""Dry-run: one (architecture x input shape) cell, counted on ``meta``.

JAX lowers and compiles each cell onto 256 / 512 placeholder devices and
reads XLA's cost and memory analyses.  The port builds the cell's
parameters, optimizer state and batch as ``meta`` tensors
(``registry.abstract_params`` / ``abstract_train_state`` /
``input_specs``, which allocate nothing) and runs ``registry.make_step``'s
step on them once under :func:`count_step`:

  * **flops**: ``torch.utils.flop_counter.FlopCounterMode`` over the aten
    products (a train step's remat recompute is counted, as XLA counts
    it), plus the attention kernels' calls, which the wrapper records on
    ``meta`` (``flash_attention.META_CALLS``), at
    :func:`attention_flops` / :func:`attention_bwd_flops`;
  * **bytes**: :class:`Counter` adds up the operand and result bytes of
    every dispatched op that moves data (views, aliases and allocations
    move none): what eager PyTorch moves, since nothing is fused; plus the
    attention calls' :func:`attention_bytes` / :func:`attention_bwd_bytes`
    and, in float32, their splits' :func:`split_bytes`;
  * **memory**: the same mode tracks the bytes of live storages that the
    step allocates (``weakref.finalize`` on each new storage) and keeps
    their peak: ``per_device_bytes`` is ``argument`` (parameters,
    optimizer state, batch or cache), ``output`` (what the step returns
    beyond them), ``temp`` (the peak above the arguments) and ``peak``.

Nothing is computed on ``meta``, as JAX's dry-run computes nothing: this
runs on any machine and is not a CPU fallback of a card path.  The terms
take one NVIDIA H100 SXM's peaks (NVIDIA's data sheet, dense, at 700 W):
bf16 GEMMs at 989 TFLOP/s, float32 GEMMs at 67 TFLOP/s (the port runs
them without TF32), the attention kernels at 989 TFLOP/s in bf16 and
989 / 6 in float32 (six bf16 plane products a float32 product), HBM at
3.35e12 B/s.  A cell's products are taken at its parameters' dtype.

What does not carry from JAX: ``collective_bytes`` and ``_shape_bytes``
(they parse XLA's HLO text), ``cost_analysis_dict``, the ``XLA_FLAGS``
device count and ``--multi-pod``: one card has no collectives, so the
collective term is 0 (ROADMAP.md lists the multi-card term).

Usage (any machine)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch tinyllama-1.1b] [--shape train_4k] [--all] [--micro N] \\
        [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config
from ..kernels import flash_attention as FA
from ..models import registry as R
from ..models import transformer as M
from ..models.config import SHAPES

META = torch.device("meta")

# ---------------------------------------------------------------------------
# One H100's peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
# ---------------------------------------------------------------------------

PEAK_BYTES_PER_S = 3.35e12          # HBM3
PEAK_BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores
PEAK_F32_FLOPS_PER_S = 67e12        # float32 without TF32
NVLINK_BYTES_PER_S = 450e9          # one direction of NVLink 4's 900 GB/s
# Attention's rate is the bf16 tensor cores' over the products each
# float32 product costs there: one for bf16 inputs; for float32 inputs
# the six bf16 plane products (of nine, the three smallest dropped) that
# fa_fwd_wgmma<hd, true> and the backward run per float32 product.
F32_PLANE_PASSES = 6
PEAK_ATTN_FLOPS_PER_S = {"bfloat16": PEAK_BF16_FLOPS_PER_S,
                         "float32": PEAK_BF16_FLOPS_PER_S / F32_PLANE_PASSES}
# Each class of flops at its rate: a cell's GEMMs at its dtype's, its
# attention calls at the kernels'.
PEAKS = {"bfloat16": PEAK_BF16_FLOPS_PER_S, "float32": PEAK_F32_FLOPS_PER_S,
         **{f"attention {k}": v for k, v in PEAK_ATTN_FLOPS_PER_S.items()}}
# JAX's names.
PEAK_FLOPS = PEAK_BF16_FLOPS_PER_S
HBM_BW = PEAK_BYTES_PER_S
ICI_BW = NVLINK_BYTES_PER_S


def roofline_terms(flops: Union[float, Mapping[str, float]],
                   hbm_bytes: float, coll_bytes: float,
                   chips: int) -> Dict[str, Any]:
    """Seconds at the peaks and the dominant term.  ``flops`` is a number
    (at ``PEAK_FLOPS``) or ``{PEAKS key: flops}``, each class at its own
    rate."""
    if isinstance(flops, Mapping):
        compute_s = sum(f / PEAKS[k] for k, f in flops.items()) / chips
    else:
        compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = hbm_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * ICI_BW)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant}


# ---------------------------------------------------------------------------
# The attention kernels' work
# ---------------------------------------------------------------------------

def head_dims_of(hd):
    """(q/k head dim, v head dim) of ``hd``: an int (both) or a pair."""
    return tuple(hd) if isinstance(hd, tuple) else (hd, hd)


def attention_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask keeps: the work these inputs need."""
    import numpy as np
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_flops(B, Sq, Sk, H, hd, causal, window) -> float:
    """2 * B * H * (hd + hd_v) flops a kept pair (S = q k^T at hd, p v at
    hd_v).  ``hd`` an int or a (q/k, v) pair."""
    hd, hd_v = head_dims_of(hd)
    return 2.0 * B * H * (hd + hd_v) * attention_pairs(Sq, Sk, causal,
                                                       window)


def attention_bytes(B, Sq, Sk, H, KV, hd, itemsize) -> int:
    """q, k, v read and o written once."""
    hd, hd_v = head_dims_of(hd)
    return itemsize * (B * Sq * H * (hd + hd_v) + B * Sk * KV * (hd + hd_v))


def attention_bwd_flops(B, Sq, Sk, H, hd, causal, window) -> float:
    """2 * B * H * (3 hd + 2 hd_v) flops a kept pair (S = q k^T
    recomputed, dK and dQ at hd; dP = do v^T and dV at hd_v: 10 hd at equal
    widths)."""
    hd, hd_v = head_dims_of(hd)
    return 2.0 * B * H * (3 * hd + 2 * hd_v) * attention_pairs(
        Sq, Sk, causal, window)


def attention_bwd_bytes(B, Sq, Sk, H, KV, hd, itemsize) -> int:
    """q, k, v, o, do and lse read once, dq, dk, dv written once."""
    hd, hd_v = head_dims_of(hd)
    return (itemsize * (B * Sq * H * (2 * hd + 2 * hd_v)
                        + 2 * B * Sk * KV * (hd + hd_v))
            + 4 * B * H * Sq)


ITEMSIZE = {"bfloat16": 2, "float32": 4}


def split_bytes(c: FA.MetaCall) -> int:
    """Bytes the float32 route's ``split_bf16x3`` launches move before a
    call's kernel: q, k and v (and do, backward) each read at 4 bytes an
    element and written as three bf16 planes, 6.  0 in bf16."""
    if c.dtype != "float32":
        return 0
    n = c.B * (c.Sq * c.H * c.hd + c.Sk * c.KV * (c.hd + c.hd_v))
    if c.kind == "bwd":
        n += c.B * c.Sq * c.H * c.hd_v
    return 10 * n


def _bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_ATTN_FLOPS_PER_S[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound_ms(B, Sq, Sk, H, KV, hd, causal, window, dtype_name):
    """max(operations at the dtype's peak, bytes at HBM's rate) of one
    forward call, and which of the two bounds it."""
    return _bound_ms(attention_flops(B, Sq, Sk, H, hd, causal, window),
                     attention_bytes(B, Sq, Sk, H, KV, hd,
                                     ITEMSIZE[dtype_name]), dtype_name)


def attention_bwd_bound_ms(B, Sq, Sk, H, KV, hd, causal, window,
                           dtype_name):
    """The gradient's bound, as :func:`attention_bound_ms`."""
    return _bound_ms(attention_bwd_flops(B, Sq, Sk, H, hd, causal, window),
                     attention_bwd_bytes(B, Sq, Sk, H, KV, hd,
                                         ITEMSIZE[dtype_name]), dtype_name)


def attention_work(calls: Iterable[FA.MetaCall]) -> Dict[str, Any]:
    """Flops by dtype, bytes (the splits' included) and calls by (kind,
    dtype) of recorded attention calls, with the float32 route's
    ``split_bf16x3`` launches."""
    flops: Dict[str, float] = {}
    nbytes = 0
    n: Dict[str, int] = {}
    for c in calls:
        hd = (c.hd, c.hd_v)
        fwd = c.kind == "fwd"
        f = (attention_flops if fwd else attention_bwd_flops)(
            c.B, c.Sq, c.Sk, c.H, hd, c.causal, c.window)
        flops[c.dtype] = flops.get(c.dtype, 0.0) + f
        nbytes += (attention_bytes if fwd else attention_bwd_bytes)(
            c.B, c.Sq, c.Sk, c.H, c.KV, hd, ITEMSIZE[c.dtype])
        nbytes += split_bytes(c)
        key = f"{c.kind} {c.dtype}"
        n[key] = n.get(key, 0) + 1
        if c.dtype == "float32":
            n[FA.SPLIT] = n.get(FA.SPLIT, 0) + (3 if fwd else 4)
    return {"flops": flops, "bytes": nbytes, "calls": n}


# ---------------------------------------------------------------------------
# The counting pass
# ---------------------------------------------------------------------------

# Ops that allocate and write nothing.
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}


def _storages(tensors) -> Dict[int, Any]:
    """id -> untyped storage of each tensor (one entry a storage)."""
    out = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[id(s)] = s
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors."""
    return sum(s.nbytes() for s in _storages(tree_leaves(tree)).values())


class Counter(TorchDispatchMode):
    """Counts, for every dispatched op, the bytes it moves (``bytes``:
    its tensor operands and results, unless it allocates only or its
    results alias its operands without mutating them) and the bytes of
    the storages it allocates while they live (``live``, their peak
    ``peak``).  Storages made outside the mode are not counted live."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _storages(tree_leaves((args, kwargs)))
        outs = _storages(tree_leaves(out))
        for key, s in outs.items():
            if key not in ins and key not in self._tracked:
                self._tracked[key] = s.nbytes()
                self.live += s.nbytes()
                weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)
        if func._overloadpacket.__name__ in _ALLOCATIONS:
            return out
        if not func._schema.is_mutable and outs and set(outs) <= set(ins):
            return out
        self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs))
                          if isinstance(t, torch.Tensor))
        self.bytes += sum(t.nbytes for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
        return out


def count_step(step, *args) -> Dict[str, Any]:
    """Run ``step(*args)`` (meta tensors) once under ``FlopCounterMode``
    and :class:`Counter`.  Returns the product flops, the op bytes, the
    attention calls the wrapper recorded, the live-byte peak above the
    arguments, the step's output bytes beyond them and the seconds the
    pass took."""
    t0 = time.perf_counter()
    fc = FlopCounterMode(display=False)
    counter = Counter()
    FA.META_CALLS = calls = []
    try:
        with fc, counter:
            out = step(*args)
    finally:
        FA.META_CALLS = None
    argument = _storages(tree_leaves(args))
    output = sum(s.nbytes() for k, s in
                 _storages(tree_leaves(out)).items() if k not in argument)
    return {"product_flops": float(fc.get_total_flops()),
            "op_bytes": counter.bytes, "attention_calls": calls,
            "temp": counter.peak, "output": output,
            "count_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

MESH_NAME = "1"


def meta_model(cfg, params) -> M.Transformer:
    """A ``Transformer`` on ``meta`` over the stacked meta tree
    ``params``."""
    dtype = next(iter(tree_leaves(params))).dtype
    return M.load_stacked(M.Transformer(cfg, device=META, dtype=dtype),
                          params)


def count_cell(cfg, shape, *, n_micro: int = 1,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """:func:`count_step` of ``cfg``'s step at ``shape`` on meta tensors
    (parameters in ``dtype``), with its ``argument`` bytes."""
    specs = {"train": R.train_input_specs,
             "prefill": R.prefill_input_specs,
             "decode": R.decode_input_specs}[shape.kind](cfg, shape)
    step = R.make_step(cfg, shape, n_micro=n_micro, device=META)
    if shape.kind == "train":
        params, opt = R.abstract_train_state(cfg, dtype)
        model = M.make_trainable(meta_model(cfg, params))
        args = (model, opt, specs)
        argument = storage_bytes((params, opt, specs))
    else:
        params = R.abstract_params(cfg, dtype)
        args = (meta_model(cfg, params), specs)
        argument = storage_bytes((params, specs))
    out = count_step(step, *args)
    out["argument"] = argument
    return out


def cell_costs(counted: Dict[str, Any], dtype_name: str) -> Dict[str, Any]:
    """Flops by ``PEAKS`` class, total flops and bytes of a counted
    cell."""
    attn = attention_work(counted["attention_calls"])
    by_peak = {dtype_name: counted["product_flops"]}
    for k, f in attn["flops"].items():
        by_peak[f"attention {k}"] = f
    return {"flops_by_peak": by_peak, "flops": sum(by_peak.values()),
            "bytes": counted["op_bytes"] + attn["bytes"],
            "attention_calls": attn["calls"]}


def lower_cell(arch: str, shape_name, *, n_micro: int = 1,
               cfg_override=None,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Count one (arch x shape) cell on ``meta``: the counterpart of
    JAX's ``lower_cell`` on a one-card mesh.  ``shape_name``: a ``SHAPES``
    name or a ``ShapeConfig`` (a cut cell); ``cfg_override``: a
    depth-reduced config (``roofline.depth_variants``).  ``compile_s`` is
    the seconds the counting pass took."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    ok, why = R.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": MESH_NAME,
                "skipped": True, "reason": why}
    counted = count_cell(cfg, shape, n_micro=n_micro, dtype=dtype)
    dtype_name = str(dtype).split(".")[-1]
    costs = cell_costs(counted, dtype_name)
    terms = roofline_terms(costs["flops_by_peak"], costs["bytes"], 0.0, 1)
    mf = R.model_flops(cfg, shape)
    argument = counted["argument"]
    return {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAME, "chips": 1,
        "skipped": False,
        "compile_s": round(counted["count_s"], 1),
        "hlo_flops": costs["flops"],
        "hlo_bytes": float(costs["bytes"]),
        "collective_bytes": 0.0,
        "collectives": {},
        "flops_by_peak": costs["flops_by_peak"],
        "attention_calls": costs["attention_calls"],
        "model_flops": mf,
        "useful_flops_ratio": (mf / costs["flops"]) if costs["flops"]
        else 0.0,
        "per_device_bytes": {
            "argument": argument,
            "output": counted["output"],
            "temp": counted["temp"],
            "peak": argument + counted["temp"],
        },
        **terms,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for arch in archs:
        for shape in shapes:
            try:
                r = lower_cell(arch, shape, n_micro=args.micro)
            except Exception as e:  # noqa: BLE001 — report, don't die
                r = {"arch": arch, "shape": shape, "mesh": MESH_NAME,
                     "error": f"{type(e).__name__}: {e}"}
            results.append(r)
            status = ("SKIP" if r.get("skipped")
                      else ("ERR " if "error" in r else "OK  "))
            extra = (r.get("reason") or r.get("error", "") or
                     f"dom={r.get('dominant')} "
                     f"c={r.get('compute_s', 0):.4f}s "
                     f"m={r.get('memory_s', 0):.4f}s "
                     f"x={r.get('collective_s', 0):.4f}s "
                     f"peak={_fmt_bytes(r['per_device_bytes']['peak'])}")
            print(f"[{status}] {arch:24s} {shape:12s} "
                  f"{r['mesh']:8s} {extra}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if "error" in r]
    return 1 if bad else 0


def _fmt_bytes(b: Optional[int]) -> str:
    if b is None:
        return "?"
    return f"{b/2**30:.2f}GiB"


if __name__ == "__main__":
    sys.exit(main())
