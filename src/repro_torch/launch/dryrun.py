# Port of repro/launch/dryrun.py (the JAX package): a cell's step run once on the meta device under a count of its flops, bytes, live memory and collectives, on one card or on the production meshes' placeholder ranks, with the roofline terms at one H100's peaks.
"""Dry-run: one (architecture x input shape) cell, counted on ``meta``.

JAX lowers and compiles each cell onto 256 / 512 placeholder devices and
reads XLA's cost and memory analyses.  The port builds the cell's
parameters, optimizer state and batch as ``meta`` tensors
(``registry.abstract_params`` / ``abstract_train_state`` /
``input_specs``, which allocate nothing) and runs ``registry.make_step``'s
step on them once under :class:`Counter`:

  * **flops**: every aten product at ``torch.utils.flop_counter``'s
    formulas (a train step's remat recompute is counted, as XLA counts
    it), plus the attention kernels' calls, which the wrapper records on
    ``meta`` (``flash_attention.META_CALLS``), at
    :func:`attention_flops` / :func:`attention_bwd_flops`;
  * **bytes**: the operand and result bytes of every dispatched op that
    moves data (views, aliases and allocations move none): what eager
    PyTorch moves, since nothing is fused; plus the attention calls'
    :func:`attention_bytes` / :func:`attention_bwd_bytes` and, in float32,
    their splits' :func:`split_bytes`;
  * **memory**: the bytes of live storages that the step allocates
    (``weakref.finalize`` on each new storage) and their peak:
    ``per_device_bytes`` is ``argument`` (parameters, optimizer state,
    batch or cache), ``output`` (what the step returns beyond them),
    ``temp`` (the peak above the arguments) and ``peak``.

``lower_cell(..., multi_pod=False / True)`` counts the cell on JAX's
production meshes, 16 x 16 ("data", "model") and 2 x 16 x 16 ("pod",
"data", "model"): a ``"fake"`` process group of 256 / 512 ranks in this
process (``mesh.fake_device_mesh``), the parameters and optimizer state
DTensors under the rules, the batch and cache under JAX's input
shardings, over ``meta`` local shards, and the activation axes set as
JAX's ``lower_cell`` sets them (``registry.cell_axes``).  The count then
sees rank 0's local ops (DTensor's own dispatch is stepped through), so
flops, bytes and memory are per device, as XLA's ``cost_analysis`` and
``memory_analysis`` are, and flops and bytes are scaled by ``chips`` as
JAX scales them.  Every collective DTensor issues (``_c10d_functional`` /
``c10d_functional`` ops) is counted by kind under JAX's names
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``) at its result's bytes, times ``chips``: JAX's
``collective_bytes``.  A Shard -> Shard move is counted as the
all-to-all it is on the card (on the fake group's ``cpu`` mesh DTensor
would gather instead).  Without ``multi_pod`` (``None``) the count is of
one card (``MESH_NAME``), with no collectives.

Nothing is computed on ``meta``, as JAX's dry-run computes nothing: this
runs on any machine and is not a CPU fallback of a card path.  The terms
take one NVIDIA H100 SXM's peaks (NVIDIA's data sheet, dense, at 700 W):
bf16 GEMMs at 989 TFLOP/s, float32 GEMMs at 67 TFLOP/s (the port runs
them without TF32), the attention kernels at 989 TFLOP/s in bf16 and
989 / 6 in float32 (six bf16 plane products a float32 product), HBM at
3.35e12 B/s.  A cell's products are taken at its parameters' dtype.  The
collective term takes ``ICI_BW``, one direction of one card's NVLink 4
(450 GB/s), as JAX's takes one TPU link's: that is the rate within an
8-card NVLink node, and a 256- or 512-card mesh spans 32 or 64 such
nodes, whose links between nodes are slower, so the term is a lower
bound there.

What does not carry from JAX: ``_shape_bytes`` and the HLO text that
``collective_bytes`` parses (the port reads the collective ops
themselves), ``cost_analysis_dict`` and the ``XLA_FLAGS`` device count.
One process holds one default process group, so a production-mesh count
runs in a process of its own (this CLI, or a subprocess).

Usage (any machine)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch tinyllama-1.1b] [--shape train_4k] [--all] [--micro N] \\
        [--pod | --multi-pod | --both-meshes] [--json out.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import weakref
from typing import Any, Dict, Iterable, Mapping, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCH_IDS, get_config
from ..device import is_dtensor
from ..kernels import flash_attention as FA
from ..models import registry as R
from ..models import transformer as M
from ..models.config import SHAPES
from . import mesh as MS

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

# The functional collectives DTensor issues, under JAX's names.
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")


def _collective_kind(func) -> Optional[str]:
    name = func._overloadpacket.__name__
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return COLLECTIVES.get(name)
    return None


def _in_fake_mode() -> bool:
    """Whether a ``FakeTensorMode`` is active: DTensor runs each op once on
    fake tensors of the global shapes to learn its output's shape, which
    is not the local computation."""
    key = torch._C._TorchDispatchModeKey.FAKE
    return torch._C._get_dispatch_mode(key) is not None


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _storages(tensors) -> Dict[int, Any]:
    """id -> untyped storage of each tensor (a DTensor's local shard's;
    one entry a storage)."""
    out = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            s = _local(t).untyped_storage()
            out[id(s)] = s
    return out


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s tensors (local
    shards of DTensors)."""
    return sum(s.nbytes() for s in _storages(tree_leaves(tree)).values())


class Counter(TorchDispatchMode):
    """Counts, for every dispatched op, its flops (``flops``: the
    ``torch.utils.flop_counter`` formula of each product, an op without
    one decomposed where it decomposes, as ``FlopCounterMode`` counts),
    the bytes it moves (``bytes``: its tensor operands and results, unless
    it allocates only or its results alias its operands without mutating
    them), the bytes of the storages it allocates while they live
    (``live``, their peak ``peak``), and each collective's result bytes by
    kind (``collectives``).  An op on DTensors is not counted itself:
    DTensor's dispatch of it runs under the mode, which counts the local
    ops and collectives it issues; the ops it runs on fake tensors to
    propagate shapes are not counted.  Storages made outside the mode are
    not counted live."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collectives: Dict[str, int] = {}
        self._tracked: Dict[int, int] = {}
        self._inner = 0

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key)

    def _run(self, func, args, kwargs):
        """``func`` run: decomposed where it decomposes (its parts then
        come back here, flops only), else counted at its flop formula."""
        if func is not torch.ops.prim.device.default:
            self._inner += 1
            try:
                with self:
                    r = func.decompose(*args, **kwargs)
            finally:
                self._inner -= 1
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _in_fake_mode():
            return func(*args, **kwargs)
        leaves = tree_leaves((args, kwargs))
        if any(is_dtensor(t) for t in leaves):
            return NotImplemented       # DTensor's dispatch, under the mode
        if self._inner:
            return self._run(func, args, kwargs)
        kind = _collective_kind(func)
        out = func(*args, **kwargs) if kind else self._run(func, args,
                                                           kwargs)
        ins = _storages(leaves)
        outs = _storages(tree_leaves(out))
        for key, s in outs.items():
            if key not in ins and key not in self._tracked:
                self._tracked[key] = s.nbytes()
                self.live += s.nbytes()
                weakref.finalize(s, self._free, key)
        self.peak = max(self.peak, self.live)
        if kind:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                t.nbytes for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
            return out
        if func._overloadpacket.__name__ in _ALLOCATIONS:
            return out
        if not func._schema.is_mutable and outs and set(outs) <= set(ins):
            return out
        self.bytes += sum(t.nbytes for t in leaves
                          if isinstance(t, torch.Tensor))
        self.bytes += sum(t.nbytes for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def _alltoall_as_on_card():
    """DTensor's Shard -> Shard move issued as its all-to-all op (whose
    ``meta`` kernel the count runs), as on a CUDA mesh, where on a ``cpu``
    mesh it would gather and slice; a no-op where this PyTorch has no
    such hook."""
    import torch.distributed.tensor.placement_types as PT
    saved = getattr(PT, "shard_dim_alltoall", None)
    op = getattr(getattr(torch.ops, "_dtensor", None), "shard_dim_alltoall",
                 None)
    if saved is None or op is None:
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return op(input, gather_dim, shard_dim,
                  mesh.get_group(mesh_dim).group_name)
    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = saved


def count_step(step, *args) -> Dict[str, Any]:
    """Run ``step(*args)`` (meta tensors, or DTensors over meta shards)
    once under :class:`Counter`.  Returns the product flops, the op
    bytes, the attention calls the wrapper recorded, the collectives'
    bytes by kind, the live-byte peak above the arguments, the step's
    output bytes beyond them and the seconds the pass took: per device
    (rank 0's) on a mesh."""
    t0 = time.perf_counter()
    counter = Counter()
    FA.META_CALLS = calls = []
    try:
        with _alltoall_as_on_card(), counter:
            out = step(*args)
    finally:
        FA.META_CALLS = None
    argument = _storages(tree_leaves(args))
    output = sum(s.nbytes() for k, s in
                 _storages(tree_leaves(out)).items() if k not in argument)
    return {"product_flops": float(counter.flops),
            "op_bytes": counter.bytes, "attention_calls": calls,
            "collectives": dict(counter.collectives),
            "temp": counter.peak, "output": output,
            "count_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

MESH_NAME = "1"


def mesh_name(multi_pod: Optional[bool]) -> str:
    """``MESH_NAME`` (one card) for None, else JAX's production mesh's."""
    if multi_pod is None:
        return MESH_NAME
    return "2x16x16" if multi_pod else "16x16"


def meta_model(cfg, params) -> M.Transformer:
    """A ``Transformer`` on ``meta`` over the stacked meta tree
    ``params``."""
    dtype = next(iter(tree_leaves(params))).dtype
    return M.load_stacked(M.Transformer(cfg, device=META, dtype=dtype),
                          params)


def count_cell(cfg, shape, *, n_micro: int = 1,
               dtype: torch.dtype = torch.bfloat16, mesh=None, rules=None,
               batch_axes=None, head_axes="model") -> Dict[str, Any]:
    """:func:`count_step` of ``cfg``'s step at ``shape`` on meta tensors
    (parameters in ``dtype``), with its ``argument`` bytes.  ``mesh``: a
    ``DeviceMesh`` (``mesh.fake_device_mesh``) to count the step on, the
    parameters and optimizer state under ``rules``, the batch over
    ``batch_axes`` and the heads on ``head_axes``
    (``registry.make_step(mesh=)``); per device."""
    specs = {"train": R.train_input_specs,
             "prefill": R.prefill_input_specs,
             "decode": R.decode_input_specs}[shape.kind](cfg, shape)
    step = R.make_step(cfg, shape, n_micro=n_micro, device=META, mesh=mesh,
                       batch_axes=batch_axes, head_axes=head_axes)
    if mesh is not None:
        cache = specs.pop("cache", None)
        specs = R.shard_batch(specs, mesh, batch_axes)
        if cache is not None:
            specs["cache"] = R.shard_cache(cache, cfg, mesh)
    if shape.kind == "train":
        params, opt = R.abstract_train_state(cfg, dtype)
        model = meta_model(cfg, params)
        if mesh is not None:
            model = R.shard_model(model, cfg, mesh, rules)
            opt = R.shard_opt_state(opt, cfg, mesh, rules)
            params = M.stacked_params(model)
        args = (M.make_trainable(model), opt, specs)
        argument = storage_bytes((params, opt, specs))
    else:
        model = meta_model(cfg, R.abstract_params(cfg, dtype))
        if mesh is not None:
            model = R.shard_model(model, cfg, mesh, rules)
        args = (model, specs)
        argument = storage_bytes((M.stacked_params(model), specs))
    out = count_step(step, *args)
    out["argument"] = argument
    return out


def cell_costs(counted: Dict[str, Any], dtype_name: str,
               chips: int = 1) -> Dict[str, Any]:
    """Flops by ``PEAKS`` class, total flops and bytes of a counted cell,
    and its collectives' bytes by kind, each times ``chips`` (a per-device
    count made global, as JAX scales ``cost_analysis``)."""
    attn = attention_work(counted["attention_calls"])
    by_peak = {dtype_name: counted["product_flops"] * chips}
    for k, f in attn["flops"].items():
        by_peak[f"attention {k}"] = f * chips
    return {"flops_by_peak": by_peak, "flops": sum(by_peak.values()),
            "bytes": (counted["op_bytes"] + attn["bytes"]) * chips,
            "collectives": {k: float(b * chips) for k, b in
                            sorted(counted.get("collectives", {}).items())},
            "attention_calls": attn["calls"]}


def lower_cell(arch: str, shape_name, *, multi_pod: Optional[bool] = None,
               n_micro: int = 1, rules: Optional[Dict[str, Any]] = None,
               cfg_override=None, dtype: torch.dtype = torch.bfloat16,
               batch_axes_override=None,
               head_axes_override="model") -> Dict[str, Any]:
    """Count one (arch x shape x mesh) cell on ``meta``: the counterpart of
    JAX's ``lower_cell``.  ``multi_pod``: None counts one card
    (``MESH_NAME``, no collectives); False / True the 16 x 16 / 2 x 16 x 16
    production mesh on a fake group of 256 / 512 ranks, the activation
    axes set as JAX sets them (``batch_axes_override`` / 
    ``head_axes_override``), parameters and optimizer state under
    ``rules`` (default ``DEFAULT_RULES``).  ``shape_name``: a ``SHAPES``
    name or a ``ShapeConfig`` (a cut cell); ``cfg_override``: a
    depth-reduced config (``roofline.depth_variants``).  ``compile_s`` is
    the seconds the counting pass took; flops, bytes and collective bytes
    are global (per device times ``chips``), ``per_device_bytes`` rank 0's
    local shards and live storages."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    name = mesh_name(multi_pod)
    ok, why = R.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "skipped": True, "reason": why}
    if multi_pod is None:
        mesh, chips = None, 1
    else:
        shape_of = MS.make_production_mesh(multi_pod=multi_pod)
        mesh, chips = MS.fake_device_mesh(shape_of), shape_of.size
    counted = count_cell(cfg, shape, n_micro=n_micro, dtype=dtype,
                         mesh=mesh, rules=rules,
                         batch_axes=batch_axes_override,
                         head_axes=head_axes_override)
    dtype_name = str(dtype).split(".")[-1]
    costs = cell_costs(counted, dtype_name, chips)
    coll = sum(costs["collectives"].values())
    terms = roofline_terms(costs["flops_by_peak"], costs["bytes"], coll,
                           chips)
    mf = R.model_flops(cfg, shape)
    argument = counted["argument"]
    return {
        "arch": arch, "shape": shape_name, "mesh": name, "chips": chips,
        "skipped": False,
        "compile_s": round(counted["count_s"], 1),
        "hlo_flops": costs["flops"],
        "hlo_bytes": float(costs["bytes"]),
        "collective_bytes": float(coll),
        "collectives": costs["collectives"],
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


def meshes_of(args) -> list:
    """The CLI's meshes: ``--both-meshes`` both production meshes,
    ``--multi-pod`` 2 x 16 x 16, ``--pod`` 16 x 16, else one card."""
    if args.both_meshes:
        return [False, True]
    if args.multi_pod:
        return [True]
    return [False] if args.pod else [None]


def add_mesh_args(ap) -> None:
    ap.add_argument("--pod", action="store_true",
                    help="count on the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="count on the 2x16x16 production mesh")
    ap.add_argument("--both-meshes", action="store_true")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--json", default=None)
    add_mesh_args(ap)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes_of(args):
                try:
                    r = lower_cell(arch, shape, multi_pod=mp,
                                   n_micro=args.micro)
                except Exception as e:  # noqa: BLE001 — report, don't die
                    r = {"arch": arch, "shape": shape,
                         "mesh": mesh_name(mp),
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
