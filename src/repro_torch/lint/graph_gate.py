"""Layer 2 of the port's repro-lint: the replay's event keys at the
dispatcher, and on the card in their captured graphs.

The counterpart of ``tools/lint/jaxpr_gate.py``.  The JAX gate reads the
jaxpr XLA compiles; the port's replay is a fixed sequence of aten
operations per event key (``batched.Step.op``), which a ``Runner``
captures once as a CUDA graph and replays for every later event of the
key.  So the gate replays every policy (``policy_core.POLICY_IDS``) x
variant through the entry point that builds it, on a tiny mixed A30 +
A100 + H100 fixture (``mixed_fixture``, JAX's), and records under a
``TorchDispatchMode`` the operations each event's ``Step`` call
dispatches, keyed by the plan's keys (``batched.plan_events``):

* ``plain``: ``batched.make_replay`` on the padded trace;
* ``chunked``: ``streaming.make_chunked_replay`` in chunks of
  ``CHUNK_EVENTS``;
* ``sharded``: ``sharded.make_sharded_replay`` of ``NUM_SHARDS`` ranks
  (on the CPU two gloo ranks through ``sharded.spawn_fleet``; on one card
  one NCCL rank in this process);
* ``kernel`` (MCC and MECC only): ``make_replay`` on the fixture's
  single-model cut (``kernel_fixture``), where the arrivals score through
  the pick kernels (their plain versions on the CPU).

Four invariants:

1. **No float64 or complex tensor** among any operation's inputs or
   outputs, in any key.  Hard.
2. **No host synchronisation** (``aten._local_scalar_dense``, ``nonzero``,
   ``masked_select``, ``unique*``, boolean-mask indexing, a
   device-to-host copy) in any key the runner captures; GRMU's
   consolidating step-end ``(STEP_END, True)`` runs eagerly and is
   exempt.  Hard.
3. **Key invariance**: every event of one key dispatches the same
   operations with the same non-tensor arguments and tensor shapes (on
   the card, also the same as the capture).  Hard: it is the condition
   under which a graph captured from one event replays the next, and
   the one thing about capture a CPU run can show.
4. **Fingerprint**: per key, the operation-count multiset and the dtype
   set, against ``baselines.json``.  Hard under the torch version and
   device the baselines were written with, informational otherwise.

On the card (``device="cuda"``) the runner's graphs are also read (kept
with ``keep_graph=True``, walked through libcuda): each key's
kernel, memcpy and memset nodes, no device-to-host memcpy node in any
graph, and ``Runner.launches``: exactly one ``mcc_pick`` / ``ecc_pick``
per MCC / MECC arrival key of the kernel entries, none in any other key.
The replay through the graphs must equal the eager one.

Run as ``PYTHONPATH=src python -m repro_torch.lint``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

BASELINES_PATH = Path(__file__).with_name("baselines.json")

VARIANTS = ("plain", "chunked", "sharded")
KERNEL_POLICIES = ("MCC", "MECC")
CHUNK_EVENTS = 16          # smaller than the fixture's padded event count
NUM_SHARDS = 2

MIXED_MODELS = ("A30-24GB", "A100-40GB", "H100-80GB")

# Operations that read a device value on the host (by their packet name).
SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                      "_unique", "_unique2", "unique_dim",
                      "unique_consecutive", "unique_dim_consecutive"})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})


# ---------------------------------------------------------------------------
# Fixture
# ---------------------------------------------------------------------------

def mixed_fixture(models: Tuple[str, ...] = MIXED_MODELS):
    """Tiny deterministic mixed-fleet trace, JAX's (``tools/lint/
    jaxpr_gate.py``): 8 VMs over 6 GPUs (2 each of A30-24GB / A100-40GB /
    H100-80GB) on 3 hosts.  ``models`` names the three models the GPUs
    take in turn."""
    from ..core.batched import build_events_arrays
    from ..core.mig import DEVICE_MODELS
    from ..workload.alibaba import map_gpu_requirement_to_profile

    fleet = tuple(DEVICE_MODELS[n] for n in dict.fromkeys(models))
    mid = np.array([fleet.index(DEVICE_MODELS[models[i % 3]])
                    for i in range(6)], np.int32)
    u = np.array([0.10, 0.22, 0.48, 1.00, 0.30, 0.60, 0.14, 1.00])
    pids = np.stack(
        [map_gpu_requirement_to_profile(u, u_max=1.0, model=m)
         for m in fleet], axis=1).astype(np.int16)
    n = len(u)
    return build_events_arrays(
        arrival=np.array([0.2, 0.4, 1.1, 1.3, 2.2, 2.4, 3.1, 3.3]),
        duration=np.array([2.0, 5.0, 2.0, 3.0, 1.0, 2.0, 1.0, 1.0]),
        cpu=np.full(n, 2.0, np.float32),
        ram=np.full(n, 8.0, np.float32),
        vm_ids=np.arange(n),
        pids=pids,
        models=fleet,
        gpu_model_id=mid,
        gpu_host_id=np.array([0, 0, 1, 1, 2, 2], np.int32),
        cpu_cap=np.full(3, 32.0, np.float32),
        ram_cap=np.full(3, 128.0, np.float32))


def kernel_fixture():
    """The fixture's single-model cut (every GPU an A100-40GB): the
    fleet on which MCC and MECC arrivals score through the pick kernels."""
    return mixed_fixture(("A100-40GB",) * 3)


def policy_kwargs(policy_name: str) -> dict:
    # JAX's: GRMU with defrag on (its gated step-end), consolidation off.
    return {"defrag": True} if policy_name == "GRMU" else {}


def key_name(key: tuple) -> str:
    from ..core import batched as B
    if key[0] == B.ARRIVAL:
        return f"arrival(p={key[1]},pick={key[2]},heavy={int(key[3])})"
    if key[0] == B.DEPARTURE:
        return "departure"
    return f"step_end(consolidates={int(key[1])})"


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def _leaf(x):
    """A hashable description of one argument or result leaf."""
    if isinstance(x, torch.Tensor):
        return ("T", str(x.dtype), tuple(x.shape), x.device.type)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (torch.dtype, torch.device, torch.layout,
                      torch.memory_format)):
        return str(x)
    return type(x).__name__


class Op:
    """One dispatched operation: its name, a hashable signature (the
    leaves of its arguments, results left out), its tensors' dtypes and
    what it reveals: 64-bit or complex tensors, a host synchronisation."""

    def __init__(self, func, args, kwargs, out):
        self.name = str(func)
        ins = pytree.tree_leaves((args, kwargs))
        outs = pytree.tree_leaves(out)
        self.sig = (self.name, tuple(_leaf(x) for x in ins))
        t_in = [x for x in ins if isinstance(x, torch.Tensor)]
        t_out = [x for x in outs if isinstance(x, torch.Tensor)]
        tensors = t_in + t_out
        self.dtypes = {str(t.dtype) for t in tensors}
        self.wide = sorted({str(t.dtype) for t in tensors
                            if t.dtype == torch.float64 or t.is_complex()})
        packet = func._overloadpacket.__name__
        self.sync = None
        if packet in SYNC_OPS:
            self.sync = packet
        elif packet in _INDEX_OPS and any(
                isinstance(x, torch.Tensor)
                and x.dtype in (torch.bool, torch.uint8)
                for x in pytree.tree_leaves(args[1:2])):
            self.sync = "boolean-mask index"
        elif any(t.device.type == "cuda" for t in t_in) and any(
                t.device.type == "cpu" for t in t_out + (
                    t_in[:1] if packet == "copy_" else [])):
            self.sync = "device-to-host copy"


class Recorder(TorchDispatchMode):
    """Records the operations dispatched while ``self.event`` is a list
    (an event's), and nothing else."""

    def __init__(self):
        super().__init__()
        self.event: Optional[List[Op]] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.event is not None:
            self.event.append(Op(func, args, kwargs, out))
        return out


class KeyRecords:
    """Each key's recorded events (``events``), and on the card its
    capture (``captures``): :meth:`wrap` makes the runner's step hand out
    recording calls, so the runner's own loop records them."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.events: Dict[tuple, List[List[Op]]] = {}
        self.captures: Dict[tuple, List[Op]] = {}

    def wrap(self, runner) -> None:
        """Shadow ``runner.step.op`` (``del runner.step.op`` restores it)."""
        op = runner.step.op
        runner.step.op = lambda key: self._recorded(runner, key, op(key))

    def _recorded(self, runner, key, fn) -> Callable[[], None]:
        from ..core import batched as B

        def call():
            ops: Optional[List[Op]] = []
            if runner.graphed and torch.cuda.is_current_stream_capturing():
                self.captures[key] = ops
            elif runner.graphed and key not in runner.graphs and \
                    key != (B.STEP_END, True):
                ops = None           # the capture's eager warm-up
            else:
                self.events.setdefault(key, []).append(ops)
            outer, self.rec.event = self.rec.event, ops
            try:
                fn()
            finally:
                self.rec.event = outer
        return call


# ---------------------------------------------------------------------------
# The card's graphs
# ---------------------------------------------------------------------------

# CUgraphNodeType and CUmemorytype (cuda.h).
_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}
_MEM_HOST, _MEM_UNIFIED = 1, 4
_ATTR_MEMORY_TYPE = 2


class _Memcpy3D(ctypes.Structure):
    """``CUDA_MEMCPY3D`` (cuda.h)."""
    _S, _U, _P, _D = (ctypes.c_size_t, ctypes.c_uint, ctypes.c_void_p,
                      ctypes.c_uint64)
    _fields_ = [("srcXInBytes", _S), ("srcY", _S), ("srcZ", _S),
                ("srcLOD", _S), ("srcMemoryType", _U), ("srcHost", _P),
                ("srcDevice", _D), ("srcArray", _P), ("reserved0", _P),
                ("srcPitch", _S), ("srcHeight", _S),
                ("dstXInBytes", _S), ("dstY", _S), ("dstZ", _S),
                ("dstLOD", _S), ("dstMemoryType", _U), ("dstHost", _P),
                ("dstDevice", _D), ("dstArray", _P), ("reserved1", _P),
                ("dstPitch", _S), ("dstHeight", _S),
                ("WidthInBytes", _S), ("Height", _S), ("Depth", _S)]


def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    P = ctypes.c_void_p
    for name, args in (("cuGraphGetNodes", [P, P, P]),
                       ("cuGraphNodeGetType", [P, P]),
                       ("cuGraphMemcpyNodeGetParams", [P, P]),
                       ("cuPointerGetAttribute", [P, ctypes.c_int,
                                                  ctypes.c_uint64])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: libcuda error {rc}")


def graph_nodes(graph, drv=None) -> Dict[str, int]:
    """A captured graph's nodes by kind (``kernel``, ``memcpy``,
    ``memset``, ``other``) and its device-to-host memcpy nodes
    (``memcpy_to_host``).  The graph must have been built with
    ``keep_graph=True``."""
    drv = drv or _libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(drv.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(drv.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0,
           "memcpy_to_host": 0}
    for node in nodes:
        kind = ctypes.c_uint(0)
        _check(drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
               "cuGraphNodeGetType")
        out[_NODE_KINDS.get(kind.value, "other")] += 1
        if kind.value != 1:
            continue
        p = _Memcpy3D()
        _check(drv.cuGraphMemcpyNodeGetParams(ctypes.c_void_p(node),
                                              ctypes.byref(p)),
               "cuGraphMemcpyNodeGetParams")
        dst = p.dstMemoryType
        if dst == _MEM_UNIFIED:
            mt = ctypes.c_uint(0)
            rc = drv.cuPointerGetAttribute(ctypes.byref(mt),
                                           _ATTR_MEMORY_TYPE, p.dstDevice)
            dst = mt.value if rc == 0 else _MEM_HOST   # unregistered: host
        out["memcpy_to_host"] += dst == _MEM_HOST
    return out


@contextlib.contextmanager
def kept_graphs():
    """Within, every ``torch.cuda.CUDAGraph`` keeps its ``cudaGraph_t``
    (``keep_graph=True``), so :func:`graph_nodes` can read it; it is
    instantiated at its first replay."""
    orig = torch.cuda.CUDAGraph

    class Kept(orig):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = orig


# ---------------------------------------------------------------------------
# One entry: a policy x variant
# ---------------------------------------------------------------------------

def build_run(policy_name: str, variant: str, device: torch.device,
              num_shards: int = NUM_SHARDS):
    """``(run, heavy capacity)``: the entry point's replay of ``variant``
    for ``policy_name`` on its fixture.  ``sharded`` runs this rank of
    a ``num_shards``-rank fleet (``sharded.fleet_group``)."""
    from ..core import batched as B
    from ..core import policy_core as pc
    from ..core import sharded as SH
    from ..core import streaming as ST
    from ..core.bucketing import pad_events
    pid, kw = pc.POLICY_IDS[policy_name], policy_kwargs(policy_name)
    if variant == "plain":
        ev = pad_events(mixed_fixture())
        run = B.make_replay(ev, pid, device, **kw)
    elif variant == "chunked":
        run = ST.make_chunked_replay(mixed_fixture(), pid,
                                     chunk_events=CHUNK_EVENTS,
                                     device=device, **kw)
        ev = run.events
    elif variant == "sharded":
        ev = pad_events(mixed_fixture(), shards=NUM_SHARDS)
        run = SH.make_sharded_replay(ev, pid, num_shards, device, **kw)
    elif variant == "kernel":
        ev = pad_events(kernel_fixture())
        run = B.make_replay(ev, pid, device, **kw)
        if run.runner.st.score_backend != "kernel":
            raise AssertionError(f"{policy_name}:kernel scores through "
                                 f"{run.runner.st.score_backend!r}")
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return run, B.default_heavy_capacity(ev)


def _same_outputs(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def trace_entry(policy_name: str, variant: str, device: torch.device,
                num_shards: int = NUM_SHARDS) -> dict:
    """Replay one policy x variant with its step's operations recorded.
    Returns {"keys": {key name: {"events": [[Op]], "capture": [Op] or
    None, "exempt": bool, "launches", "nodes"}}, "graphs_equal_eager"}."""
    from ..core import batched as B
    from ..kernels import mask_scores
    run, cap = build_run(policy_name, variant, device, num_shards)
    runner, keys = run.runner, run.plan.keys
    rec = Recorder()
    records = KeyRecords(rec)
    saved_launches = dict(mask_scores.LAUNCHES)
    result = {"graphs_equal_eager": None}
    records.wrap(runner)
    try:
        if runner.graphed:
            runner.close()
            with kept_graphs(), rec:
                graphed = run(cap)
            captured = dict(records.captures)
            graphs, launches = runner.graphs, runner.launches
            drv = _libcuda()
            nodes = {k: graph_nodes(g, drv) for k, g in graphs.items()}
            # The same replay with every key eager: the events' records.
            records.events.clear()
            runner.graphs, runner.launches, runner.graphed = {}, {}, False
            try:
                with rec:
                    eager = run(cap)
            finally:
                runner.graphs, runner.launches = graphs, launches
                runner.graphed = True
            result["graphs_equal_eager"] = _same_outputs(graphed, eager)
        else:
            captured, launches, nodes = {}, {}, {}
            with rec:
                run(cap)
    finally:
        del runner.step.op
        mask_scores.LAUNCHES.update(saved_launches)
    result["keys"] = {
        key_name(k): {"key": k, "events": records.events.get(k, []),
                      "capture": captured.get(k),
                      "exempt": k == (B.STEP_END, True),
                      "launches": launches.get(k),
                      "nodes": nodes.get(k)}
        for k in dict.fromkeys(keys)}
    return result


def fingerprint(ops: List[Op]) -> dict:
    counts: Dict[str, int] = {}
    dtypes = set()
    for op in ops:
        counts[op.name] = counts.get(op.name, 0) + 1
        dtypes |= op.dtypes
    return {"ops": dict(sorted(counts.items())), "dtypes": sorted(dtypes)}


def check_entry(entry: str, traced: dict, device: torch.device
                ) -> Tuple[List[str], Dict[str, dict]]:
    """The hard invariants of one traced entry: (errors, {key name:
    fingerprint, with the event count and on the card the nodes and
    launches})."""
    from ..core import batched as B
    errors: List[str] = []
    out: Dict[str, dict] = {}
    policy, variant = entry.split(":")
    pick = {"MCC": "mcc_pick", "MECC": "ecc_pick"}.get(policy)
    if traced["graphs_equal_eager"] is False:
        errors.append(f"{entry}: the replay through the captured graphs "
                      "differs from the eager replay")
    for name, k in traced["keys"].items():
        events, capture = k["events"], k["capture"]
        where = f"{entry} {name}"
        if not events:
            errors.append(f"{where}: no event recorded")
            continue
        for ops in events + ([capture] if capture else []):
            for op in ops:
                if op.wide:
                    errors.append(f"{where}: {op.name} on {op.wide} "
                                  "tensors (no float64 or complex in the "
                                  "step)")
                if op.sync and not k["exempt"]:
                    errors.append(f"{where}: {op.name} is a host "
                                  f"synchronisation ({op.sync}) in a "
                                  "captured key")
        first = [op.sig for op in events[0]]
        for i, ops in enumerate(events[1:], 1):
            if [op.sig for op in ops] != first:
                errors.append(f"{where}: event {i} dispatches other "
                              "operations or arguments than event 0 — a "
                              "graph captured from one event would replay "
                              f"the wrong one ({_first_diff(events[0], ops)})")
        if capture is not None and [op.sig for op in capture] != first:
            errors.append(f"{where}: the capture dispatches other operations "
                          f"than the events ({_first_diff(events[0], capture)})")
        fp = fingerprint(events[0])
        fp["events"] = len(events)
        if device.type == "cuda" and not k["exempt"]:
            nodes, launches = k["nodes"], k["launches"]
            if nodes is None:
                errors.append(f"{where}: no captured graph")
            else:
                fp["nodes"] = nodes
                if nodes["memcpy_to_host"]:
                    errors.append(f"{where}: {nodes['memcpy_to_host']} "
                                  "device-to-host memcpy node(s) in its "
                                  "graph")
            want = ({pick: 1} if variant == "kernel"
                    and k["key"][0] == B.ARRIVAL else {})
            fp["launches"] = launches or {}
            if (launches or {}) != want:
                errors.append(f"{where}: kernel launches {launches or {}} "
                              f"in its graph, expected {want}")
        out[name] = fp
    return errors, out


def _first_diff(a: List[Op], b: List[Op]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x.sig != y.sig:
            return f"op {i}: {x.sig} vs {y.sig}"
    return f"{len(a)} vs {len(b)} ops"


def entries() -> List[str]:
    from ..core import policy_core as pc
    names = [n for n, _ in sorted(pc.POLICY_IDS.items(),
                                  key=lambda kv: kv[1])]
    out = [f"{n}:{v}" for n in names for v in VARIANTS]
    return out + [f"{n}:kernel" for n in names if n in KERNEL_POLICIES]


def gate_entries(names: List[str], device: torch.device,
                 num_shards: int = NUM_SHARDS
                 ) -> Tuple[List[str], Dict[str, dict]]:
    """Trace and check ``names`` in this process."""
    errors: List[str] = []
    results: Dict[str, dict] = {}
    for entry in names:
        policy, variant = entry.split(":")
        traced = trace_entry(policy, variant, device, num_shards)
        errs, results[entry] = check_entry(entry, traced, device)
        errors += errs
    return errors, results


def sharded_rank(names: List[str], device=None):
    """One rank of the sharded entries (``sharded.spawn_fleet``): every
    rank checks its own records; the ranks' errors are pooled, so every
    rank returns the same result."""
    import torch.distributed as dist
    errors, results = gate_entries(names, torch.device(device),
                                   dist.get_world_size())
    pooled: List[Optional[List[str]]] = [None] * dist.get_world_size()
    dist.all_gather_object(pooled, errors)
    return sorted({e for errs in pooled for e in errs}), results


def _sharded(names: List[str], device: torch.device
             ) -> Tuple[List[str], Dict[str, dict]]:
    """The sharded entries: ``NUM_SHARDS`` gloo ranks on the CPU; on the
    card one NCCL rank in this process (one card), its group destroyed
    after unless it was there before."""
    from ..core import sharded as SH
    if device.type == "cpu":
        return SH.spawn_fleet(sharded_rank, NUM_SHARDS, names, device="cpu",
                              timeout=300.0)
    import torch.distributed as dist
    had_group = dist.is_initialized()
    try:
        return gate_entries(names, device, num_shards=1)
    finally:
        from ..core import compile_cache
        compile_cache.clear_cache()
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Baselines + gate
# ---------------------------------------------------------------------------

def load_baselines(path: Path = BASELINES_PATH) -> Optional[dict]:
    return json.loads(path.read_text()) if path.exists() else None


def save_baselines(results: Dict[str, dict], path: Path = BASELINES_PATH
                   ) -> None:
    payload = {
        "_comment": ("repro-lint graph-gate fingerprints: per policy x "
                     "variant and event key, the aten operation counts and "
                     "dtypes its Step call dispatches on the CPU.  "
                     "Regenerate with `PYTHONPATH=src python -m "
                     "repro_torch.lint --device cpu --update-baselines` "
                     "and review the diff (drift = the step dispatches "
                     "other operations than the pinned one)."),
        "torch_version": torch.__version__,
        "device": "cpu",
        "entries": {e: {k: {"ops": fp["ops"], "dtypes": fp["dtypes"]}
                        for k, fp in sorted(results[e].items())}
                    for e in sorted(results)},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def compare_baselines(results: Dict[str, dict], baselines: Optional[dict],
                      device: torch.device) -> Tuple[List[str], List[str]]:
    """(errors, notes) of the fingerprints against the baselines: hard
    under the baselines' torch version and device, notes otherwise."""
    errors: List[str] = []
    notes: List[str] = []
    if baselines is None:
        return [f"no baselines pinned ({BASELINES_PATH.name}); run with "
                "--device cpu --update-baselines"], notes
    same = (baselines.get("torch_version") == torch.__version__
            and baselines.get("device") == device.type)
    if not same:
        notes.append(
            f"baselines written under torch {baselines.get('torch_version')}"
            f" on {baselines.get('device')}, running torch "
            f"{torch.__version__} on {device.type}: fingerprint drift is "
            "informational (the other invariants stay hard)")
    base = baselines.get("entries", {})
    for entry, keys in sorted(results.items()):
        for name, fp in sorted(keys.items()):
            want = base.get(entry, {}).get(name)
            if want is None:
                msg = f"{entry} {name}: no baseline pinned"
            elif fp["ops"] != want["ops"] or fp["dtypes"] != want["dtypes"]:
                drift = {op: (want["ops"].get(op, 0), fp["ops"].get(op, 0))
                         for op in set(want["ops"]) | set(fp["ops"])
                         if want["ops"].get(op, 0) != fp["ops"].get(op, 0)}
                msg = (f"{entry} {name}: fingerprint mismatch (op counts "
                       f"drifted {drift}; dtypes {want['dtypes']} -> "
                       f"{fp['dtypes']})")
            else:
                continue
            (errors if same else notes).append(msg)
    return errors, notes


def run_gate(device, update: bool = False,
             names: Optional[List[str]] = None,
             baselines_path: Path = BASELINES_PATH
             ) -> Tuple[List[str], List[str], Dict[str, dict]]:
    """Trace and check ``names`` (default: every entry) on ``device``;
    compare with (or, with ``update``, write) the baselines.  Returns
    (errors, notes, {entry: {key name: fingerprint}})."""
    from ..device import resolve_device
    device = resolve_device(device)
    names = list(entries() if names is None else names)
    local = [n for n in names if not n.endswith(":sharded")]
    errors, results = gate_entries(local, device)
    sharded = [n for n in names if n.endswith(":sharded")]
    if sharded:
        errs, res = _sharded(sharded, device)
        errors += errs
        results.update(res)
    notes: List[str] = []
    if update:
        if device.type != "cpu":
            raise ValueError("baselines are written on the CPU")
        save_baselines(results, baselines_path)
        notes.append(f"baselines written: {baselines_path} "
                     f"({len(results)} entries)")
    else:
        errs, notes = compare_baselines(
            results, load_baselines(baselines_path), device)
        errors += errs
    return errors, notes, {n: results[n] for n in names}


def node_lines(results: Dict[str, dict]) -> List[str]:
    """One line per captured key: its graph's kernel, memcpy and memset
    nodes (card results only)."""
    lines = []
    for entry, keys in results.items():
        for name, fp in keys.items():
            nodes = fp.get("nodes")
            if nodes is not None:
                lines.append(
                    f"{entry} {name}: {nodes['kernel']} kernel, "
                    f"{nodes['memcpy']} memcpy ({nodes['memcpy_to_host']} "
                    f"to the host), {nodes['memset']} memset, "
                    f"{nodes['other']} other nodes; launches "
                    f"{fp['launches']}; {fp['events']} event(s)")
    return lines


__all__ = ["mixed_fixture", "kernel_fixture", "entries", "run_gate",
           "trace_entry", "check_entry", "fingerprint", "graph_nodes",
           "node_lines", "VARIANTS", "CHUNK_EVENTS", "NUM_SHARDS"]
