"""Trace replay in PyTorch — port of ``repro/core/batched.py``.

The same event stream (departure | arrival | step-end, in within-bucket
order) is replayed through the same decisions as the JAX ``lax.scan``,
with the cluster state held in a dict of tensors on one device, updated
in place.

Each event kind is a fixed sequence of device operations
(:class:`Step`): the event's VM or step index and its time are read from
device-resident event rows at a device cursor that each event advances,
GRMU's basket capacities are device scalars, MECC's expiry is a
fixed-width masked scatter from a device pointer and GRMU's defrag is
gated on the device ``rej`` flag.  What stays on the host is the event's
kind and the values of its key: the reference profile (the counts row
and the pick kernel's profile argument) and GRMU's heavy flag.  So the
host walks the event kinds and launches one operation sequence per
event, and no event's value comes back to the host, except at GRMU's
consolidations: ``policy_core.consolidation_plan`` walks its candidates
on the host (one synchronisation each), and whether one is due is
decided on the host from the static event times.

The entry points (:func:`make_replay`, ``repro_torch.core.streaming``)
replay through a :class:`Runner` from the replay compile cache
(:mod:`.compile_cache`): on the card each key's sequence is captured once
as a CUDA graph and each event costs the host one graph launch; on the
CPU the same step runs eagerly.  :func:`run_events` is the eager loop
over a caller's state, which the graphs are held against.

Scoring: ``score_backend="tables"`` gathers from the per-model mask
tables (``policy_core``); ``"kernel"`` scores MCC/MECC arrivals with the
CUDA kernels of :mod:`repro_torch.kernels.mask_scores` (on a CPU device,
their plain versions), ``"auto"`` picks ``"kernel"`` for MCC/MECC on a
single-model fleet.

Telemetry (``telemetry=True``, :mod:`repro_torch.obs.inscan`) adds the
decision code of each arrival as a 4th ``vmrow`` column and, at each
step-end, the migration and basket counters and the free masks into the
step-indexed ``tele_steps`` / ``tele_masks`` state; it reads decision
state only, so every decision is the same as with telemetry off, and it
adds no host synchronisation.  With telemetry off none of its
operations runs.

Within each step (1 h bucket): departures are processed first, then
arrivals, then the step-end hook (defrag -> consolidation -> metrics);
scans resolve ties by lowest globalIndex.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels import mask_scores
from ..obs import inscan as obs_inscan
from ..obs import reasons as obs_reasons
from ..sim.cluster import VM, Cluster
from ..sim.metrics import SimResult
from .mig import A100_40GB, DeviceModel, PROFILE_INDEX
from . import compile_cache
from . import policy_core as pc

FF, BF, MCC, MECC, GRMU = pc.FF, pc.BF, pc.MCC, pc.MECC, pc.GRMU

# Event kinds, in within-bucket processing order.  PAD rows are a no-op.
DEPARTURE, ARRIVAL, STEP_END, PAD = 0, 1, 2, 3

# Basket label of GPUs that only exist as shape padding.
PAD_BASKET = -1

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Event stream (numpy; copied from the JAX package's module)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EventTrace:
    """Host-precomputed event stream + static cluster/VM metadata.

    The big arrays are bit-packed: event kinds are ``uint8`` and profile
    indices ``int16``, with ``int32`` for VM/GPU indices.  The replay
    widens them before any decision arithmetic or indexing."""
    # Per-event rows (E,), sorted by (bucket, kind, time, vm_id):
    kind: np.ndarray         # uint8: DEPARTURE | ARRIVAL | STEP_END | PAD
    vm_index: np.ndarray     # int32 dense 0..N-1 (0 for step-end rows)
    profile: np.ndarray      # int16 reference-model profile (0 for step-end)
    time: np.ndarray         # float32 step start t of the row's bucket
    idx: np.ndarray          # int32: arrival order (arrivals),
    #                          step index (step ends), 0 otherwise
    # Static per-VM arrays in dense (arrival, vm_id) order (N,):
    vm_ids: np.ndarray       # int64 original vm_id per dense index
    vm_pids: np.ndarray      # (N, M) int16 profile per fleet model
    vm_heavy: np.ndarray     # (N,) bool — full-GPU request on every model
    vm_cpu: np.ndarray       # float32
    vm_ram: np.ndarray       # float32
    # MECC observation schedule over *included* arrivals (A,):
    arr_times: np.ndarray    # float32 observation time (bucket start)
    arr_pids: np.ndarray     # (A, M) int16 profile per fleet model
    # Step sampling times (S,):
    step_times: np.ndarray   # float64
    # Cluster shape:
    num_vms: int
    num_gpus: int
    num_hosts: int
    models: Tuple[DeviceModel, ...]  # fleet models; [0] is the reference
    gpu_model_id: np.ndarray  # (G,) int32 index into models
    gpu_host_id: np.ndarray  # (G,) int32
    cpu_cap: np.ndarray      # (H,) float32
    ram_cap: np.ndarray      # (H,) float32
    step_hours: float = 1.0
    # Padded metric-buffer rows (None = len(step_times), i.e. unpadded).
    hourly_slots: Optional[int] = None


def step_grid(horizon: float, step_hours: float) -> np.ndarray:
    """Exactly the sequential engine's sampling loop (accumulated float64
    grid, inclusive of the first step at/after ``horizon``)."""
    times = []
    t = 0.0
    while t < horizon + _EPS:
        times.append(t)
        t += step_hours
    return np.asarray(times, np.float64)


def build_events_arrays(*, arrival: np.ndarray, duration: np.ndarray,
                        cpu: np.ndarray, ram: np.ndarray,
                        vm_ids: np.ndarray, pids: np.ndarray,
                        models: Tuple[DeviceModel, ...],
                        gpu_model_id: np.ndarray, gpu_host_id: np.ndarray,
                        cpu_cap: np.ndarray, ram_cap: np.ndarray,
                        step_hours: float = 1.0,
                        horizon: Optional[float] = None) -> EventTrace:
    """Vectorized trace lowering from plain arrays (no VM objects).
    ``pids`` is (N, M): each VM's Eq. 27-30 profile per fleet model."""
    arrival = np.asarray(arrival, np.float64).reshape(-1)
    duration = np.asarray(duration, np.float64).reshape(-1)
    n = arrival.shape[0]
    if n >= np.iinfo(np.int32).max:
        raise ValueError(f"trace has {n} VMs; int32 VM indices overflow")
    M = len(models)
    pids = (np.asarray(pids, np.int16).reshape(n, M) if n
            else np.zeros((0, M), np.int16))
    vm_ids = np.asarray(vm_ids, np.int64).reshape(-1)
    cpu = np.asarray(cpu, np.float32).reshape(-1)
    ram = np.asarray(ram, np.float32).reshape(-1)

    # Dense (arrival, vm_id) order — the engines' globalIndex order.
    order = np.lexsort((vm_ids, arrival))
    arrival, duration = arrival[order], duration[order]
    vm_ids, pids = vm_ids[order], pids[order]
    cpu, ram = cpu[order], ram[order]
    del order
    departure = arrival + duration

    # Heavy iff the request maps to the full-GPU profile on EVERY model.
    hp = np.array([m.heavy_profile for m in models], np.int16)
    heavy = (np.all((pids == hp[None, :]) & (hp[None, :] >= 0), axis=1)
             if n else np.zeros(0, bool))

    if horizon is None:
        horizon = (float(arrival.max()) if n else 0.0) + step_hours
    st64 = step_grid(horizon, step_hours)
    S = len(st64)

    ab = np.floor((arrival + _EPS) / step_hours).astype(np.int32)
    db = (np.ceil((departure + _EPS) / step_hours).astype(np.int32) - 1)
    # A same-bucket departure is heap-popped one bucket later (the heap
    # push happens after the bucket's departure phase).
    db = np.maximum(db, ab + 1)
    inc = ab < S            # past-horizon arrivals are never offered
    dep_inc = inc & (db < S)
    a_ord = np.cumsum(inc, dtype=np.int32) - 1

    dense = np.arange(n, dtype=np.int32)
    ref_p = pids[:, 0] if n else np.zeros(0, np.int16)
    # Sort tiebreak: vm_ids, at int32 when the id range allows it.
    tb = (vm_ids.astype(np.int32)
          if n == 0 or (vm_ids.min() >= np.iinfo(np.int32).min
                        and vm_ids.max() <= np.iinfo(np.int32).max)
          else vm_ids)

    def rows(sel, kind, t_actual, tiebreak, bucket, idx):
        return dict(bucket=bucket[sel],
                    kind=np.full(int(sel.sum()), kind, np.uint8),
                    t=t_actual[sel], tb=tiebreak[sel],
                    vm=dense[sel], p=ref_p[sel],
                    idx=idx[sel])

    arr = rows(inc, ARRIVAL, arrival, tb, ab, a_ord)
    dep = rows(dep_inc, DEPARTURE, departure, tb, db,
               np.zeros(n, np.int32))
    si = np.arange(S, dtype=np.int32)
    stp = dict(bucket=si, kind=np.full(S, STEP_END, np.uint8),
               t=np.full(S, np.inf), tb=np.zeros(S, tb.dtype),
               vm=np.zeros(S, np.int32), p=np.zeros(S, np.int16), idx=si)

    cat = {k: np.concatenate([arr[k], dep[k], stp[k]]) for k in arr}
    del arr, dep, stp
    perm = np.lexsort((cat["tb"], cat["t"], cat["kind"], cat["bucket"]))
    for k in cat:
        cat[k] = cat[k][perm]
    del perm

    return EventTrace(
        kind=cat["kind"],
        vm_index=cat["vm"],
        profile=cat["p"],
        time=st64[cat["bucket"]].astype(np.float32),
        idx=cat["idx"],
        vm_ids=vm_ids,
        vm_pids=pids,
        vm_heavy=heavy,
        vm_cpu=cpu,
        vm_ram=ram,
        arr_times=st64[ab[inc]].astype(np.float32),
        arr_pids=pids[inc],
        step_times=st64,
        num_vms=n,
        num_gpus=len(gpu_model_id), num_hosts=len(cpu_cap),
        models=tuple(models),
        gpu_model_id=np.asarray(gpu_model_id, np.int32),
        gpu_host_id=np.asarray(gpu_host_id, np.int32),
        cpu_cap=np.asarray(cpu_cap, np.float32),
        ram_cap=np.asarray(ram_cap, np.float32),
        step_hours=step_hours)


def build_events(vms: List[VM], cluster: Union[Cluster, int],
                 step_hours: float = 1.0,
                 horizon: Optional[float] = None) -> EventTrace:
    """Lower a VM list + cluster onto the replay's event stream.

    ``cluster`` may be a ``Cluster`` (host topology + CPU/RAM caps +
    fleet device models are honored) or a bare GPU count (one
    unconstrained A100-40GB host per GPU).  ``horizon`` defaults to the
    sequential engine's (max arrival + step)."""
    if isinstance(cluster, Cluster):
        num_gpus = cluster.num_gpus
        num_hosts = len(cluster.hosts)
        models = cluster.models
        gpu_model_id = cluster.gpu_model_id.astype(np.int32)
        gpu_host_id = cluster.gpu_host_id.astype(np.int32)
        cpu_cap = cluster.host_cpu_cap.copy()
        ram_cap = cluster.host_ram_cap.copy()

        def pids_of(vm: VM) -> np.ndarray:
            return cluster.vm_pids(vm)
    else:
        num_gpus = int(cluster)
        num_hosts = num_gpus
        models = (A100_40GB,)
        gpu_model_id = np.zeros(num_gpus, dtype=np.int32)
        gpu_host_id = np.arange(num_gpus, dtype=np.int32)
        cpu_cap = np.full(num_hosts, np.inf, dtype=np.float32)
        ram_cap = np.full(num_hosts, np.inf, dtype=np.float32)

        def pids_of(vm: VM) -> np.ndarray:
            return np.array([PROFILE_INDEX[vm.profile.name]], np.int32)

    M = len(models)
    all_pids = (np.stack([pids_of(v) for v in vms])
                if vms else np.zeros((0, M), np.int32)).astype(np.int32)
    return build_events_arrays(
        arrival=np.array([v.arrival for v in vms], np.float64),
        duration=np.array([v.duration for v in vms], np.float64),
        cpu=np.array([v.cpu for v in vms], np.float32),
        ram=np.array([v.ram for v in vms], np.float32),
        vm_ids=np.array([v.vm_id for v in vms], np.int64),
        pids=all_pids, models=tuple(models),
        gpu_model_id=gpu_model_id, gpu_host_id=gpu_host_id,
        cpu_cap=cpu_cap, ram_cap=ram_cap,
        step_hours=step_hours, horizon=horizon)


# ---------------------------------------------------------------------------
# Replay statics, trace and state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplayStatics:
    """Everything the replay step specializes on."""
    policy: int
    models: Tuple[DeviceModel, ...]
    defrag: bool = True
    consolidation_interval: Optional[float] = None
    defrag_trigger: str = "light"
    mecc_window: float = 24.0
    # "tables" = per-model mask-table gathers; "kernel" = MCC/MECC scoring
    # through the CUDA kernels (their plain versions on a CPU device).
    score_backend: str = "tables"
    # In-replay telemetry (repro_torch.obs.inscan).  Off by default.
    telemetry: bool = False


def replay_statics(events: EventTrace, policy: int, *,
                   defrag: bool = True,
                   consolidation_interval: Optional[float] = None,
                   defrag_trigger: str = "light",
                   mecc_window: float = 24.0,
                   score_backend: str = "auto",
                   telemetry: bool = False,
                   num_shards: int = 0) -> ReplayStatics:
    """Resolve user cfg (including ``score_backend="auto"``) against the
    trace's fleet into a hashable :class:`ReplayStatics`."""
    if num_shards:
        raise NotImplementedError("sharded replay is not ported yet")
    kernel_ok = policy in (MCC, MECC) and len(events.models) == 1
    if score_backend == "auto":
        score_backend = "kernel" if kernel_ok else "tables"
    if score_backend not in ("tables", "kernel"):
        raise ValueError(f"unknown score_backend {score_backend!r}; "
                         "expected 'tables', 'kernel' or 'auto'")
    if score_backend == "kernel" and not kernel_ok:
        raise ValueError(
            "score_backend='kernel' needs policy MCC/MECC on a single-model "
            f"fleet (got policy={policy}, M={len(events.models)})")
    return ReplayStatics(
        policy=policy, models=tuple(events.models), defrag=defrag,
        consolidation_interval=consolidation_interval,
        defrag_trigger=defrag_trigger, mecc_window=mecc_window,
        score_backend=score_backend, telemetry=telemetry)


def _gpu_full(events: EventTrace) -> np.ndarray:
    """Per-GPU all-free mask; 0 on padded GPUs."""
    full = np.array([m.full_mask for m in events.models], np.int32)
    out = full[events.gpu_model_id]
    out[events.num_gpus:] = 0
    return out


def trace_arrays(events: EventTrace) -> Dict[str, np.ndarray]:
    """The trace as a dict of numpy arrays — the same keys, dtypes and
    padding as the JAX package's ``trace_arrays``."""
    M = len(events.models)
    n_vm_rows = len(events.vm_pids)
    return dict(
        kind=np.clip(events.kind, 0, 3).astype(np.uint8),
        vm_index=events.vm_index.astype(np.int32),
        profile=events.profile.astype(np.int16),
        time=events.time.astype(np.float32),
        idx=events.idx.astype(np.int32),
        vm_pids=(events.vm_pids.astype(np.int16) if n_vm_rows
                 else np.zeros((1, M), np.int16)),
        vm_heavy=(events.vm_heavy.astype(bool) if n_vm_rows
                  else np.zeros(1, bool)),
        vm_res=(np.stack([events.vm_cpu, events.vm_ram],
                         axis=1).astype(np.float32) if n_vm_rows
                else np.zeros((1, 2), np.float32)),
        gpu_mid=events.gpu_model_id.astype(np.int32),
        gpu_host=events.gpu_host_id.astype(np.int32),
        gpu_full=_gpu_full(events),
        cpu_cap=events.cpu_cap.astype(np.float32),
        ram_cap=events.ram_cap.astype(np.float32),
        arr_times=(events.arr_times.astype(np.float32)
                   if len(events.arr_times)
                   else np.full(1, np.inf, np.float32)),
        arr_pids=(events.arr_pids.astype(np.int16)
                  if len(events.arr_times) else np.zeros((1, M), np.int16)),
        n_gpus=np.asarray(events.num_gpus, np.int32),
    )


# Keys of the E-sized event-stream arrays of ``trace_arrays`` — the only
# arrays ``repro_torch.core.streaming`` splits into chunks.
EVENT_KEYS = ("kind", "vm_index", "profile", "time", "idx")


# Keys of the device event rows in ``Trace.dev``: each non-PAD event's VM
# index (arrivals, departures) or step index (step-ends), and its time.
EVENT_ROW_KEYS = ("ev_arg", "ev_time")


@dataclasses.dataclass
class Trace:
    """A trace on one device: ``dev`` holds the tensors the decisions
    read (index arrays widened to int64: torch refuses int16 index
    tensors and reads uint8 ones as boolean masks) and the non-PAD
    events' rows (``EVENT_ROW_KEYS``); ``host`` holds the numpy arrays
    the host plans the events on; ``rows`` are the positions of the
    non-PAD events in the event stream."""
    device: torch.device
    host: Dict[str, np.ndarray]
    dev: Dict[str, torch.Tensor]
    rows: np.ndarray


def trace_from_numpy(arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> Trace:
    """Move a :func:`trace_arrays` dict onto ``device``."""
    device = resolve_device(device)
    h = {k: np.asarray(v) for k, v in arrays.items()}

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    ghost = h["gpu_host"].astype(np.int64)
    rows = np.flatnonzero(h["kind"] != PAD)
    kind = h["kind"][rows]
    dev = dict(
        vm_pids=t(h["vm_pids"].astype(np.int64), torch.int64),
        vm_res=t(h["vm_res"], torch.float32),
        gpu_mid=t(h["gpu_mid"].astype(np.int64), torch.int64),
        gpu_host=t(ghost, torch.int64),
        gpu_full=t(h["gpu_full"], torch.int32),
        cpu_cap=t(h["cpu_cap"], torch.float32),
        ram_cap=t(h["ram_cap"], torch.float32),
        cap_g=t(np.stack([h["cpu_cap"][ghost], h["ram_cap"][ghost]], axis=1),
                torch.float32),
        arr_pids=t(h["arr_pids"].astype(np.int64), torch.int64),
        arr_times=t(h["arr_times"], torch.float32),
        ev_arg=t(np.where(kind == STEP_END, h["idx"][rows],
                          h["vm_index"][rows]).astype(np.int64), torch.int64),
        ev_time=t(h["time"][rows], torch.float32),
    )
    return Trace(device=device, host=h, dev=dev, rows=rows)


def init_state(events: EventTrace, st: ReplayStatics,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Fresh replay state: the JAX package's initial carry, key for key,
    as tensors on ``device``."""
    device = resolve_device(device)
    T = pc.tables_for(st.models, device)
    N = max(len(events.vm_pids), 1)
    G = len(events.gpu_model_id)
    H = len(events.cpu_cap)
    S = events.hourly_slots or len(events.step_times)
    NP, M = T.num_profiles, T.num_models

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    # Telemetry adds the per-VM decision code (-1 = not yet offered).
    vm0 = [-1, 0, 0, -1] if st.telemetry else [-1, 0, 0]
    state = dict(
        free=torch.as_tensor(_gpu_full(events), device=device),
        # Per-VM row: [gpu, start, accepted] (+ telemetry reason code).
        vmrow=torch.tensor(vm0, dtype=torch.int32,
                           device=device).repeat(N, 1),
        # Per-reference-profile row: [accepted, total].
        counts=zeros((NP, 2), torch.int32),
        # Per-host row: [cpu_used, ram_used].
        host_used=zeros((H, 2), torch.float32),
        # Per-step row: [accepted_cum, total_cum, pms, gpus].
        hourly=zeros((S, 4), torch.int32),
    )
    if st.telemetry:
        state["tele_steps"] = zeros((S, obs_inscan.NUM_STEP_COLS),
                                    torch.int32)
        state["tele_masks"] = zeros((S, G), obs_inscan.MASK_DTYPE)
    if st.policy == GRMU:
        ar = np.arange(G)
        basket = np.where(ar == 0, pc.HEAVY_BASKET,
                          np.where(ar == 1, pc.LIGHT_BASKET,
                                   pc.POOL)).astype(np.int32)
        basket[events.num_gpus:] = PAD_BASKET
        state["basket"] = torch.as_tensor(basket, device=device)
        state["intra"] = zeros((), torch.int32)
        state["inter"] = zeros((), torch.int32)
        if st.defrag:
            state["rej"] = zeros((), torch.bool)
        if st.consolidation_interval is not None:
            state["vm_count"] = zeros((G,), torch.int32)
            state["last_cons"] = zeros((), torch.float32)
    if st.policy == MECC:
        state["mecc_counts"] = zeros((M, NP), torch.int32)
        state["mecc_ptr"] = zeros((), torch.int32)
    return state


def state_from_numpy(carry: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A replay state (for example a JAX carry) as tensors on ``device``,
    keeping each array's shape and dtype."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in carry.items()}


def state_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in state.items()}


# ---------------------------------------------------------------------------
# The replay step
# ---------------------------------------------------------------------------

def _set_drop(dst: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``dst[idx] = vals`` where an index equal to ``len(dst)`` is
    dropped, as JAX's ``mode="drop"`` scatter drops it: the write goes
    through a buffer one row longer whose last row is discarded."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf[idx] = vals.to(buf.dtype)
    dst.copy_(buf[:-1])


def _kernel_pick(st: ReplayStatics, free, prof0: int, ghost, host_used,
                 cap_g, need, mecc_w):
    """MCC/MECC pick through the fused pick kernels (single-model fleets):
    host headroom, the score (-1 on infeasible masks) and the first
    maximizer in one launch."""
    model = st.models[0]
    if st.policy == MCC:
        return mask_scores.mcc_pick(free, ghost, host_used, cap_g, need,
                                    prof0, model)
    # MECC — integer windowed counts as f32 weights (exact < 2^24)
    w = mecc_w[0].to(torch.float32)
    return mask_scores.ecc_pick(free, ghost, host_used, cap_g, need, prof0,
                                w, model)


def expiry_width(trace: Trace, st: ReplayStatics) -> int:
    """MECC's expiry width W: the most observations one arrival expires
    in the whole trace (the JAX scan's ``while_loop`` count), rounded up
    to a power of two; 0 for the other policies and where no arrival
    expires any.  The expiry pointer of each arrival is the number of
    observation times below its cutoff ``time - window``, compared in
    float32 as the scan compares them; this needs ``arr_times`` sorted,
    which :func:`build_events_arrays` (arrival order, +inf padding)
    guarantees."""
    if st.policy != MECC:
        return 0
    h = trace.host
    at = h["arr_times"]
    if np.any(at[1:] < at[:-1]):
        raise ValueError("arr_times must be sorted (arrival order)")
    cutoff = h["time"][h["kind"] == ARRIVAL] - np.float32(st.mecc_window)
    ptr = np.maximum.accumulate(np.searchsorted(at, cutoff, side="left"))
    k = int(np.diff(ptr, prepend=0).max(initial=0))
    return 0 if k == 0 else 1 << (k - 1).bit_length()


# Keys of the step's operations: (ARRIVAL, profile, pick profile, heavy),
# (DEPARTURE,) and (STEP_END, consolidates).  The arrival's key holds the
# host values its operations are built on: the counts row, the pick
# kernel's profile argument (-1 off the kernel path) and, for GRMU, heavy.
_DEPARTURE_KEY = (DEPARTURE,)


class Step:
    """The replay's event step on ``state`` (updated in place).

    Each event kind is one method, made of device operations only: the
    event's VM or step index and its time are read from the event rows
    ``ev_arg`` / ``ev_time`` at the device cursor ``cur``, which each
    event advances, so no event's value reaches the host and the same
    operations serve every event of one key (:meth:`op`).  That is what
    lets a CUDA graph captured from one event replay the next
    (:class:`Runner`); run eagerly, they are the replay loop
    (:func:`run_events`).  The host values that remain are in the
    arrival's key; GRMU's heavy and light capacities are the device
    scalars ``caps``.  The exceptions are GRMU's consolidating step-ends
    (``policy_core.consolidation_plan`` loops over the candidates on the
    host, one synchronisation each), which only ever run eagerly.

    ``dev`` holds the trace's resident tensors (:func:`trace_from_numpy`)
    and ``host`` its numpy arrays (consolidation reads the GPU hosts
    there); ``width`` is the MECC expiry width (:func:`expiry_width`)."""

    def __init__(self, st: ReplayStatics, state: Dict[str, torch.Tensor],
                 dev: Dict[str, torch.Tensor], host: Dict[str, np.ndarray],
                 ev_arg: torch.Tensor, ev_time: torch.Tensor,
                 cur: torch.Tensor, caps: torch.Tensor, width: int):
        self.st, self.state, self.dev, self.host = st, state, dev, host
        self.ev_arg, self.ev_time, self.cur, self.caps = (ev_arg, ev_time,
                                                          cur, caps)
        device = ev_arg.device
        self.T = T = pc.tables_for(st.models, device)
        self.need_defrag = st.policy == GRMU and st.defrag
        self.need_consolidation = (st.policy == GRMU
                                   and st.consolidation_interval is not None)
        self.garange = torch.arange(dev["gpu_mid"].shape[0], device=device)
        self.zero_f = torch.zeros((), dtype=torch.float32, device=device)
        self.blocks = torch.arange(T.max_blocks, device=device)
        if st.telemetry:
            self.code_table, self.basket_cols = obs_inscan.device_tables(
                str(device))
        self.width = width
        self._ops: Dict[tuple, Callable[[], None]] = {}
        if st.policy == MECC:
            # MECC's counts are added through their flat (M * NP) view:
            # ``index_add_`` is one launch, where an accumulating
            # ``index_put_`` sorts its indices first (~15 launches).
            M = T.num_models
            self.model_rows = torch.arange(M, device=device) * T.num_profiles
            self.ones_m = torch.ones(M, dtype=torch.int32, device=device)
            self.warange = torch.arange(width, device=device)

    def op(self, key: tuple) -> Callable[[], None]:
        """The operations of one event of ``key``, as a call."""
        fn = self._ops.get(key)
        if fn is None:
            if key[0] == ARRIVAL:
                fn = functools.partial(self.arrival, *key[1:])
            elif key[0] == DEPARTURE:
                fn = self.departure
            else:
                fn = functools.partial(self.step_end, key[1])
            self._ops[key] = fn
        return fn

    def _arg(self):
        """The event's row at the cursor, (1,) int64: its VM index (an
        arrival or a departure) or its step index (a step-end)."""
        return self.ev_arg[self.cur]

    # -- arrival ---------------------------------------------------------
    def _expire(self, counts: torch.Tensor) -> None:
        """Expire the MECC history older than (now - window): the JAX
        scan's two-pointer ``while_loop`` over the static observation
        schedule, as a fixed-width masked scatter of -1 over the ``width``
        observations from the device pointer on.  The loop's stopping
        rule is a running product of its condition, so the masked rows are
        exactly the ones it visits (``width`` bounds their count)."""
        d, W = self.dev, self.width
        A, M = d["arr_times"].shape[0], self.T.num_models
        ptr = self.state["mecc_ptr"]
        j = ptr.long() + self.warange
        jc = j.clamp(max=A - 1)
        cutoff = self.ev_time[self.cur] - np.float32(self.st.mecc_window)
        keep = ((j < A) & (d["arr_times"][jc] < cutoff)).to(
            torch.int32).cumprod(0, dtype=torch.int32)
        counts.view(-1).index_add_(
            0, (self.model_rows + d["arr_pids"][jc]).view(-1),
            -keep[:, None].expand(W, M).reshape(-1))
        ptr.add_(keep.sum(dtype=torch.int32))

    def arrival(self, p: int, prof0: int, heavy: bool) -> None:
        st, T, s, d = self.st, self.T, self.state, self.dev
        free, vmrow, host_used = s["free"], s["vmrow"], s["host_used"]
        mid, ghost, cap_g = d["gpu_mid"], d["gpu_host"], d["cap_g"]
        vi = self._arg()
        pids = d["vm_pids"][vi].view(-1)                # (M,) int64
        mecc_w = None
        if st.policy == MECC:
            # Count the arrival (once per fleet model), then expire.
            counts = s["mecc_counts"]
            counts.view(-1).index_add_(0, self.model_rows + pids,
                                       self.ones_m)
            if self.width:
                self._expire(counts)
            mecc_w = pc.mecc_weights(counts)

        need = d["vm_res"][vi].view(2)                  # cpu, ram
        grew = quota_full = None
        if st.policy == GRMU:
            basket = s["basket"]
            heavy_cap, light_cap = self.caps[0:1], self.caps[1:2]
            host_ok = (host_used[ghost] + need <= cap_g).all(dim=1)
            pick, grew, grow_idx = pc.grmu_select(
                T, mid, free, pids, heavy, host_ok, basket, heavy_cap,
                light_cap)
            want = pc.HEAVY_BASKET if heavy else pc.LIGHT_BASKET
            if st.telemetry:
                # Read before the basket grows.
                quota_full = ((basket == want).sum()
                              >= (heavy_cap if heavy else light_cap))
            basket[grow_idx] = torch.where(grew, want, basket[grow_idx])
        elif st.score_backend == "kernel":
            pick = _kernel_pick(st, free, prof0, ghost, host_used, cap_g,
                                need, mecc_w)
            if st.telemetry:
                # The fused pick keeps its host headroom to itself.
                host_ok = (host_used[ghost] + need <= cap_g).all(dim=1)
        else:
            host_ok = (host_used[ghost] + need <= cap_g).all(dim=1)
            pick = pc.select_gpu(st.policy, T, mid, free, pids, host_ok,
                                 mecc_w)
        ok = pick >= 0
        okc = ok.to(torch.int32)
        g = pick.clamp(min=0)
        mask = free[g]
        mid_g = mid[g]
        p_g = pids[mid_g]         # profile under the chosen GPU's model
        ml = mask.long()
        row = [torch.where(ok, pick, -1).to(torch.int32),
               torch.where(ok, T.assign_start[mid_g, ml, p_g], 0), okc]
        if st.telemetry:
            # From the pre-placement free masks and host headroom.
            row.append(obs_inscan.arrival_reason_code(
                T, mid, free, pids, host_ok, ok, self.code_table, grew,
                quota_full))
        vmrow[vi] = torch.cat(row)
        free[g] = torch.where(ok, T.assign_mask[mid_g, ml, p_g], mask)
        s["counts"][p, 0:1] += okc
        s["counts"][p, 1] += 1
        hg = ghost[g]
        host_used[hg] = host_used[hg] + torch.where(ok, need, self.zero_f)
        if self.need_consolidation:
            s["vm_count"][g] += okc
        if self.need_defrag and not (st.defrag_trigger == "light" and heavy):
            s["rej"].view(1).logical_or_(~ok)
        self.cur.add_(1)

    # -- departure --------------------------------------------------------
    def departure(self) -> None:
        T, s, d = self.T, self.state, self.dev
        free, vmrow, host_used = s["free"], s["vmrow"], s["host_used"]
        vi = self._arg()
        r = vmrow[vi].view(-1)
        ok = r[0:1] >= 0
        g = r[0:1].clamp(min=0).long()
        mid_g = d["gpu_mid"][g]
        blocks = T.size_mask[mid_g, d["vm_pids"][vi].view(-1)[mid_g]] \
            << r[1:2]
        fg = free[g]
        hg = d["gpu_host"][g]
        delta = torch.where(ok, -d["vm_res"][vi].view(2), self.zero_f)
        free[g] = torch.where(ok, fg | blocks, fg)
        vmrow[:, 0].index_fill_(0, vi, -1)
        host_used[hg] = host_used[hg] + delta
        if self.need_consolidation:
            s["vm_count"][g] -= ok.to(torch.int32)
        self.cur.add_(1)

    # -- GRMU step-end operations ----------------------------------------
    def _defrag(self) -> None:
        """Alg. 4, applied only where ``rej`` is set: the JAX scan's
        ``lax.cond`` on the flag, as a gate on the device."""
        T, s, d = self.T, self.state, self.dev
        free, vmrow, mid = s["free"], s["vmrow"], d["gpu_mid"]
        tgt = pc.defrag_target(T, mid, free, s["basket"] == pc.LIGHT_BASKET)
        do = tgt >= 0
        g = tgt.clamp(min=0)
        mid_g = mid[g]
        on_g = vmrow[:, 0] == g
        vm_start = vmrow[:, 1].long()
        # Profile (on g's model) of the VM whose instance starts at each
        # block of g, -1 where none.  The live VMs on one GPU hold
        # disjoint blocks, so each start block names at most one VM, and
        # this scatter is the reference's per-block first-match search;
        # rows off g all go to the discarded slot MAXB.
        blk = torch.where(on_g, vm_start, T.max_blocks)
        prof_blk = torch.full((T.max_blocks + 1,), -1, dtype=torch.int64,
                              device=free.device)
        prof_blk[blk] = torch.where(on_g, d["vm_pids"][:, mid_g].view(-1),
                                    -1)
        starts, ok, final_mask, moved = pc.repack_gpu(
            T, mid_g, prof_blk[:T.max_blocks])
        apply = do & ok & (moved > 0) & s["rej"]
        # Each VM on g moves to its block's repacked start.
        lut = torch.where(starts >= 0, starts, self.blocks)
        vmrow[:, 1] = torch.where(on_g & apply, lut[vm_start], vmrow[:, 1])
        free[g] = torch.where(apply, final_mask, free[g])
        s["intra"].view(1).add_(torch.where(apply, moved, 0))

    def _consolidate(self) -> None:
        T, s, d = self.T, self.state, self.dev
        free, vmrow, basket = s["free"], s["vmrow"], s["basket"]
        vm_count, host_used = s["vm_count"], s["host_used"]
        mid, garange = d["gpu_mid"], self.garange
        G, N = free.shape[0], vmrow.shape[0]
        NP = T.num_profiles
        vm_gpu = vmrow[:, 0]
        # Sole resident per GPU (valid only where vm_count == 1; the
        # winner among duplicate indices is unspecified and never read).
        owner = torch.full((G + 1,), -1, dtype=torch.int32,
                           device=free.device)
        owner[torch.where(vm_gpu >= 0, vm_gpu, G).long()] = torch.arange(
            N, dtype=torch.int32, device=free.device)
        owner = owner[:G]
        owner_c = owner.clamp(0, N - 1).long()
        has = (owner >= 0)[:, None]
        # The sole VM mapped onto every fleet model, (G, M); and onto its
        # own GPU's model, (G,).
        sole_pids = torch.where(has, d["vm_pids"][owner_c], -1)
        sole_own = sole_pids[garange, mid]
        sole_res = torch.where(has, d["vm_res"][owner_c], self.zero_f)
        cand = pc.consolidation_candidates(
            T, mid, free, basket == pc.LIGHT_BASKET, vm_count, sole_own)
        tgt_of, cpu_used, ram_used = pc.consolidation_plan(
            T, mid, free, cand, sole_pids, sole_res[:, 0], sole_res[:, 1],
            d["gpu_host"], host_used[:, 0], host_used[:, 1], d["cpu_cap"],
            d["ram_cap"], self.host["gpu_host"])
        valid = tgt_of >= 0
        tgt_c = tgt_of.clamp(0, G - 1).long()
        # Each source's profile under its *target's* model.
        p_tgt = sole_pids[garange, mid[tgt_c]].clamp(0, NP - 1)
        starts = T.assign_start[mid[tgt_c], free[tgt_c].long(), p_tgt]
        # Receive side: each target gets exactly one source.
        recv_p = torch.full((G + 1,), -1, dtype=torch.int64,
                            device=free.device)
        recv_p[torch.where(valid, tgt_of, G).long()] = torch.where(
            valid, p_tgt, -1)
        recv_p = recv_p[:G]
        recv_pc = recv_p.clamp(0, NP - 1)
        new_free = torch.where(valid, d["gpu_full"], free)
        new_free = torch.where(recv_p >= 0,
                               T.assign_mask[mid, free.long(), recv_pc],
                               new_free)
        vi = torch.where(valid, owner, N).long()
        _set_drop(vmrow[:, 0], vi, tgt_of)
        _set_drop(vmrow[:, 1], vi, starts)
        free.copy_(new_free)
        basket.copy_(torch.where(valid, pc.POOL, basket))
        vm_count.copy_(torch.where(valid, 0, vm_count)
                       + (recv_p >= 0).to(torch.int32))
        host_used.copy_(torch.stack([cpu_used, ram_used], dim=1))
        s["inter"].view(1).add_(valid.sum().to(torch.int32))

    # -- step end ----------------------------------------------------------
    def step_end(self, consolidate: bool) -> None:
        s, d = self.state, self.dev
        free, counts = s["free"], s["counts"]
        idx = self._arg()
        if self.need_defrag:
            self._defrag()
            s["rej"].zero_()
        if consolidate:
            self._consolidate()
        gpu_active = (free != d["gpu_full"]).to(torch.int32)
        per_host = torch.zeros(s["host_used"].shape[0], dtype=torch.int32,
                               device=free.device).index_add_(
            0, d["gpu_host"], gpu_active)
        s["hourly"][idx] = torch.stack([
            counts[:, 0].sum(), counts[:, 1].sum(), (per_host > 0).sum(),
            gpu_active.sum()]).to(torch.int32)
        if self.st.telemetry:
            obs_inscan.step_row(s, self.basket_cols, idx)
        self.cur.add_(1)


@dataclasses.dataclass
class Plan:
    """The host side of replaying events ``[start, stop)`` of a trace:
    the key of each non-PAD event (:meth:`Step.op`), in order, and their
    positions ``[lo, hi)`` in the trace's device event rows.  Whether a
    GRMU step-end consolidates is decided here, from the event times and
    the last consolidation time, which the plan carries on (``last_cons``
    after its events)."""
    keys: List[tuple]
    lo: int
    hi: int
    last_cons: Optional[np.float32]


def plan_events(st: ReplayStatics, trace: Trace, start: int = 0,
                stop: Optional[int] = None,
                last_cons: Optional[np.float32] = None) -> Plan:
    """Plan events ``[start, stop)`` of ``trace`` (``last_cons``: the last
    consolidation time before them, for GRMU with consolidation)."""
    h = trace.host
    stop = len(h["kind"]) if stop is None else stop
    lo, hi = (int(i) for i in np.searchsorted(trace.rows, [start, stop]))
    sel = trace.rows[lo:hi]
    kernel, grmu = st.score_backend == "kernel", st.policy == GRMU
    consolidates = grmu and st.consolidation_interval is not None
    if consolidates:
        interval = np.float32(st.consolidation_interval)
        last_cons = np.float32(last_cons)
    vm_pids, vm_heavy = h["vm_pids"], h["vm_heavy"]
    times = h["time"][sel]
    keys: List[tuple] = []
    for j, (kind, vi, p) in enumerate(zip(h["kind"][sel].tolist(),
                                          h["vm_index"][sel].tolist(),
                                          h["profile"][sel].tolist())):
        if kind == ARRIVAL:
            keys.append((ARRIVAL, p, int(vm_pids[vi, 0]) if kernel else -1,
                         bool(vm_heavy[vi]) if grmu else False))
        elif kind == DEPARTURE:
            keys.append(_DEPARTURE_KEY)
        else:
            due = consolidates and times[j] - last_cons >= interval
            if due:
                last_cons = times[j]
            keys.append((STEP_END, bool(due)))
    return Plan(keys, lo, hi, last_cons if consolidates else None)


def run_events(st: ReplayStatics, state: Dict[str, torch.Tensor],
               trace: Trace, heavy_capacity: int, start: int = 0,
               stop: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The eager replay loop: events ``[start, stop)`` of ``trace`` on
    ``state`` (updated in place and returned), one :class:`Step` call
    per event.  The state holds the whole cluster, so runs over
    consecutive slices compose into one run over their union.  The
    replay's entry points run the same step through :class:`Runner`
    (captured graphs on the card); this loop is what they are held
    against."""
    dev = trace.device
    consolidates = (st.policy == GRMU
                    and st.consolidation_interval is not None)
    plan = plan_events(st, trace, start, stop,
                       state["last_cons"].item() if consolidates else None)
    hc = int(heavy_capacity)
    caps = torch.tensor([hc, int(trace.host["n_gpus"]) - hc],
                        dtype=torch.int32, device=dev)
    step = Step(st, state, trace.dev, trace.host,
                trace.dev["ev_arg"][plan.lo:plan.hi],
                trace.dev["ev_time"][plan.lo:plan.hi],
                torch.zeros(1, dtype=torch.int64, device=dev), caps,
                expiry_width(trace, st))
    for key in plan.keys:
        step.op(key)()
    if consolidates:
        state["last_cons"].fill_(float(plan.last_cons))
    return state


# ---------------------------------------------------------------------------
# Replay runners: the cached, graph-captured step
# ---------------------------------------------------------------------------

# Rows of a whole replay's event buffer: make_replay streams a trace's
# event rows through it in pieces of this many.
EVENT_ROWS = 1 << 16


def replay_key(st: ReplayStatics, trace: Trace, state0, *variant,
               width: Optional[int] = None) -> tuple:
    """The compile-cache key of a runner: the statics, ``variant`` (the
    streaming engine's ``"chunk", chunk_events``, the decision step's
    ``"serve", rows``) and the bucket shape a runner's graphs fix, (N, G,
    H, S, A, W) with W the MECC expiry width (``width``, else the trace's
    :func:`expiry_width`), on one device."""
    d = trace.dev
    if width is None:
        width = expiry_width(trace, st)
    shape = (d["vm_pids"].shape[0], d["gpu_mid"].shape[0],
             d["cpu_cap"].shape[0], state0["hourly"].shape[0],
             d["arr_times"].shape[0], width)
    return (st, *variant, shape, str(trace.device))


class Runner:
    """A replay's :class:`Step` on static buffers: the value the replay
    compile cache holds for one :func:`replay_key`.

    The runner owns a state, the trace's resident tensors, an event
    buffer of ``rows`` rows, the cursor and the GRMU caps; :meth:`load`
    copies a trace and a fresh state into them, :meth:`stage` copies event
    rows into the buffer and :meth:`replay` runs their keys.  On the CPU
    each key runs eagerly.  On the card each key is one CUDA graph,
    captured the first time a trace needs it: one eager warm-up on a side
    stream (it builds the kernels and the tables, so nothing is built or
    copied from the host inside a capture), then the capture.  An event
    of a captured key then costs the host one graph launch.  GRMU's
    consolidating step-ends are never captured: they run eagerly, with
    the one host synchronisation of their plan.

    All graphs of a runner share one memory pool.  That is safe because
    every intermediate of a graph is consumed inside that graph and every
    result lands in the static buffers, so no graph reads memory another
    graph's replay may have reused.  A replay of a graph that holds a
    pick kernel adds that pick to ``mask_scores.LAUNCHES``; the warm-up's
    and the capture's counts are taken back out (the capture launches
    nothing; the warm-up runs on throwaway rows)."""

    def __init__(self, st: ReplayStatics, trace: Trace,
                 state0: Dict[str, torch.Tensor], rows: int,
                 width: Optional[int] = None):
        dev = trace.device
        self.st, self.device, self.rows = st, dev, rows
        self.graphed = dev.type == "cuda"
        resident = {k: torch.empty_like(v) for k, v in trace.dev.items()
                    if k not in EVENT_ROW_KEYS}
        self.state = {k: torch.empty_like(v) for k, v in state0.items()}
        self.step = Step(
            st, self.state, resident, trace.host,
            torch.zeros(rows, dtype=torch.int64, device=dev),
            torch.zeros(rows, dtype=torch.float32, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev),
            expiry_width(trace, st) if width is None else width)
        self.graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self.launches: Dict[tuple, Dict[str, int]] = {}
        self.pool = None
        self.capture_s = 0.0

    def close(self) -> None:
        """Free the graphs (the cache calls this on eviction); a later
        :meth:`load` captures again."""
        self.graphs.clear()
        self.launches.clear()
        self.pool = None

    def load(self, trace: Trace, state0: Dict[str, torch.Tensor],
             heavy_capacity: int, keys: List[tuple]) -> None:
        """Copy ``trace``'s resident tensors and the fresh state ``state0``
        into the static buffers, set the caps from ``heavy_capacity`` and
        the cursor to 0; on the card, first capture the graphs of the
        ``keys`` not captured yet."""
        step = self.step
        for k, v in step.dev.items():
            v.copy_(trace.dev[k])
        step.host = trace.host
        self._reset(state0, heavy_capacity, int(trace.host["n_gpus"]))
        if self.graphed:
            todo = [k for k in dict.fromkeys(keys)
                    if k not in self.graphs and k != (STEP_END, True)]
            if todo:
                self._capture(todo)
                self._reset(state0, heavy_capacity,
                            int(trace.host["n_gpus"]))

    def _reset(self, state0, heavy_capacity: int, n_gpus: int) -> None:
        for k, v in self.state.items():
            v.copy_(state0[k])
        hc = int(heavy_capacity)
        self.step.caps[0].fill_(hc)
        self.step.caps[1].fill_(n_gpus - hc)
        self.step.cur.zero_()

    def _capture(self, keys: List[tuple]) -> None:
        t0 = time.perf_counter()
        step = self.step
        # Throwaway rows: VM 0 and step 0 are valid indices of any trace.
        step.ev_arg.zero_()
        step.ev_time.zero_()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        saved = dict(mask_scores.LAUNCHES)
        side = torch.cuda.Stream(self.device)
        for key in keys:
            fn = step.op(key)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                step.cur.zero_()
                fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            step.cur.zero_()
            before = dict(mask_scores.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool):
                fn()
            self.launches[key] = {
                n: c - before[n] for n, c in mask_scores.LAUNCHES.items()
                if c != before[n]}
            self.graphs[key] = graph
        mask_scores.LAUNCHES.update(saved)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def stage(self, ev_arg: torch.Tensor, ev_time: torch.Tensor) -> None:
        """Copy event rows (on the runner's device) into the buffer and
        set the cursor to its first row."""
        n = ev_arg.shape[0]
        if n > self.rows:
            raise ValueError(f"{n} event rows exceed the runner's "
                             f"{self.rows}")
        self.step.ev_arg[:n].copy_(ev_arg)
        self.step.ev_time[:n].copy_(ev_time)
        self.step.cur.zero_()

    def replay(self, keys: List[tuple]) -> None:
        """Run the staged rows, one call per key: a graph launch on the
        card, the eager step on the CPU and for consolidating step-ends.
        On the card a key that :meth:`load` did not capture (the runner
        was closed since) raises rather than run eagerly."""
        graphs, step = self.graphs, self.step
        if self.graphed:
            missing = set(keys) - graphs.keys() - {(STEP_END, True)}
            if missing:
                raise RuntimeError(f"keys {sorted(missing)} have no captured "
                                   "graph; load() the runner first")
        for fn in [graphs[k].replay if k in graphs else step.op(k)
                   for k in keys]:
            fn()
        if self.launches:
            for key, n in collections.Counter(keys).items():
                for name, c in self.launches.get(key, {}).items():
                    mask_scores.LAUNCHES[name] += n * c

    def finish(self, plan: Plan, finalize: Callable
               ) -> Dict[str, torch.Tensor]:
        """Write the plan's last consolidation time into the state and
        return ``finalize(state)`` (the replay's outputs), copied out of
        the static buffers."""
        if plan.last_cons is not None:
            self.state["last_cons"].fill_(float(plan.last_cons))
        return {k: v.clone() for k, v in finalize(self.state).items()}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _finalize(st: ReplayStatics, final: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Reduce a final state to the replay's small output tensors."""
    zero = torch.zeros((), dtype=torch.int32, device=final["free"].device)
    out = dict(
        accepted=final["counts"][:, 0], total=final["counts"][:, 1],
        vm_accepted=final["vmrow"][:, 2] > 0,
        h_acc=final["hourly"][:, 0], h_tot=final["hourly"][:, 1],
        h_pms=final["hourly"][:, 2], h_gpus=final["hourly"][:, 3],
        intra=final.get("intra", zero), inter=final.get("inter", zero),
    )
    if st.telemetry:
        out.update(obs_inscan.unpack_finalize(final))
    return out


def default_heavy_capacity(events: EventTrace,
                           frac: float = 0.30) -> int:
    # Same rounding as the sequential GRMU constructor (no floor).
    return int(round(frac * events.num_gpus))


def make_replay(events: EventTrace, policy: int,
                device: DeviceLike = None, **cfg) -> Callable:
    """``run(heavy_capacity) -> dict of output tensors`` on ``device``
    (``None`` = the CUDA device).  The trace and a fresh state are moved
    to the device once; the runner comes from the replay compile cache
    (:func:`replay_key`), so a trace of an already-seen statics and
    bucket captures nothing new.  Each call loads the trace and the fresh
    state into the runner and replays the event rows through its buffer,
    :data:`EVENT_ROWS` at a time.  On the card a failed capture or graph
    launch raises; nothing falls back to the eager loop.  ``run.runner``
    and ``run.plan`` are the runner and the trace's :class:`Plan`."""
    device = resolve_device(device)
    st = replay_statics(events, policy, **cfg)
    trace = trace_from_numpy(trace_arrays(events), device)
    state0 = init_state(events, st, device)
    runner = compile_cache.cached_replay_fn(
        replay_key(st, trace, state0),
        lambda: Runner(st, trace, state0, EVENT_ROWS))
    plan = plan_events(st, trace, last_cons=0.0)
    d = trace.dev

    def run(heavy_capacity):
        runner.load(trace, state0, heavy_capacity, plan.keys)
        for a in range(plan.lo, plan.hi, EVENT_ROWS):
            b = min(a + EVENT_ROWS, plan.hi)
            runner.stage(d["ev_arg"][a:b], d["ev_time"][a:b])
            runner.replay(plan.keys[a - plan.lo:b - plan.lo])
        return runner.finish(plan, functools.partial(_finalize, st))

    run.runner, run.plan = runner, plan
    return run


def replay(events: EventTrace, policy: int, heavy_capacity=None,
           device: DeviceLike = None, **cfg) -> SimResult:
    """Replay the trace under ``policy`` on ``device`` (``None`` = the
    CUDA device; pass ``device="cpu"`` for the CPU) and return a full
    ``SimResult``.  ``heavy_capacity`` is only used by GRMU; GRMU knobs
    (``defrag``, ``consolidation_interval``, ``defrag_trigger``), MECC's
    ``mecc_window``, ``score_backend`` (auto|tables|kernel) and
    ``telemetry`` pass through ``cfg``; with telemetry the result's
    ``rejection_reasons`` are filled."""
    if heavy_capacity is None:
        heavy_capacity = default_heavy_capacity(events)
    out = make_replay(events, policy, device, **cfg)(heavy_capacity)
    return result_from_arrays(
        events, policy, {k: v.cpu().numpy() for k, v in out.items()})


def sweep_heavy_capacity(events: EventTrace, fracs, device: DeviceLike = None,
                         **cfg) -> np.ndarray:
    """Fig. 6 on ``device`` (``None`` = the CUDA device): the GRMU replay
    at each basket capacity ``round(frac * num_gpus)``.  Defaults to the
    'DB' configuration (defrag & consolidation off — the point whose
    acceptance the paper's sweep explores); pass ``defrag=True`` /
    ``consolidation_interval=...`` for full GRMU.  Returns (len(fracs),
    num_profiles) int32 accepted-per-reference-profile.

    The JAX package ``vmap``s the replay over the capacities; here every
    capacity replays through one runner (:func:`make_replay`): GRMU's
    capacities are device scalars of its state, so its graphs are
    captured once and each capacity is one ``run(cap)``."""
    cfg.setdefault("defrag", False)
    cfg.setdefault("consolidation_interval", None)
    caps = np.round(np.asarray(fracs) * events.num_gpus).astype(np.int32)
    run = make_replay(events, GRMU, device, **cfg)
    return np.stack([run(int(c))["accepted"].cpu().numpy() for c in caps])


# ---------------------------------------------------------------------------
# The placement service's decision step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostCarry:
    """What a decision-step caller carries on the host from one
    micro-batch to the next, beside its state: GRMU's last consolidation
    time (``None`` without consolidation; the host plans which step-ends
    consolidate), the host mirror of ``state["mecc_ptr"]`` and the MECC
    expiry width W so far (the largest count one arrival has expired,
    rounded up to a power of two).  The step updates it in place."""
    last_cons: Optional[np.float32] = None
    mecc_ptr: int = 0
    width: int = 0


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device`` without a host synchronisation: on the card
    through pinned memory, a non-blocking copy."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _expire_ahead(st: ReplayStatics, arr_times: np.ndarray,
                  times: np.ndarray, ptr: int) -> Tuple[int, int]:
    """(the most observations one arrival at ``times`` expires, the
    expiry pointer after them) from the pointer ``ptr``: the scan's
    two-pointer loop on the host, over the sorted observation times, with
    the float32 cutoffs the step computes."""
    if not len(times):
        return 0, ptr
    cutoff = times.astype(np.float32) - np.float32(st.mecc_window)
    ptrs = np.maximum.accumulate(np.maximum(
        np.searchsorted(arr_times, cutoff, side="left"), ptr))
    return int(np.diff(ptrs, prepend=ptr).max()), int(ptrs[-1])


class DecisionStep:
    """The placement service's micro-batch step (:func:`make_decision_step`).

    ``step(state, ev, rest, heavy_capacity, carry, read=None)`` runs one
    batch of event rows on the caller's ``state`` and returns ``(state,
    rows)``: ``ev`` holds the batch's event arrays (host numpy, the keys
    of :data:`EVENT_KEYS`; PAD rows are dropped), ``rest`` is the caller's
    :class:`Trace` (its resident tensors and their host mirrors: the VM
    table, the MECC observation times, the GPU hosts), ``carry`` its
    :class:`HostCarry`, and ``rows`` the ``vmrow`` rows ``[lo, hi)`` of
    ``read`` as numpy (``None`` without ``read``).  The state is updated
    in place and returned: the JAX package's contract (state and resident
    tables in, state out) on a :class:`Runner`.

    A runner is shared through the replay compile cache by every caller
    with the same statics, bucket shape and row count, and it owns static
    buffers; so each call copies the caller's resident tensors and state
    into the runner (on the card, keys it has not captured are captured
    on that copy, which is then copied in again: :meth:`Runner.load`),
    stages the batch's rows with one host-to-device copy, replays them
    and copies the state back.
    Two callers of one configuration never see each other's state.  The
    only host synchronisations are the copy of the read rows to the host
    and GRMU's consolidating step-ends.  MECC's runner is the one of the
    width W that covers every arrival so far: the host computes each
    batch's expiry counts from the observation times it stamped."""

    def __init__(self, st: ReplayStatics):
        self.st = st
        self.runner: Optional[Runner] = None

    def __call__(self, state: Dict[str, torch.Tensor],
                 ev: Dict[str, np.ndarray], rest: Trace, heavy_capacity: int,
                 carry: HostCarry, read: Optional[Tuple[int, int]] = None):
        st, dev = self.st, rest.device
        kind = np.asarray(ev["kind"])
        sel = np.flatnonzero(kind != PAD)
        host = dict(rest.host, **{k: np.asarray(ev[k]) for k in EVENT_KEYS})
        plan = plan_events(st, Trace(dev, host, {}, sel),
                           last_cons=carry.last_cons)
        if st.policy == MECC:
            arr = sel[kind[sel] == ARRIVAL]
            most, carry.mecc_ptr = _expire_ahead(st, rest.host["arr_times"],
                                                 host["time"][arr],
                                                 carry.mecc_ptr)
            if most > carry.width:
                carry.width = 1 << (most - 1).bit_length()
        rows = len(kind)
        runner = self.runner = compile_cache.cached_replay_fn(
            replay_key(st, rest, state, "serve", rows, width=carry.width),
            lambda: Runner(st, rest, state, rows, width=carry.width))
        runner.load(rest, state, heavy_capacity, plan.keys)
        n = len(sel)
        if n:
            arg = np.where(kind[sel] == STEP_END, host["idx"][sel],
                           host["vm_index"][sel]).astype(np.int64)
            bits = host["time"][sel].astype(np.float32).view(np.int32)
            buf = host_to_device(np.concatenate([arg, bits.astype(np.int64)]),
                                 dev)
            runner.stage(buf[:n], buf[n:].to(torch.int32).view(torch.float32))
            runner.replay(plan.keys)
        for k, v in state.items():
            v.copy_(runner.state[k])
        if plan.last_cons is not None:
            carry.last_cons = plan.last_cons
            state["last_cons"].fill_(float(plan.last_cons))
        out = None
        if read is not None:
            out = state["vmrow"][read[0]:read[1]].cpu().numpy()
        return state, out


def make_decision_step(st: ReplayStatics) -> DecisionStep:
    """The online placement service's micro-batch decision step (see
    :class:`DecisionStep`).  Its runners come from the replay compile
    cache under ``replay_key(st, rest, state, "serve", rows, width=W)``,
    so a service's whole life on one tier runs one set of captured graphs
    (a new MECC width W adds a runner).  Batches compose: a stream of
    micro-batches gives exactly an offline replay's decisions of the same
    event order, for any batch size.  Telemetry statics are refused, as
    in the JAX package."""
    if st.telemetry:
        raise ValueError("the serving decision step does not support "
                         "in-scan telemetry statics")
    return DecisionStep(st)


def result_from_arrays(events: EventTrace, policy: int, out: dict
                       ) -> SimResult:
    """Assemble a SimResult from ``run``'s output arrays (host side, in
    float64, exactly how the sequential engine derives its series).
    Slices every padded buffer back to the trace's logical sizes."""
    ref_profiles = events.models[0].profiles
    accepted = np.asarray(out["accepted"])
    total = np.asarray(out["total"])
    res = SimResult.for_model(
        pc.POLICY_NAMES.get(policy, str(policy)), events.models[0])
    res.total_requests = int(total.sum())
    res.accepted = int(accepted.sum())
    res.rejected = res.total_requests - res.accepted
    for i, p in enumerate(ref_profiles):
        res.per_profile_total[p.name] = int(total[i])
        res.per_profile_accepted[p.name] = int(accepted[i])
    S = len(events.step_times)
    res.hourly_times = [float(t) for t in events.step_times]
    h_acc = np.asarray(out["h_acc"])[:S]
    h_tot = np.asarray(out["h_tot"])[:S]
    res.hourly_acceptance = [int(a) / max(1, int(t))
                             for a, t in zip(h_acc, h_tot)]
    denom = events.num_hosts + events.num_gpus
    res.hourly_active_hw = [(int(p) + int(g)) / denom
                            for p, g in zip(out["h_pms"][:S],
                                            out["h_gpus"][:S])]
    res.intra_migrations = int(out["intra"])
    res.inter_migrations = int(out["inter"])
    res.migrations = res.intra_migrations + res.inter_migrations
    acc_mask = np.asarray(out["vm_accepted"], bool)[:len(events.vm_ids)]
    res.accepted_ids = [int(v) for v in events.vm_ids[acc_mask]]
    if "tele_rej" in out:       # telemetry-enabled replay: reason tally
        rej = np.asarray(out["tele_rej"])
        res.rejection_reasons = {
            obs_reasons.REASON_NAMES[c]: int(rej[c])
            for c in range(1, obs_reasons.NUM_CODES)}
    return res


__all__ = ["EventTrace", "build_events", "build_events_arrays",
           "make_replay", "replay", "result_from_arrays", "run_events",
           "sweep_heavy_capacity", "make_decision_step", "DecisionStep",
           "HostCarry", "host_to_device",
           "plan_events", "Plan", "Step", "Runner", "replay_key",
           "expiry_width", "EVENT_KEYS", "EVENT_ROW_KEYS", "EVENT_ROWS",
           "default_heavy_capacity", "trace_arrays", "trace_from_numpy",
           "Trace", "init_state", "state_from_numpy", "state_to_numpy",
           "replay_statics", "ReplayStatics", "step_grid",
           "FF", "BF", "MCC", "MECC", "GRMU",
           "DEPARTURE", "ARRIVAL", "STEP_END", "PAD", "PAD_BASKET"]
