"""Trace replay in PyTorch — port of ``repro/core/batched.py``.

The same event stream (departure | arrival | step-end, in within-bucket
order) is replayed through the same decisions as the JAX ``lax.scan``,
with the cluster state held in a dict of tensors on one device.  The
event kinds, VM indices, profiles and times are host numpy, so the loop
over events is a plain Python loop that dispatches each event with a
host ``if``; every decision is made by tensor operations on the device,
without a host sync, except:

  * GRMU's defrag reads the ``rej`` flag once per step-end;
  * GRMU's consolidation reads its candidate list once per consolidation
    (``policy_core.consolidation_plan`` loops over it on the host).

Host-known quantities are tracked on the host: MECC's expiry pointer
(the schedule ``arr_times`` is static; compared in float32 exactly as
the scan does) and the last consolidation time (event times are static).
Both are written back into the state dict when a run of events ends, so
the state is always the JAX carry, key for key.

Scoring: ``score_backend="tables"`` gathers from the per-model mask
tables (``policy_core``); ``"kernel"`` scores MCC/MECC arrivals with the
CUDA kernels of :mod:`repro_torch.kernels.mask_scores` (on a CPU device,
their plain versions), ``"auto"`` picks ``"kernel"`` for MCC/MECC on a
single-model fleet.  The state tensors are updated in place.

Telemetry (``telemetry=True``, :mod:`repro_torch.obs.inscan`) adds the
decision code of each arrival as a 4th ``vmrow`` column and, at each
step-end, the migration and basket counters and the free masks into the
step-indexed ``tele_steps`` / ``tele_masks`` state; it reads decision
state only, so every decision is the same as with telemetry off, and it
adds no host synchronisation.  With telemetry off none of its
operations runs.

``run_events`` over consecutive ranges of events on one state composes
into one run over their union (``repro_torch.core.streaming`` replays a
trace so, chunk by chunk).

Within each step (1 h bucket): departures are processed first, then
arrivals, then the step-end hook (defrag -> consolidation -> metrics);
scans resolve ties by lowest globalIndex.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class Trace:
    """A trace on one device: ``dev`` holds the tensors the decisions
    read (index arrays widened to int64: torch refuses int16 index
    tensors and reads uint8 ones as boolean masks); ``host`` holds the
    numpy arrays the event loop dispatches on."""
    device: torch.device
    host: Dict[str, np.ndarray]
    dev: Dict[str, torch.Tensor]


def trace_from_numpy(arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> Trace:
    """Move a :func:`trace_arrays` dict onto ``device``."""
    device = resolve_device(device)
    h = {k: np.asarray(v) for k, v in arrays.items()}

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    ghost = h["gpu_host"].astype(np.int64)
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
    )
    return Trace(device=device, host=h, dev=dev)


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


def stage_events(trace: Trace, start: int = 0,
                 stop: Optional[int] = None) -> Tuple:
    """Events ``[start, stop)`` of ``trace`` as the host rows the event
    loop dispatches on: lists of kinds, VM indices, profiles and step
    indices, and the float32 times."""
    h = trace.host
    stop = len(h["kind"]) if stop is None else stop
    return (h["kind"][start:stop].tolist(),
            h["vm_index"][start:stop].tolist(),
            h["profile"][start:stop].tolist(),
            h["idx"][start:stop].tolist(), h["time"][start:stop])


def run_events(st: ReplayStatics, state: Dict[str, torch.Tensor],
               trace: Trace, heavy_capacity: int, start: int = 0,
               stop: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Replay events ``[start, stop)`` of ``trace`` on ``state`` (updated
    in place and returned).  The state holds the whole cluster, so runs
    over consecutive slices compose into one run over their union."""
    return run_staged(st, state, trace, heavy_capacity,
                      stage_events(trace, start, stop))


def run_staged(st: ReplayStatics, state: Dict[str, torch.Tensor],
               trace: Trace, heavy_capacity: int, rows: Tuple
               ) -> Dict[str, torch.Tensor]:
    """:func:`run_events` over rows already staged by
    :func:`stage_events`."""
    dev = trace.device
    T = pc.tables_for(st.models, dev)
    h, d = trace.host, trace.dev
    G = d["gpu_mid"].shape[0]
    N = state["vmrow"].shape[0]
    M, NP = T.num_models, T.num_profiles
    H = state["host_used"].shape[0]
    need_defrag = st.policy == GRMU and st.defrag
    need_consolidation = (st.policy == GRMU
                          and st.consolidation_interval is not None)

    mid, ghost, gfull = d["gpu_mid"], d["gpu_host"], d["gpu_full"]
    vm_pids, vm_res, cap_g = d["vm_pids"], d["vm_res"], d["cap_g"]
    vm_pids_h, vm_heavy_h = h["vm_pids"], h["vm_heavy"]
    gpu_host_h = h["gpu_host"]
    heavy_cap = int(heavy_capacity)
    light_cap = int(h["n_gpus"]) - heavy_cap

    free, vmrow, counts = state["free"], state["vmrow"], state["counts"]
    host_used, hourly = state["host_used"], state["hourly"]
    basket = state.get("basket")
    vm_count = state.get("vm_count")
    # 0-d carry scalars are worked on as (1,) views of the same storage.
    rej = state["rej"].view(1) if need_defrag else None
    intra = state["intra"].view(1) if st.policy == GRMU else None
    inter = state["inter"].view(1) if st.policy == GRMU else None
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    garange = torch.arange(G, device=dev)
    if st.telemetry:
        tele_steps, tele_masks = state["tele_steps"], state["tele_masks"]
        code_table, basket_cols = obs_inscan.device_tables(str(dev))

    if st.policy == MECC:
        mecc_counts = state["mecc_counts"]
        atimes, apids = h["arr_times"], d["arr_pids"]
        A = len(atimes)
        marange = torch.arange(M, device=dev)
        ones_m = torch.ones(M, dtype=torch.int32, device=dev)
        neg = torch.full((A, M), -1, dtype=torch.int32, device=dev)
        window = np.float32(st.mecc_window)
        ptr = int(state["mecc_ptr"])
    if need_consolidation:
        interval = np.float32(st.consolidation_interval)
        last_cons = np.float32(state["last_cons"].item())

    # -- arrival ---------------------------------------------------------
    def arrival(vi: int, p: int, time: np.float32):
        nonlocal ptr
        pids = vm_pids[vi]                              # (M,) int64
        mecc_w = None
        if st.policy == MECC:
            # Count the arrival (once per fleet model), then expire the
            # history older than (now - window): a two-pointer over the
            # static observation schedule, compared in float32.
            mecc_counts.index_put_((marange, pids), ones_m, accumulate=True)
            cutoff = time - window
            p0 = ptr
            while ptr < A and atimes[ptr] < cutoff:
                ptr += 1
            if ptr > p0:
                k = ptr - p0
                mecc_counts.index_put_((marange.expand(k, M), apids[p0:ptr]),
                                       neg[:k], accumulate=True)
            mecc_w = pc.mecc_weights(mecc_counts)

        need = vm_res[vi]                               # (2,) cpu, ram
        heavy = bool(vm_heavy_h[vi])
        grew = quota_full = None
        if st.policy == GRMU:
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
            pick = _kernel_pick(st, free, int(vm_pids_h[vi, 0]), ghost,
                                host_used, cap_g, need, mecc_w)
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
                T, mid, free, pids, host_ok, ok, code_table, grew,
                quota_full))
        vmrow[vi] = torch.cat(row)
        free[g] = torch.where(ok, T.assign_mask[mid_g, ml, p_g], mask)
        counts[p, 0:1] += okc
        counts[p, 1] += 1
        hg = ghost[g]
        host_used[hg] = host_used[hg] + torch.where(ok, need, zero_f)
        if need_consolidation:
            vm_count[g] = vm_count[g] + okc
        if need_defrag and not (st.defrag_trigger == "light" and heavy):
            rej.logical_or_(~ok)

    # -- departure --------------------------------------------------------
    def departure(vi: int):
        r = vmrow[vi]
        ok = r[0:1] >= 0
        okc = ok.to(torch.int32)
        g = r[0:1].clamp(min=0).long()
        mid_g = mid[g]
        blocks = T.size_mask[mid_g, vm_pids[vi][mid_g]] << r[1:2]
        fg = free[g]
        hg = ghost[g]
        delta = torch.where(ok, -vm_res[vi], zero_f)
        free[g] = torch.where(ok, fg | blocks, fg)
        vmrow[vi, 0] = -1
        host_used[hg] = host_used[hg] + delta
        if need_consolidation:
            vm_count[g] = vm_count[g] - okc

    # -- GRMU step-end operations ----------------------------------------
    def do_defrag():
        light = basket == pc.LIGHT_BASKET
        tgt = pc.defrag_target(T, mid, free, light)
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
                              device=dev)
        prof_blk[blk] = torch.where(on_g, vm_pids[:, mid_g].view(-1), -1)
        starts, ok, final_mask, moved = pc.repack_gpu(
            T, mid_g, prof_blk[:T.max_blocks])
        apply = do & ok & (moved > 0)
        # Each VM on g moves to its block's repacked start.
        lut = torch.where(starts >= 0, starts,
                          torch.arange(T.max_blocks, device=dev,
                                       dtype=starts.dtype))
        vmrow[:, 1] = torch.where(on_g & apply, lut[vm_start],
                                  vmrow[:, 1])
        free[g] = torch.where(apply, final_mask, free[g])
        intra.add_(torch.where(apply, moved, 0))

    def do_consolidate():
        vm_gpu = vmrow[:, 0]
        # Sole resident per GPU (valid only where vm_count == 1; the
        # winner among duplicate indices is unspecified and never read).
        owner = torch.full((G + 1,), -1, dtype=torch.int32, device=dev)
        owner[torch.where(vm_gpu >= 0, vm_gpu, G).long()] = torch.arange(
            N, dtype=torch.int32, device=dev)
        owner = owner[:G]
        owner_c = owner.clamp(0, N - 1).long()
        has = (owner >= 0)[:, None]
        # The sole VM mapped onto every fleet model, (G, M); and onto its
        # own GPU's model, (G,).
        sole_pids = torch.where(has, vm_pids[owner_c], -1)
        sole_own = sole_pids[garange, mid]
        sole_res = torch.where(has, vm_res[owner_c], zero_f)
        cand = pc.consolidation_candidates(
            T, mid, free, basket == pc.LIGHT_BASKET, vm_count, sole_own)
        tgt_of, cpu_used, ram_used = pc.consolidation_plan(
            T, mid, free, cand, sole_pids, sole_res[:, 0], sole_res[:, 1],
            ghost, host_used[:, 0], host_used[:, 1], d["cpu_cap"],
            d["ram_cap"], gpu_host_h)
        valid = tgt_of >= 0
        tgt_c = tgt_of.clamp(0, G - 1).long()
        # Each source's profile under its *target's* model.
        p_tgt = sole_pids[garange, mid[tgt_c]].clamp(0, NP - 1)
        starts = T.assign_start[mid[tgt_c], free[tgt_c].long(), p_tgt]
        # Receive side: each target gets exactly one source.
        recv_p = torch.full((G + 1,), -1, dtype=torch.int64, device=dev)
        recv_p[torch.where(valid, tgt_of, G).long()] = torch.where(
            valid, p_tgt, -1)
        recv_p = recv_p[:G]
        recv_pc = recv_p.clamp(0, NP - 1)
        new_free = torch.where(valid, gfull, free)
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
        inter.add_(valid.sum().to(torch.int32))

    # -- step end ----------------------------------------------------------
    def step_end(time: np.float32, idx: int):
        nonlocal last_cons
        if need_defrag:
            if bool(rej):                   # one host sync per step-end
                do_defrag()
            rej.zero_()
        if need_consolidation and time - last_cons >= interval:
            do_consolidate()
            last_cons = time
        gpu_active = (free != gfull).to(torch.int32)
        per_host = torch.zeros(H, dtype=torch.int32, device=dev).index_add_(
            0, ghost, gpu_active)
        hourly[idx] = torch.stack([
            counts[:, 0].sum(), counts[:, 1].sum(), (per_host > 0).sum(),
            gpu_active.sum()]).to(torch.int32)
        if st.telemetry:
            head, tele_masks[idx] = obs_inscan.step_row(state, basket_cols)
            if head is not None:
                tele_steps[idx] = head

    kinds, vis, profs, idxs, times = rows
    for j, kind in enumerate(kinds):
        if kind == ARRIVAL:
            arrival(vis[j], profs[j], times[j])
        elif kind == DEPARTURE:
            departure(vis[j])
        elif kind == STEP_END:
            step_end(times[j], idxs[j])
        # PAD rows are a no-op.

    if st.policy == MECC:
        state["mecc_ptr"].fill_(ptr)
    if need_consolidation:
        state["last_cons"].fill_(float(last_cons))
    return state


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
    (``None`` = the CUDA device).  The trace is moved to the device once;
    each call starts from a fresh state."""
    device = resolve_device(device)
    st = replay_statics(events, policy, **cfg)
    trace = trace_from_numpy(trace_arrays(events), device)

    def run(heavy_capacity):
        state = init_state(events, st, device)
        return _finalize(st, run_events(st, state, trace, heavy_capacity))

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
           "stage_events", "run_staged", "EVENT_KEYS",
           "default_heavy_capacity", "trace_arrays", "trace_from_numpy",
           "Trace", "init_state", "state_from_numpy", "state_to_numpy",
           "replay_statics", "ReplayStatics", "step_grid",
           "FF", "BF", "MCC", "MECC", "GRMU",
           "DEPARTURE", "ARRIVAL", "STEP_END", "PAD", "PAD_BASKET"]
