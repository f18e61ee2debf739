"""Online placement service — port of ``repro/serve/placement.py``.

``PlacementService`` turns the offline trace replayer into the paper's
*online* GRMU framework: streaming VM arrivals/departures enter a bounded
request queue (``repro_torch.serve.queue``) and are drained in
**micro-batches** through the replay's decision step
(``repro_torch.core.batched.make_decision_step``) against live cluster
state, held on the service's device between batches.

Serve-many: the service pads a zero-event skeleton trace of its fleet to
fixed capacity buckets (``pad_events(min_shape=...)``), so every
micro-batch has one bucket shape and one replay runner of the compile
cache serves a tier's whole life: on the card its captured CUDA graphs,
one graph launch per event.  The service owns its state tensors and its
resident trace tables; each batch copies them into the runner's static
buffers and the state back, so services of one configuration never share
state.  Because the event step never reads an event's position, the
stream of micro-batches computes exactly the single replay's fixpoint:
**decisions are bit-identical to an offline replay of the same arrival
order**, for every registry policy and any batch size, and to the JAX
service's (tests/test_torch_serve.py).

Event semantics mirror the offline lowering exactly: the service tracks
the current step bucket, auto-inserts STEP_END rows when a request's
bucket advances past it (defrag / consolidation / hourly sampling run in
the step, exactly where the offline stream places them), stamps arrivals
with the bucket's accumulated float64 grid time, and applies the offline
same-bucket departure rule.  New arrivals' per-VM rows and MECC
observation rows are copied in place into the resident tables (one
host-to-device copy) before the batch's step runs; the batch's real rows
are staged with one more; the pending arrivals' decisions come back in
one device-to-host copy, the batch's only host synchronisation apart
from GRMU's consolidating step-ends.  On the host the service carries
GRMU's last consolidation time and MECC's expiry pointer and width
(``batched.HostCarry``).

Scoring: the tiers' statics resolve ``score_backend="auto"`` as the
offline replay does, so on a single-model fleet the MCC and MECC tiers
launch the fused pick kernels (``mcc_pick`` / ``ecc_pick``) once per
arrival, inside the graphs.  The JAX service pins ``"tables"``; the
decisions are identical either way.

Graceful degradation: an admission :class:`Governor` walks a tier ladder
(e.g. ``("ILP", "GRMU", "FF")``) — degrading when queue depth or the
rolling p99 decision latency breaches the SLO, recovering after a run of
healthy batches.  Registry-policy tiers run on the array backend (one
decision step per tier's ``ReplayStatics``); the ``"ILP"`` tier runs the
rolling-horizon :class:`~repro_torch.core.policies.ILPPolicy` against an
object-level ``Cluster`` rebuilt from the same canonical state snapshot
that moves between tiers.  Switches are recorded through the flight
recorder (``serve.batch`` spans + ``service`` JSONL records).

Checkpoint/restore rides ``repro_torch.launch.checkpoint``: the canonical
snapshot (state + host-side VM/arrival tables + stream counters) is an
atomic numpy-pytree checkpoint in the JAX package's layout, and a freshly
constructed service with the same config restores mid-stream (from
either package's checkpoint) and continues bit-identically.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import batched as B
from ..core import policy_core as pc
from ..core.bucketing import next_pow2, pad_events
from ..core.mig import GPU, DeviceModel
from ..device import DeviceLike, resolve_device
from ..launch import checkpoint as ckpt
from ..obs import recorder as obs_recorder
from ..sim.cluster import VM, Cluster, Host
from .queue import (Arrival, BoundedRequestQueue, Departure, Request,
                    arrival_bucket, departure_bucket)

_EPS = 1e-9

# The object-backed oracle tier (rolling-horizon MILP); every other tier
# name must be a registry policy id (FF/BF/MCC/MECC/GRMU).
ILP_TIER = "ILP"


@dataclasses.dataclass
class ServeConfig:
    """Service capacities, policy knobs and governor thresholds.

    Capacities size the padded state buckets (then pow2-rounded by
    ``pad_events``): ``max_vms`` bounds total arrivals over the service's
    life, ``max_steps`` the step-grid horizon, ``max_arrivals`` the MECC
    observation schedule (defaults to ``max_vms``).  ``micro_batch`` is
    the decision step's event-row count per dispatch (pow2-rounded).
    """
    policy: str = "GRMU"
    tiers: Optional[Tuple[str, ...]] = None   # degradation ladder;
    #                                           None = (policy,) only
    micro_batch: int = 64
    queue_capacity: int = 1024
    max_vms: int = 4096
    max_steps: int = 1024
    max_arrivals: Optional[int] = None
    step_hours: float = 1.0
    # Policy knobs (mirror repro_torch.core.batched.replay defaults).
    heavy_capacity: Optional[int] = None      # None = round(0.30 * G)
    heavy_capacity_frac: float = 0.30
    defrag: bool = True
    consolidation_interval: Optional[float] = None
    defrag_trigger: str = "light"
    mecc_window: float = 24.0
    # Admission governor.
    slo_s: float = 0.050          # rolling-p99 decision-latency SLO
    degrade_depth: float = 0.75   # queue fill fraction that breaches
    recover_after: int = 8        # healthy batches before stepping up
    latency_window: int = 256     # rolling decision-latency samples
    # ILP-tier knobs (object backend).
    ilp_window: int = 8
    ilp_time_limit: float = 5.0


@dataclasses.dataclass(frozen=True)
class Decision:
    """One arrival's placement decision.  ``latency_s`` is submit ->
    decision-ready wall time (queue wait + step + readback)."""
    vm_id: int
    accepted: bool
    gpu: int                  # global GPU index, -1 when rejected
    start: int                # start block on the chosen GPU
    tier: str                 # tier that made the decision
    latency_s: float


class Governor:
    """Admission governor: walks the tier ladder on SLO breach.

    A batch *breaches* when the queue fill is at/above ``degrade_depth``
    or the rolling p99 of decision latencies exceeds ``slo_s``.  A breach
    degrades one tier (toward the cheap end of the ladder);
    ``recover_after`` consecutive healthy batches recover one tier.  The
    latency window is cleared on every switch so the new tier is judged
    on its own samples.  ``slo_s`` is mutable at runtime (operators
    retune SLOs; tests drive the trigger with it)."""

    def __init__(self, cfg: ServeConfig, n_tiers: int):
        self.slo_s = float(cfg.slo_s)
        self.degrade_depth = float(cfg.degrade_depth)
        self.recover_after = int(cfg.recover_after)
        self.n_tiers = int(n_tiers)
        self.tier = 0
        self._healthy = 0
        self._lats = deque(maxlen=int(cfg.latency_window))

    def p99_s(self) -> float:
        if not self._lats:
            return 0.0
        return float(np.percentile(np.asarray(self._lats), 99.0))

    def note_batch(self, latencies: Sequence[float],
                   fill: float) -> Optional[Tuple[str, int, int]]:
        """Feed one batch's decision latencies + queue fill; returns a
        ``("degrade"|"recover", from_tier, to_tier)`` switch or None."""
        self._lats.extend(latencies)
        breach = fill >= self.degrade_depth or self.p99_s() > self.slo_s
        if breach:
            self._healthy = 0
            if self.tier < self.n_tiers - 1:
                old, self.tier = self.tier, self.tier + 1
                self._lats.clear()
                return ("degrade", old, self.tier)
            return None
        self._healthy += 1
        if self.tier > 0 and self._healthy >= self.recover_after:
            old, self.tier = self.tier, self.tier - 1
            self._healthy = 0
            self._lats.clear()
            return ("recover", old, self.tier)
        return None


def _skeleton_trace(models: Tuple[DeviceModel, ...],
                    gpu_model_id: np.ndarray, gpu_host_id: np.ndarray,
                    cpu_cap: np.ndarray, ram_cap: np.ndarray,
                    step_hours: float) -> B.EventTrace:
    """A zero-event EventTrace of the fleet — the shape seed that
    ``pad_events(min_shape=...)`` grows into the service's fixed-capacity
    state buckets."""
    M = len(models)
    return B.EventTrace(
        kind=np.zeros(0, np.uint8), vm_index=np.zeros(0, np.int32),
        profile=np.zeros(0, np.int16), time=np.zeros(0, np.float32),
        idx=np.zeros(0, np.int32), vm_ids=np.zeros(0, np.int64),
        vm_pids=np.zeros((0, M), np.int16), vm_heavy=np.zeros(0, bool),
        vm_cpu=np.zeros(0, np.float32), vm_ram=np.zeros(0, np.float32),
        arr_times=np.zeros(0, np.float32),
        arr_pids=np.zeros((0, M), np.int16),
        step_times=np.zeros(0, np.float64),
        num_vms=0, num_gpus=len(gpu_model_id), num_hosts=len(cpu_cap),
        models=tuple(models),
        gpu_model_id=np.asarray(gpu_model_id, np.int32),
        gpu_host_id=np.asarray(gpu_host_id, np.int32),
        cpu_cap=np.asarray(cpu_cap, np.float32),
        ram_cap=np.asarray(ram_cap, np.float32),
        step_hours=step_hours)


def requests_from_trace(events: B.EventTrace
                        ) -> Tuple[List[Request], float]:
    """Convert an offline EventTrace's rows into the canonical request
    stream (STEP_END rows skipped — the service regenerates them) plus
    the horizon to :meth:`PlacementService.flush` to.  Feeding this
    stream reproduces the offline replay's decisions bit-for-bit."""
    reqs: List[Request] = []
    for j in range(len(events.kind)):
        k = int(events.kind[j])
        if k == B.ARRIVAL:
            i = int(events.vm_index[j])
            reqs.append(Arrival(
                vm_id=int(events.vm_ids[i]), time=float(events.time[j]),
                profile_ids=tuple(int(x) for x in events.vm_pids[i]),
                cpu=float(events.vm_cpu[i]),
                ram=float(events.vm_ram[i])))
        elif k == B.DEPARTURE:
            i = int(events.vm_index[j])
            reqs.append(Departure(vm_id=int(events.vm_ids[i]),
                                  time=float(events.time[j])))
    horizon = (float(events.step_times[-1])
               if len(events.step_times) else 0.0)
    return reqs, horizon


# The resident tables a restore or an ingest writes: the host mirror's
# key in the service's trace and its device dtype.
_MUTABLE = (("vm_pids", torch.int64), ("vm_res", torch.float32),
            ("arr_times", torch.float32), ("arr_pids", torch.int64))


class PlacementService:
    """See the module docstring.  Build with :meth:`from_cluster` /
    :meth:`for_trace`, or directly from fleet arrays.  ``device`` is
    where the array tiers' state lives (``None`` = the CUDA device; pass
    ``device="cpu"`` for the CPU)."""

    def __init__(self, *, models: Sequence[DeviceModel],
                 gpu_model_id: np.ndarray, gpu_host_id: np.ndarray,
                 cpu_cap: np.ndarray, ram_cap: np.ndarray,
                 config: Optional[ServeConfig] = None,
                 device: DeviceLike = None):
        cfg = config or ServeConfig()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = tuple(models)
        self._M = len(self.models)
        self._G = len(gpu_model_id)
        self._H = len(cpu_cap)
        self._step_hours = float(cfg.step_hours)

        batch = next_pow2(max(int(cfg.micro_batch), 1))
        max_arr = cfg.max_arrivals or cfg.max_vms
        skeleton = _skeleton_trace(self.models, gpu_model_id,
                                   gpu_host_id, cpu_cap, ram_cap,
                                   self._step_hours)
        self._padded = pad_events(
            skeleton,
            min_shape=(batch, max(cfg.max_vms, 1), 1, 1,
                       max(max_arr, 1), max(cfg.max_steps, 1)))
        self._batch_rows = len(self._padded.kind)          # E
        self._Ncap = len(self._padded.vm_pids)
        self._Acap = len(self._padded.arr_times)
        self._Scap = self._padded.hourly_slots
        self._Gp = len(self._padded.gpu_model_id)
        self._Hp = len(self._padded.cpu_cap)
        self._NP = pc.tables_for(self.models, "cpu").num_profiles
        self._heavy_profiles = np.array(
            [m.heavy_profile for m in self.models], np.int16)

        # Tier ladder -> statics / backends.
        self._tier_names: Tuple[str, ...] = tuple(cfg.tiers or
                                                  (cfg.policy,))
        self._statics: Dict[str, B.ReplayStatics] = {}
        for name in self._tier_names:
            if name == ILP_TIER:
                # Object-backend topology is validated on tier entry
                # (_enter_object): gpu_host_id must be host-grouped.
                continue
            if name not in pc.POLICY_IDS:
                raise ValueError(f"unknown tier policy {name!r} (want "
                                 f"one of {list(pc.POLICY_IDS)} or "
                                 f"{ILP_TIER!r})")
            self._statics[name] = B.replay_statics(
                self._padded, pc.POLICY_IDS[name], defrag=cfg.defrag,
                consolidation_interval=cfg.consolidation_interval,
                defrag_trigger=cfg.defrag_trigger,
                mecc_window=cfg.mecc_window)
        if cfg.heavy_capacity is not None:
            self.heavy_capacity = int(cfg.heavy_capacity)
        else:
            # Same rounding as default_heavy_capacity / the GRMU class.
            self.heavy_capacity = int(round(cfg.heavy_capacity_frac
                                            * self._G))

        # Resident trace tables on the device; their host arrays are the
        # mutable tables' mirrors (checkpoint source, object-tier rebuild
        # source, the decision step's plan).  Both are written in place:
        # never rebind an entry.
        rest_np = {k: v.copy() for k, v in
                   B.trace_arrays(self._padded).items()}
        self._trace = B.trace_from_numpy(rest_np, self.device)
        h = self._trace.host
        self._h_vm_pids = h["vm_pids"]
        self._h_vm_heavy = h["vm_heavy"]
        self._h_vm_res = h["vm_res"]
        self._h_arr_times = h["arr_times"]
        self._h_arr_pids = h["arr_pids"]

        # Per-slot stream bookkeeping (host only).
        self._h_vm_ids = np.full(self._Ncap, -1, np.int64)
        self._h_vm_arrival = np.zeros(self._Ncap, np.float64)
        self._h_vm_abucket = np.zeros(self._Ncap, np.int32)
        self._h_accepted = np.zeros(self._Ncap, bool)
        self._slot_of: Dict[int, int] = {}
        self._n_vms = 0
        self._n_arr = 0
        self._bucket = 0
        self._step_t = 0.0          # accumulated float64 step grid
        self.late_requests = 0

        # Migration totals carried across tier switches; the live tier's
        # own counters start at 0 after every switch.
        self._mig_intra = 0
        self._mig_inter = 0

        self.queue = BoundedRequestQueue(cfg.queue_capacity)
        self.governor = Governor(cfg, len(self._tier_names))
        self.decisions: Dict[int, Decision] = {}
        self.tier_occupancy: Dict[str, int] = {n: 0
                                               for n in self._tier_names}
        self.switch_events: List[dict] = []
        self._ckpt_seq = 0

        # Object-tier state (populated by _enter_object).
        self._cluster: Optional[Cluster] = None
        self._policy = None
        self._h_counts = np.zeros((self._NP, 2), np.int32)
        self._h_hourly = np.zeros((self._Scap, 4), np.int32)
        self._rejected_step: List[VM] = []

        # Array-tier state.  The MECC width only grows over the service's
        # life (any width at or above an arrival's expiry count decides
        # alike), so a tier switch keeps it.
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._step_fn: Optional[B.DecisionStep] = None
        self._carry = B.HostCarry()
        self.batches = 0

        self._enter_tier(0, self._initial_snapshot())

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_cluster(cls, cluster: Cluster,
                     config: Optional[ServeConfig] = None,
                     device: DeviceLike = None) -> "PlacementService":
        return cls(models=cluster.models,
                   gpu_model_id=cluster.gpu_model_id,
                   gpu_host_id=cluster.gpu_host_id,
                   cpu_cap=cluster.host_cpu_cap,
                   ram_cap=cluster.host_ram_cap, config=config,
                   device=device)

    @classmethod
    def for_trace(cls, events: B.EventTrace,
                  config: Optional[ServeConfig] = None,
                  device: DeviceLike = None) -> "PlacementService":
        """A service sized to replay ``events``' fleet and stream (the
        parity-test / benchmark constructor)."""
        cfg = dataclasses.replace(
            config or ServeConfig(),
            max_vms=max(events.num_vms, 1),
            max_steps=max(len(events.step_times), 1),
            max_arrivals=max(len(events.arr_times), 1),
            step_hours=events.step_hours)
        return cls(models=events.models,
                   gpu_model_id=events.gpu_model_id[:events.num_gpus],
                   gpu_host_id=events.gpu_host_id[:events.num_gpus],
                   cpu_cap=events.cpu_cap[:events.num_hosts],
                   ram_cap=events.ram_cap[:events.num_hosts],
                   config=cfg, device=device)

    # -- public surface ----------------------------------------------------
    @property
    def tier_name(self) -> str:
        return self._tier_names[self.governor.tier]

    @property
    def runner(self) -> Optional[B.Runner]:
        """The replay runner the live array tier used last (None on the
        ILP tier or before the first batch)."""
        return self._step_fn.runner if self._step_fn is not None else None

    def submit(self, req: Request) -> bool:
        """Enqueue a request; False = queue full (backpressure)."""
        return self.queue.submit(req)

    def drain(self, max_batches: Optional[int] = None) -> List[Decision]:
        """Drain queued requests through the decision step in
        micro-batches; returns the arrival decisions made."""
        out: List[Decision] = []
        batches = 0
        while len(self.queue) and (max_batches is None
                                   or batches < max_batches):
            out.extend(self._drain_batch())
            batches += 1
        return out

    def flush(self, horizon: float) -> None:
        """Drain everything queued, then emit trailing STEP_END events
        through the step grid up to ``horizon`` (inclusive) — the online
        equivalent of the offline trace's trailing step rows."""
        self.drain()
        if self.tier_name == ILP_TIER:
            while self._step_t < horizon + _EPS:
                self._object_step_end()
            return
        while self._step_t < horizon + _EPS:
            self._dispatch_steps_only(horizon)

    def accepted_ids(self) -> List[int]:
        """Accepted vm_ids in arrival order (== offline
        ``SimResult.accepted_ids`` for the same stream)."""
        return [int(self._h_vm_ids[i]) for i in range(self._n_vms)
                if self._h_accepted[i]]

    def migrations(self) -> Tuple[int, int]:
        """(intra, inter) migration totals across all tiers so far."""
        snap = self._snapshot()
        return int(snap["intra"]), int(snap["inter"])

    def stats(self) -> dict:
        lats = [d.latency_s for d in self.decisions.values()]
        arr = np.asarray(lats) if lats else np.zeros(1)
        return {
            "tier": self.tier_name,
            "decisions": len(self.decisions),
            "accepted": sum(d.accepted for d in
                            self.decisions.values()),
            "p50_ms": float(np.percentile(arr, 50.0)) * 1e3,
            "p99_ms": float(np.percentile(arr, 99.0)) * 1e3,
            "queue_high_watermark": self.queue.high_watermark,
            "queue_dropped": self.queue.dropped,
            "tier_occupancy": dict(self.tier_occupancy),
            "switches": len(self.switch_events),
        }

    # -- checkpoint / restore ----------------------------------------------
    def _checkpoint_tree(self, snap: Optional[dict] = None) -> dict:
        snap = snap or self._snapshot()
        return {
            "snap": snap,
            "vm": {"pids": self._h_vm_pids, "heavy": self._h_vm_heavy,
                   "res": self._h_vm_res, "ids": self._h_vm_ids,
                   "arrival": self._h_vm_arrival,
                   "abucket": self._h_vm_abucket,
                   "accepted": self._h_accepted},
            "arr": {"times": self._h_arr_times,
                    "pids": self._h_arr_pids},
            "scalars": np.array(
                [self._n_vms, self._n_arr, self._bucket,
                 self.governor.tier, self.late_requests],
                np.int64),
            "step_t": np.float64(self._step_t),
        }

    def checkpoint(self, ckpt_dir: str) -> str:
        """Atomically snapshot the full service state (drained queue
        required — in-flight requests are not part of the state)."""
        if len(self.queue):
            raise RuntimeError("drain() the queue before checkpointing "
                               f"({len(self.queue)} requests in flight)")
        self._ckpt_seq += 1
        path = ckpt.save(ckpt_dir, self._ckpt_seq,
                         self._checkpoint_tree())
        rec = obs_recorder.active()
        if rec is not None:
            rec.service("checkpoint", dir=ckpt_dir, seq=self._ckpt_seq,
                        bucket=self._bucket, n_vms=self._n_vms)
        return path

    def restore(self, ckpt_dir: str) -> bool:
        """Restore the newest checkpoint into this (identically
        configured, freshly built) service.  Returns False when no valid
        checkpoint exists."""
        out = ckpt.restore_latest(ckpt_dir, self._checkpoint_tree())
        if out is None:
            return False
        seq, tree = out
        self._ckpt_seq = int(seq)
        # Host mirrors and the resident tables, in place.
        for mirror, src in ((self._h_vm_pids, tree["vm"]["pids"]),
                            (self._h_vm_heavy, tree["vm"]["heavy"]),
                            (self._h_vm_res, tree["vm"]["res"]),
                            (self._h_arr_times, tree["arr"]["times"]),
                            (self._h_arr_pids, tree["arr"]["pids"])):
            mirror[...] = src
        dev = self._trace.dev
        for k, dtype in _MUTABLE:
            dev[k].copy_(torch.as_tensor(self._trace.host[k]).to(dtype))
        self._h_vm_ids = tree["vm"]["ids"].copy()
        self._h_vm_arrival = tree["vm"]["arrival"].copy()
        self._h_vm_abucket = tree["vm"]["abucket"].copy()
        self._h_accepted = tree["vm"]["accepted"].copy()
        n_vms, n_arr, bucket, tier, late = (int(x) for x in
                                            tree["scalars"])
        self._n_vms, self._n_arr = n_vms, n_arr
        self._bucket, self.late_requests = bucket, late
        self._step_t = float(tree["step_t"])
        self._slot_of = {int(self._h_vm_ids[i]): i
                         for i in range(n_vms)}
        snap = {k: np.asarray(v) for k, v in tree["snap"].items()}
        self._mig_intra = int(snap["intra"])
        self._mig_inter = int(snap["inter"])
        self.governor.tier = min(tier, len(self._tier_names) - 1)
        self._enter_tier(self.governor.tier, snap)
        rec = obs_recorder.active()
        if rec is not None:
            rec.service("restore", dir=ckpt_dir, seq=self._ckpt_seq,
                        bucket=self._bucket, n_vms=self._n_vms)
        return True

    # -- canonical state snapshot ------------------------------------------
    def _initial_snapshot(self) -> dict:
        """Fresh-service snapshot — value-identical to
        ``batched.init_state`` on the padded skeleton."""
        ar = np.arange(self._Gp)
        basket = np.where(ar == 0, pc.HEAVY_BASKET,
                          np.where(ar == 1, pc.LIGHT_BASKET,
                                   pc.POOL)).astype(np.int32)
        basket[self._G:] = B.PAD_BASKET
        return {
            "free": np.asarray(B._gpu_full(self._padded), np.int32),
            "vmrow": np.tile(np.array([-1, 0, 0], np.int32),
                             (self._Ncap, 1)),
            "counts": np.zeros((self._NP, 2), np.int32),
            "host_used": np.zeros((self._Hp, 2), np.float32),
            "hourly": np.zeros((self._Scap, 4), np.int32),
            "basket": basket,
            "intra": np.int32(0), "inter": np.int32(0),
            "rej": np.bool_(False),
            "vm_count": np.zeros(self._Gp, np.int32),
            "last_cons": np.float32(0.0),
            "mecc_counts": np.zeros((self._M, self._NP), np.int32),
            "mecc_ptr": np.int32(0),
        }

    def _snapshot(self, tier: Optional[int] = None) -> dict:
        """The canonical host-side cluster state: every key every tier
        could need, synthesized deterministically where the live tier
        doesn't track it.  ``intra``/``inter`` are service-lifetime
        totals (tier bases folded in).  ``tier`` is the ladder index of
        the tier whose state is live (default: the governor's)."""
        snap = self._initial_snapshot()
        if tier is None:
            tier = self.governor.tier
        if self._tier_names[tier] == ILP_TIER:
            cl, pol = self._cluster, self._policy
            free = snap["free"]
            free[:self._G] = cl.free_masks.astype(np.int32)
            vmrow = snap["vmrow"]
            for vm_id, (host, gpu) in cl.placements.items():
                i = self._slot_of[vm_id]
                vmrow[i, 0] = gpu.global_index
                vmrow[i, 1] = int(gpu.placements[vm_id][1])
            vmrow[:self._Ncap, 2] = self._h_accepted
            host_used = snap["host_used"]
            host_used[:self._H, 0] = cl.host_cpu_used
            host_used[:self._H, 1] = cl.host_ram_used
            snap["counts"] = self._h_counts.copy()
            snap["hourly"] = self._h_hourly.copy()
            snap["intra"] = np.int32(self._mig_intra
                                     + pol.intra_migrations)
            snap["inter"] = np.int32(self._mig_inter
                                     + pol.inter_migrations)
        else:
            live = B.state_to_numpy(self._state)
            for k, v in live.items():
                snap[k] = np.array(v)
            snap["vmrow"][:, 2] = self._h_accepted
            snap["intra"] = np.int32(self._mig_intra
                                     + int(live.get("intra", 0)))
            snap["inter"] = np.int32(self._mig_inter
                                     + int(live.get("inter", 0)))
        # Keys the leaving tier didn't track keep their deterministic
        # initial-snapshot synthesis (documented loss: GRMU basket
        # evolution and MECC observation history do not survive an
        # intervening tier that doesn't carry them; the consolidation
        # clock restarts at the switch).
        return snap

    # -- tier transitions --------------------------------------------------
    def _switch_tier(self, kind: str, old: int, new: int) -> None:
        # The governor has moved on already; the live state is the
        # leaving tier's.  (The JAX service snapshots by the governor's
        # new tier, which fails on leaving or entering the ILP tier.)
        snap = self._snapshot(old)
        self._mig_intra = int(snap["intra"])
        self._mig_inter = int(snap["inter"])
        event = {"event": kind, "from": self._tier_names[old],
                 "to": self._tier_names[new], "bucket": self._bucket,
                 "queue_depth": len(self.queue),
                 "p99_ms": self.governor.p99_s() * 1e3}
        self.switch_events.append(event)
        rec = obs_recorder.active()
        if rec is not None:
            rec.service(**event)
        self._enter_tier(new, snap)

    def _enter_tier(self, tier: int, snap: dict) -> None:
        name = self._tier_names[tier]
        if name == ILP_TIER:
            self._enter_object(snap)
        else:
            self._enter_array(name, snap)

    def _enter_array(self, name: str, snap: dict) -> None:
        st = self._statics[name]
        self._cluster = None
        self._policy = None

        def t(key, dtype, value=None):
            a = np.array(snap[key] if value is None else value, dtype)
            return torch.as_tensor(a, device=self.device)

        state = dict(free=t("free", np.int32), vmrow=t("vmrow", np.int32),
                     counts=t("counts", np.int32),
                     host_used=t("host_used", np.float32),
                     hourly=t("hourly", np.int32))
        carry = B.HostCarry(width=self._carry.width)
        if st.policy == B.GRMU:
            state["basket"] = t("basket", np.int32)
            state["intra"] = t(None, np.int32, 0)
            state["inter"] = t(None, np.int32, 0)
            if st.defrag:
                state["rej"] = t(None, np.bool_, False)
            if st.consolidation_interval is not None:
                vm_gpu = snap["vmrow"][:, 0]
                state["vm_count"] = t(None, np.int32, np.bincount(
                    vm_gpu[vm_gpu >= 0], minlength=self._Gp))
                carry.last_cons = np.float32(snap["last_cons"])
                state["last_cons"] = t(None, np.float32, carry.last_cons)
        if st.policy == B.MECC:
            state["mecc_counts"] = t("mecc_counts", np.int32)
            state["mecc_ptr"] = t("mecc_ptr", np.int32)
            carry.mecc_ptr = int(snap["mecc_ptr"])
        self._state = state
        self._carry = carry
        self._step_fn = B.make_decision_step(st)

    def _enter_object(self, snap: dict) -> None:
        from ..core.policies import ILPPolicy
        ghid = self._padded.gpu_host_id[:self._G]
        if self._G and np.any(np.diff(ghid) < 0):
            raise ValueError(
                "the ILP tier rebuilds an object-level Cluster, which "
                "numbers GPUs host-by-host — gpu_host_id must be "
                "grouped (non-decreasing)")
        hosts = []
        g = 0
        for h in range(self._H):
            gpus = []
            while g < self._G and int(ghid[g]) == h:
                gpus.append(GPU(
                    model=self.models[
                        int(self._padded.gpu_model_id[g])]))
                g += 1
            hosts.append(Host(h, gpus,
                              float(self._padded.cpu_cap[h]),
                              float(self._padded.ram_cap[h])))
        cluster = Cluster(hosts, models=self.models)
        order = []
        vmrow = snap["vmrow"]
        for i in range(self._n_vms):
            if vmrow[i, 0] < 0:
                continue
            vm = self._vm_object(i)
            gidx = int(vmrow[i, 0])
            cluster.place_at(vm, cluster.gpu_index[gidx][1],
                             int(vmrow[i, 1]))
            order.append(vm.vm_id)
        policy = ILPPolicy(cluster, window=self.cfg.ilp_window,
                           time_limit=self.cfg.ilp_time_limit)
        # Residents in dense (acceptance) order define the rolling
        # window, exactly as if the policy had placed them itself.
        policy._order = order
        self._cluster = cluster
        self._policy = policy
        self._h_counts = snap["counts"].copy()
        self._h_hourly = snap["hourly"].copy()
        self._rejected_step = []
        self._state = None
        self._step_fn = None

    def _vm_object(self, slot: int) -> VM:
        pids = tuple(int(x) for x in self._h_vm_pids[slot])
        # profile is cosmetic when profile_ids is set (placement resolves
        # per-model via vm_pids); clamp -1 ("no GI on reference model").
        return VM(vm_id=int(self._h_vm_ids[slot]),
                  profile=self.models[0].profiles[max(pids[0], 0)],
                  arrival=float(self._h_vm_arrival[slot]),
                  duration=0.0,
                  cpu=float(self._h_vm_res[slot, 0]),
                  ram=float(self._h_vm_res[slot, 1]),
                  profile_ids=pids)

    # -- stream bookkeeping ------------------------------------------------
    def _request_bucket(self, req: Request) -> int:
        if isinstance(req, Arrival):
            b = arrival_bucket(req.time, self._step_hours)
            if b < self._bucket:
                self.late_requests += 1
                b = self._bucket
            return b
        slot = self._slot_of.get(req.vm_id)
        if slot is None:
            raise KeyError(f"departure for unknown vm_id {req.vm_id}")
        b = departure_bucket(req.time,
                             int(self._h_vm_abucket[slot]),
                             self._step_hours)
        if b < self._bucket:
            self.late_requests += 1
            b = self._bucket
        return b

    def _admit_slot(self, req: Arrival) -> Tuple[int, int]:
        """Assign the next dense VM slot + arrival ordinal and record the
        request in the host tables.  Returns (slot, arrival ordinal)."""
        if req.vm_id in self._slot_of:
            raise ValueError(f"duplicate arrival for vm_id {req.vm_id}")
        if self._n_vms >= self._Ncap:
            raise RuntimeError(
                f"VM capacity exhausted ({self._Ncap} slots; raise "
                "ServeConfig.max_vms)")
        if self._n_arr >= self._Acap:
            raise RuntimeError(
                f"arrival-schedule capacity exhausted ({self._Acap}; "
                "raise ServeConfig.max_arrivals)")
        if len(req.profile_ids) != self._M:
            raise ValueError(
                f"vm {req.vm_id}: profile_ids has "
                f"{len(req.profile_ids)} entries for a "
                f"{self._M}-model fleet")
        slot, a = self._n_vms, self._n_arr
        self._n_vms += 1
        self._n_arr += 1
        pids = np.asarray(req.profile_ids, np.int16)
        hp = self._heavy_profiles
        self._h_vm_pids[slot] = pids
        self._h_vm_heavy[slot] = bool(np.all((pids == hp) & (hp >= 0)))
        self._h_vm_res[slot] = (np.float32(req.cpu),
                                np.float32(req.ram))
        self._h_vm_ids[slot] = req.vm_id
        self._h_vm_arrival[slot] = req.time
        self._h_vm_abucket[slot] = self._bucket
        # MECC observation row: stamped with the bucket's grid start,
        # exactly like the offline arr_times column.
        self._h_arr_times[a] = np.float32(self._step_t)
        self._h_arr_pids[a] = pids
        self._slot_of[req.vm_id] = slot
        return slot, a

    def _advance_bucket(self) -> None:
        if self._bucket + 1 >= self._Scap:
            raise RuntimeError(
                f"step-grid capacity exhausted ({self._Scap} slots; "
                "raise ServeConfig.max_steps)")
        self._bucket += 1
        self._step_t += self._step_hours

    def _ingest(self, s0: int, a0: int, k: int) -> None:
        """Copy the ``k`` new arrivals' rows (VM slots ``s0..``, arrival
        ordinals ``a0..``) from the host mirrors into the resident
        tables, in place, through one host-to-device copy."""
        M = self._M
        pids = self._h_vm_pids[s0:s0 + k].astype(np.int64).reshape(-1)
        bits = np.concatenate([
            self._h_vm_res[s0:s0 + k].reshape(-1),
            self._h_arr_times[a0:a0 + k]]).view(np.int32)
        buf = B.host_to_device(
            np.concatenate([pids, bits.astype(np.int64)]), self.device)
        d = self._trace.dev
        p = buf[:k * M].view(k, M)
        f = buf[k * M:].to(torch.int32).view(torch.float32)
        d["vm_pids"][s0:s0 + k] = p
        d["arr_pids"][a0:a0 + k] = p
        d["vm_res"][s0:s0 + k] = f[:2 * k].view(k, 2)
        d["arr_times"][a0:a0 + k] = f[2 * k:]

    # -- the micro-batch ---------------------------------------------------
    def _drain_batch(self) -> List[Decision]:
        if self.tier_name == ILP_TIER:
            return self._drain_batch_object()
        return self._drain_batch_array()

    def _batch_arrays(self):
        E = self._batch_rows
        return dict(kind=np.full(E, B.PAD, np.uint8),
                    vm_index=np.zeros(E, np.int32),
                    profile=np.zeros(E, np.int16),
                    time=np.zeros(E, np.float32),
                    idx=np.zeros(E, np.int32))

    def _drain_batch_array(self) -> List[Decision]:
        E = self._batch_rows
        ev = self._batch_arrays()
        kind, vi, prof, tim, idx = (ev[k] for k in B.EVENT_KEYS)
        pending: List[Tuple[int, int, float]] = []
        s0, a0 = self._n_vms, self._n_arr
        n = 0
        while n < E:
            nxt = self.queue.peek()
            if nxt is None:
                break
            req, enq = nxt
            b = self._request_bucket(req)
            if b > self._bucket:
                kind[n] = B.STEP_END
                tim[n] = np.float32(self._step_t)
                idx[n] = self._bucket
                n += 1
                self._advance_bucket()
                continue
            self.queue.pop()
            if isinstance(req, Arrival):
                slot, a = self._admit_slot(req)
                kind[n] = B.ARRIVAL
                vi[n] = slot
                prof[n] = self._h_vm_pids[slot, 0]
                tim[n] = np.float32(self._step_t)
                idx[n] = a
                pending.append((slot, req.vm_id, enq))
            else:
                slot = self._slot_of[req.vm_id]
                kind[n] = B.DEPARTURE
                vi[n] = slot
                prof[n] = self._h_vm_pids[slot, 0]
                tim[n] = np.float32(self._step_t)
            n += 1
        if n == 0:
            return []
        tier = self.tier_name
        k = len(pending)
        rec = obs_recorder.active()
        span = (rec.span("serve.batch", tier=tier, rows=n, arrivals=k)
                if rec is not None else _null_ctx())
        with span:
            if k:
                # The new arrivals' table rows go in before the step
                # reads them.
                self._ingest(s0, a0, k)
            self._state, rows = self._step_fn(
                self._state, ev, self._trace, self.heavy_capacity,
                self._carry, read=(s0, s0 + k) if k else None)
        self.batches += 1
        t_done = time.perf_counter()
        out: List[Decision] = []
        for slot, vm_id, enq in pending:
            r = rows[slot - s0]
            acc = int(r[2]) > 0
            self._h_accepted[slot] = acc
            d = Decision(vm_id=vm_id, accepted=acc,
                         gpu=int(r[0]) if acc else -1,
                         start=int(r[1]) if acc else 0,
                         tier=tier, latency_s=t_done - enq)
            self.decisions[vm_id] = d
            self.tier_occupancy[tier] += 1
            out.append(d)
        self._note_governor([d.latency_s for d in out])
        return out

    def _dispatch_steps_only(self, horizon: float) -> None:
        """One batch of trailing STEP_END rows (flush path); reads
        nothing back."""
        E = self._batch_rows
        ev = self._batch_arrays()
        n = 0
        while n < E and self._step_t < horizon + _EPS:
            ev["kind"][n] = B.STEP_END
            ev["time"][n] = np.float32(self._step_t)
            ev["idx"][n] = self._bucket
            n += 1
            self._advance_bucket()
        if n == 0:
            return
        self._state, _ = self._step_fn(self._state, ev, self._trace,
                                       self.heavy_capacity, self._carry)
        self.batches += 1

    # -- object (ILP) tier -------------------------------------------------
    def _drain_batch_object(self) -> List[Decision]:
        tier = self.tier_name
        cl, pol = self._cluster, self._policy
        out: List[Decision] = []
        n = 0
        rec = obs_recorder.active()
        span = (rec.span("serve.batch", tier=tier,
                         rows=min(self._batch_rows, len(self.queue)))
                if rec is not None else _null_ctx())
        with span:
            while n < self._batch_rows:
                nxt = self.queue.peek()
                if nxt is None:
                    break
                req, enq = nxt
                b = self._request_bucket(req)
                if b > self._bucket:
                    self._object_step_end()
                    n += 1
                    continue
                self.queue.pop()
                n += 1
                if isinstance(req, Arrival):
                    slot, _ = self._admit_slot(req)
                    vm = self._vm_object(slot)
                    pol.on_arrival_observed(vm, self._step_t)
                    p0 = int(self._h_vm_pids[slot, 0])
                    self._h_counts[p0, 1] += 1
                    ok = pol.place(vm)
                    if ok:
                        self._h_counts[p0, 0] += 1
                        self._h_accepted[slot] = True
                        _, gpu = cl.placements[vm.vm_id]
                        g = gpu.global_index
                        start = int(gpu.placements[vm.vm_id][1])
                    else:
                        g, start = -1, 0
                        self._rejected_step.append(vm)
                    d = Decision(vm_id=req.vm_id, accepted=ok, gpu=g,
                                 start=start, tier=tier,
                                 latency_s=time.perf_counter() - enq)
                    self.decisions[req.vm_id] = d
                    self.tier_occupancy[tier] += 1
                    out.append(d)
                else:
                    if req.vm_id in cl.placements:
                        vm = cl.vms[req.vm_id]
                        cl.release(req.vm_id)
                        pol.on_departure(vm, self._step_t)
        self.batches += 1
        self._note_governor([d.latency_s for d in out])
        return out

    def _object_step_end(self) -> None:
        self._policy.on_step_end(self._step_t, self._rejected_step)
        self._rejected_step = []
        pms, gpus = self._cluster.active_hardware()
        self._h_hourly[self._bucket] = (
            int(self._h_counts[:, 0].sum()),
            int(self._h_counts[:, 1].sum()), pms, gpus)
        self._advance_bucket()

    # -- governor ----------------------------------------------------------
    def _note_governor(self, latencies: List[float]) -> None:
        switch = self.governor.note_batch(latencies, self.queue.fill)
        if switch is not None:
            self._switch_tier(*switch)


class _null_ctx:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


__all__ = ["PlacementService", "ServeConfig", "Decision", "Governor",
           "requests_from_trace", "ILP_TIER"]
