"""Sharded-fleet replay over ``torch.distributed`` — port of
``repro/core/sharded.py``.

The JAX module runs the replay scan under ``shard_map`` over a 1-D
"fleet" mesh of K devices; here the fleet is a process group of K ranks,
one process per rank (rank r on ``cuda:r`` with NCCL, or on the CPU with
gloo).  As in the JAX module:

  * every rank holds the whole cluster state (it is replicated) and runs
    the same replay step (``batched.Step``) on it;
  * per arrival, each rank scores only its contiguous ``G/K`` slice of
    GPUs and contributes one row ``(score, global index, any)``; one
    all-gather and a reconcile on the device pick the winner: the first
    maximizer of the scores for FF/BF/MCC/MECC (ranks cover contiguous
    index ranges in order and ``argmax`` returns the first maximizer, so
    ties resolve to the lowest global index), the least first fit for
    GRMU;
  * everything else — departures, GRMU's growth, defrag and
    consolidation, step-ends and telemetry — reads only replicated state
    and runs identically on every rank, with no collective.  So every
    rank's outputs equal the unsharded replay's, and telemetry needs no
    reconcile of its own (the JAX ``P()`` out-spec).

Scoring is always the table gathers (``score_backend="tables"``): the
JAX package runs no Pallas kernel under shards, and the port launches no
pick or score kernel on this path.

The all-gather's buffers belong to the replay step (:class:`FleetShard`,
allocated once), so a captured CUDA graph fixes their addresses and no
value of the collective reaches Python.  Every rank plans the same event
keys from the same trace and captures and replays them in the same
order, so the ranks' collectives match one for one.  GRMU's
consolidating step-ends run eagerly, with their host synchronisations,
on every rank; they run no collective.

The rank-level entry points (:func:`make_sharded_replay`,
:func:`replay_sharded`, ``streaming.make_chunked_replay(num_shards=K)``)
run inside an initialised process group of K ranks.  Called with
``num_shards=1`` (or ``None``) from a process with no group, they
initialise a one-rank group (:func:`fleet_group`).  :func:`spawn_fleet`
starts K ranks, runs a function on each and returns rank 0's result.
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..sim.metrics import SimResult
from . import policy_core as pc

# The backend of a rank's group, by device type.  No other pairing is
# used: a CUDA replay never falls back to gloo, nor to the CPU.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

_INT_SENTINEL = np.iinfo(np.int32).min  # below every feasible int score
_BIG_IDX = np.iinfo(np.int32).max

# torch deprecates ``all_gather_into_tensor`` where it has
# ``all_gather_single``; both take (output, input, group).
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class FleetShard:
    """One rank's part of a sharded fleet, held by the replay step: its
    process group, its index ``rank`` of ``num_shards``, its contiguous
    GPUs ``local`` (starting at ``start``) and the all-gather's buffers,
    one ``(score, index, any)`` int32 row sent and ``(num_shards, 3)``
    received (int32, as the JAX module gathers: scores, GPU indices and
    flags all fit)."""

    def __init__(self, group, num_shards: int, num_gpus: int,
                 device: torch.device):
        if num_gpus % num_shards:
            raise ValueError(
                f"num_gpus={num_gpus} does not divide over {num_shards} "
                "shards; bucket the trace first: repro_torch.core.bucketing."
                f"pad_events(ev, shards={num_shards})")
        self.group, self.num_shards = group, num_shards
        self.rank = dist.get_rank(group)
        size = num_gpus // num_shards
        self.start = self.rank * size
        self.local = slice(self.start, self.start + size)
        self.send = torch.zeros(3, dtype=torch.int32, device=device)
        self.recv = torch.zeros(3 * num_shards, dtype=torch.int32,
                                device=device)

    def gather(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank's ``row`` (3,), in rank order, as (num_shards, 3)."""
        self.send.copy_(row)
        _all_gather(self.recv, self.send, group=self.group)
        return self.recv.view(self.num_shards, 3)


def select_gpu_sharded(policy, T, mid, free, pids, host_ok, mecc_w,
                       shard: FleetShard):
    """Sharded FF/BF/MCC/MECC pick — decision-identical to
    ``policy_core.select_gpu``; a (1,) int64 GPU index or -1.

    All operands are replicated; each rank gathers fits and scores only
    for its slice.  Feasible scores rank strictly above infeasible ones
    (policy_core's invariant), so the local argmax is the local first
    maximizer; its score goes out as int32 (MECC's integer weights keep
    its scores exact), or the sentinel where nothing fits locally, and
    the argmax over the ranks' scores (first rank wins) is the global
    first maximizer."""
    loc = shard.local
    lmid = mid[loc]
    lfree = free[loc].long()
    lprof = pids[lmid]
    lfits = T.fits[lmid, lfree, lprof] & host_ok[loc]
    lscores = pc.placement_scores(policy, T, lmid, lfree, lprof, lfits,
                                  mecc_w)
    lbest = torch.argmax(lscores).reshape(1)
    lany = lfits.any().reshape(1)
    cand = shard.gather(torch.cat([
        torch.where(lany, lscores[lbest].to(torch.int32), _INT_SENTINEL),
        (shard.start + lbest).to(torch.int32), lany.to(torch.int32)]))
    win = torch.argmax(cand[:, 0]).reshape(1)
    return torch.where(cand[:, 2].any(), cand[win, 1], -1).long()


def grmu_select_sharded(T, mid, free, pids, is_heavy: bool, host_ok,
                        basket, heavy_cap, light_cap, shard: FleetShard):
    """Sharded Alg. 3 — decision-identical to ``policy_core.grmu_select``
    (the same arguments and ``(pick, grew, grow_idx)``).

    The first-fit scan over the request's basket is sharded: each rank
    sends its first fit as a global index, or ``_BIG_IDX`` (in the row's
    index column), and the pick is their minimum.  The growth decision
    reads only the replicated basket labels and ``host_ok`` and is
    computed identically on every rank."""
    want = pc.HEAVY_BASKET if is_heavy else pc.LIGHT_BASKET
    cap = heavy_cap if is_heavy else light_cap
    in_basket = basket == want
    loc = shard.local
    lmid = mid[loc]
    lfits = (T.fits[lmid, free[loc].long(), pids[lmid]] & host_ok[loc]
             & in_basket[loc])
    lpick = pc.first_true(lfits)
    found = lpick >= 0
    cand = shard.gather(torch.cat([
        torch.zeros_like(lpick, dtype=torch.int32),
        torch.where(found, shard.start + lpick, _BIG_IDX).to(torch.int32),
        found.to(torch.int32)]))
    first = cand[:, 1].amin().reshape(1)
    pick = torch.where(first < _BIG_IDX, first, -1).long()
    # Replicated growth (Alg. 3's fetch-then-place, as in grmu_select).
    pool_free = basket == pc.POOL
    grew = (pick < 0) & (in_basket.sum() < cap) & pool_free.any()
    grow_idx = torch.argmax(pool_free.to(torch.int32)).reshape(1)
    grown_pick = torch.where(grew & host_ok[grow_idx], grow_idx, -1)
    return torch.where(pick >= 0, pick, grown_pick), grew, grow_idx


# ---------------------------------------------------------------------------
# Process groups
# ---------------------------------------------------------------------------

def _init_one_rank(backend: str) -> None:
    """This process as the one rank of a new default group, on a
    ``FileStore`` in a temporary directory (no port is bound).  The group
    lives as long as the process, as any ``init_process_group``'s."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_fleet_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1))


def fleet_group(num_shards: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[object, int]:
    """(process group, this rank's index) of a fleet of ``num_shards``
    ranks (``None``: the group's world size) replaying on ``device``
    (``None`` = the CUDA device): the counterpart of the JAX
    ``fleet_mesh``.  The fleet is the default group, one rank per shard;
    its backend must be ``BACKENDS[device type]``.  Outside a group, with
    ``num_shards`` 1 or ``None``, this process becomes a one-rank group
    (:func:`_init_one_rank`).  Raises ``ValueError`` where ``num_shards``
    is not the group's world size, exceeds the visible GPUs on the card,
    or the backend does not match."""
    dev = resolve_device(device)
    want = BACKENDS[dev.type]
    world = dist.get_world_size() if dist.is_initialized() else 1
    k = num_shards or world
    if k > world:
        raise ValueError(
            f"num_shards={k} exceeds the process group's world size "
            f"{world}; run one process per shard (repro_torch.core."
            "sharded.spawn_fleet, or init_process_group in each)")
    if k != world:
        raise ValueError(f"num_shards={k} but the process group has "
                         f"{world} ranks; the fleet is one rank per shard")
    if dev.type == "cuda" and k > torch.cuda.device_count():
        raise ValueError(f"num_shards={k} but only "
                         f"{torch.cuda.device_count()} CUDA devices are "
                         "visible; one rank per GPU")
    if not dist.is_initialized():
        _init_one_rank(want)
    backend = dist.get_backend()
    if backend != want and f"{dev.type}:{want}" not in backend.split(","):
        raise ValueError(f"the process group runs {backend!r}; a replay on "
                         f"{dev.type} needs {want!r}")
    return dist.group.WORLD, dist.get_rank()


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:rank`` for a CUDA ``device``
    (``None`` = CUDA; an explicit index must be the rank's), else
    ``device``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index not in (None, rank):
        raise ValueError(f"rank {rank} replays on cuda:{rank}, not {dev}")
    return torch.device("cuda", rank)


def _rank_main(rank, world, dev_type, store_path, results, timeout, fn,
               args, kwargs):
    """One rank of :func:`spawn_fleet`: join the group, run ``fn`` on
    the rank's device, report ``(rank, ok, pickled result or
    traceback)``."""
    try:
        if dev_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            BACKENDS[dev_type], rank=rank, world_size=world,
            store=dist.FileStore(store_path, world),
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args, device=rank_device(dev_type, rank), **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn_fleet(fn: Callable, num_shards: int, *args,
                device: DeviceLike = None, timeout: float = 600.0,
                **kwargs):
    """Run ``fn(*args, device=<the rank's device>, **kwargs)`` on
    ``num_shards`` new processes, the ranks of a fresh process group
    (``BACKENDS``: NCCL with rank r on ``cuda:r`` for ``device=None`` or
    CUDA, gloo on the CPU), and return rank 0's result after checking
    that every rank's result pickles to the same bytes: a sharded
    replay's outputs are replicated.  ``fn`` and its arguments are
    pickled (``fn`` by its import path).  Raises ``RuntimeError`` with a
    rank's traceback if one fails, or after ``timeout`` seconds; every
    process it started has ended when it returns or raises."""
    dev = resolve_device(device)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_fleet_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, num_shards, dev.type, os.path.join(tmp, "store"), results,
            timeout, fn, args, kwargs)) for r in range(num_shards)]
        for p in procs:
            p.start()
        try:
            got = {}
            deadline = time.monotonic() + timeout
            while len(got) < num_shards:
                try:
                    rank, ok, payload = results.get(
                        timeout=max(deadline - time.monotonic(), 0.0))
                except queue.Empty:
                    raise RuntimeError(
                        f"spawn_fleet: {num_shards - len(got)} of "
                        f"{num_shards} ranks gave no result in {timeout} s")
                if not ok:
                    raise RuntimeError(f"spawn_fleet: rank {rank} failed:\n"
                                       f"{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    differ = [r for r in range(num_shards) if got[r] != got[0]]
    if differ:
        raise RuntimeError(f"spawn_fleet: ranks {differ} returned another "
                           "result than rank 0")
    return pickle.loads(got[0])


# ---------------------------------------------------------------------------
# Replay entry points
# ---------------------------------------------------------------------------

def make_sharded_replay(events, policy: int,
                        num_shards: Optional[int] = None,
                        device: DeviceLike = None, **cfg) -> Callable:
    """Sharded twin of ``batched.make_replay`` — same outputs, same
    decisions — for this rank of a fleet of ``num_shards`` ranks
    (:func:`fleet_group`), on the rank's device (:func:`rank_device`).
    Requires the padded GPU count to divide by ``num_shards`` (bucket
    with ``pad_events(events, shards=K)``).  The runner's cache key adds
    ``("shard", K, rank, group)`` to the unsharded one."""
    from . import batched as B     # deferred: batched imports this module
    group, rank = fleet_group(num_shards, device)
    k = dist.get_world_size(group)
    st = B.replay_statics(events, policy, num_shards=k, **cfg)
    return B.runner_replay(events, st, rank_device(device, rank),
                           "shard", k, rank, group, group=group)


def replay_sharded(events, policy: int, heavy_capacity=None,
                   num_shards: Optional[int] = None,
                   device: DeviceLike = None, **cfg) -> SimResult:
    """Sharded twin of ``batched.replay`` (full ``SimResult``)."""
    from . import batched as B
    if heavy_capacity is None:
        heavy_capacity = B.default_heavy_capacity(events)
    out = make_sharded_replay(events, policy, num_shards, device,
                              **cfg)(heavy_capacity)
    return B.result_from_arrays(
        events, policy, {k: v.cpu().numpy() for k, v in out.items()})


__all__ = ["BACKENDS", "FleetShard", "fleet_group", "rank_device",
           "select_gpu_sharded", "grmu_select_sharded", "spawn_fleet",
           "make_sharded_replay", "replay_sharded"]
