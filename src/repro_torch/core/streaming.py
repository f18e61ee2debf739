"""Trace-streamed replay — port of ``repro/core/streaming.py``.

The event stream is split into fixed-size chunks, and the replay runs
them in turn on one whole-cluster state: the chunk step over events
``[i*C, (i+1)*C)``, then the same finalize as the unchunked replay.
Chunk boundaries are decision-neutral by construction: the state is the
complete cluster state and the event step never reads an event's
position (the JAX module's argument, which holds for the port's step as
for the scan), so the outputs equal ``batched.make_replay``'s for any
chunk size.

The trace is padded with ``pad_events(event_multiple=chunk_events)``, as
the JAX module pads it: PAD rows are a no-op (the port drops them when
it plans the events), padded GPUs hold a free mask of 0 (no profile fits
it, so the scorers and the pick kernels never choose them) and sit
outside GRMU's baskets.

The chunk step is a ``batched.Runner`` whose event buffer holds one
chunk, and finalize is ``batched._finalize``; both come from the replay
compile cache under the JAX module's keys, ``(st, "chunk", chunk)`` and
``(st, "finalize")``, the chunk step's key with the bucket shape its
graphs fix (``batched.replay_key``).  A chunk's staging copies its event
rows from the trace's device rows into the runner's chunk buffer; its
step replays them (on the card one graph launch per event).  With a
recorder installed (:mod:`repro_torch.obs.recorder`) each chunk's
staging is a ``chunk.prefetch`` span and its step a ``chunk.step`` span
(with ``index`` and ``nbytes``, the chunk's packed event bytes), the
final reduction a ``finalize`` span, and a ``cache`` record follows,
under the JAX module's names.  The JAX module stages chunk i+1 before
it steps chunk i, to overlap the copy with the scan; the port's runner
has one chunk buffer, which the next chunk's copy would overwrite before
the step has read it, so it stages each chunk just before its step (the
copy is one device-to-device copy on the step's stream).

``num_shards`` composes with :mod:`.sharded`, as in the JAX module: the
trace is padded with ``pad_events(..., shards=K)`` and the chunk step is
this rank's sharded runner (replicated state, its slice of GPUs scored,
one all-gather per arrival), under the key ``"shard-chunk", K, rank,
group, chunk_events``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs import recorder as obs_recorder
from ..sim.metrics import SimResult
from . import compile_cache, sharded
from .batched import (EVENT_KEYS, EventTrace, Runner, _finalize,
                      default_heavy_capacity, init_state, plan_events,
                      replay_key, replay_statics, result_from_arrays,
                      trace_arrays, trace_from_numpy)
from .bucketing import pad_events

# Default chunk length (the JAX module's).
DEFAULT_CHUNK_EVENTS = 65536


def split_trace(tr: Dict[str, np.ndarray]):
    """(event-stream arrays, resident arrays) — the chunked/static split
    of a :func:`repro_torch.core.batched.trace_arrays` dict."""
    ev = {k: tr[k] for k in EVENT_KEYS}
    rest = {k: v for k, v in tr.items() if k not in EVENT_KEYS}
    return ev, rest


def replay_bytes(events: EventTrace,
                 chunk_events: Optional[int] = None) -> Dict[str, int]:
    """Byte accounting for one replay: total packed event-stream bytes,
    the resident (non-chunked) trace bytes, and — when ``chunk_events``
    is given — the per-chunk event bytes."""
    ev, rest = split_trace(trace_arrays(events))
    ev_bytes = sum(int(a.nbytes) for a in ev.values())
    out = dict(event_bytes=ev_bytes,
               resident_bytes=sum(int(a.nbytes) for a in rest.values()))
    if chunk_events:
        n_rows = max(len(events.kind), 1)
        out["chunk_bytes"] = -(-ev_bytes * chunk_events // n_rows)
    return out


def make_chunked_replay(events: EventTrace, policy: int, *,
                        chunk_events: int = DEFAULT_CHUNK_EVENTS,
                        num_shards: Optional[int] = None,
                        device: DeviceLike = None, **cfg) -> Callable:
    """Chunk-streaming twin of ``batched.make_replay`` — same outputs,
    same decisions.  The trace is padded so the event dimension splits
    evenly into ``chunk_events``-row chunks (and, with ``num_shards``,
    its GPUs over the shards); the returned ``run(heavy_capacity)``
    exposes ``run.num_chunks``, ``run.chunk_events``, ``run.events`` (the
    padded trace), ``run.runner`` and ``run.plan`` (``batched.Plan``).
    With ``num_shards`` this is one rank of a sharded fleet
    (``sharded.fleet_group``), on the rank's device."""
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    events = pad_events(events, event_multiple=chunk_events,
                        shards=num_shards or 1)
    group, k, variant = None, 0, ("chunk", chunk_events)
    if num_shards:
        group, rank = sharded.fleet_group(num_shards, device)
        k = num_shards
        device = sharded.rank_device(device, rank)
        variant = ("shard-chunk", k, rank, group, chunk_events)
    device = resolve_device(device)
    st = replay_statics(events, policy, num_shards=k, **cfg)
    tr = trace_arrays(events)
    trace = trace_from_numpy(tr, device)
    state0 = init_state(events, st, device)
    runner = compile_cache.cached_replay_fn(
        replay_key(st, trace, state0, *variant),
        lambda: Runner(st, trace, state0, chunk_events, group=group))
    finalize = compile_cache.cached_replay_fn(
        (st, "finalize"), lambda: functools.partial(_finalize, st))
    n_chunks = len(events.kind) // chunk_events
    plan = plan_events(st, trace, last_cons=0.0)
    # Chunk i's non-PAD events are rows [bounds[i], bounds[i + 1]).
    bounds = np.searchsorted(trace.rows,
                             np.arange(n_chunks + 1) * chunk_events).tolist()
    ev_np, _ = split_trace(tr)
    chunk_bytes = sum(int(v[:chunk_events].nbytes) for v in ev_np.values())
    d = trace.dev

    def stage(i):
        a, b = bounds[i], bounds[i + 1]
        runner.stage(d["ev_arg"][a:b], d["ev_time"][a:b])

    def step(i):
        runner.replay(plan.keys[bounds[i]:bounds[i + 1]])

    def run(heavy_capacity):
        runner.load(trace, state0, heavy_capacity, plan.keys)
        rec = obs_recorder.active()
        if rec is not None:
            return _run_recorded(rec)
        for i in range(n_chunks):
            stage(i)
            step(i)
        return runner.finish(plan, finalize)

    def _run_recorded(rec):
        """Same loop with per-chunk flight-recorder spans and the cache
        record."""
        for i in range(n_chunks):
            with rec.span("chunk.prefetch", index=i, nbytes=chunk_bytes):
                stage(i)
            with rec.span("chunk.step", index=i, nbytes=chunk_bytes):
                step(i)
        with rec.span("finalize"):
            out = runner.finish(plan, finalize)
        rec.cache_stats()
        return out

    run.num_chunks = n_chunks
    run.chunk_events = chunk_events
    run.events = events
    run.runner, run.plan = runner, plan
    return run


def replay_chunked(events: EventTrace, policy: int, heavy_capacity=None,
                   *, chunk_events: int = DEFAULT_CHUNK_EVENTS,
                   num_shards: Optional[int] = None,
                   device: DeviceLike = None, **cfg) -> SimResult:
    """Chunk-streaming twin of ``batched.replay`` (full ``SimResult``) on
    ``device`` (``None`` = the CUDA device).  Decision-for-decision
    identical to the unchunked replay for any chunk size."""
    if heavy_capacity is None:
        heavy_capacity = default_heavy_capacity(events)
    run = make_chunked_replay(events, policy, chunk_events=chunk_events,
                              num_shards=num_shards, device=device, **cfg)
    out = {k: v.cpu().numpy() for k, v in run(heavy_capacity).items()}
    return result_from_arrays(run.events, policy, out)


__all__ = ["DEFAULT_CHUNK_EVENTS", "split_trace", "replay_bytes",
           "make_chunked_replay", "replay_chunked"]
