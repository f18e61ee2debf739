"""Trace-streamed replay — port of ``repro/core/streaming.py``.

The event stream is split into fixed-size chunks, and the replay runs
them in turn on one whole-cluster state: :func:`batched.run_staged` over
events ``[i*C, (i+1)*C)``, then the same finalize as the unchunked
replay.  Chunk boundaries are decision-neutral by construction: the
state is the complete cluster state and the event step never reads an
event's position (the JAX module's argument, which holds for the eager
loop as for the scan), so the outputs equal ``batched.make_replay``'s
for any chunk size.

The trace is padded with ``pad_events(event_multiple=chunk_events)``, as
the JAX module pads it: PAD rows are a no-op, padded GPUs hold a free
mask of 0 (no profile fits it, so the scorers and the pick kernels never
choose them) and sit outside GRMU's baskets.

A chunk's staging is its host half: the event rows, which stay on the
host because the loop dispatches on them, turned into the Python values
the loop reads (``batched.stage_events``).  With a recorder installed
(:mod:`repro_torch.obs.recorder`) each chunk's staging is a
``chunk.prefetch`` span and its run a ``chunk.step`` span (with
``index`` and ``nbytes``, the chunk's packed event bytes), and the final
reduction a ``finalize`` span, under the JAX module's names.  The JAX
module also writes a ``cache`` record there; the port has no replay
compile cache yet (ROADMAP.md, Queue 2), so it writes none.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..obs import recorder as obs_recorder
from ..sim.metrics import SimResult
from .batched import (EVENT_KEYS, EventTrace, _finalize,
                      default_heavy_capacity, init_state, replay_statics,
                      result_from_arrays, run_staged, stage_events,
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
    evenly into ``chunk_events``-row chunks; the returned
    ``run(heavy_capacity)`` exposes ``run.num_chunks``,
    ``run.chunk_events`` and ``run.events`` (the padded trace)."""
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    if num_shards:
        raise NotImplementedError("sharded replay is not ported yet; see "
                                  "ROADMAP.md, Queue 2")
    device = resolve_device(device)
    events = pad_events(events, event_multiple=chunk_events)
    st = replay_statics(events, policy, **cfg)
    tr = trace_arrays(events)
    trace = trace_from_numpy(tr, device)
    n_chunks = len(events.kind) // chunk_events
    ev_np, _ = split_trace(tr)
    chunk_bytes = sum(int(v[:chunk_events].nbytes) for v in ev_np.values())

    def stage(i):
        return stage_events(trace, i * chunk_events,
                            (i + 1) * chunk_events)

    def run(heavy_capacity):
        state = init_state(events, st, device)
        rec = obs_recorder.active()
        if rec is not None:
            return _run_recorded(rec, state, heavy_capacity)
        for i in range(n_chunks):
            state = run_staged(st, state, trace, heavy_capacity, stage(i))
        return _finalize(st, state)

    def _run_recorded(rec, state, heavy_capacity):
        """Same loop with per-chunk flight-recorder spans, staged one
        chunk ahead as the JAX module stages its device copies."""
        with rec.span("chunk.prefetch", index=0, nbytes=chunk_bytes):
            nxt = stage(0)
        for i in range(n_chunks):
            cur = nxt
            if i + 1 < n_chunks:
                with rec.span("chunk.prefetch", index=i + 1,
                              nbytes=chunk_bytes):
                    nxt = stage(i + 1)
            with rec.span("chunk.step", index=i, nbytes=chunk_bytes):
                state = run_staged(st, state, trace, heavy_capacity, cur)
        with rec.span("finalize"):
            return _finalize(st, state)

    run.num_chunks = n_chunks
    run.chunk_events = chunk_events
    run.events = events
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
