# Copied from repro/core/bucketing.py (the JAX package), so the port imports nothing of it; one change: event_multiple may be any positive integer, since the port compiles nothing per shape.
"""Shape bucketing: pad an EventTrace to power-of-two buckets.

XLA compiles one executable per argument-shape signature.  Replays differ
in six shape dimensions — event rows E, VM rows N, GPUs G, hosts H, MECC
observations A, and hourly slots S — so without bucketing every trace
recompiles.  :func:`pad_events` rounds each dimension up to its
power-of-two bucket with **decision-neutral** padding; together with the
trace-as-argument scan (``repro.core.batched._scan_fn``) and the
process/persistent caches (``repro.core.compile_cache``), a
policy×fleet×scale sweep compiles once per bucket.

Why each padding class is a provable no-op (property-tested for all five
registry policies in tests/test_bucketing.py):

  * **PAD event rows** dispatch to the scan's identity branch — the state
    threads through untouched, wherever the rows sit in the stream.
  * **Padded GPUs** carry an all-zero free mask (``gpu_full == 0``): no
    slot template is a submask of 0, so ``Tables.fits`` is False for
    every profile — they can never be picked by FF/BF/MCC/MECC scoring
    (infeasible sentinels rank strictly below every feasible score) —
    and they sit in the ``PAD_BASKET`` (-1) for GRMU, outside both
    baskets *and* the growth pool.  With ``free == gpu_full`` they are
    also invisible to the active-hardware metrics, defrag targeting
    (never light-basket) and consolidation (never a candidate, never an
    available target).
  * **Padded hosts** have zero CPU/RAM capacity and no GPUs mapped onto
    them; no arrival can charge them and the PM count ignores them.
  * **Padded VMs** are never named by any event row, and the accepted
    mask is sliced back to the logical ``vm_ids`` length.
  * **Padded MECC observations** carry ``arr_times = +inf``: the expiry
    two-pointer stops strictly before them (any finite cutoff compares
    False), so windowed counts see only real arrivals.
  * **Hourly padding** only lengthens the metric buffer; step-end events
    exist solely for real steps and results slice back to ``step_times``.

The *logical* sizes (``num_vms`` / ``num_gpus`` / ``num_hosts`` /
``vm_ids`` / ``step_times``) are untouched — GRMU's basket capacities,
result assembly and acceptance masks all key off them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .batched import PAD, PAD_BASKET, EventTrace  # noqa: F401 (re-export)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if len(a) >= n:
        return a
    tail = np.full((n - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, tail])


def bucket_shape(events: EventTrace) -> Tuple[int, ...]:
    """(E, N, G, H, A, S) — the array shapes XLA sees (after padding, the
    compile-cache shape key)."""
    return (len(events.kind), len(events.vm_pids),
            len(events.gpu_model_id), len(events.cpu_cap),
            max(len(events.arr_times), 1),
            events.hourly_slots or len(events.step_times))


def pad_events(events: EventTrace, *, shards: int = 1,
               min_gpus: int = 1, min_events: int = 1,
               min_shape: Tuple[int, ...] | None = None,
               event_multiple: int | None = None) -> EventTrace:
    """Pad every shape dimension of ``events`` to its power-of-two bucket.

    ``shards`` (a power of two) guarantees the padded GPU count divides
    evenly across fleet shards (``repro.core.sharded``); ``min_gpus=128``
    additionally aligns the fleet to the Pallas lane width so the fused
    scoring kernels can engage.  ``min_shape`` — a :func:`bucket_shape`
    tuple — forces every dimension at least that large, which pins two
    near-identical traces into one bucket (the compile-amortization
    measurement in benchmarks/batched_engine.py).  Idempotent: re-padding
    an already bucketed trace is a no-op.

    ``event_multiple`` switches the *event* dimension from pow2 rounding
    to round-up-to-a-multiple: the chunk-streaming replay
    (``repro.core.streaming``) compiles one step per chunk shape, so E
    only needs to split evenly into chunks — rounding E to the next
    multiple of the (pow2) chunk length instead of the next pow2 keeps
    the padding overhead bounded by one chunk at any scale, while the
    non-event dimensions keep their pow2 buckets (the compiled chunk
    step's shape signature).  The port's chunked replay compiles
    nothing per shape, so any positive multiple is accepted here."""
    if shards & (shards - 1):
        raise ValueError(f"shards must be a power of two, got {shards}")
    mE, mN, mG, mH, mA, mS = min_shape or (1, 1, 1, 1, 1, 1)
    E = max(len(events.kind), min_events, mE)
    if event_multiple:
        if event_multiple < 1:
            raise ValueError("event_multiple must be positive, "
                             f"got {event_multiple}")
        E = -(-E // event_multiple) * event_multiple
    else:
        E = next_pow2(E)
    N = next_pow2(max(len(events.vm_pids), 1, mN))
    G = next_pow2(max(len(events.gpu_model_id), shards, min_gpus, mG))
    H = next_pow2(max(len(events.cpu_cap), 1, mH))
    A = next_pow2(max(len(events.arr_times), 1, mA))
    S = next_pow2(max(events.hourly_slots or len(events.step_times), mS))
    M = len(events.models)

    arr_pids = (events.arr_pids if len(events.arr_times)
                else np.zeros((0, M), np.int16))
    vm_pids = (events.vm_pids if len(events.vm_pids)
               else np.zeros((0, M), np.int16))
    return dataclasses.replace(
        events,
        kind=_pad_to(events.kind, E, PAD),
        vm_index=_pad_to(events.vm_index, E, 0),
        profile=_pad_to(events.profile, E, 0),
        time=_pad_to(events.time, E, 0.0),
        idx=_pad_to(events.idx, E, 0),
        vm_pids=_pad_to(vm_pids, N, 0),
        vm_heavy=_pad_to(np.asarray(events.vm_heavy, bool), N, False),
        vm_cpu=_pad_to(events.vm_cpu, N, 0.0),
        vm_ram=_pad_to(events.vm_ram, N, 0.0),
        arr_times=_pad_to(np.asarray(events.arr_times, np.float32), A,
                          np.inf),
        arr_pids=_pad_to(arr_pids, A, 0),
        gpu_model_id=_pad_to(events.gpu_model_id, G, 0),
        gpu_host_id=_pad_to(events.gpu_host_id, G, 0),
        cpu_cap=_pad_to(events.cpu_cap, H, 0.0),
        ram_cap=_pad_to(events.ram_cap, H, 0.0),
        hourly_slots=S,
    )


__all__ = ["pad_events", "bucket_shape", "next_pow2"]
