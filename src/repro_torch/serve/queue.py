# Copied unchanged from repro/serve/queue.py (the JAX package), so the port imports nothing of it.
"""Bounded request queue: the admission edge of the placement service.

Requests are plain host-side records (:class:`Arrival` /
:class:`Departure`); the queue is a FIFO with a hard depth bound —
``submit`` returns ``False`` when the bound is hit (backpressure: the
caller sheds or retries, the service never buffers unboundedly) — and it
timestamps every accepted request so the service can report *decision
latency* (submit -> decision ready) rather than kernel time alone.

The bucket helpers mirror ``repro.core.batched``'s offline bucket math
exactly (same float64 expressions, same epsilon), so a request stream
submitted in the offline trace's canonical order replays into the same
(bucket, kind) event sequence the batched engine scans — the root of the
online ≡ offline decision-parity contract pinned in tests/test_serve.py.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Optional, Tuple, Union

_EPS = 1e-9


def arrival_bucket(t: float, step_hours: float = 1.0) -> int:
    """Bucket in which the engines offer an arrival at time ``t`` —
    smallest ``b`` with ``t < (b+1)*step - eps`` (``batched._arr_bucket``)."""
    return int(math.floor((t + _EPS) / step_hours))


def departure_bucket(t: float, arrival_b: int,
                     step_hours: float = 1.0) -> int:
    """Bucket at whose start a departure at time ``t`` is released.
    A same-bucket departure is popped one bucket after its arrival (the
    engine's heap push happens after the bucket's departure phase) —
    the ``max`` mirrors ``batched.build_events_arrays``."""
    db = int(math.ceil((t + _EPS) / step_hours)) - 1
    return max(db, arrival_b + 1)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """A VM placement request.  ``profile_ids`` is the request's Eq. 27-30
    profile index on every fleet model (length M, reference model first) —
    the same per-model resolution contract as ``VM.profile_ids``."""
    vm_id: int
    time: float                      # hours (decides the bucket)
    profile_ids: Tuple[int, ...]
    cpu: float = 0.0
    ram: float = 0.0


@dataclasses.dataclass(frozen=True)
class Departure:
    """Release of a previously submitted VM (accepted or not — releasing
    a rejected VM is a no-op, exactly like the offline departure row)."""
    vm_id: int
    time: float


Request = Union[Arrival, Departure]


class BoundedRequestQueue:
    """FIFO of (request, submit-timestamp) with a hard depth bound."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._q: Deque[Tuple[Request, float]] = collections.deque()
        self.dropped = 0          # submits refused at the bound
        self.accepted_total = 0   # submits enqueued over the queue's life
        self.high_watermark = 0   # deepest the queue has ever been

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Enqueue ``req``; False (and counted as a drop) when full."""
        if len(self._q) >= self.capacity:
            self.dropped += 1
            return False
        self._q.append((req, time.perf_counter() if now is None else now))
        self.accepted_total += 1
        if len(self._q) > self.high_watermark:
            self.high_watermark = len(self._q)
        return True

    def peek(self) -> Optional[Tuple[Request, float]]:
        return self._q[0] if self._q else None

    def pop(self) -> Tuple[Request, float]:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def fill(self) -> float:
        """Current depth as a fraction of capacity (governor input)."""
        return len(self._q) / self.capacity


__all__ = ["Arrival", "Departure", "Request", "BoundedRequestQueue",
           "arrival_bucket", "departure_bucket"]
