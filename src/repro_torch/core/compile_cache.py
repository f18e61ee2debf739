# Port of repro/core/compile_cache.py (the JAX package): the same API and counters, holding replay runners (batched.Runner) where the JAX module holds jitted functions.
"""Process-level replay cache.

The JAX module caches one jitted replay per :class:`ReplayStatics`, and
XLA keeps one executable per bucket shape under it.  On the card a
captured CUDA graph is what an executable is to XLA, but a graph fixes
the buffer addresses as well as the shapes, so the port's keys name the
bucket shapes themselves: ``(statics, shape)`` for a whole replay and
``(statics, "chunk", chunk_events, shape)`` for the streaming engine's
chunk step, beside its ``(statics, "finalize")`` (see
``repro_torch.core.batched.replay_key``).  A value is what ``build``
returned: a replay runner (``batched.Runner``; on the card its captured
graphs, static state, event buffer and graph memory pool, on the CPU the
eager step functions) or any other callable.

Evicting an entry (or :func:`clear_cache`) calls its ``close()`` where
it has one, which frees a runner's graphs.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

_RUN_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_MAX_ENTRIES: Optional[int] = None


def _release(value: Any) -> None:
    close = getattr(value, "close", None)
    if close is not None:
        close()


def _evict_to(n: int) -> None:
    while len(_RUN_CACHE) > n:
        _release(_RUN_CACHE.popitem(last=False)[1])
        _STATS["evictions"] += 1


def cached_replay_fn(key: Any, build: Callable[[], Any]) -> Any:
    """Return the process-cached value for ``key`` (any hashable),
    building it on miss.

    When a bound is set with :func:`set_max_entries` the cache evicts
    least-recently-used entries (a hit refreshes recency); unbounded by
    default."""
    fn = _RUN_CACHE.get(key)
    if fn is None:
        _STATS["misses"] += 1
        fn = _RUN_CACHE[key] = build()
        if _MAX_ENTRIES is not None:
            _evict_to(_MAX_ENTRIES)
    else:
        _STATS["hits"] += 1
        _RUN_CACHE.move_to_end(key)
    return fn


def set_max_entries(n: Optional[int]) -> Optional[int]:
    """Bound the cache to ``n`` LRU entries (None = unbounded, the
    default).  Evicts immediately if already over.  Returns the previous
    bound so callers can restore it (try/finally)."""
    global _MAX_ENTRIES
    prev, _MAX_ENTRIES = _MAX_ENTRIES, n
    if n is not None:
        _evict_to(n)
    return prev


def cache_stats() -> Dict[str, int]:
    """Hit/miss/eviction counters plus the number of live entries (the
    flight recorder snapshots this into its JSONL stream)."""
    return dict(_STATS, entries=len(_RUN_CACHE))


def clear_cache() -> None:
    for fn in _RUN_CACHE.values():
        _release(fn)
    _RUN_CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = _STATS["evictions"] = 0


def ensure_persistent_cache(path: str | None = None) -> str:
    """The JAX module points XLA's on-disk compilation cache at a
    directory here, so later processes skip compiling.  A captured CUDA
    graph holds the addresses of one process's buffers and cannot be
    saved for another process, so the port has nothing to persist: this
    always returns '' (disabled)."""
    return ""


__all__ = ["cached_replay_fn", "cache_stats", "clear_cache",
           "set_max_entries", "ensure_persistent_cache"]
