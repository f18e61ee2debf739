"""Host observability plane — port of ``repro/obs/recorder.py``.

The :class:`Recorder` is the flight recorder's host half.  Engines check
:func:`active` (None when recording is off, the default) and only then
emit spans, so nothing is recorded unless a recorder is installed with
:func:`record`:

    from repro_torch.obs import recorder as obs_recorder
    with obs_recorder.record("run.jsonl", meta={"policy": "GRMU"}) as rec:
        res = replay_chunked(events, GRMU)      # emits chunk.* spans
        rec.result(res)

Every line in the JSONL file is one record with ``schema`` (the
``SCHEMA_VERSION`` of ``repro_torch.obs.inscan``), ``kind`` and
``run_id``, with the JAX package's record kinds:

  ``meta``       run header (wall time, caller-provided metadata)
  ``span``       a named wall-clock span (``name``, ``dur_s``, extras
                 such as ``index``/``nbytes`` for chunk steps) — also a
                 ``torch.profiler.record_function`` range, so spans line
                 up with the card's operations in a profiler trace
  ``cache``      replay compile-cache statistics (``cache_stats``)
  ``result``     a SimResult summary + rejection-reason tally
  ``telemetry``  a full ``ReplayTelemetry`` payload
  ``service``    a placement-service control-plane event

Spans measure host wall-clock: the card runs asynchronously, so a
chunk-step span is the host's cost of dispatching that chunk (and of the
few host reads the replay makes), not the card's time — that comes from
the profiler trace.  ``REPRO_TRACE=1`` additionally runs a
``torch.profiler`` session for the recorder's lifetime and writes its
Chrome trace to ``REPRO_TRACE_DIR`` (default: ``torch_trace`` beside the
JSONL file) as ``<run_id>.trace.json``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

from .inscan import SCHEMA_VERSION

_ACTIVE: Optional["Recorder"] = None


def active() -> Optional["Recorder"]:
    """The process-active recorder, or None (recording off — default)."""
    return _ACTIVE


class Recorder:
    """Appends schema-versioned JSONL records; see the module docstring.
    Prefer the :func:`record` context manager, which also installs the
    recorder as the process-active one so engine loops emit spans."""

    def __init__(self, path, *, run_id: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.path = str(path)
        self.run_id = run_id or f"run-{os.getpid()}-{int(time.time())}"
        self._fh = open(self.path, "a")
        self._profiler = None
        self.emit("meta", time_unix=time.time(), **(meta or {}))
        if os.environ.get("REPRO_TRACE") == "1":
            trace_dir = os.environ.get(
                "REPRO_TRACE_DIR",
                os.path.join(os.path.dirname(self.path) or ".",
                             "torch_trace"))
            os.makedirs(trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._trace_file = os.path.join(trace_dir,
                                            f"{self.run_id}.trace.json")
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.start()
            self.emit("trace_started", trace_dir=trace_dir)

    def emit(self, kind: str, **fields) -> None:
        rec = {"schema": SCHEMA_VERSION, "kind": kind,
               "run_id": self.run_id}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    @contextlib.contextmanager
    def span(self, name: str, **fields) -> Iterator[None]:
        """Time a host-side region; doubles as a profiler range so the
        span is visible in a ``REPRO_TRACE=1`` capture."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.emit("span", name=name,
                  dur_s=time.perf_counter() - t0, **fields)

    def cache_stats(self) -> None:
        """Snapshot the replay compile cache (hits/misses/evictions)."""
        from ..core import compile_cache
        self.emit("cache", **compile_cache.cache_stats())

    def result(self, res) -> None:
        """Record a ``SimResult``'s summary + rejection-reason tally."""
        self.emit("result", summary=res.summary(),
                  rejection_reasons=dict(res.rejection_reasons))

    def telemetry(self, tele) -> None:
        """Record a full ``ReplayTelemetry`` payload."""
        self.emit("telemetry", **tele.to_json_dict())

    def service(self, event: str, **fields) -> None:
        """Record a placement-service control-plane event (``kind=
        "service"``).  ``event`` names the transition."""
        self.emit("service", event=event, **fields)

    def close(self) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            self._profiler.export_chrome_trace(self._trace_file)
            self._profiler = None
        if not self._fh.closed:
            self._fh.close()


@contextlib.contextmanager
def record(path, *, run_id: Optional[str] = None,
           meta: Optional[dict] = None) -> Iterator[Recorder]:
    """Open a :class:`Recorder` on ``path`` and install it as the
    process-active recorder for the duration of the block."""
    global _ACTIVE
    rec = Recorder(path, run_id=run_id, meta=meta)
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = prev
        rec.close()


__all__ = ["Recorder", "record", "active"]
