"""Flight recorder — port of ``repro/obs``: replay observability in two
planes.

``repro_torch.obs.inscan``   — in-replay telemetry written into the
                               replay's state (rejection reasons, basket
                               occupancy, free-mask snapshots) and the
                               host series derived from it.  Off by
                               default; decision-neutral when on.
``repro_torch.obs.reasons``  — the rejection-reason taxonomy (a copy).
``repro_torch.obs.recorder`` — host plane: profiler-annotated spans,
                               schema-versioned JSONL export.
``repro_torch.obs.report``   — ``python -m repro_torch.obs.report``:
                               text/JSON dashboards from JSONL files.
"""
from . import reasons
from .inscan import (SCHEMA_VERSION, TELE_KEYS, ReplayTelemetry,
                     replay_with_telemetry, telemetry_from_arrays)
from .reasons import REASON_NAMES, REJECTION_REASONS, empty_reason_tally
from .recorder import Recorder, active, record

__all__ = ["reasons", "SCHEMA_VERSION", "TELE_KEYS", "ReplayTelemetry",
           "replay_with_telemetry", "telemetry_from_arrays",
           "REASON_NAMES", "REJECTION_REASONS", "empty_reason_tally",
           "Recorder", "active", "record"]
