# Copied unchanged from repro/sim/metrics.py (the JAX package), so the port imports nothing of it.
"""Metrics collection matching the paper's evaluation (§8)."""
from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Dict, List

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..core.mig import DeviceModel

# numpy renamed trapz -> trapezoid in 2.0 (trapz is removed in 2.x).
_trapezoid = getattr(np, "trapezoid", None) or np.trapz

# Serialized-SimResult schema.  Bump on any field add/rename/remove;
# ``from_dict`` refuses mismatched versions instead of misreading them.
SCHEMA_VERSION = 1


@dataclasses.dataclass
class SimResult:
    """Per-run metrics.  ``per_profile_*`` tallies are keyed by the
    cluster's *reference* device model (``cluster.models[0]``) — use
    :meth:`for_model` (or pass the dicts explicitly) so a result built
    for a non-A100 fleet never carries another model's profile names.
    The default is *empty*, not the legacy A100-40GB profile set.
    """
    policy: str
    total_requests: int = 0
    accepted: int = 0
    rejected: int = 0
    per_profile_total: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    per_profile_accepted: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    hourly_times: List[float] = dataclasses.field(default_factory=list)
    hourly_acceptance: List[float] = dataclasses.field(default_factory=list)
    hourly_active_hw: List[float] = dataclasses.field(default_factory=list)
    migrations: int = 0
    intra_migrations: int = 0
    inter_migrations: int = 0
    # Per-VM decisions: vm_ids accepted, in arrival order (both engines
    # fill this; the cross-engine equivalence tests compare it).
    accepted_ids: List[int] = dataclasses.field(default_factory=list)
    # Rejections by reason name (repro.obs.reasons).  The sequential
    # engine always fills this; the batched engine fills it when replayed
    # with telemetry=True — empty otherwise, so equivalence tests that
    # predate the taxonomy keep comparing only the fields above.
    rejection_reasons: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def for_model(cls, policy: str, model: "DeviceModel",
                  **kw) -> "SimResult":
        """A result whose per-profile tallies are keyed by ``model``'s
        profile names (the fleet's reference model)."""
        return cls(policy=policy,
                   per_profile_total={p.name: 0 for p in model.profiles},
                   per_profile_accepted={p.name: 0
                                         for p in model.profiles},
                   **kw)

    # -- derived ------------------------------------------------------------
    @property
    def overall_acceptance_rate(self) -> float:
        return self.accepted / max(1, self.total_requests)

    @property
    def average_active_hw_rate(self) -> float:
        """Mean of hourly active-hardware rates (§8.2.1)."""
        return float(np.mean(self.hourly_active_hw)) if self.hourly_active_hw else 0.0

    @property
    def active_hw_auc(self) -> float:
        """Area under the active-hardware curve (Table 6)."""
        if len(self.hourly_times) < 2:
            return 0.0
        return float(_trapezoid(self.hourly_active_hw, self.hourly_times))

    def per_profile_acceptance_rate(self) -> Dict[str, float]:
        return {name: (self.per_profile_accepted[name]
                       / max(1, self.per_profile_total[name]))
                for name in self.per_profile_total}

    @property
    def average_profile_acceptance(self) -> float:
        """Mean of per-profile acceptance rates (blue line, Fig. 8) over
        profiles that actually occur in the workload."""
        rates = [v for k, v in self.per_profile_acceptance_rate().items()
                 if self.per_profile_total[k] > 0]
        return float(np.mean(rates)) if rates else 0.0

    @property
    def migration_fraction(self) -> float:
        """Migrations as a fraction of accepted VMs (§8.3.3)."""
        return self.migrations / max(1, self.accepted)

    def summary(self) -> Dict[str, float]:
        return {
            "policy": self.policy,
            "total": self.total_requests,
            "accepted": self.accepted,
            "acceptance_rate": round(self.overall_acceptance_rate, 4),
            "avg_profile_acceptance": round(self.average_profile_acceptance, 4),
            "avg_active_hw_rate": round(self.average_active_hw_rate, 4),
            "active_hw_auc": round(self.active_hw_auc, 2),
            "migrations": self.migrations,
            "migration_fraction": round(self.migration_fraction, 4),
        }

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """Schema-versioned plain-dict form (JSON-safe: every field is
        already int/float/str containers)."""
        return {"schema_version": SCHEMA_VERSION,
                **dataclasses.asdict(self)}

    def to_json(self, **json_kw) -> str:
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SimResult":
        d = dict(d)
        ver = d.pop("schema_version", None)
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"SimResult schema_version {ver!r} != supported "
                f"{SCHEMA_VERSION}; refusing to misread")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SimResult":
        return cls.from_dict(json.loads(s))


__all__ = ["SimResult", "SCHEMA_VERSION"]
