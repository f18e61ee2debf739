# Copied unchanged from repro/core/podsched.py (the JAX package), so the port imports nothing of it.
"""MIG grammar -> TPU pod-slice scheduling (the hardware adaptation).

The paper's placement grammar — profiles of sizes {1,2,2,4,4,8} over 8
memory blocks with fixed legal start offsets — is isomorphic to carving a
TPU pod row into power-of-two slices with alignment constraints (a 4-chip
slice must start on a 4-chip boundary, etc.).  Under this mapping:

    GPU           <-> an 8-chip pod row (or any 8-unit allocatable line)
    memory block  <-> one chip (or chip pair) in the row
    GI profile    <-> slice shape (1/2/4/8 chips; two 2-sizes and two
                      4-sizes model compute-heavy vs memory-heavy slices)
    VM            <-> serving/training job of one (arch x shape) workload

GRMU then runs unchanged: the heavy basket caps whole-row jobs, Alg. 1's
CC-maximizing start selection keeps rows defragmented for large slices,
and consolidation drains near-empty rows (doubling as straggler drains —
migrating work off a slow row is an inter-GPU migration in paper terms).

``profile_for_request`` sizes a request to a slice profile the same way
the paper's Eqs. 27-30 map Alibaba pods to MIG profiles: normalized
resource demand -> nearest profile value.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .mig import PROFILES, Profile

# Slice catalogue: profile name -> (chips, HBM GiB on v5e-8 row)
SLICE_OF_PROFILE: Dict[str, Tuple[int, int]] = {
    "1g.5gb": (1, 16),
    "1g.10gb": (2, 32),     # memory-heavy small slice
    "2g.10gb": (2, 32),     # compute-heavy small slice
    "3g.20gb": (4, 64),
    "4g.20gb": (4, 64),
    "7g.40gb": (8, 128),    # whole row
}

# Published-profile combined values (Eq. 28-29 applied to the slice grid).
_U = np.array([(p.compute / 7.0) * (p.size / 8.0) for p in PROFILES])
_U_HAT = _U / _U.max()


def demand_fraction(context: int, batch: int,
                    max_context: int = 32768, max_batch: int = 16) -> float:
    """Normalized resource demand of a serving request: KV-cache bytes
    scale with context x batch (the analogue of the pod's GPU fraction)."""
    frac = (min(context, max_context) / max_context) \
        * (min(batch, max_batch) / max_batch)
    return float(np.clip(frac, 1e-4, 1.0))


def profile_for_request(context: int, batch: int) -> str:
    """Eq. 30 over the slice grid: nearest profile to the demand."""
    u_hat = demand_fraction(context, batch)
    k = int(np.argmin(np.abs(_U_HAT - u_hat)))
    return PROFILES[k].name


def chips_for_profile(name: str) -> int:
    return SLICE_OF_PROFILE[name][0]


__all__ = ["SLICE_OF_PROFILE", "demand_fraction", "profile_for_request",
           "chips_for_profile"]
