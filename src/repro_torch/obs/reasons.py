# Copied unchanged from repro/obs/reasons.py (the JAX package), so the port imports nothing of it.
"""Rejection-reason taxonomy shared by every engine (flight recorder).

A rejected arrival is classified into exactly one code by a fixed
cascade, evaluated against the cluster state *at decision time* (before
any basket growth or placement mutation).  The sequential engine
(``repro.sim.engine``), the batched scan (``repro.core.batched``) and
its chunked/sharded twins all run this same cascade — the sequential
path with numpy scalars, the scan with traced jnp values — so the
per-reason tallies are cross-engine comparable bit for bit
(tests/test_obs.py).

Codes::

    ACCEPTED          placed (never appears in rejection tallies)
    REJ_NO_SLOT       no GPU fleet-wide has a feasible MIG slot for the
                      request's profile (ignoring host CPU/RAM)
    REJ_CAPACITY      a slot existed but host CPU/RAM blocked every
                      feasible GPU — including GRMU's grown pool GPU
    REJ_BASKET_QUOTA  GRMU only: capacity existed outside the request's
                      basket, the basket had no room and its quota was
                      already full (Alg. 3's cap)
    REJ_FROZEN        capacity existed but no policy-eligible GPU could
                      take the VM: GRMU with an unfillable basket and an
                      empty pool, or the ILP oracle blocked by frozen
                      residents

The cascade is ``xp``-parameterized (numpy or jax.numpy) and kept free
of any engine import so both planes share one definition.
"""
from __future__ import annotations

ACCEPTED = 0
REJ_NO_SLOT = 1
REJ_CAPACITY = 2
REJ_BASKET_QUOTA = 3
REJ_FROZEN = 4
NUM_CODES = 5

REASON_NAMES = {
    REJ_NO_SLOT: "no_slot",
    REJ_CAPACITY: "capacity",
    REJ_BASKET_QUOTA: "basket_quota",
    REJ_FROZEN: "frozen",
}
# Rejection-reason names in code order (codes 1..NUM_CODES-1).
REJECTION_REASONS = tuple(REASON_NAMES[c] for c in range(1, NUM_CODES))


def empty_reason_tally() -> dict:
    """All-zero per-reason tally, every key present (stable JSON shape)."""
    return {name: 0 for name in REJECTION_REASONS}


def arrival_code(xp, ok, slot_any, slot_host_any, grew, quota_full):
    """Classify one arrival decision; returns an int32 code.

    ``slot_any``       any GPU fleet-wide has a feasible MIG slot for the
                       request (host constraints ignored);
    ``slot_host_any``  any GPU has a feasible slot AND host headroom;
    ``grew``           GRMU grew its basket from the pool this arrival
                       (a rejected-and-grown request was host-blocked on
                       the grown GPU — capacity, not quota);
    ``quota_full``     the request's basket was at its cap *before* any
                       growth (False for non-GRMU policies).

    The cascade must see pre-mutation state: callers capture these flags
    before basket growth / free-mask updates.
    """
    code = xp.where(
        ~slot_any, REJ_NO_SLOT,
        xp.where(~slot_host_any, REJ_CAPACITY,
                 xp.where(grew, REJ_CAPACITY,
                          xp.where(quota_full, REJ_BASKET_QUOTA,
                                   REJ_FROZEN))))
    return xp.where(ok, ACCEPTED, code).astype(xp.int32)


__all__ = ["ACCEPTED", "REJ_NO_SLOT", "REJ_CAPACITY", "REJ_BASKET_QUOTA",
           "REJ_FROZEN", "NUM_CODES", "REASON_NAMES", "REJECTION_REASONS",
           "empty_reason_tally", "arrival_code"]
