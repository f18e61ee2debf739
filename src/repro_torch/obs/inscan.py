"""In-replay telemetry — port of ``repro/obs/inscan.py``.

When ``ReplayStatics.telemetry`` is on, ``repro_torch.core.batched``
records, with no host synchronisation:

  * per VM, the decision code of :mod:`.reasons` in a 4th ``vmrow``
    column (-1 until the VM's arrival is processed), written by the same
    row write the arrival always does;
  * per step, at each step-end after defrag and consolidation (exactly
    what the next hour sees), a row pair ``step_row``: the (5,) int32
    counters (intra and inter migrations, GRMU's heavy / light / pool
    GPU counts) and the (G,) free masks narrowed to ``MASK_DTYPE``,
    written straight into the state's ``tele_steps`` / ``tele_masks``
    buffers at the step's index, read on the device from the replay's
    event rows.

The JAX module's ``fold_step_rows`` has no counterpart.  It exists there
because XLA's ``lax.switch`` copies every carried buffer through every
branch, so the JAX scan emits the step rows as per-event scan outputs
and folds them into the step series after each scan.  The port's replay
writes into its state tensors in place (eagerly, or from captured CUDA
graphs), so the step-end writes its row where it belongs and nothing
needs folding.

``unpack_finalize`` emits the ``TELE_KEYS`` output arrays: the per-VM
codes, their tally (a compare-and-sum, as in the JAX module) and the
step series.  The host side (``ReplayTelemetry`` to
``replay_with_telemetry``) is the JAX module's numpy code line for line,
so the float64 series (``frag_mean``, ``util``) come out bit for bit the
same; the per-model histogram and fragmentation are derived there from
the mask snapshots, and the cumulative rejections by reason from the
event stream.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, List

import numpy as np
import torch

from ..core import policy_core as pc
from . import reasons

SCHEMA_VERSION = 1

# Column layout of the per-step scalar row (``step_row`` head /
# ``tele_steps``).
COL_INTRA = 0
COL_INTER = 1
COL_HEAVY = 2         # cols 2..4: GRMU basket occupancy (0 otherwise)
COL_LIGHT = 3
COL_POOL = 4
NUM_STEP_COLS = 5

# The telemetry arrays a telemetry-enabled replay adds to its output
# dict (``unpack_finalize``), in one place so tests stay in sync.
TELE_KEYS = ("tele_vm_reason", "tele_rej", "tele_steps", "tele_masks")

# Free-mask snapshot dtype: DeviceModel enforces num_blocks <= 8, so
# every free mask is < 2**8.
MASK_DTYPE = torch.uint8

# Basket labels in the order of the step row's columns 2..4.
BASKET_COLS = (pc.HEAVY_BASKET, pc.LIGHT_BASKET, pc.POOL)


def _code_table() -> np.ndarray:
    """``reasons.arrival_code`` of every rejected arrival, as a flat
    int32 table indexed by ``best * 4 + grew * 2 + quota_full``, where
    ``best`` is 0 (no slot), 1 (a slot, no host headroom) or 2 (both)."""
    best, grew, quota = (np.array(v) for v in zip(
        *itertools.product((0, 1, 2), (0, 1), (0, 1))))
    return reasons.arrival_code(np, np.zeros(len(best), bool), best >= 1,
                                best >= 2, grew.astype(bool),
                                quota.astype(bool))


@functools.lru_cache(maxsize=None)
def device_tables(device: str):
    """``(code table, BASKET_COLS)`` on ``device`` (see
    ``arrival_reason_code`` and ``step_row``), copied there once per
    process: a copy to the card waits for it."""
    return (torch.as_tensor(_code_table(), device=device),
            torch.tensor(BASKET_COLS, dtype=torch.int32, device=device))


def arrival_reason_code(T, mid, free, pids, host_ok, ok, table, grew=None,
                        quota_full=None) -> torch.Tensor:
    """Classify one arrival decision: a (1,) int32 code.

    ``free`` / ``host_ok`` must be the pre-placement state and ``grew`` /
    ``quota_full`` GRMU's flags before the basket grows (None for the
    other policies, which never grow one).  The fleet-wide slot gather
    and one max give both feasibility flags, as in the JAX module (here
    as ``best * 4``); the cascade of ``reasons.arrival_code`` is then one
    lookup in ``table`` (``device_tables``), so no flag is read on the
    host.  The key keeps a dimension: indexing with a 0-d tensor reads
    its value on the host, a synchronisation per arrival."""
    slot = T.fits[mid, free.long(), pids[mid]]
    key = torch.where(slot, torch.where(host_ok, 8, 4), 0).amax(
        0, keepdim=True)
    if grew is not None:
        key = key + grew * 2 + quota_full
    return torch.where(ok, reasons.ACCEPTED, table[key])


def step_row(state: Dict[str, torch.Tensor], cols: torch.Tensor,
             idx: torch.Tensor) -> None:
    """Write one step-end telemetry row pair into the state at the step
    index ``idx`` ((1,) int64 on the state's device, so the write needs
    no host value): the (5,) int32 scalars into ``tele_steps`` and the
    (G,) free masks, as ``MASK_DTYPE``, into ``tele_masks``.  Sampled
    after defrag and consolidation; ``cols`` is ``BASKET_COLS`` on the
    state's device (``device_tables``).  Where the state keeps no baskets
    and no migration counters (not GRMU) the scalar row stays 0.  A
    snapshot, not a reduction: everything derivable from the masks is
    derived on the host (``telemetry_from_arrays``)."""
    basket = state.get("basket")
    if basket is not None:
        occupancy = (basket[None, :] == cols[:, None]).sum(
            dim=1, dtype=torch.int32)
        state["tele_steps"][idx] = torch.cat(
            [state["intra"].view(1), state["inter"].view(1), occupancy])
    state["tele_masks"][idx] = state["free"].to(MASK_DTYPE)


def unpack_finalize(final: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Emit the ``TELE_KEYS`` output tensors from a final replay state.
    The reason tally is a compare-and-sum over the codes >= 0."""
    codes = final["vmrow"][:, 3]
    rej = ((codes[:, None] == torch.arange(reasons.NUM_CODES,
                                           device=codes.device)[None, :])
           & (codes >= 0)[:, None]).sum(dim=0, dtype=torch.int32)
    return dict(
        tele_vm_reason=codes,
        tele_rej=rej,
        tele_steps=final["tele_steps"],
        tele_masks=final["tele_masks"],
    )


# ---------------------------------------------------------------------------
# Host side: output arrays -> series (the JAX module's numpy, line for line)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplayTelemetry:
    """Host-side view of one replay's telemetry (logical sizes, padding
    sliced away, derived series filled in).  ``to_json_dict`` is the
    schema-versioned JSONL payload the :class:`repro_torch.obs.recorder`
    exports and ``repro_torch.obs.report`` renders."""
    model_names: List[str]
    rejection_reasons: Dict[str, int]
    vm_reason: np.ndarray      # (N,) int32 code per VM, -1 = not offered
    step_times: np.ndarray     # (S,) float64
    rej_hourly: np.ndarray     # (S, 4) cumulative rejections by reason
    intra_hourly: np.ndarray   # (S,) cumulative intra migrations
    inter_hourly: np.ndarray   # (S,) cumulative inter migrations
    basket_hourly: np.ndarray  # (S, 3) heavy/light/pool GPU counts
    free_hist: np.ndarray      # (S, M, B+1) free-block histogram
    frag_mean: np.ndarray      # (S, M) mean frag score over model GPUs
    util: np.ndarray           # (S, M) used-block fraction in [0, 1]
    active_gpus: np.ndarray    # (S, M) GPUs with >= 1 block in use

    def to_json_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "model_names": list(self.model_names),
            "rejection_reasons": dict(self.rejection_reasons),
            "vm_reason": self.vm_reason.tolist(),
            "step_times": self.step_times.tolist(),
            "rej_hourly": self.rej_hourly.tolist(),
            "intra_hourly": self.intra_hourly.tolist(),
            "inter_hourly": self.inter_hourly.tolist(),
            "basket_hourly": self.basket_hourly.tolist(),
            "free_hist": self.free_hist.tolist(),
            "frag_mean": self.frag_mean.tolist(),
            "util": self.util.tolist(),
            "active_gpus": self.active_gpus.tolist(),
        }


def _cum_rejections(events, vm_reason: np.ndarray) -> np.ndarray:
    """(S, 4) cumulative rejections by reason at each step-end row,
    reconstructed from event positions: arrivals sort strictly before
    their bucket's step-end event, so a cumsum over the event stream
    sampled at step-end rows equals what an in-state counter would have
    held.  Pure host numpy — runs once per replay."""
    from ..core import batched as B  # deferred: batched imports us
    kind = np.asarray(events.kind)
    S = len(events.step_times)
    is_arr = kind == B.ARRIVAL
    is_step = kind == B.STEP_END
    onehot = np.zeros((len(kind), reasons.NUM_CODES), np.int64)
    codes = vm_reason[np.asarray(events.vm_index)[is_arr]]
    onehot[is_arr, np.clip(codes, 0, reasons.NUM_CODES - 1)] = codes >= 0
    cum = np.cumsum(onehot, axis=0)
    rows = np.zeros((S, 4), np.int64)
    rows[np.asarray(events.idx)[is_step]] = cum[is_step][:, 1:5]
    return rows


def telemetry_from_arrays(events, out: dict) -> ReplayTelemetry:
    """Assemble a :class:`ReplayTelemetry` from a telemetry-enabled
    replay's output arrays (numpy; ``batched.make_replay(...,
    telemetry=True)``).  Mirrors ``result_from_arrays``: everything is
    sliced back to the trace's logical N/S and derived in float64."""
    S = len(events.step_times)
    N = len(events.vm_ids)
    models = events.models
    M = len(models)
    steps = np.asarray(out["tele_steps"])[:S]
    rej = np.asarray(out["tele_rej"])
    vm_reason = np.asarray(out["tele_vm_reason"])[:N]

    mid = np.asarray(events.gpu_model_id)[:events.num_gpus]
    # The port's own numpy tables (policy_core's host staging).
    T = pc._stack_host_tables(tuple(models))
    B = max(m.num_blocks for m in models)
    masks = np.asarray(out["tele_masks"]).astype(
        np.int64)[:S, :events.num_gpus]                     # (S, G)
    pop = np.asarray(T["pop"])[mid[None, :], masks]
    member = (mid[:, None] == np.arange(M)[None, :])        # (G, M)
    onehot = (pop[:, :, None] == np.arange(B + 1)[None, None, :])
    hist = np.einsum("sgb,gm->smb", onehot.astype(np.int64),
                     member.astype(np.int64))
    frag_sum = np.einsum(
        "sg,gm->sm", np.asarray(T["frag"])[mid[None, :], masks],
        member.astype(np.float64)).astype(np.float64)
    gpus_per_model = np.bincount(mid, minlength=M).astype(np.float64)
    blocks_per_model = np.array(
        [bin(m.full_mask).count("1") for m in models], np.float64)
    total_blocks = gpus_per_model * blocks_per_model

    free_blocks = (hist * np.arange(hist.shape[-1])[None, None, :]
                   ).sum(axis=-1).astype(np.float64)
    denom = np.maximum(total_blocks, 1.0)[None, :]
    util = np.where(total_blocks[None, :] > 0,
                    1.0 - free_blocks / denom, 0.0)
    # A GPU is idle iff its free-block count equals its model's total.
    idle = np.stack([hist[:, m, int(blocks_per_model[m])]
                     for m in range(M)], axis=1).astype(np.float64)
    active_gpus = gpus_per_model[None, :] - idle
    frag_mean = np.where(gpus_per_model[None, :] > 0,
                         frag_sum / np.maximum(gpus_per_model, 1.0)[None, :],
                         0.0)
    return ReplayTelemetry(
        model_names=[m.name for m in models],
        rejection_reasons={reasons.REASON_NAMES[c]: int(rej[c])
                           for c in range(1, reasons.NUM_CODES)},
        vm_reason=vm_reason,
        step_times=np.asarray(events.step_times, np.float64),
        rej_hourly=_cum_rejections(events, vm_reason),
        intra_hourly=steps[:, COL_INTRA],
        inter_hourly=steps[:, COL_INTER],
        basket_hourly=steps[:, COL_HEAVY:COL_POOL + 1],
        free_hist=hist,
        frag_mean=frag_mean,
        util=util,
        active_gpus=active_gpus,
    )


def replay_with_telemetry(events, policy: int, heavy_capacity=None,
                          device=None, **cfg):
    """Convenience entry point: telemetry-enabled replay on ``device``
    (``None`` = the CUDA device) returning ``(SimResult,
    ReplayTelemetry)``.  Accepts the same cfg as ``batched.replay``."""
    from ..core import batched as B  # deferred: batched imports us
    if heavy_capacity is None:
        heavy_capacity = B.default_heavy_capacity(events)
    out = B.make_replay(events, policy, device, telemetry=True,
                        **cfg)(heavy_capacity)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return (B.result_from_arrays(events, policy, out),
            telemetry_from_arrays(events, out))


__all__ = ["SCHEMA_VERSION", "TELE_KEYS", "NUM_STEP_COLS", "MASK_DTYPE",
           "BASKET_COLS", "device_tables", "arrival_reason_code",
           "step_row",
           "unpack_finalize", "ReplayTelemetry", "telemetry_from_arrays",
           "replay_with_telemetry"]
