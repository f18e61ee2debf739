# Port of examples/serve_with_grmu.py
"""Minimal online-placement example: stream arrivals through
``PlacementService`` with a GRMU -> FF degradation ladder, on the device.

    PYTHONPATH=src python -m repro_torch.examples.serve_with_grmu \\
        [--device cpu]

For the full driver (flash-crowd load, SLO knobs, checkpointing,
flight-recorder output) use ``python -m repro_torch.launch.serve --smoke``.
The latencies (and so the tier switches a 50 ms SLO may trigger) are the
host's and the device's; the decisions of a run without a switch are the
offline replay's.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

from ..core import batched as B
from ..core.bucketing import pad_events
from ..device import DeviceLike, resolve_device
from ..serve import PlacementService, ServeConfig, requests_from_trace
from ..workload.flashcrowd import FlashCrowdConfig, generate_flash_crowd


def run(n_vms: int = 300, n_gpus: int = 16, horizon_hours: float = 48.0,
        seed: int = 0, micro_batch: int = 32, slo_s: float = 0.050,
        device: DeviceLike = None) -> Dict[str, object]:
    """The script's body: a flash crowd of ``n_vms`` VMs on an
    ``n_gpus``-GPU A100 fleet (a 6x arrival burst mid-trace) through the
    service on ``device``.  Returns the service's stats and, without a
    tier switch, whether the online decisions equal the offline replay's
    (``"online_equals_offline"``)."""
    device = resolve_device(device)
    events = generate_flash_crowd(FlashCrowdConfig(
        n_vms=n_vms, n_gpus=n_gpus, horizon_hours=horizon_hours, seed=seed))
    reqs, horizon = requests_from_trace(events)

    svc = PlacementService.for_trace(events, ServeConfig(
        tiers=("GRMU", "FF"),   # degrade GRMU -> FF on SLO breach
        micro_batch=micro_batch, slo_s=slo_s), device=device)

    for r in reqs:
        while not svc.submit(r):     # full queue: shed one batch, retry
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)

    st = svc.stats()
    print(f"{st['decisions']} decisions, {st['accepted']} accepted; "
          f"p50={st['p50_ms']:.2f}ms p99={st['p99_ms']:.2f}ms; "
          f"tier={svc.tier_name} switches={st['switches']}")
    out = dict(st, tier=svc.tier_name, accepted_ids=svc.accepted_ids())

    # The serving-layer contract: with a single-policy ladder the online
    # decisions are bit-identical to an offline replay of this order.
    if not svc.switch_events:
        res = B.replay(pad_events(events), B.GRMU, device=device)
        out["online_equals_offline"] = (svc.accepted_ids()
                                        == list(res.accepted_ids))
        print("online == offline:", out["online_equals_offline"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
