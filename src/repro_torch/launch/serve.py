"""Online placement-service command line — port of
``repro/launch/serve.py``:
stream a flash crowd through ``repro_torch.serve.PlacementService`` and
report decision latency, admission, and governor activity.

    python -m repro_torch.launch.serve --smoke
    python -m repro_torch.launch.serve --vms 5000 --gpus 128 \
        --tiers GRMU,FF --slo-ms 25 --burst 8 --obs serve_run.jsonl
    python -m repro_torch.launch.serve --smoke --device cpu

(run from ``src/`` or with it on ``PYTHONPATH``).  It generates a
flash-crowd trace (Poisson base + burst window,
``repro_torch.workload.flashcrowd``), streams its canonical request order
into the service with backpressure (a full queue sheds to ``drain``),
flushes to the horizon, and optionally verifies the decisions against
the port's offline replay of the same order (``--verify``) — the
serve-many parity contract.  ``--device`` is where the service runs (the
CUDA card unless given, e.g. ``cpu``).  ``--checkpoint-dir`` snapshots
final state through ``repro_torch.launch.checkpoint``; ``--obs`` records
``serve.batch`` spans and ``service`` governor events through the flight
recorder.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="stream a flash crowd through the placement service")
    ap.add_argument("--vms", type=int, default=2000)
    ap.add_argument("--gpus", type=int, default=64)
    ap.add_argument("--horizon", type=float, default=96.0)
    ap.add_argument("--policy", default="GRMU",
                    help="single-tier policy (ignored with --tiers)")
    ap.add_argument("--tiers", default=None,
                    help="degradation ladder, e.g. GRMU,FF or ILP,GRMU,FF")
    ap.add_argument("--micro-batch", type=int, default=64)
    ap.add_argument("--queue", type=int, default=1024)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--burst", type=float, default=6.0,
                    help="flash-crowd burst rate multiplier")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="check online decisions == offline replay")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--obs", default=None,
                    help="flight-recorder JSONL path")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run (200 VMs, 16 GPUs) + --verify")
    ap.add_argument("--device", default=None,
                    help="torch device of the service (default: the CUDA "
                         "device)")
    args = ap.parse_args(argv)

    from ..obs import recorder as obs_recorder
    from ..serve import PlacementService, ServeConfig, requests_from_trace
    from ..workload.flashcrowd import FlashCrowdConfig, generate_flash_crowd

    if args.smoke:
        args.vms, args.gpus, args.horizon = 200, 16, 48.0
        args.verify = True

    fc = FlashCrowdConfig(n_vms=args.vms, n_gpus=args.gpus,
                          horizon_hours=args.horizon,
                          burst_multiplier=args.burst, seed=args.seed)
    events = generate_flash_crowd(fc)
    reqs, horizon = requests_from_trace(events)
    tiers = tuple(args.tiers.split(",")) if args.tiers else None
    cfg = ServeConfig(policy=args.policy, tiers=tiers,
                      micro_batch=args.micro_batch,
                      queue_capacity=args.queue,
                      slo_s=args.slo_ms / 1e3)
    print(f"[serve] fleet: {args.gpus} GPUs, stream: {len(reqs)} requests "
          f"({args.vms} VMs) over {horizon:.0f}h, "
          f"tiers={tiers or (args.policy,)}", flush=True)

    rec_ctx = (obs_recorder.record(args.obs, meta={"driver": "serve"})
               if args.obs else contextlib.nullcontext())
    with rec_ctx:
        svc = PlacementService.for_trace(events, cfg, device=args.device)
        t0 = time.perf_counter()
        for r in reqs:
            while not svc.submit(r):      # backpressure: drain, retry
                svc.drain(max_batches=1)
        svc.drain()
        svc.flush(horizon)
        wall = time.perf_counter() - t0
        if args.checkpoint_dir:
            path = svc.checkpoint(args.checkpoint_dir)
            print(f"[serve] checkpointed -> {path}", flush=True)

    st = svc.stats()
    n_arr = st["decisions"]
    print(f"[serve] {n_arr} decisions ({st['accepted']} accepted) in "
          f"{wall:.2f}s = {n_arr / wall:.0f} arrivals/s", flush=True)
    print(f"[serve] latency p50={st['p50_ms']:.2f}ms "
          f"p99={st['p99_ms']:.2f}ms  queue high-water="
          f"{st['queue_high_watermark']}", flush=True)
    occ = st["tier_occupancy"]
    total = max(sum(occ.values()), 1)
    occ_pct = {k: f"{100.0 * v / total:.1f}%" for k, v in occ.items()}
    print(f"[serve] tier occupancy: {occ_pct}  switches: "
          f"{st['switches']}", flush=True)

    if args.verify:
        from ..core import batched as B
        from ..core.bucketing import pad_events
        pol = B.__dict__[args.policy] if not tiers else B.__dict__[
            tiers[0] if tiers[0] != "ILP" else "GRMU"]
        if tiers and (len(tiers) > 1 or tiers[0] == "ILP"):
            print("[serve] --verify needs a single registry-policy tier; "
                  "skipping", flush=True)
        else:
            res = B.replay(pad_events(events), pol, device=args.device)
            ok = svc.accepted_ids() == list(res.accepted_ids)
            print(f"[serve] online == offline decisions: {ok}", flush=True)
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
