#!/usr/bin/env python3
"""Full-scale trace-replay rate of the PyTorch port on one CUDA card, to
compare checkouts of the repository within one run.

    python3 replay_rate.py ROOT [ROOT ...] [--policies FF,MCC,MECC] [--reps 3]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``.  The roots
run one after another, each in its own process (one import of the port
per process), in the order given: list ``A B B A`` to alternate two
versions.  For each policy a root prints one JSON line: the events/s of
``--reps`` full replays of ``TraceConfig(scale=1.0, seed=1)`` after a
warm-up (host clock to ``torch.cuda.synchronize()``), and, under
``torch.profiler`` over the first 1,000 events, device operations per
event, device microseconds per event and the device's busy share.  The
policies' settings and the profile are ``chip_smoke.py``'s phase 4 (this
script's own checkout), the same for every root.  Exits non-zero without
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def worker(root: Path, policies, reps: int) -> None:
    import torch
    sys.path[:0] = [str(root / "src"), str(Path(__file__).resolve().parent)]
    from chip_smoke import profile_replay, replay_configs
    from repro_torch.core import batched as B
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    cap = B.default_heavy_capacity(events)
    configs = {name: (pol, kw) for name, pol, kw in replay_configs(B)}
    for name in policies:
        pol, kw = configs[name]
        run = B.make_replay(events, pol, device="cuda", **kw)
        run(cap)
        torch.cuda.synchronize()
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run(cap)
            torch.cuda.synchronize()
            rates.append(n_events / (time.perf_counter() - t0))
        accepted = int(out["vm_accepted"].sum())
        print(json.dumps(dict(root=str(root), policy=name,
                              events_per_s=rates, accepted=accepted,
                              **profile_replay(torch, B, events, pol, kw,
                                               cap))),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--policies", default="FF,MCC,MECC")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    policies = args.policies.split(",")
    import torch
    if not torch.cuda.is_available():
        print("replay_rate: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        worker(args.roots[0].resolve(), policies, args.reps)
        return 0
    for root in args.roots:
        subprocess.run([sys.executable, __file__, str(root), "--worker",
                        "--policies", args.policies, "--reps",
                        str(args.reps)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
