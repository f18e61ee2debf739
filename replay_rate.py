#!/usr/bin/env python3
"""Full-scale trace-replay rate of the PyTorch port on one CUDA card, to
compare checkouts of the repository within one run.

    python3 replay_rate.py ROOT [ROOT ...] [--policies FF,MCC,MECC] [--reps 3]
                           [--telemetry]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``.  The roots
run one after another, each in its own process (one import of the port
per process), in the order given: list ``A B B A`` to alternate two
versions.  For each policy a root prints one JSON line: the events/s of
``--reps`` full replays of ``TraceConfig(scale=1.0, seed=1)`` after a
warm-up (host clock to ``torch.cuda.synchronize()``), the graphs and
capture seconds of the replay's runner where the checkout has one, and,
under ``torch.profiler`` over a replay of the first 1,000 events,
device operations per event, device microseconds per event, copies to
the host (each a host synchronisation) and the device's busy share.  The
policies' settings and the profile are ``chip_smoke.py``'s phase 4 (this
script's own checkout), the same for every root; ``--telemetry`` replays
with telemetry on (to compare on and off, run the script with and
without it in turns).  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def root_package(root: Path) -> None:
    """Put ``root/src`` and this script's directory first on the path and
    import ``root``'s ``repro_torch`` before this checkout's
    ``chip_smoke`` (which puts its own ``src`` first when imported and
    would otherwise hand every root this checkout's package); raise unless
    the package came from ``root``."""
    sys.path[:0] = [str(root / "src"), str(Path(__file__).resolve().parent)]
    import repro_torch
    got = Path(repro_torch.__file__).resolve()
    if not got.is_relative_to((root / "src").resolve()):
        raise RuntimeError(f"repro_torch came from {got}, not {root}")


def worker(root: Path, args) -> None:
    import torch
    root_package(root)
    from chip_smoke import profile_replay, replay_configs
    from repro_torch.core import batched as B
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    cap = B.default_heavy_capacity(events)
    configs = {name: (pol, kw) for name, pol, kw in replay_configs(B)}
    for name in args.policies.split(","):
        pol, kw = configs[name]
        kw = dict(kw, telemetry=args.telemetry)
        run = B.make_replay(events, pol, device="cuda", **kw)
        run(cap)
        torch.cuda.synchronize()
        rates = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = run(cap)
            torch.cuda.synchronize()
            rates.append(n_events / (time.perf_counter() - t0))
        accepted = int(out["vm_accepted"].sum())
        # A checkout whose replay runs captured graphs has a runner.
        runner = getattr(run, "runner", None)
        graphs = dict(graphs=len(runner.graphs),
                      capture_s=runner.capture_s) if runner else {}
        print(json.dumps(dict(root=str(root), policy=name,
                              telemetry=args.telemetry,
                              events_per_s=rates, accepted=accepted,
                              **graphs,
                              **profile_replay(torch, B, events, pol, kw,
                                               cap))),
              flush=True)


def in_turns(doc: str, worker, add_options=None) -> int:
    """The command line ``ROOT [ROOT ...]`` and the options that
    ``add_options(parser)`` adds: run ``worker(root, args)`` for each ROOT
    in the order given, each in a process of its own (the same command
    line with ``--worker INDEX``).  Returns the exit code, 1 without a
    CUDA device."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    if add_options is not None:
        add_options(ap)
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print(f"{Path(sys.argv[0]).name}: no CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        worker(args.roots[args.worker].resolve(), args)
        return 0
    for i in range(len(args.roots)):
        subprocess.run([sys.executable, *sys.argv, "--worker", str(i)],
                       check=True)
    return 0


def options(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--policies", default="FF,MCC,MECC")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--telemetry", action="store_true")


if __name__ == "__main__":
    sys.exit(in_turns(__doc__, worker, options))
