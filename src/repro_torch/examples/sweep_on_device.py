# Port of examples/sweep_on_device.py
"""Beyond-paper: run the Fig. 6 heavy-basket sweep on the device (every
capacity through one replay runner: its captured graphs on the card), and
cross-check the sequential engine.

    PYTHONPATH=src python -m repro_torch.examples.sweep_on_device \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np

from ..core import batched as B
from ..core.grmu import GRMU
from ..device import DeviceLike, resolve_device
from ..sim.engine import simulate
from ..workload.alibaba import TraceConfig, generate

SCALE = 0.15


def run(scale: float = SCALE, seed: int = 3, n_fracs: int = 10,
        device: DeviceLike = None) -> Dict[str, object]:
    """The script's body at ``scale`` / ``seed`` over ``n_fracs``
    capacities from 0.15 to 0.6.  Returns the accepted counts per
    capacity, the best capacity and the cross-check's two counts."""
    device = resolve_device(device)
    cluster, vms = generate(TraceConfig(scale=scale, seed=seed))
    events = B.build_events(vms, cluster)
    fracs = np.linspace(0.15, 0.6, n_fracs)
    print(f"replaying {len(vms)} VMs x {len(fracs)} basket capacities "
          f"on-device (one replay runner, its graphs on the card)...")
    acc = B.sweep_heavy_capacity(events, fracs, device=device)
    total = len(vms)
    for f, row in zip(fracs, acc):
        bar = "#" * int(50 * row.sum() / total)
        print(f"  frac={f:.2f} accepted={int(row.sum()):5d} {bar}")

    best = fracs[int(np.argmax(acc.sum(axis=1)))]
    print(f"\nbest heavy-basket capacity: {best:.2f} "
          f"(paper tunes to 0.30 for its workload)")

    # cross-check one point against the sequential engine
    cluster, vms = generate(TraceConfig(scale=scale, seed=seed))
    pol = GRMU(cluster, heavy_capacity_frac=0.3, defrag=False)
    res = simulate(cluster, pol, vms)
    idx = int(np.argmin(np.abs(fracs - 0.3)))
    print(f"cross-check @0.30: sequential={res.accepted} "
          f"vmapped={int(acc[idx].sum())} (engines are decision-equivalent)")
    return {"accepted": [int(r.sum()) for r in acc], "best": float(best),
            "sequential": int(res.accepted), "device": int(acc[idx].sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
