# Port of examples/paper_eval.py
"""Full paper evaluation (§8): all five policies on the full-scale
synthetic Alibaba-2023-shaped trace (1,213 hosts / 8,063 VMs), printing
the Fig. 10-12 + Table 6 summary.

    PYTHONPATH=src python -m repro_torch.examples.paper_eval \\
        [--scale 1.0] [--seed 1] [--heavy-frac 0.3] [--device cpu]

Each policy replays the trace through ``core.batched.replay`` on the
device (the JAX script's sequential ``simulate`` gives the same
decisions, so the same lines).
"""
from __future__ import annotations

import argparse
import sys
from typing import List

from ..core import batched as B
from ..device import DeviceLike, resolve_device
from ..sim.metrics import SimResult
from ..workload.alibaba import TraceConfig, generate
from .quickstart import GRMU_KNOBS

# The JAX script's policies in its order: POLICY_REGISTRY's, then GRMU.
POLICIES = (("FF", B.FF, {}), ("BF", B.BF, {}), ("MCC", B.MCC, {}),
            ("MECC", B.MECC, {}), ("GRMU", B.GRMU, GRMU_KNOBS))


def policy_line(name: str, res: SimResult) -> str:
    s = res.summary()
    pp = res.per_profile_acceptance_rate()
    return (f"{name:5s} acc={s['acceptance_rate']:.3f} "
            f"hw={s['avg_active_hw_rate']:.3f} auc={s['active_hw_auc']:.0f} "
            f"mig={s['migrations']} ({s['migration_fraction']*100:.1f}% "
            f"of accepted) | per-profile: "
            + " ".join(f"{k}={v:.2f}" for k, v in pp.items()))


def headline(rows: List[SimResult]) -> List[str]:
    """The '--- headline vs paper ---' block's lines."""
    by = {r.policy: r for r in rows}
    g, m, f = (by["GRMU"].overall_acceptance_rate,
               by["MCC"].overall_acceptance_rate,
               by["FF"].overall_acceptance_rate)
    mx = max(r.active_hw_auc for r in rows)
    return ["",
            "--- headline vs paper ---",
            f"GRMU/MCC acceptance: {g/m:.2f}x   (paper: 1.22x)",
            f"GRMU/FF  acceptance: {g/f:.2f}x   (paper: 1.39x)",
            f"GRMU normalized hw AUC: {by['GRMU'].active_hw_auc/mx:.3f} "
            f"(paper Table 6: 0.815)",
            f"GRMU migration fraction: "
            f"{by['GRMU'].migration_fraction*100:.2f}% (paper: ~1%)"]


def run(scale: float = 1.0, seed: int = 1, heavy_frac: float = 0.3,
        device: DeviceLike = None) -> List[str]:
    """Replay the five policies and print the script's lines; returns
    them."""
    device = resolve_device(device)
    cluster, vms = generate(TraceConfig(scale=scale, seed=seed))
    events = B.build_events(vms, cluster)
    cap = B.default_heavy_capacity(events, heavy_frac)
    rows, lines = [], []
    for name, policy, kw in POLICIES:
        res = B.replay(events, policy, heavy_capacity=cap, device=device,
                       **kw)
        rows.append(res)
        lines.append(policy_line(name, res))
        print(lines[-1], flush=True)
    for line in headline(rows):
        lines.append(line)
        print(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--heavy-frac", type=float, default=0.3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.scale, args.seed, args.heavy_frac, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
