# Port of examples/quickstart.py
"""Quickstart: the paper's MIG model + GRMU in 60 seconds.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Parts 1-2 run on the host-side MIG model, as in the JAX script; part 3
replays a 5%-scale trace under FF, MCC and GRMU through
``core.batched.replay`` on the device (the JAX script's sequential
``simulate`` gives the same decisions).
"""
from __future__ import annotations

import argparse
import sys

from ..core import batched as B
from ..core.mig import GPU, PROFILE_BY_NAME
from ..device import DeviceLike, resolve_device
from ..workload.alibaba import TraceConfig, generate

# JAX's GRMU(cluster, heavy_capacity_frac=0.3): defrag on, no
# consolidation, defrag on a rejected light VM.
GRMU_KNOBS = dict(defrag=True, consolidation_interval=None,
                  defrag_trigger="light")


def mig_model() -> None:
    """Parts 1 and 2: a single A100's CC-maximizing placement, and the
    Fig. 2(a) fragmentation."""
    gpu = GPU()
    p = PROFILE_BY_NAME["1g.5gb"]
    print("empty GPU CC:", gpu.cc())                      # 18 slots
    print("first 1g.5gb placed at block:", gpu.assign("vm-a", p))   # 6
    print("second 1g.5gb placed at block:", gpu.assign("vm-b", p))  # 4
    print("CC now:", gpu.cc())

    frag = GPU()
    frag.assign_at("x", PROFILE_BY_NAME["1g.5gb"], 0)
    frag.assign_at("y", PROFILE_BY_NAME["1g.5gb"], 2)
    frag.assign_at("z", PROFILE_BY_NAME["3g.20gb"], 4)
    print("\nfree blocks:", sorted(frag.free),
          "-> 1g.10gb fits?", frag.fits(PROFILE_BY_NAME["1g.10gb"]))


def run(scale: float = 0.05, seed: int = 42,
        device: DeviceLike = None) -> None:
    """The script's body; ``scale`` and ``seed`` are part 3's trace."""
    device = resolve_device(device)
    mig_model()
    print("\nreplaying a 5%-scale Alibaba-shaped trace...")
    for policy, kw in ((B.FF, {}), (B.MCC, {}), (B.GRMU, GRMU_KNOBS)):
        cluster, vms = generate(TraceConfig(scale=scale, seed=seed))
        events = B.build_events(vms, cluster)
        res = B.replay(events, policy,
                       heavy_capacity=B.default_heavy_capacity(events, 0.3),
                       device=device, **kw)
        s = res.summary()
        print(f"  {s['policy']:5s} acceptance={s['acceptance_rate']:.3f} "
              f"active_hw={s['avg_active_hw_rate']:.3f} "
              f"migrations={s['migrations']}")
    print("\nGRMU should accept the most while keeping the least hardware "
          "active (paper §8).")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
