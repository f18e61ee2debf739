# Port of examples/train_lm.py
"""End-to-end training driver: train a small dense LM with the full stack
(data pipeline -> model -> AdamW -> atomic checkpoints), including
kill-and-resume fault tolerance.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        [--device cpu]

It calls ``repro_torch.launch.train.main`` with the JAX script's flags
(StableLM-3B's smoke config); the checkpoint directory defaults to
``repro_train_ckpt`` under the system's temporary directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional

from ..launch.train import main as train_main


def run(steps: int = 200, batch: int = 4, seq: int = 128,
        ckpt_dir: Optional[str] = None, device: Optional[str] = None) -> int:
    """The script's body: ``launch.train.main`` with its flags."""
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_train_ckpt")
    argv = ["--arch", "stablelm-3b", "--smoke",
            "--steps", str(steps),
            "--batch", str(batch),
            "--seq", str(seq),
            "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "25"]
    if device is not None:
        argv += ["--device", device]
    return train_main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run(args.steps, args.batch, args.seq, args.ckpt_dir, args.device)


if __name__ == "__main__":
    sys.exit(main())
