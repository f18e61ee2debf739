#!/usr/bin/env python3
"""Attention time of the PyTorch port on one CUDA card, forward and
backward, to compare checkouts of the repository within one run.

    python3 attention_rate.py ROOT [ROOT ...]

Each ROOT is a checkout whose ``src/`` holds ``repro_torch``.  The roots
run one after another, each in its own process (its own kernel build), in
the order given: list ``A B B A`` to alternate two versions.  A root first
prints the seconds its kernel build took and ``chip_smoke.
default_route_digests``: the SHA-256 of the attention routes' results
(flag off) at TinyLlama's prefill and training shapes.  For float32
and bfloat16 a root prints one JSON line: the milliseconds of one
``flash_attention`` wrapper call at ``chip_smoke.py``'s prefill shape (B
4, S 4096, TinyLlama's heads, causal; CUDA events over 10 calls after a
warm-up, the inputs ``chip_smoke._qkv`` with seed 1), and the call's max
abs difference from the plain version.  Then for float32 and bfloat16 one
more line: the milliseconds of one ``flash_attention_bwd`` call at
``chip_smoke.TRAIN_ATTN_SHAPE`` (TinyLlama's training attention: B 4, S
4096, H 32, KV 4, hd 64, causal; CUDA events over 10 calls after a
warm-up, the inputs ``chip_smoke._bwd_inputs`` with seed 1, o and lse from
the forward kernel), the gradients' max abs difference from the plain
backward, and a SHA-256 of the gradients' bytes (dq, dk, dv in turn), so
two roots that compute the same bits print the same digest.  Shape,
inputs and timing are this script's own checkout's, the same for every
root.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

from replay_rate import in_turns, root_package


def worker(root: Path, args) -> None:
    import torch
    root_package(root)
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps(dict(root=str(root), build_s=time.perf_counter() - t0,
                          flag_off_digests=C.default_route_digests(torch))),
          flush=True)
    cfg = C._tinyllama()
    B, S, H, KV = C.PREFILL_B, C.PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = C._qkv(torch, B, S, S, H, KV, hd, dtype, seed=1)
        diff = (FA.flash_attention(q, k, v).float()
                - ref.flash_attention_ref(q, k, v).float()).abs().max()
        ms = C.event_ms(torch, lambda: FA.flash_attention(q, k, v), 10)
        print(json.dumps(dict(root=str(root), dtype=str(dtype)[6:], ms=ms,
                              max_abs_diff=diff.item(),
                              shape=dict(B=B, S=S, H=H, KV=KV, hd=hd,
                                         causal=True))), flush=True)
        del q, k, v
    B, S, _, H, KV, hd, causal, window = C.TRAIN_ATTN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, _, _ = C._bwd_inputs(torch, C.TRAIN_ATTN_SHAPE, dtype,
                                          seed=1)
        # (out, lse), and the chunk statistics where the root has them.
        o, lse = FA._forward(q, k, v, causal, window, want_lse=True)[:2]

        def call():
            return FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window)
        got = call()
        want = C.plain_attention_bwd(q, k, v, o, lse, do, causal, window)
        diff = max((g.float() - w).abs().max().item()
                   for g, w in zip(got, want))
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        ms = C.event_ms(torch, call, 10)
        print(json.dumps(dict(root=str(root), dtype=str(dtype)[6:],
                              what="backward", ms=ms, max_abs_diff=diff,
                              sha256=digest.hexdigest(),
                              shape=dict(B=B, S=S, H=H, KV=KV, hd=hd,
                                         causal=causal))), flush=True)
        del q, k, v, do, o, lse, got, want


if __name__ == "__main__":
    sys.exit(in_turns(__doc__, worker))
