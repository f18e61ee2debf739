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
two roots that compute the same bits print the same digest.  Then the
same four lines for the p_bf16 routes (JAX's ``ATTN_P_BF16``, set for the
calls; ``what`` "p_bf16 forward" / "p_bf16 backward"): the forward against
the plain p_bf16 version (``stat_ms``: the call that training makes,
which also stores the row LSE and the chunk statistics), the backward
from the p_bf16 forward's o, lse and chunk statistics against the plain
p_bf16 backward, with each
backward kernel's device ms from the profiler (``kernel_ms``,
``chip_smoke.bwd_kernel_ms``) and the gradients' SHA-256.  Shape, inputs
and timing are this script's own checkout's, the same for every root.
``--ptxas`` first compiles the root's two attention sources with ``nvcc
-Xptxas=-v`` (once a root, at its first turn) and prints one JSON line
per kernel instantiation (registers, stack frame and spill bytes) and
one per source with any ptxas warning.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

from replay_rate import in_turns, root_package


def ptxas_usage(text: str):
    """{kernel: (registers, stack bytes, spill stores, spill loads)} from
    ``-Xptxas=-v`` output, each kernel named with its template arguments
    (``fa_fwd_wgmma<64, 64, false, true>``)."""
    out, cur, spill = {}, None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(fa_\w+?wgmma|"
                      r"split_bf16x3_kernel)(I(.*?)E)?E?v", line)
        if m:
            args = re.findall(r"L(i|b)(\d+)E", m.group(3) or "")
            vals = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in args]
            cur = (f"{m.group(1)}<{', '.join(vals)}>" if vals
                   else m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)),) + spill
            cur = None
    return out


def ptxas_report(root: Path) -> None:
    """One JSON line per kernel of the root's attention sources, then one
    per source with its ptxas warnings."""
    from repro_torch.kernels import _build
    for stem in ("flash_attention_sm90", "flash_attention_bwd_sm90"):
        res = subprocess.run(
            [_build.nvcc_path(), *_build._ARCH, "-Xptxas=-v", "-c", "-o",
             "/dev/null", str(_build.CSRC / f"{stem}.cu")],
            capture_output=True, text=True)
        text = res.stdout + res.stderr
        warnings = sorted({line.strip() for line in text.splitlines()
                           if "ptxas" in line and "warning" in line.lower()})
        for name, (regs, stack, st, ld) in ptxas_usage(text).items():
            print(json.dumps(dict(root=str(root), source=stem, kernel=name,
                                  registers=regs, stack=stack,
                                  spill_stores=st, spill_loads=ld)),
                  flush=True)
        print(json.dumps(dict(root=str(root), source=stem, rc=res.returncode,
                              ptxas_warnings=warnings)), flush=True)


def worker(root: Path, args) -> None:
    import torch
    root_package(root)
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.ptxas and args.roots.index(args.roots[args.worker]) == args.worker:
        ptxas_report(root)
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
    pb_routes(torch, C, FA, root)


def pb_routes(torch, C, FA, root: Path) -> None:
    """The p_bf16 lines (the module's note)."""
    cfg = C._tinyllama()
    B, S, H, KV = C.PREFILL_B, C.PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = C._qkv(torch, B, S, S, H, KV, hd, dtype, seed=1)
        with C.p_bf16_flag():
            diff = (FA.flash_attention(q, k, v).float() - C.pb_plain(
                q, k, v, True, None).float()).abs().max()
            ms = C.event_ms(torch, lambda: FA.flash_attention(q, k, v), 10)
        stat_ms = C.event_ms(torch, lambda: FA._forward(
            q, k, v, True, None, want_lse=True, p_bf16=True), 10)
        print(json.dumps(dict(root=str(root), dtype=str(dtype)[6:],
                              what="p_bf16 forward", ms=ms, stat_ms=stat_ms,
                              max_abs_diff=diff.item(),
                              shape=dict(B=B, S=S, H=H, KV=KV, hd=hd,
                                         causal=True))), flush=True)
        del q, k, v
    B, S, _, H, KV, hd, causal, window = C.TRAIN_ATTN_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype)[6:]
        q, k, v, do, _, _ = C._bwd_inputs(torch, C.TRAIN_ATTN_SHAPE, dtype,
                                          seed=1)
        with C.p_bf16_flag():
            o, lse, mst = FA._forward(q, k, v, causal, window,
                                      want_lse=True, p_bf16=True)

        def call():
            return FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window, p_bf16=True,
                                          mstat=mst)
        got = call()
        want = C.pb_plain_bwd(q, k, v, o, lse, do, causal, window)
        diff = max((g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want))
        digest = hashlib.sha256()
        for g in got:
            digest.update(g.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes())
        ms = C.event_ms(torch, call, 10)
        kernel_ms = C.bwd_kernel_ms(torch, call, tname)
        print(json.dumps(dict(root=str(root), dtype=tname,
                              what="p_bf16 backward", ms=ms,
                              kernel_ms=kernel_ms, max_abs_diff=diff,
                              sha256=digest.hexdigest(),
                              shape=dict(B=B, S=S, H=H, KV=KV, hd=hd,
                                         causal=causal))), flush=True)
        del q, k, v, do, o, lse, mst, got, want


def options(ap) -> None:
    ap.add_argument("--ptxas", action="store_true")


if __name__ == "__main__":
    sys.exit(in_turns(__doc__, worker, options))
