#!/usr/bin/env python3
"""Probes of the mask kernels (``src/repro_torch/kernels/csrc/mask_scores.cu``)
on one CUDA card.

    python3 mask_probe.py [SOURCE ...]

1. For each SOURCE (default: this checkout's ``mask_scores.cu``; give a
   parent checkout's to compare), builds it with the flags
   ``kernels/_build`` gives ``mask_scores`` and prints, per kernel of its
   SASS (``cuobjdump -sass``), the instruction count, the local-memory
   loads and stores (``LDL``/``STL``: a kernel parameter copied to the
   stack shows here) and the constant-bank loads (``LDC``).
2. CC two ways on the A100-40GB preset: the table path
   (``mask_scores.cc``) and a direct path (each mask's CC from the slot
   templates by the table build's own ``fit_count``, read from constants
   in a loop over the compile-time maximum; one thread per int4 of
   masks), both equal to ``ref.cc_ref``, timed at N = 1,860, 1,863 and
   1M in ``chip_smoke.time_ms``'s CUDA-graph harness beside its launch
   floor.
3. Where one CTA's time goes: a copy of ``mask_scores.cu`` with
   ``clock64()`` marks in ``score_kernel`` (thread 0 of CTA 0) gives, for
   cc, frag and mcc at N = 1,860 and 1M, the cycles from the kernel's
   start to its loads issued, its table built (after the build's last
   barrier), its first stores issued and its end (medians of 20 launches).

Prints one JSON line per reading.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DIRECT_CC = r'''
#include "%s"

// CC of each mask straight from the templates (no table): the table
// build's fit_count applied to the mask.  One thread per int4 of masks.
__global__ void __launch_bounds__(MRT_THREADS)
cc_direct_kernel(const int* __restrict__ masks, int* __restrict__ out,
                 int64_t n, int vec, MrtModel md) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  const int4* __restrict__ m4 = reinterpret_cast<const int4*>(masks);
  int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
  for (int64_t v = tid; v < n4; v += stride) {
    const int4 m = __ldcs(m4 + v);
    __stcs(o4 + v, make_int4(fit_count(m.x, md), fit_count(m.y, md),
                             fit_count(m.z, md), fit_count(m.w, md)));
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride)
    out[i] = fit_count(masks[i], md);
}

extern "C" int probe_cc_direct(const int* masks, int* out, int64_t n,
                               MrtModel md, void* stream) {
  if (n > 0)
    cc_direct_kernel<<<mrt_blocks((n + 3) / 4, MRT_THREADS), MRT_THREADS, 0,
                       (cudaStream_t)stream>>>(
        masks, out, n, mrt_aligned16(masks, out), md);
  return (int)cudaGetLastError();
}
'''


# clock64() marks in score_kernel: (anchor line, mark placed before it).
MARKS = [("  int4 first[MRT_SCORE_ITEMS];\n", 0),
         ("  build_table<KIND>(tb, md, profile, weights);\n", 1),
         ("  const int full = (1 << md.num_blocks) - 1;\n#pragma unroll\n"
          "  for (int k = 0; k < MRT_SCORE_ITEMS; ++k) {\n"
          "    const int64_t v = tid + k * stride;\n"
          "    if (v < n4) __stcs", 2),
         ("  for (int64_t v = tid + MRT_SCORE_ITEMS * stride; v < n4;", 3),
         ("    out[i] = tb.score[masks[i] & full];\n}\n", 4)]
MARK_NAMES = ("start", "loads_issued", "table_built", "first_stores", "end")


def with_marks(src: str) -> str:
    """mask_scores.cu with MARKS in score_kernel and a C entry point
    ``probe_marks`` that copies them out ((4 kinds, 8) int64)."""
    head = ("#define MRT_MARK(i) do { if (blockIdx.x == 0 && threadIdx.x == 0)"
            " probe_clock[KIND][i] = clock64(); } while (0)\n"
            "__device__ long long probe_clock[4][8];\n")
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            raise ValueError(f"mark {i}: anchor not found once in the source")
        at = src.index(anchor)
        if i == 4:                     # before the kernel's closing brace
            at += anchor.index("}")
        src = src[:at] + f"  MRT_MARK({i});\n" + src[at:]
    at = src.index("#define MRT_MAX_BLOCKS")
    return (src[:at] + head + src[at:] + '\nextern "C" int probe_marks('
            "long long* h) { return (int)cudaMemcpyFromSymbol(h, probe_clock,"
            " sizeof(probe_clock)); }\n")


def nvcc(src: Path, out: Path) -> None:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.nvcc_flags("mask_scores"),
                    "-o", str(out), str(src)], check=True)


def sass_opcodes(text: str):
    """{kernel: Counter of opcodes} from ``cuobjdump -sass`` output
    (predicates and modifiers dropped: ``@!P0 LDC.64`` counts as LDC)."""
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and name:
            kernels[name][m.group(2)] += 1
    return kernels


def report_sass(sources) -> None:
    from repro_torch.kernels import _build
    build = ROOT / "build" / "mask_probe"
    for i, src in enumerate(sources):
        lib = build / f"sass_{i}.so"
        nvcc(src, lib)
        cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
        text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              check=True, capture_output=True,
                              text=True).stdout
        for kernel, ops in sorted(sass_opcodes(text).items()):
            print(json.dumps(dict(
                source=str(src), kernel=kernel,
                instructions=sum(ops.values()),
                local_loads=ops["LDL"], local_stores=ops["STL"],
                constant_loads=ops["LDC"])), flush=True)


def cc_paths(torch) -> None:
    from chip_smoke import N_BIG, N_MAIN, tiled_masks, time_ms
    from repro_torch.core.mig import A100_40GB as model
    from repro_torch.kernels import _build, mask_scores as K, ref
    build = ROOT / "build" / "mask_probe"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "cc_direct.cu"
    src.write_text(DIRECT_CC % (_build.CSRC / "mask_scores.cu"))
    lib_path = build / "libcc_direct.so"
    nvcc(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.probe_cc_direct.argtypes = [P, P, ctypes.c_int64, K.MrtModel, P]
    lib.probe_cc_direct.restype = ctypes.c_int
    md = K.model_struct(model)

    def direct(masks, out):
        err = lib.probe_cc_direct(masks.data_ptr(), out.data_ptr(),
                                  masks.numel(), md,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe_cc_direct: CUDA error {err}")

    z = torch.empty(1, dtype=torch.float32, device="cuda")
    floor_us = time_ms(torch, z.zero_) * 1e3
    for n in (N_MAIN, N_MAIN + 3, N_BIG):
        masks = tiled_masks(torch, model, n, high_bits=True, seed=n)
        out = torch.empty_like(masks)
        direct(masks, out)
        want = ref.cc_ref(masks, model)
        if not (torch.equal(out, want) and torch.equal(K.cc(masks, model),
                                                       want)):
            raise AssertionError(f"cc paths != cc_ref at N {n}")
        print(json.dumps(dict(
            n=n, table_us=time_ms(torch, lambda: K.cc(masks, model)) * 1e3,
            direct_us=time_ms(torch, lambda: direct(masks, out)) * 1e3,
            launch_floor_us=floor_us)), flush=True)


def cycle_marks(torch) -> None:
    import numpy as np
    from chip_smoke import N_BIG, N_MAIN, tiled_masks
    from repro_torch.core.mig import A100_40GB as model
    from repro_torch.kernels import _build, mask_scores as K
    build = ROOT / "build" / "mask_probe"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "marks.cu"
    src.write_text(with_marks((_build.CSRC / "mask_scores.cu").read_text()))
    lib_path = build / "libmarks.so"
    nvcc(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.mrt_cc.argtypes = lib.mrt_frag.argtypes = [P, P, I64, K.MrtModel, P]
    lib.mrt_mcc.argtypes = [P, P, I64, ctypes.c_int, K.MrtModel, P]
    lib.probe_marks.argtypes = [P]
    md = K.model_struct(model)
    for n in (N_MAIN, N_BIG):
        masks = tiled_masks(torch, model, n)
        out = torch.empty_like(masks)
        args = (masks.data_ptr(), out.data_ptr(), n)
        stream = torch.cuda.current_stream().cuda_stream
        for kind, k, launch in (
                ("cc", 0, lambda: lib.mrt_cc(*args, md, stream)),
                ("frag", 1, lambda: lib.mrt_frag(*args, md, stream)),
                ("mcc", 2, lambda: lib.mrt_mcc(*args, 0, md, stream))):
            rows = []
            for _ in range(25):
                if launch():
                    raise RuntimeError(f"{kind}: launch failed")
                torch.cuda.synchronize()
                h = (ctypes.c_longlong * 32)()
                if lib.probe_marks(h):
                    raise RuntimeError("probe_marks failed")
                m = list(h)[8 * k: 8 * k + len(MARK_NAMES)]
                rows.append([x - m[0] for x in m[1:]])
            med = np.median(np.array(rows[5:]), 0)
            print(json.dumps(dict(kind=kind, n=n, cycles=dict(
                zip(MARK_NAMES[1:], med.tolist())))), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mask_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    from chip_smoke import card_line
    print(card_line(), flush=True)
    sources = [Path(a).resolve() for a in sys.argv[1:]] or [
        ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "mask_scores.cu"]
    report_sass(sources)
    cc_paths(torch)
    cycle_marks(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
