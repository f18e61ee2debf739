#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  1. Card line and kernel build: prints the card's name and power limit,
     requires a CUDA device and builds ``kernels/csrc/*.cu`` with nvcc.
  2. Kernels vs their plain PyTorch versions on the card: every mask x
     every profile of the four device presets, tiled to N = 1,048,576 and
     to the replay's ragged N = 1,860, compared exactly; then each kernel
     is timed at both sizes.
  3. The replay on the card equals the replay on the CPU (Alibaba-shaped
     trace at scale 0.1, all five policies, GRMU with and without defrag
     and consolidation, MCC/MECC through the kernels and the tables).
  4. The main path: full-scale trace replay (``TraceConfig(scale=1.0,
     seed=1)``: 8,063 VMs, 1,860 GPUs, 9,326 events) for FF, BF, MCC,
     MECC and GRMU.  Each result's digest must equal the JAX reference's
     (``DIGESTS``); the MCC/MECC kernels must launch once per arrival and
     give the tables path's decisions.  Then ``torch.profiler`` over the
     first 1,000 events of each policy: the device's busy share and the
     host operations that cost the most.
  2b. The attention kernel vs its plain version (``flash_attention_ref``)
     on the card: TinyLlama's heads (H 32 / KV 4, hd 64), hd 128 with GQA
     4:1, MHA, MQA, hd 32, causal and non-causal with Sq != Sk, a 96-key
     window, a ragged S = 1000 and the requests' prefill (B 8, S 128), in
     bf16 (3e-2, and within half a bf16 ulp of the plain version in
     float32) and float32 (2e-5); then the same check at the slice's
     prefill shape (B 4, S 4096, H 32, KV 4, hd 64, bf16, causal), where
     the kernel, the plain version and PyTorch's
     ``scaled_dot_product_attention`` (timed only) are timed.
  5. The serving path at full width: TinyLlama-1.1B (22 layers, bf16,
     random weights from a seeded generator) through
     ``registry.make_step``.  Prefill of 4 x 4096 tokens (tokens/s, the
     attention kernel's share of device time, 22 launches per call, logits
     vs the same prefill with the plain attention); then 8 requests of
     128-token prompts: first token from ``prefill``, cache filled by
     ``decode_step`` over the prompt, 32 greedy tokens (decode tokens/s;
     prefill's logits vs the teacher-forced decode's within 0.15).  A
     2-layer float32 model's prefill on the card equals the CPU's.
  6. Prints the kernel table as one JSON line, the card line again, and
     as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# sha256 of (accepted_ids, intra, inter, hourly series reprs) of the JAX
# reference replay (repro.core.batched.replay, CPU) on
# TraceConfig(scale=1.0, seed=1) with the default heavy capacity 558;
# GRMU runs with defrag=True, consolidation_interval=24.0.  Pinned against
# the JAX package by tests/test_torch_boundary.py.
DIGESTS = {
    "FF": "5a02708aed3fafc68a88f8795399f329b56cdf151cdff263b33ee047697454ae",
    "BF": "392536a6e6888b11876a9a5c9f856550b189cb677896380eaddcf1a09d61d266",
    "MCC": "7b0a872c9253222ab4f81a74e59376d0aadc608adcc94037a194dff0af6706f0",
    "MECC": "7b0a872c9253222ab4f81a74e59376d0aadc608adcc94037a194dff0af6706f0",
    "GRMU": "f5f4baa0c60658f914265fcbb961a8ec2a96b046a41be59d83ecc9afe41b62a2",
}
GRMU_FULL = dict(defrag=True, consolidation_interval=24.0)

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth and the
# non-tensor-core float32 rate, the highest rate any of these kernels'
# integer/float32 scalar operations could run at; and the dense bf16
# tensor-core rate, the bound of attention over bf16 inputs.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS_PER_S = 989e12

N_BIG, N_MAIN = 1 << 20, 1860
KERNELS = {
    "mcc": "src/repro/kernels/policy_score.py:77",
    "ecc": "src/repro/kernels/policy_score.py:94",
    "cc": "src/repro/kernels/cc_score.py:41",
    "frag": "src/repro/kernels/frag_score.py:49",
}
SOURCE = "src/repro_torch/kernels/csrc/mask_scores.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:82"
ARCH = "tinyllama_1_1b"
PREFILL_B, PREFILL_S = 4, 4096          # SHAPES["prefill_32k"] cut for time
N_REQ, PROMPT, GEN, MAX_SEQ = 8, 128, 32, 4096
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_flash_attention.py
# The bf16 kernel rounds its float32 result once, and the plain version
# computes in float32 from the same upcast inputs, so the bf16 kernel must
# also lie within half a bf16 ulp (2**-8 of the value) of the plain version
# run in float32.  The atol covers float32 summation order (kernel vs plain
# version in float32: 3.7e-7 at most, PERF.md).
BF16_HALF_ULP, F32_ATOL = 2.0 ** -8, 1e-5
# Prefill logits, kernel vs plain attention, bf16, 22 layers: relative L2
# error and max error over max |logit|.  Measured on the H100 (PERF.md):
# 0.047 and 0.052 — one-ulp bf16 differences per layer grow through 22
# layers of the reference init's peaked softmax (two plain-torch paths,
# prefill vs teacher-forced decode, differ by as much: 0.059 and 0.061).
# The elementwise bound is the JAX package's 0.15.
PREFILL_TOL = (0.1, 0.15)


def result_digest(res) -> str:
    """Digest of a SimResult's decisions and series (both packages'
    SimResult have these fields)."""
    payload = repr((list(res.accepted_ids), res.intra_migrations,
                    res.inter_migrations,
                    [repr(v) for v in res.hourly_acceptance],
                    [repr(v) for v in res.hourly_active_hw]))
    return hashlib.sha256(payload.encode()).hexdigest()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def same_result(a, b) -> bool:
    return (a.accepted_ids == b.accepted_ids
            and a.per_profile_accepted == b.per_profile_accepted
            and a.hourly_acceptance == b.hourly_acceptance
            and a.hourly_active_hw == b.hourly_active_hw
            and a.intra_migrations == b.intra_migrations
            and a.inter_migrations == b.inter_migrations)


# ---------------------------------------------------------------------------
# Phase 2 helpers: operation counts (for the bound) and timing
# ---------------------------------------------------------------------------

def _fits(masks, sm):
    return (masks & sm) == sm


def count_ops(name, masks, model, profile=0):
    """Scalar operations the kernel does on these masks, mirroring its
    loops in mask_scores.cu (a slot test is and + compare + add = 3)."""
    import numpy as np
    masks = np.asarray(masks, np.int64)
    n, S = len(masks), model.num_slots
    if name == "cc":
        return 3 * S * n
    if name == "frag":
        free, ops = masks.copy(), 0
        for p in model.profile_slot_masks:
            ops += 2 * n + 6 * n               # popc gate; popc/cvt/div/add
            for sm in p:
                take = _fits(free, sm)
                ops += 2 * n + int(take.sum())
                free = np.where(take, free & ~sm, free)
        return ops
    ops = 0
    for sm in model.profile_slot_masks[profile]:
        fit = int(_fits(masks, sm).sum())
        ops += 2 * n + fit * (1 + 3 * S + 2)
    if name == "ecc":
        ops += n * (3 * S + 2 * model.num_profiles)
    return ops


def bound_ms(name, masks, model, profile=0):
    n = len(masks)
    nbytes = 8 * n + (4 * model.num_profiles if name == "ecc" else 0)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = count_ops(name, masks, model, profile) / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters=200):
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, replayed between two CUDA events (no host launch cost)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(torch, fn, iters=200):
    """Microseconds per call launched eagerly from Python (what the replay
    loop pays), measured with CUDA events around the loop."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / iters


def check_kernels(torch, np):
    """Phase 2: every kernel equals its plain version on the card,
    exactly, over every mask x profile of every preset."""
    from repro_torch.core.mig import DEVICE_MODELS
    from repro_torch.kernels import mask_scores as K, ref

    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in KERNELS}
    n_checked = 0
    for model in DEVICE_MODELS.values():
        base = torch.arange(model.num_masks, dtype=torch.int32)
        big = base.repeat(N_BIG // model.num_masks + 1)[:N_BIG].cuda()
        cases = [(big, "1M"), (big[:N_MAIN].clone(), "1860")]
        NP = model.num_profiles
        w_int = torch.as_tensor(rng.integers(0, 60, NP).astype(np.float32))
        w_prob = torch.as_tensor(rng.dirichlet(np.ones(NP)).astype(
            np.float32))
        for masks, _ in cases:
            pairs = [("cc", K.cc(masks, model), ref.cc_ref(masks, model)),
                     ("frag", K.frag(masks, model),
                      ref.frag_ref(masks, model))]
            for p in range(NP):
                pairs.append(("mcc", K.mcc(masks, p, model),
                              ref.mcc_score_ref(masks, p, model)))
                for w in (w_int, w_prob):
                    w = w.cuda()
                    pairs.append(("ecc", K.ecc(masks, p, w, model),
                                  ref.ecc_score_ref(masks, p, w, model)))
            torch.cuda.synchronize()
            for name, got, want in pairs:
                diff = (got.double() - want.double()).abs().max().item()
                err[name] = max(err[name], diff)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{name} kernel != plain version on {model.name} "
                        f"(max abs diff {diff})")
                n_checked += 1
        # The plain version on the card equals the one on the CPU too.
        cpu = base
        gpu = base.cuda()
        for p in range(NP):
            if not torch.equal(K.mcc(gpu, p, model).cpu(),
                               ref.mcc_score_ref(cpu, p, model)):
                raise AssertionError(f"mcc card != CPU on {model.name}")
            if not torch.equal(K.ecc(gpu, p, w_prob.cuda(), model).cpu(),
                               ref.ecc_score_ref(cpu, p, w_prob, model)):
                raise AssertionError(f"ecc card != CPU on {model.name}")
        if not torch.equal(K.frag(gpu, model).cpu(), ref.frag_ref(cpu, model)):
            raise AssertionError(f"frag card != CPU on {model.name}")
    print(f"phase 2: {n_checked} kernel/plain comparisons exact; "
          f"max abs diff {err}", flush=True)
    return err


def time_kernels(torch, np):
    """Phase 2 timing on the A100-40GB preset (the replay's model), with
    masks spread over the whole mask space and the 1g.5gb profile (the
    most slots, so the most work per mask)."""
    from repro_torch.core.mig import A100_40GB as model
    from repro_torch.kernels import mask_scores as K, ref
    w = torch.ones(model.num_profiles, dtype=torch.float32, device="cuda")
    out = {}
    for n in (N_MAIN, N_BIG):
        base = torch.arange(model.num_masks, dtype=torch.int32)
        masks = base.repeat(n // model.num_masks + 1)[:n].cuda()
        host = masks.cpu().numpy()
        fns = {
            "mcc": (lambda: K.mcc(masks, 0, model),
                    lambda: ref.mcc_score_ref(masks, 0, model)),
            "ecc": (lambda: K.ecc(masks, 0, w, model),
                    lambda: ref.ecc_score_ref(masks, 0, w, model)),
            "cc": (lambda: K.cc(masks, model),
                   lambda: ref.cc_ref(masks, model)),
            "frag": (lambda: K.frag(masks, model),
                     lambda: ref.frag_ref(masks, model)),
        }
        for name, (kern, plain) in fns.items():
            b_ms, b_by = bound_ms(name, host, model, 0)
            out[(name, n)] = dict(
                ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain, iters=20),
                host_us=host_us(torch, kern),
                bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------------------
# Phases 3 and 4: the replay
# ---------------------------------------------------------------------------

def replay_configs(B):
    return [("FF", B.FF, {}), ("BF", B.BF, {}),
            ("MCC", B.MCC, dict(score_backend="kernel")),
            ("MECC", B.MECC, dict(score_backend="kernel")),
            ("GRMU", B.GRMU, GRMU_FULL)]


def check_card_vs_cpu():
    """Phase 3: the card replays the 0.1-scale trace exactly as the CPU."""
    from repro_torch.core import batched as B
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    events = B.build_events(vms, cluster)
    configs = replay_configs(B) + [
        ("MCC-tables", B.MCC, dict(score_backend="tables")),
        ("MECC-tables", B.MECC, dict(score_backend="tables")),
        ("GRMU-6h", B.GRMU, dict(defrag=True, consolidation_interval=6.0)),
        ("GRMU-DB", B.GRMU, dict(defrag=False, consolidation_interval=None)),
    ]
    for name, pol, kw in configs:
        card = B.replay(events, pol, device="cuda", **kw)
        cpu = B.replay(events, pol, device="cpu", **kw)
        if not same_result(card, cpu):
            raise AssertionError(f"scale 0.1 {name}: card != CPU")
        print(f"phase 3: scale 0.1 {name}: card == CPU, accepted "
              f"{card.accepted}/{card.total_requests}, migrations "
              f"{card.intra_migrations}/{card.inter_migrations}",
              flush=True)
    if B.replay(events, B.GRMU, device="cuda", defrag=False,
                consolidation_interval=None).accepted != 516:
        raise AssertionError("GRMU DB anchor at scale 0.1 is not 516")


def run_main_path(torch):
    """Phase 4: full-scale replay of all five policies on the card."""
    from repro_torch.core import batched as B
    from repro_torch.kernels import mask_scores as K
    from repro_torch.workload.alibaba import TraceConfig, generate
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    n_arrivals = int((events.kind == B.ARRIVAL).sum())
    configs = replay_configs(B)
    runs = {name: B.make_replay(events, pol, device="cuda", **kw)
            for name, pol, kw in configs}
    cap = B.default_heavy_capacity(events)
    for name, pol, _ in configs:                      # warm-up
        B.result_from_arrays(events, pol, {
            k: v.cpu().numpy() for k, v in runs[name](cap).items()})
    torch.cuda.synchronize()

    K.reset_launches()
    results, seconds = {}, {}
    for name, pol, _ in configs:
        t0 = time.perf_counter()
        out = runs[name](cap)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        results[name] = B.result_from_arrays(
            events, pol, {k: v.cpu().numpy() for k, v in out.items()})
    launches = dict(K.LAUNCHES)

    for name, _, _ in configs:
        res = results[name]
        if result_digest(res) != DIGESTS[name]:
            raise AssertionError(f"full-scale {name}: digest differs from "
                                 "the JAX reference")
        print(json.dumps({
            "policy": name, "accepted": res.accepted,
            "total": res.total_requests,
            "intra_migrations": res.intra_migrations,
            "inter_migrations": res.inter_migrations,
            "wall_s": seconds[name],
            "events_per_s": n_events / seconds[name],
            "digest_matches_jax": True}), flush=True)
    for kname in ("mcc", "ecc"):
        if launches[kname] != n_arrivals:
            raise AssertionError(f"{kname} kernel launched "
                                 f"{launches[kname]} times, expected one "
                                 f"per arrival ({n_arrivals})")
    for name, pol in (("MCC", B.MCC), ("MECC", B.MECC)):
        t0 = time.perf_counter()
        tables = B.replay(events, pol, device="cuda", score_backend="tables")
        dt = time.perf_counter() - t0
        if not same_result(tables, results[name]):
            raise AssertionError(f"full-scale {name}: kernel path != "
                                 "tables path")
        print(f"phase 4: {name} tables path == kernel path "
              f"({n_events / dt:.1f} events/s through the tables)",
              flush=True)
    print(f"phase 4: {n_events} events, {n_arrivals} arrivals; launches on "
          f"the main path {launches}", flush=True)
    for name, pol, kw in configs:
        profile_replay(torch, B, events, name, pol, kw, cap)
    return launches


def profile_replay(torch, B, events, name, pol, kw, cap, n=1000):
    """Where a replay's time goes: ``torch.profiler`` over its first
    ``n`` events on the card.  Prints the device's busy share of the
    profiled wall time, device work per event, and the host operations
    that cost the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    st = B.replay_statics(events, pol, **kw)
    trace = B.trace_from_numpy(B.trace_arrays(events), "cuda")
    state = B.init_state(events, st, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        B.run_events(st, state, trace, cap, stop=n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    top = sorted((a for a in prof.key_averages()
                  if a.key.startswith("aten::")),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    print(json.dumps({"profile": {
        "policy": name, "events": n, "profiled_wall_us_per_event":
        wall_us / n,
        "device_busy_share": (dev_us / wall_us) if dev else None,
        "device_us_per_event": dev_us / n if dev else None,
        "device_ops_per_event": len(dev) / n,
        "top_host_ops": [[a.key, a.count, a.self_cpu_time_total]
                         for a in top]}}), flush=True)


# ---------------------------------------------------------------------------
# Phase 2b: the attention kernel
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, KV, hd, causal, window)
ATTN_CASES = {
    "tinyllama": (2, 1024, 1024, 32, 4, 64, True, None),
    "hd128_gqa4": (1, 512, 512, 32, 8, 128, True, None),
    "mha": (1, 256, 256, 8, 8, 64, True, None),
    "mqa": (1, 256, 256, 8, 1, 64, True, None),
    "hd32": (2, 256, 256, 4, 4, 32, True, None),
    "noncausal": (1, 256, 768, 8, 2, 64, False, None),
    "noncausal_ragged": (1, 200, 333, 8, 2, 64, False, None),
    "window96": (1, 512, 512, 8, 2, 64, True, 96),
    "ragged1000": (2, 1000, 1000, 32, 4, 64, True, None),
    "request_prefill": (N_REQ, PROMPT, PROMPT, 32, 4, 64, True, None),
}


def attention_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask keeps: the work these inputs need."""
    import numpy as np
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound_ms(B, Sq, Sk, H, KV, hd, causal, window, itemsize):
    flops = 4.0 * B * H * hd * attention_pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _qkv(torch, B, Sq, Sk, H, KV, hd, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def hold_attention(torch, name, got, q, k, v, causal, window, err):
    """Hold one kernel output against the plain version on the same inputs:
    within ATTN_TOL in q's dtype, and for bf16 also within half an ulp of
    the plain version in float32.  Folds the max abs differences (and, for
    bf16, the largest error in half-ulps) into ``err``."""
    from repro_torch.kernels import ref
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tname = str(q.dtype).split(".")[-1]
    diff = (got.float() - want.float()).abs().max().item()
    err[tname] = max(err.get(tname, 0.0), diff)
    tol = ATTN_TOL[tname]
    if got.dtype != q.dtype or not torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"attention {name} {tname}: kernel != plain "
                             f"version (max abs diff {diff})")
    if q.dtype == torch.bfloat16:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal, window=window)
        ulps = ((got.float() - want32).abs()
                / (BF16_HALF_ULP * want32.abs() + F32_ATOL)).max().item()
        err["bf16_half_ulps"] = max(err.get("bf16_half_ulps", 0.0), ulps)
        if not ulps <= 1.0:
            raise AssertionError(
                f"attention {name} bf16: kernel is {ulps:.3f} half-ulps "
                f"from the plain version in float32 (limit 1)")


def check_attention(torch):
    """Phase 2b: the kernel equals flash_attention_ref on the card at every
    case, in bf16 and float32 (``hold_attention``)."""
    from repro_torch.kernels import flash_attention as FA
    err = {}
    for name, (B, Sq, Sk, H, KV, hd, causal, window) in ATTN_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, dtype)
            got = FA.flash_attention(q, k, v, causal=causal, window=window)
            hold_attention(torch, name, got, q, k, v, causal, window, err)
    torch.cuda.synchronize()
    print(f"phase 2b: attention kernel == plain version at "
          f"{len(ATTN_CASES)} shapes x 2 dtypes; max abs diff {err}",
          flush=True)
    return err


def event_ms(torch, fn, iters):
    """Device milliseconds per call: ``iters`` eager calls between two CUDA
    events after a warm-up (for calls of a millisecond or more, where
    launch cost is noise)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_attention(torch, err):
    """Phase 2b at the slice's prefill shape: the kernel held against its
    plain version (``hold_attention``, folded into ``err``), then timed
    beside the plain version and scaled_dot_product_attention (the
    yardstick; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA, ref
    cfg = _tinyllama()
    B, S, H, KV = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(torch, B, S, S, H, KV, hd, torch.bfloat16, seed=1)
    hold_attention(torch, "prefill", FA.flash_attention(q, k, v), q, k, v,
                   True, None, err)
    torch.cuda.synchronize()
    print(f"phase 2b: attention kernel == plain version at B {B} S {S}; "
          f"max abs diff {err}", flush=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b_ms, b_by = attention_bound_ms(B, S, S, H, KV, hd, True, None, 2)
    out = dict(
        ms=event_ms(torch, lambda: FA.flash_attention(q, k, v), 10),
        plain_ms=event_ms(torch, lambda: ref.flash_attention_ref(q, k, v), 3),
        library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10),
        bound_ms=b_ms, bound_by=b_by,
        shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype="bfloat16",
                   causal=True))
    print(f"phase 2b: attention at B {B} S {S} H {H} KV {KV} hd {hd} bf16 "
          f"causal: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} "
          f"ms, SDPA {out['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the serving path
# ---------------------------------------------------------------------------

def _tinyllama():
    from repro_torch.configs import get_config
    return get_config(ARCH)


def _rel_errors(torch, got, want):
    got, want = got.float(), want.float()
    rel = ((got - want).norm() / want.norm()).item()
    elem = ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()
    return rel, elem


class plain_attention:
    """Within the block, the model's attention calls the plain version (to
    hold the kernel's prefill against it); restored on exit."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import layers as L
        self._saved = L.flash_attention
        L.flash_attention = ref.flash_attention_ref
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.flash_attention = self._saved
        return False


def prefill_attention_share(torch, step, model, batch):
    """The attention kernel's share of one prefill's device time, from
    torch.profiler (None when the trace holds no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in dev)
    fa = sum(e.time_range.elapsed_us() for e in dev
             if "fa_fwd_kernel" in e.name)
    return (fa / total if total else None), total


def profile_decode(torch, fn, n=4):
    """torch.profiler over ``n`` decode steps: the device's busy share of
    the wall time, device ms per step, and the host operations that cost
    the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    top = sorted((a for a in prof.key_averages()
                  if a.key.startswith("aten::")),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_share": dev_us / wall_us if dev else None,
            "device_ms_per_step": dev_us / n / 1e3 if dev else None,
            "device_ops_per_step": len(dev) / n,
            "top_host_ops": [[a.key, a.count, a.self_cpu_time_total]
                             for a in top]}


def check_card_vs_cpu_prefill(torch):
    """A 2-layer float32 model at TinyLlama's head dim: prefill on the card
    (the kernel) equals prefill on the CPU (the plain version, which the
    CPU tests hold against the JAX package)."""
    from repro_torch.models import transformer as M
    from repro_torch.serve import llm_decode as D
    cfg = _tinyllama().scaled(n_layers=2, d_model=512, n_heads=8,
                              n_kv_heads=1, d_ff=1024, vocab=512)
    # A CPU generator draws the same weights for either device.
    cpu, card = (M.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, device=dev)
                 for dev in ("cpu", "cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=torch.Generator().manual_seed(4))
    got = D.prefill(card, tokens.cuda(), cfg, 256).cpu()
    want = D.prefill(cpu, tokens, cfg, 256)
    rel, elem = _rel_errors(torch, got, want)
    if not rel <= 1e-4 or not elem <= 1e-3:
        raise AssertionError(f"2-layer float32 prefill card != CPU "
                             f"(relative L2 {rel}, max {elem})")
    print(f"phase 5: 2-layer float32 prefill, card == CPU (relative L2 "
          f"{rel:.3g}, max {elem:.3g})", flush=True)


def run_serving(torch):
    """Phase 5: TinyLlama-1.1B at full width on the card, through
    registry.make_step.  Returns the kernel's launches on this path."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve import llm_decode as D
    cfg = _tinyllama()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = M.init_params(cfg, gen)
    torch.cuda.synchronize()
    print(f"phase 5: {cfg.name} ({registry.total_param_count(cfg)} "
          f"parameters, bf16) initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    prefill_shape = ShapeConfig("prefill_4k", PREFILL_S, PREFILL_B, "prefill")
    prefill = registry.make_step(cfg, prefill_shape)
    decode = registry.make_step(cfg, ShapeConfig("decode_4k", MAX_SEQ, N_REQ,
                                                 "decode"))
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    prefill(model, batch)                                # warm-up
    torch.cuda.synchronize()

    FA.reset_launches()
    # -- the main path: prefill, then requests -------------------------------
    n_prefill = 3
    t0 = time.perf_counter()
    for _ in range(n_prefill):
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / n_prefill
    if FA.LAUNCHES["flash_attention"] != n_prefill * cfg.n_layers:
        raise AssertionError(
            f"prefill launched the attention kernel "
            f"{FA.LAUNCHES['flash_attention']} times in {n_prefill} calls, "
            f"expected {cfg.n_layers} per call")

    prompts = torch.randint(0, cfg.vocab, (N_REQ, PROMPT), generator=gen,
                            device="cuda")
    t0 = time.perf_counter()
    first = prefill(model, {"tokens": prompts})          # (N, 1, V)
    torch.cuda.synchronize()
    req_prefill_s = time.perf_counter() - t0
    cache = D.init_cache(cfg, N_REQ, MAX_SEQ)
    t0 = time.perf_counter()
    for t in range(PROMPT):
        step_logits, cache = decode(model, {
            "cache": cache, "tokens": prompts[:, t:t + 1],
            "pos": torch.full((N_REQ,), t, dtype=torch.int32,
                              device="cuda")})
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    nxt = first.argmax(-1)                               # (N, 1)
    generated = [nxt]
    t0 = time.perf_counter()
    for i in range(GEN):
        out, cache = decode(model, {
            "cache": cache, "tokens": nxt,
            "pos": torch.full((N_REQ,), PROMPT + i, dtype=torch.int32,
                              device="cuda")})
        nxt = out.argmax(-1)
        generated.append(nxt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = FA.LAUNCHES["flash_attention"]
    # -- end of the main path -------------------------------------------------
    want = (n_prefill + 1) * cfg.n_layers
    if launches != want:
        raise AssertionError(f"{launches} attention launches on the main "
                             f"path, expected {want}")

    for name, x, shape in (("prefill", logits, (PREFILL_B, 1, cfg.vocab)),
                           ("request prefill", first, (N_REQ, 1, cfg.vocab)),
                           ("decode", out, (N_REQ, 1, cfg.vocab))):
        if tuple(x.shape) != shape or not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name} logits: shape {tuple(x.shape)}, "
                                 f"want {shape}, or not finite")
    tf_rel, tf_elem = _rel_errors(torch, step_logits, first)
    tf_ok = torch.allclose(step_logits.float(), first.float(), rtol=0.15,
                           atol=0.15)
    agree = (step_logits.argmax(-1) == first.argmax(-1)).float().mean().item()
    with plain_attention():
        plain = prefill(model, batch)
    torch.cuda.synchronize()
    pl_rel, pl_elem = _rel_errors(torch, logits, plain)
    share, dev_us = prefill_attention_share(torch, prefill, model, batch)
    decode_profile = profile_decode(torch, lambda i: decode(model, {
        "cache": cache, "tokens": nxt,
        "pos": torch.full((N_REQ,), PROMPT + GEN + i, dtype=torch.int32,
                          device="cuda")}))

    result = {
        "prefill": {"batch": PREFILL_B, "seq": PREFILL_S,
                    "wall_s": prefill_s,
                    "tokens_per_s": PREFILL_B * PREFILL_S / prefill_s,
                    "device_ms": dev_us / 1e3 if share is not None else None,
                    "attention_share_of_device_time": share,
                    "launches_per_call": cfg.n_layers,
                    "vs_plain_attention": {"relative_l2": pl_rel,
                                           "max_over_scale": pl_elem}},
        "requests": {"n": N_REQ, "prompt": PROMPT, "generated": GEN,
                     "max_seq": MAX_SEQ,
                     "prefill_s": req_prefill_s,
                     "prompt_fill_decode_tokens_per_s":
                         N_REQ * PROMPT / fill_s,
                     "decode_tokens_per_s": N_REQ * GEN / gen_s,
                     "decode_profile": decode_profile,
                     "prefill_vs_teacher_forced": {
                         "relative_l2": tf_rel, "max_over_scale": tf_elem,
                         "argmax_agreement": agree}},
    }
    print(json.dumps({"serving": result}), flush=True)
    if not tf_ok:
        raise AssertionError(
            f"prefill's last logits vs the teacher-forced decode's differ "
            f"beyond 0.15 (relative L2 {tf_rel}, max {tf_elem})")
    if not (pl_rel <= PREFILL_TOL[0] and pl_elem <= PREFILL_TOL[1]):
        raise AssertionError(
            f"full-width prefill logits, kernel vs plain attention: "
            f"relative L2 {pl_rel} max {pl_elem}, tolerance {PREFILL_TOL}")
    if share is None:
        raise AssertionError("the profiler saw no device time in prefill")
    del model, cache
    torch.cuda.empty_cache()
    return launches, result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} from {SOURCE} and {FA_SOURCE} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    err = check_kernels(torch, np)
    timing = time_kernels(torch, np)
    fa_err = check_attention(torch)
    fa_time = time_attention(torch, fa_err)
    check_card_vs_cpu()
    launches = run_main_path(torch)
    check_card_vs_cpu_prefill(torch)
    fa_launches, _ = run_serving(torch)

    rows = []
    for name, replaces in KERNELS.items():
        main_t, big_t = timing[(name, N_MAIN)], timing[(name, N_BIG)]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], on_main_path=name in ("mcc", "ecc"),
            max_abs_err=err[name], max_abs_diff=err[name],
            ms=main_t["ms"], plain_ms=main_t["plain_ms"],
            bound_ms=main_t["bound_ms"], bound_by=main_t["bound_by"],
            library_ms=None, host_us_per_call=main_t["host_us"],
            us_at_1860=main_t["ms"] * 1e3, us_at_1M=big_t["ms"] * 1e3,
            plain_us_at_1M=big_t["plain_ms"] * 1e3,
            bound_us_at_1M=big_t["bound_ms"] * 1e3,
            bound_by_at_1M=big_t["bound_by"]))
    rows.append(dict(
        name="flash_attention", route="cuda", source=FA_SOURCE,
        replaces=FA_REPLACES, launches=fa_launches, on_main_path=True,
        max_abs_err=max(fa_err["float32"], fa_err["bfloat16"]),
        max_abs_err_by_dtype=fa_err,
        ms=fa_time["ms"], plain_ms=fa_time["plain_ms"],
        bound_ms=fa_time["bound_ms"], bound_by=fa_time["bound_by"],
        library_ms=fa_time["library_ms"], shape=fa_time["shape"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
