#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

  1. Card line and kernel build: prints the card's name and power limit,
     requires a CUDA device, builds ``kernels/csrc/*.cu`` with nvcc (all
     sources in parallel).
  2. Kernels vs their plain PyTorch versions on the card: every mask x
     every profile of the four device presets, tiled to N = 1,048,576, to
     the replay's N = 1,860 and to a ragged N = 1,863 (and the same with
     bits set above the model's blocks, and an unaligned view), compared
     exactly; the fused picks on random fleets of both sizes (ties,
     nothing fitting, every host full, high mask bits; integer and
     probability weights), compared exactly; then
     each kernel is timed at both sizes beside a launch floor (one
     one-element ``zero_()`` in the same CUDA-graph harness).
  3. The replay on the card equals the replay on the CPU (Alibaba-shaped
     trace at scale 0.1, all five policies, GRMU with and without defrag
     and consolidation, MCC/MECC through the kernels and the tables), and
     so do the five policies' telemetry (``replay_with_telemetry``: the
     decisions, the rejection reasons and every telemetry series).
  4. The main path: full-scale trace replay (``TraceConfig(scale=1.0,
     seed=1)``: 8,063 VMs, 1,860 GPUs, 9,326 events) for FF, BF, MCC,
     MECC and GRMU.  Each result's digest must equal the JAX reference's
     (``DIGESTS``); the MCC/MECC pick kernels must launch once per
     arrival, the score kernels never, and give the tables path's
     decisions.  Then ``torch.profiler`` over a replay of the first 1,000
     events of each policy: the device's busy share and the host
     operations that cost the most.  ``make_replay`` runs on the card
     through captured CUDA graphs (one graph launch per event).
  4b. Telemetry, chunk streaming and the synthetic workload.  (a) The
     full-scale trace with telemetry on, all five policies: each result
     digest equals ``DIGESTS`` (telemetry changes no decision), each
     telemetry digest (``telemetry_digest``) equals ``TELE_DIGESTS``, and
     the MCC/MECC picks still launch once per arrival, the score kernels
     never; events/s, then ``torch.profiler`` over the first 1,000 events
     of MCC and GRMU with telemetry on, whose copies to the host (each a
     host synchronisation) must number phase 4's (``replay_rate.py
     --telemetry`` profiles every policy).  (b) GRMU at the DB
     point on the pow2-padded scale-0.1 trace with telemetry on:
     rejection reasons ``ANCHOR_REASONS`` (``BENCH_batched_engine.json``,
     "telemetry").  (c) ``make_chunked_replay`` of all five policies at
     ``CHUNK_EVENTS`` (1,000) events a chunk, cuts inside hours, defrag,
     consolidation and MECC windows: each digest equals ``DIGESTS``; then
     GRMU chunked with telemetry under a ``Recorder`` on a temporary
     file: its telemetry digest equals the unchunked one, and the file
     holds one ``chunk.step`` span per chunk.  (d) The JAX ladder's
     synthetic rung ``synth:20000x512`` (``SYNTH_CFG``, padded to a
     multiple of 4,096 events, 11 chunks of 4,096): GRMU DB accepts
     17,862, and GRMU DB and MECC (through ``ecc_pick``) equal
     ``SYNTH_DIGESTS``; events/s for both.
  4c. The replay's graph runners (``run_graph_path``): through captured
     graphs, the full-scale replays of all five policies equal
     ``DIGESTS``, with telemetry also ``TELE_DIGESTS``, chunked at 1,000
     events ``DIGESTS``, and ``synth:20000x512`` ``SYNTH_DIGESTS``; one
     pick per MCC/MECC arrival and replay; host synchronisations per
     replay (torch's sync debug mode) at most the consolidating
     step-ends; device memory flat from one replay to the next.  Prints
     events/s through the graphs and through the eager loop
     (``run_events``, whose outputs must equal the graphs') in this
     process, graphs per runner and capture seconds.
  2b. The attention kernels vs their plain version (``flash_attention_ref``)
     on the card: TinyLlama's heads (H 32 / KV 4, hd 64), hd 128 with GQA
     4:1, MHA, MQA, hd 32, causal and non-causal with Sq != Sk, a 96-key
     window, a ragged S = 1000 and the requests' prefill (B 8, S 128), in
     bf16 (``fa_fwd_wgmma<hd, false>``; 3e-2, and within half a bf16 ulp
     of the plain version in float32) and float32 (``split_bf16x3`` of q,
     k and v, then ``fa_fwd_wgmma<hd, true>``; 2e-5), each dtype reaching
     only its own kernels; in float32 also a long accumulation (non-causal,
     Sq 1024 over Sk 16,384).  The split kernel is held bit for bit
     against ``ref.split_bf16x3`` (normal, tiny and zero inputs, a ragged
     length and an unaligned view).  Then the same check at the slice's
     prefill shape (B 4, S 4096, H 32, KV 4, hd 64, causal) in both dtypes,
     where each kernel, the plain version and PyTorch's
     ``scaled_dot_product_attention`` (timed only) are timed, and in
     float32 the kernel and the plain version are held against the float64
     function (``attention_f64``, the kernel within 2e-5).
  5. The serving path at full width: TinyLlama-1.1B (22 layers, bf16,
     random weights from a seeded generator) through
     ``registry.make_step``.  Prefill of 4 x 4096 tokens (tokens/s, the
     attention kernel's share of device time and prefill's ten costliest
     device operations, 22 launches per call, logits vs the same prefill
     with the plain attention); then 8 requests of
     128-token prompts: first token from ``prefill``, cache filled by
     ``decode_step`` over the prompt, 32 greedy tokens (decode tokens/s;
     prefill's logits vs the teacher-forced decode's within 0.15).  A
     2-layer float32 model's prefill on the card equals the CPU's.  The
     float32 path: TinyLlama-1.1B in float32, prefill of 1 x 4096 tokens
     (22 float32 kernel launches and 66 splits per call, no bf16 one; wall
     time, the kernels' share of device time, logits vs the same prefill
     with the plain attention).
  5b. The bf16 kernel's accuracy against the float64 function, beside
     the float32 plain version rounded to bf16: error size, mean signed
     error toward larger magnitude and the direction of roundings that
     differ from the float64 value's, at the prefill shape and layer by
     layer in a full-width prefill; then prefill logits on five seeds with
     each as the model's attention, against float64 attention.  Fails
     if the kernel is further from float64 than the plain version
     (``ACCURACY_LOGITS_RATIO``).
  6. The placement service (``run_service``; after phase 4c).  (a) The
     full-scale trace as a request stream (8,604 requests, 8,063
     arrivals) through ``PlacementService.for_trace`` at micro-batches of
     64, all five policies (GRMU as in ``DIGESTS``), after one stream each
     that captures the graphs: each result (the final snapshot through
     ``result_from_arrays``) equals ``DIGESTS``, MCC/MECC launch their
     pick once per arrival (8,063) and nothing else launches, the runners
     hold graphs, device memory is flat across the five streams, and (a
     third stream, torch's sync debug mode) host synchronisations number
     at most one per batch plus GRMU's consolidating step-ends; one JSON
     line per policy with arrivals/s, p50 / p99 decision latency,
     batches, graphs and capture seconds.  (b) The flash crowd at
     ``BENCH_serve.json``'s size (600 VMs, 32 GPUs, 72 h, seed 2, GRMU):
     online == offline, 373 accepted; the ("GRMU", "FF") ladder at
     slo_s=0 degrades once and ends on FF.  (c) Checkpoint at half the
     full-scale GRMU stream, restore into a fresh service: the decisions
     equal the uninterrupted stream's.  (d) The ("ILP", "GRMU", "FF")
     ladder on tests/test_serve.py's small stream at slo_s=0: card ==
     CPU.  (e) ``sweep_heavy_capacity`` at full scale, GRMU DB, over
     ``SWEEP_FRACS``: equals the JAX sweep's ``SWEEP_ACCEPTED``; seconds
     per capacity.
  7. Prints the kernel table as one JSON line (the picks' rows add the
     service's launches, ``service_launches``), the card line again, and
     as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import hashlib
import json
import math
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
GRMU_DB = dict(defrag=False, consolidation_interval=None)

# sha256 of the telemetry output arrays (``telemetry_digest``) of the JAX
# replay with telemetry=True on the same trace and settings as DIGESTS.
# Pinned against the JAX package by tests/test_torch_boundary.py.
TELE_DIGESTS = {
    "FF": "72af53c86af97cc98ba0604777d027ede0cfd7b40af1aafd33cab96a8efa2dbc",
    "BF": "e0aa7e92886e117a0fcf1de927f317ad33d3029f7782cebd94c7cf1d11d2e870",
    "MCC": "3196f667a78c7121b11a1b6b352e6921e08df41f716e033b1260323483d50875",
    "MECC": "3196f667a78c7121b11a1b6b352e6921e08df41f716e033b1260323483d50875",
    "GRMU": "3a0853de0aa44d11cf7ebdfb84a8cb41bbe962fdf10ea95a1e46887a9e29276d",
}
# Phase 4b (b): GRMU DB on the pow2-padded TraceConfig(scale=0.1, seed=1)
# trace (BENCH_batched_engine.json, "telemetry").
ANCHOR_REASONS = {"no_slot": 70, "capacity": 0, "basket_quota": 220,
                  "frozen": 0}
# Phase 4b (c): chunk length of the full-scale chunked replays.
CHUNK_EVENTS = 1000
# Phase 4b (d): the JAX ladder's rung synth:20000x512 (benchmarks/
# batched_engine.py: seed 1, streamed in chunks of 4,096 events), and
# result digests of the JAX replay of it, padded to a multiple of the
# chunk (GRMU DB at the default heavy capacity 154; MECC).  Pinned by
# tests/test_torch_boundary.py.
SYNTH_CFG = dict(n_vms=20000, n_gpus=512, seed=1)
SYNTH_CHUNK = 4096
SYNTH_ACCEPTED_GRMU_DB = 17862
SYNTH_DIGESTS = {
    "GRMU-DB":
        "3d4ca5141d01d14b9ed95d9f935f5c1f2c81b1920a930ac4df62509215fb4518",
    "MECC":
        "3ef85caeca1918f77a2e3552862cee74799b142375947070adb2c51b9f33c932",
}

# Phase 6: the placement service.  (a) the full-scale trace's request
# stream (8,604 requests, 8,063 arrivals) at micro-batches of 64; (b) the
# flash crowd at BENCH_serve.json's size (GRMU accepts 373 online and
# offline); (d) tests/test_serve.py's small synthetic stream; (e) the
# sweep's capacities (benchmarks/batched_engine.py) and the accepted
# counts per reference profile of the JAX sweep (repro.core.batched.
# sweep_heavy_capacity, GRMU DB, CPU) at full scale.  Pinned by
# tests/test_torch_boundary.py.
SERVE_BATCH = 64
SERVE_REQUESTS, SERVE_ARRIVALS = 8604, 8063
FLASH_CFG = dict(n_vms=600, n_gpus=32, horizon_hours=72.0, seed=2)
FLASH_ACCEPTED = 373
SERVE_SMALL = dict(n_vms=200, n_gpus=12, horizon_hours=30.0,
                   mean_duration_hours=6.0, seed=5)
ILP_LADDER = dict(tiers=("ILP", "GRMU", "FF"), micro_batch=16, slo_s=0.0,
                  ilp_window=4, ilp_time_limit=2.0)
SWEEP_FRACS = (0.2, 0.25, 0.3, 0.35, 0.4)
SWEEP_ACCEPTED = [[1454, 491, 1318, 937, 491, 433],
                  [1454, 491, 1318, 937, 491, 539],
                  [1448, 484, 1305, 925, 485, 649],
                  [1368, 465, 1223, 854, 449, 760],
                  [1270, 436, 1140, 782, 424, 868]]

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth (the mask
# kernels' and the split's bound: they move bytes and do no arithmetic
# worth a peak) and the dense bf16 tensor-core rate (attention's).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS_PER_S = 989e12
# Attention's bound is the bf16 tensor cores' rate over the products each
# float32 product costs there: one for bf16 inputs; for float32 inputs the
# six bf16 plane products (of nine, the three smallest dropped) that
# fa_fwd_wgmma<hd, true> issues per float32 product.
F32_PLANE_PASSES = 6
PEAK_ATTN_FLOPS_PER_S = {"bfloat16": PEAK_BF16_FLOPS_PER_S,
                         "float32": PEAK_BF16_FLOPS_PER_S / F32_PLANE_PASSES}

N_BIG, N_MAIN = 1 << 20, 1860
N_RAG = 1863                      # not a multiple of 4: a scalar tail
H_MAIN = 1213                     # the replay's hosts at full scale
KERNELS = {
    "mcc": "src/repro/kernels/policy_score.py:77",
    "ecc": "src/repro/kernels/policy_score.py:94",
    "cc": "src/repro/kernels/cc_score.py:41",
    "frag": "src/repro/kernels/frag_score.py:49",
    # The picks fuse the replay's whole MCC/MECC arrival scoring (the TPU
    # kernel, its host-headroom mask and argmax) into one launch.
    "mcc_pick": "src/repro/kernels/policy_score.py:77",
    "ecc_pick": "src/repro/kernels/policy_score.py:94",
}
SOURCE = "src/repro_torch/kernels/csrc/mask_scores.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
FA_REPLACES = "src/repro/kernels/flash_attention.py:82"
ARCH = "tinyllama_1_1b"
PREFILL_B, PREFILL_S = 4, 4096          # SHAPES["prefill_32k"] cut for time
F32_PREFILL_B = 1                       # the float32 prefill: 1 x 4096
N_REQ, PROMPT, GEN, MAX_SEQ = 8, 128, 32, 4096
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_flash_attention.py
# The bf16 kernel rounds its float32 result once, and the plain version
# computes in float32 from the same upcast inputs, so on phase 2b's random
# (well-conditioned) inputs the bf16 kernel must also lie within half a
# bf16 ulp (2**-8 of the value) of the plain version run in float32.  The
# atol covers float32 summation order (kernel vs plain version in float32:
# 3.7e-7 at most, PERF.md).  On a model's ill-conditioned rows any two
# float32 summation orders differ by more; phase 5b holds those against
# float64 instead.
BF16_HALF_ULP, F32_ATOL = 2.0 ** -8, 1e-5
# Prefill logits, kernel vs plain attention, bf16, 22 layers: relative L2
# error and max error over max |logit|.  Measured on the H100 (PERF.md)
# over five seeds: 0.073-0.084 and 0.073-0.102.  Each layer's ill-
# conditioned rows flip bf16 roundings between any two float32 summation
# orders, and 22 layers of the reference init's peaked softmax amplify
# them: two plain-torch paths, prefill vs teacher-forced decode, differ by
# 0.06, and every implementation is ~0.075 from float64 attention.  The
# elementwise bound is the JAX package's 0.15.
PREFILL_TOL = (0.1, 0.15)
# Phase 5b: the bf16 kernel may be no further from the float64 function
# than the float32 plain version: per reading, no more elements beyond half
# a bf16 ulp, and prefill logits against float64 attention (mean relative
# L2 over the seeds) within this factor of the plain version's.  Measured
# on the H100 (PERF.md): 0.64x the count, 0.95x the logits error.
ACCURACY_LOGITS_RATIO = 1.25


def result_digest(res) -> str:
    """Digest of a SimResult's decisions and series (both packages'
    SimResult have these fields)."""
    payload = repr((list(res.accepted_ids), res.intra_migrations,
                    res.inter_migrations,
                    [repr(v) for v in res.hourly_acceptance],
                    [repr(v) for v in res.hourly_active_hw]))
    return hashlib.sha256(payload.encode()).hexdigest()


def telemetry_digest(events, out) -> str:
    """Digest of a telemetry replay's output arrays (numpy), sliced to
    the trace's logical VMs, steps and GPUs: the per-VM codes, the code
    tally, the step rows and the free-mask snapshots, with their dtypes
    and shapes."""
    import numpy as np
    N, S, G = len(events.vm_ids), len(events.step_times), events.num_gpus
    h = hashlib.sha256()
    for a in (out["tele_vm_reason"][:N], out["tele_rej"],
              out["tele_steps"][:S], out["tele_masks"][:S, :G]):
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


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
# Phase 2 helpers: bounds and timing
# ---------------------------------------------------------------------------

def bound_ms(name, n, model, hosts=0):
    """The bytes floor of one call over ``n`` masks (GPUs): each input
    byte read once and each output byte written once, over the card's
    memory rate.  A scorer reads a 4-byte mask and writes a 4-byte score
    per mask (ecc also reads its weights).  A pick reads per GPU its mask
    (4), host id (8) and capacity row (8), the used row (8) of each of
    the ``hosts`` hosts that hold a GPU, the (2,) need (8) and the
    weights (ecc), and writes one int64."""
    weights = 4 * model.num_profiles if name.startswith("ecc") else 0
    if name.endswith("_pick"):
        nbytes = 20 * n + 8 * hosts + 8 + weights + 8
    else:
        nbytes = 8 * n + weights
    return nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


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


def tiled_masks(torch, model, n, high_bits=False, seed=0):
    """Every mask of the model, tiled to ``n``; with ``high_bits``, random
    bits above the model's blocks (bit 31 on every fifth)."""
    import numpy as np
    base = np.arange(model.num_masks, dtype=np.int64)
    masks = np.resize(base, n)
    if high_bits:
        rng = np.random.default_rng(seed)
        masks = masks | (rng.integers(0, 1 << (31 - model.num_blocks), n)
                         << model.num_blocks)
        masks[::5] |= 1 << 31
    return torch.as_tensor(masks.astype(np.uint32).view(np.int32)).cuda()


def random_fleet(torch, model, G, seed, case="random", H=None):
    """One arrival's pick inputs on the card: ``tests/_torch_fleets.py``'s
    draws (ties, nothing fitting, every host full, bits above the blocks;
    headroom at, just under and just over the need)."""
    from _torch_fleets import fleet
    return [torch.as_tensor(a).cuda()
            for a in fleet(model, G, seed, case, H)]


def pick_weights(torch, model, seed):
    """(integer counts, real probabilities) as float32 on the card."""
    from _torch_fleets import weights
    return [torch.as_tensor(w).cuda() for w in weights(model, seed)]


def check_kernels(torch, np):
    """Phase 2: every kernel equals its plain version on the card,
    exactly: the scorers over every mask x profile of every preset (and
    with bits above the blocks), the picks on random fleets."""
    from _torch_fleets import CASES
    from repro_torch.core.mig import DEVICE_MODELS
    from repro_torch.kernels import mask_scores as K, ref

    rng = np.random.default_rng(0)
    err = {k: 0.0 for k in KERNELS}
    n_checked = 0

    def hold(name, got, want, where):
        nonlocal n_checked
        diff = (got.double() - want.double()).abs().max().item()
        err[name] = max(err[name], diff)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} kernel != plain version on "
                                 f"{where} (max abs diff {diff})")
        n_checked += 1

    for model in DEVICE_MODELS.values():
        big = tiled_masks(torch, model, N_BIG)
        rag = tiled_masks(torch, model, N_RAG, high_bits=True, seed=2)
        # rag[1:] starts 4 bytes past a 16-byte boundary: the kernels'
        # one-mask-at-a-time path; N_RAG (not a multiple of 4) its tail.
        cases = [big, big[:N_MAIN].clone(),
                 tiled_masks(torch, model, N_BIG, high_bits=True),
                 tiled_masks(torch, model, N_MAIN, high_bits=True, seed=1),
                 tiled_masks(torch, model, N_RAG), rag, rag[1:]]
        NP = model.num_profiles
        w_int = torch.as_tensor(rng.integers(0, 60, NP).astype(np.float32))
        w_prob = torch.as_tensor(rng.dirichlet(np.ones(NP)).astype(
            np.float32))
        for masks in cases:
            where = f"{model.name} N {masks.numel()}"
            hold("cc", K.cc(masks, model), ref.cc_ref(masks, model), where)
            hold("frag", K.frag(masks, model), ref.frag_ref(masks, model),
                 where)
            for p in range(NP):
                hold("mcc", K.mcc(masks, p, model),
                     ref.mcc_score_ref(masks, p, model), where)
                for w in (w_int, w_prob):
                    w = w.cuda()
                    hold("ecc", K.ecc(masks, p, w, model),
                         ref.ecc_score_ref(masks, p, w, model), where)
        # The plain version on the card equals the one on the CPU too.
        cpu = torch.arange(model.num_masks, dtype=torch.int32)
        gpu = cpu.cuda()
        for p in range(NP):
            if not torch.equal(K.mcc(gpu, p, model).cpu(),
                               ref.mcc_score_ref(cpu, p, model)):
                raise AssertionError(f"mcc card != CPU on {model.name}")
            if not torch.equal(K.ecc(gpu, p, w_prob.cuda(), model).cpu(),
                               ref.ecc_score_ref(cpu, p, w_prob, model)):
                raise AssertionError(f"ecc card != CPU on {model.name}")
        if not torch.equal(K.frag(gpu, model).cpu(), ref.frag_ref(cpu, model)):
            raise AssertionError(f"frag card != CPU on {model.name}")
        if not torch.equal(K.cc(gpu, model).cpu(), ref.cc_ref(cpu, model)):
            raise AssertionError(f"cc card != CPU on {model.name}")
        # The picks, on random fleets of both sizes.
        n_minus = 0
        for G in (N_MAIN, N_BIG):
            for c, case in enumerate(CASES):
                fleet = random_fleet(torch, model, G, seed=G + c, case=case,
                                     H=H_MAIN if G == N_MAIN else None)
                where = f"{model.name} G {G} {case}"
                for p in range(NP):
                    got = K.mcc_pick(*fleet, p, model)
                    hold("mcc_pick", got,
                         ref.mcc_pick_ref(*fleet, p, model), where)
                    n_minus += int(got.item() < 0)
                    for w in pick_weights(torch, model, p):
                        got = K.ecc_pick(*fleet, p, w, model)
                        hold("ecc_pick", got,
                             ref.ecc_pick_ref(*fleet, p, w, model), where)
                        n_minus += int(got.item() < 0)
        # The CPU's plain pick on one fleet equals the card's.
        fleet = random_fleet(torch, model, N_MAIN, seed=5, H=H_MAIN)
        for p in range(NP):
            if not torch.equal(K.mcc_pick(*fleet, p, model).cpu(),
                               ref.mcc_pick_ref(*[t.cpu() for t in fleet],
                                                p, model)):
                raise AssertionError(f"mcc_pick card != CPU on {model.name}")
        print(f"phase 2: {model.name}: picks == plain versions, "
              f"{n_minus} of them -1", flush=True)
    torch.cuda.synchronize()
    print(f"phase 2: {n_checked} kernel/plain comparisons exact; "
          f"max abs diff {err}", flush=True)
    return err


def timed_fleet(model, n):
    """The arrival the picks are timed on: ``n`` GPUs over the replay's
    1,213 hosts at N = 1,860 (a third of ``n`` otherwise), numbered host
    by host so that every host holds one or two (three at 1M).  Returns
    the numpy arrays and the number of host rows the pick reads."""
    import numpy as np
    from _torch_fleets import fleet
    arrays = fleet(model, n, seed=n, H=H_MAIN if n == N_MAIN else n // 3,
                   contiguous=True)
    return arrays, len(np.unique(arrays[1]))


def time_kernels(torch, np):
    """Phase 2 timing on the A100-40GB preset (the replay's model): the
    scorers over masks spread over the whole mask space with the 1g.5gb
    profile (the most slots), the picks on ``timed_fleet``; and a launch
    floor, one one-element ``zero_()`` in the same harness."""
    from repro_torch.core.mig import A100_40GB as model
    from repro_torch.kernels import mask_scores as K, ref
    w = torch.ones(model.num_profiles, dtype=torch.float32, device="cuda")
    z = torch.empty(1, dtype=torch.float32, device="cuda")
    floor_ms = time_ms(torch, z.zero_)
    out = {"launch_floor": dict(ms=floor_ms, host_us=host_us(torch, z.zero_))}
    print(f"phase 2: launch floor {floor_ms * 1e3:.3f} us (graph), "
          f"{out['launch_floor']['host_us']:.3f} us eager", flush=True)
    for n in (N_MAIN, N_BIG):
        masks = tiled_masks(torch, model, n)
        arrays, hosts = timed_fleet(model, n)
        arrival = [torch.as_tensor(a).cuda() for a in arrays]
        fns = {
            "mcc": (lambda: K.mcc(masks, 0, model),
                    lambda: ref.mcc_score_ref(masks, 0, model)),
            "ecc": (lambda: K.ecc(masks, 0, w, model),
                    lambda: ref.ecc_score_ref(masks, 0, w, model)),
            "cc": (lambda: K.cc(masks, model),
                   lambda: ref.cc_ref(masks, model)),
            "frag": (lambda: K.frag(masks, model),
                     lambda: ref.frag_ref(masks, model)),
            "mcc_pick": (lambda: K.mcc_pick(*arrival, 0, model),
                         lambda: ref.mcc_pick_ref(*arrival, 0, model)),
            "ecc_pick": (lambda: K.ecc_pick(*arrival, 0, w, model),
                         lambda: ref.ecc_pick_ref(*arrival, 0, w, model)),
        }
        for name, (kern, plain) in fns.items():
            b_ms, b_by = bound_ms(name, n, model, hosts)
            t = out[(name, n)] = dict(
                ms=time_ms(torch, kern),
                plain_ms=time_ms(torch, plain, iters=20),
                host_us=host_us(torch, kern),
                bound_ms=b_ms, bound_by=b_by)
            print(f"phase 2: {name} N {n}: {t['ms'] * 1e3:.3f} us "
                  f"(launch floor {floor_ms * 1e3:.3f}, bound "
                  f"{b_ms * 1e3:.4f} us {b_by}), plain "
                  f"{t['plain_ms'] * 1e3:.1f} us, eager "
                  f"{t['host_us']:.2f} us", flush=True)
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
    from repro_torch.obs import inscan
    for name, pol, kw in replay_configs(B):
        card, card_tele = inscan.replay_with_telemetry(events, pol,
                                                       device="cuda", **kw)
        cpu, cpu_tele = inscan.replay_with_telemetry(events, pol,
                                                     device="cpu", **kw)
        if (not same_result(card, cpu)
                or card.rejection_reasons != cpu.rejection_reasons
                or card_tele.to_json_dict() != cpu_tele.to_json_dict()):
            raise AssertionError(f"scale 0.1 {name} telemetry: card != CPU")
        print(f"phase 3: scale 0.1 {name} telemetry: card == CPU, "
              f"rejections {card.rejection_reasons}", flush=True)


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
    # One fused pick per MCC/MECC arrival; no score kernel on the replay.
    want = {k: n_arrivals if k in ("mcc_pick", "ecc_pick") else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"mask kernels launched {launches} on the "
                             f"main path, expected {want}")
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
    profiles = {}
    for name, pol, kw in configs:
        profiles[name] = profile_replay(torch, B, events, pol, kw, cap)
        print(json.dumps({"profile": dict(policy=name, **profiles[name])}),
              flush=True)
    return launches, profiles


def first_events(events, n):
    """The trace cut to its first ``n`` events; the VM, fleet and
    schedule arrays stay as they are."""
    import dataclasses
    return dataclasses.replace(events, **{
        k: getattr(events, k)[:n]
        for k in ("kind", "vm_index", "profile", "time", "idx")})


def profile_replay(torch, B, events, pol, kw, cap, n=1000):
    """Where a replay's time goes: ``torch.profiler`` over one replay of
    the trace's first ``n`` events through ``make_replay`` on the card,
    run once before the profile (so a graph runner's captures fall
    outside it).  Returns the device's busy share of the profiled wall
    time, device work per event, and the host operations that cost the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = B.make_replay(first_events(events, n), pol, device="cuda", **kw)
    run(cap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(cap)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    top = sorted((a for a in prof.key_averages()
                  if a.key.startswith(("aten::", "cuda"))),
                 key=lambda a: a.self_cpu_time_total, reverse=True)[:6]
    per_kernel = {}
    for e in dev:
        per_kernel[e.name[:60]] = per_kernel.get(e.name[:60], 0) + 1
    return {"events": n, "profiled_wall_us_per_event": wall_us / n,
            # Each copy to the host is a point where the host waits.
            "device_to_host_copies": sum(
                v for k, v in per_kernel.items() if k.startswith(
                    "Memcpy DtoH")),
            "device_busy_share": (dev_us / wall_us) if dev else None,
            "device_us_per_event": dev_us / n if dev else None,
            "device_ops_per_event": len(dev) / n,
            "top_host_ops": [[a.key, a.count, a.self_cpu_time_total]
                             for a in top],
            "top_device_ops_by_count": sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:12]}


def _timed(torch, run, cap):
    """(output arrays, seconds) of one replay run to a synchronize."""
    t0 = time.perf_counter()
    out = run(cap)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {k: v.cpu().numpy() for k, v in out.items()}, dt


def _check_picks(launches, n_arrivals, what):
    want = {k: n_arrivals if k in ("mcc_pick", "ecc_pick") else 0
            for k in launches}
    if launches != want:
        raise AssertionError(f"mask kernels launched {launches} in {what}, "
                             f"expected {want}")


def run_streaming_and_telemetry(torch, off_profiles):
    """Phase 4b: telemetry at full scale, the padded scale-0.1 anchor, the
    chunked replay at full scale and the synthetic rung, on the card.
    ``off_profiles`` are phase 4's profiles, telemetry off: telemetry
    must add no copy to the host (no host synchronisation)."""
    import tempfile
    from repro_torch.core import batched as B
    from repro_torch.core import streaming as ST
    from repro_torch.core.bucketing import pad_events
    from repro_torch.kernels import mask_scores as K
    from repro_torch.obs import inscan, recorder, report
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    n_arrivals = int((events.kind == B.ARRIVAL).sum())
    cap = B.default_heavy_capacity(events)
    configs = replay_configs(B)

    # (a) Telemetry at full scale.
    K.reset_launches()
    for name, pol, kw in configs:
        out, dt = _timed(torch, B.make_replay(events, pol, device="cuda",
                                              telemetry=True, **kw), cap)
        res = B.result_from_arrays(events, pol, out)
        if result_digest(res) != DIGESTS[name]:
            raise AssertionError(f"full-scale {name} with telemetry: digest "
                                 "differs from the JAX reference")
        if telemetry_digest(events, out) != TELE_DIGESTS[name]:
            raise AssertionError(f"full-scale {name}: telemetry digest "
                                 "differs from the JAX reference")
        print(json.dumps({
            "phase": "4b telemetry", "policy": name,
            "rejection_reasons": res.rejection_reasons, "wall_s": dt,
            "events_per_s": n_events / dt, "digests_match_jax": True}),
            flush=True)
    _check_picks(dict(K.LAUNCHES), n_arrivals, "the telemetry replays")
    for name, pol, kw in configs:
        if name not in ("MCC", "GRMU"):     # ~40 s a profile on the card
            continue
        prof = profile_replay(torch, B, events, pol,
                              dict(kw, telemetry=True), cap)
        print(json.dumps({"profile": dict(policy=name, telemetry=True,
                                          **prof)}), flush=True)
        off = off_profiles[name]["device_to_host_copies"]
        if prof["device_to_host_copies"] != off:
            raise AssertionError(
                f"{name}: {prof['device_to_host_copies']} copies to the "
                f"host in {prof['events']} events with telemetry, {off} "
                "without")

    # (b) The anchor: GRMU DB on the padded scale-0.1 trace.
    c01, v01 = generate(TraceConfig(scale=0.1, seed=1))
    res, _ = inscan.replay_with_telemetry(
        pad_events(B.build_events(v01, c01)), B.GRMU, device="cuda",
        **GRMU_DB)
    if res.accepted != 516 or res.rejection_reasons != ANCHOR_REASONS:
        raise AssertionError(f"padded scale-0.1 GRMU DB: accepted "
                             f"{res.accepted}, {res.rejection_reasons}")
    print(f"phase 4b: padded scale-0.1 GRMU DB accepted 516, rejections "
          f"{res.rejection_reasons}", flush=True)

    # (c) Chunked at full scale, then GRMU chunked with telemetry and a
    # recorder.
    K.reset_launches()
    for name, pol, kw in configs:
        run = ST.make_chunked_replay(events, pol, chunk_events=CHUNK_EVENTS,
                                     device="cuda", **kw)
        out, dt = _timed(torch, run, cap)
        if result_digest(B.result_from_arrays(run.events, pol, out)) \
                != DIGESTS[name]:
            raise AssertionError(f"full-scale {name} chunked: digest "
                                 "differs from the JAX reference")
        print(json.dumps({
            "phase": "4b chunked", "policy": name,
            "chunk_events": CHUNK_EVENTS, "num_chunks": run.num_chunks,
            "padded_shape": [len(run.events.kind),
                             len(run.events.gpu_model_id)],
            "wall_s": dt, "events_per_s": n_events / dt,
            "digest_matches_jax": True}), flush=True)
    _check_picks(dict(K.LAUNCHES), n_arrivals, "the chunked replays")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "grmu_chunked.jsonl"
        with recorder.record(path, run_id="chip-smoke-4b",
                             meta={"policy": "GRMU"}) as rec:
            run = ST.make_chunked_replay(events, B.GRMU,
                                         chunk_events=CHUNK_EVENTS,
                                         device="cuda", telemetry=True,
                                         **GRMU_FULL)
            out, dt = _timed(torch, run, cap)
            res = B.result_from_arrays(run.events, B.GRMU, out)
            rec.result(res)
        (summary,) = [report.summarize(r) for r in report.load([str(path)])]
    if (result_digest(res) != DIGESTS["GRMU"]
            or telemetry_digest(run.events, out) != TELE_DIGESTS["GRMU"]):
        raise AssertionError("full-scale GRMU chunked with telemetry: "
                             "digests differ from the unchunked replay's")
    spans = summary["spans"]
    if (spans["chunk.step"]["count"] != run.num_chunks
            or spans["chunk.prefetch"]["count"] != run.num_chunks
            or spans["finalize"]["count"] != 1 or not summary["cache"]
            or summary["rejection_reasons"] != res.rejection_reasons):
        raise AssertionError(f"recorded chunked replay: {summary}")
    print(json.dumps({
        "phase": "4b chunked telemetry recorded", "policy": "GRMU",
        "num_chunks": run.num_chunks, "wall_s": dt,
        "events_per_s": n_events / dt, "spans": spans,
        "digests_match_jax": True}), flush=True)

    # (d) The synthetic rung, as the JAX ladder pads and streams it.
    synth = generate_events(SyntheticConfig(**SYNTH_CFG))
    n_synth = len(synth.kind)
    synth_arrivals = int((synth.kind == B.ARRIVAL).sum())
    synth = pad_events(synth, event_multiple=SYNTH_CHUNK)
    scap = B.default_heavy_capacity(synth)
    for name, pol, kw in (("GRMU-DB", B.GRMU, GRMU_DB),
                          ("MECC", B.MECC, dict(score_backend="kernel"))):
        run = ST.make_chunked_replay(synth, pol, chunk_events=SYNTH_CHUNK,
                                     device="cuda", **kw)
        K.reset_launches()
        out, dt = _timed(torch, run, scap)
        launches = dict(K.LAUNCHES)
        want = {k: synth_arrivals if (k, name) == ("ecc_pick", "MECC")
                else 0 for k in launches}
        if launches != want:
            raise AssertionError(f"synth:20000x512 {name}: mask kernels "
                                 f"launched {launches}, expected {want}")
        res = B.result_from_arrays(run.events, pol, out)
        if result_digest(res) != SYNTH_DIGESTS[name]:
            raise AssertionError(f"synth:20000x512 {name}: digest differs "
                                 "from the JAX reference")
        if name == "GRMU-DB" and res.accepted != SYNTH_ACCEPTED_GRMU_DB:
            raise AssertionError(f"synth:20000x512 GRMU DB accepted "
                                 f"{res.accepted}")
        print(json.dumps({
            "phase": "4b synth:20000x512", "policy": name,
            "events": n_synth, "num_chunks": run.num_chunks,
            "accepted": res.accepted, "total": res.total_requests,
            "launches": launches, "wall_s": dt,
            "events_per_s": n_synth / dt, "digest_matches_jax": True}),
            flush=True)


def graph_replay(torch, run, cap):
    """Phase 4c: one replay through ``run``'s runner, which must hold
    captured graphs, after two warm-up calls.  Returns the outputs
    (numpy), the host synchronisations torch's sync debug mode reports
    during the call, the mask kernels' launches in it, and whether the
    device memory in use after it equals that after the call before."""
    import warnings
    from repro_torch.kernels import mask_scores as K
    runner = run.runner
    run(cap)
    out = run(cap)
    torch.cuda.synchronize()
    if not (runner.graphed and runner.graphs):
        raise AssertionError("the replay ran no captured graph")
    mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    del out
    K.reset_launches()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run(cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # torch's warning at each synchronising call (its one-off notice that
    # the mode is a prototype does not count).
    syncs = [str(w.message) for w in seen
             if "called a synchronizing" in str(w.message)]
    flat = mem == (torch.cuda.memory_allocated(),
                   torch.cuda.memory_reserved())
    return ({k: v.cpu().numpy() for k, v in out.items()}, syncs,
            dict(K.LAUNCHES), flat)


def run_graph_path(torch):
    """Phase 4c: the replay's graph runners.  Through captured graphs,
    with the checks of ``graph_replay``: the full-scale replays of all
    five policies equal ``DIGESTS``, with telemetry ``DIGESTS`` and
    ``TELE_DIGESTS``, chunked at CHUNK_EVENTS ``DIGESTS``, and the
    synthetic rung ``SYNTH_DIGESTS``; MCC/MECC launch one pick per
    arrival; each replay's host synchronisations are at most its
    consolidating step-ends; device memory stays flat from one replay to
    the next.  Then each full-scale replay's events/s through the graphs
    and through the eager loop (``run_events``) in this process, which
    must give the same outputs, with graphs per runner and capture
    seconds."""
    from repro_torch.core import batched as B
    from repro_torch.core import streaming as ST
    from repro_torch.core.bucketing import pad_events
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    import numpy as np
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    n_events = len(events.kind)
    cap = B.default_heavy_capacity(events)
    synth = pad_events(generate_events(SyntheticConfig(**SYNTH_CFG)),
                       event_multiple=SYNTH_CHUNK)
    n_synth = int((synth.kind != B.PAD).sum())

    def chunked(evs, chunk):
        return lambda pol, **kw: ST.make_chunked_replay(
            evs, pol, chunk_events=chunk, device="cuda", **kw)

    plain = lambda pol, **kw: B.make_replay(events, pol, device="cuda",
                                            **kw)
    cases = [("plain", plain, name, pol, kw, n_events, DIGESTS[name])
             for name, pol, kw in replay_configs(B)]
    cases += [("telemetry", plain, name, pol, dict(kw, telemetry=True),
               n_events, DIGESTS[name]) for name, pol, kw in
              replay_configs(B)]
    cases += [("chunked", chunked(events, CHUNK_EVENTS), name, pol, kw,
               n_events, DIGESTS[name]) for name, pol, kw in
              replay_configs(B)]
    cases += [("synth", chunked(synth, SYNTH_CHUNK), name, pol, kw,
               n_synth, SYNTH_DIGESTS[name]) for name, pol, kw in
              (("GRMU-DB", B.GRMU, GRMU_DB),
               ("MECC", B.MECC, dict(score_backend="kernel")))]
    for what, make, name, pol, kw, n_ev, digest in cases:
        run = make(pol, **kw)
        evs = run.events if what in ("chunked", "synth") else events
        c = B.default_heavy_capacity(evs)
        out, syncs, launches, flat = graph_replay(torch, run, c)
        res = B.result_from_arrays(evs, pol, out)
        if result_digest(res) != digest:
            raise AssertionError(f"4c {what} {name}: digest differs from "
                                 "the JAX reference")
        if what == "telemetry" and (telemetry_digest(evs, out)
                                    != TELE_DIGESTS[name]):
            raise AssertionError(f"4c telemetry {name}: telemetry digest "
                                 "differs from the JAX reference")
        arrivals = int((evs.kind == B.ARRIVAL).sum())
        pick = {B.MCC: "mcc_pick", B.MECC: "ecc_pick"}.get(
            pol if kw.get("score_backend") == "kernel" else None)
        if launches != {k: arrivals if k == pick else 0 for k in launches}:
            raise AssertionError(f"4c {what} {name}: mask kernels "
                                 f"launched {launches}")
        n_cons = run.plan.keys.count((B.STEP_END, True))
        # Each consolidation reads its candidates on the host: the count
        # must see those, and nothing else.
        if len(syncs) > n_cons or (n_cons and not syncs):
            raise AssertionError(f"4c {what} {name}: {len(syncs)} host "
                                 f"synchronisations, {n_cons} "
                                 f"consolidating step-ends: {syncs[:3]}")
        if not flat:
            raise AssertionError(f"4c {what} {name}: device memory grew "
                                 "from one replay to the next")
        row = {"phase": "4c", "what": what, "policy": name, "events": n_ev,
               "graphs": len(run.runner.graphs),
               "capture_s": run.runner.capture_s, "host_syncs": len(syncs),
               "consolidating_step_ends": n_cons, "launches": launches,
               "memory_flat": flat, "digests_match_jax": True}
        if what == "plain":
            # Per replay: events/s, and the share of its wall time the
            # host spent before ``run`` returned (all launches queued).
            rates, queued = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                run(c)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                rates.append(n_ev / (time.perf_counter() - t0))
                queued.append((t1 - t0) * rates[-1] / n_ev)
            st = B.replay_statics(events, pol, **kw)
            trace = B.trace_from_numpy(B.trace_arrays(events), "cuda")
            state = B.init_state(events, st, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            B.run_events(st, state, trace, c)
            torch.cuda.synchronize()
            eager_s = time.perf_counter() - t0
            eager = {k: v.cpu().numpy()
                     for k, v in B._finalize(st, state).items()}
            if any(not np.array_equal(eager[k], out[k]) for k in out):
                raise AssertionError(f"4c {name}: graph replay != eager "
                                     "loop")
            row.update(events_per_s=rates, host_share_until_queued=queued,
                       eager_events_per_s=n_ev / eager_s,
                       graphs_equal_eager=True)
        print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the placement service
# ---------------------------------------------------------------------------

def serve_stream(svc, reqs, horizon):
    """tests/test_serve.py's driving loop: submit in order, draining one
    micro-batch whenever the queue is full, then drain and flush."""
    for r in reqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)
    return svc


def decisions_of(svc):
    return {v: (d.accepted, d.gpu, d.start, d.tier)
            for v, d in svc.decisions.items()}


def service_result(B, svc, events, policy):
    """The service's SimResult: its final snapshot read through the
    replay's ``_finalize`` and ``result_from_arrays``."""
    import torch
    st = svc._statics[svc.tier_name]
    snap = {k: torch.as_tensor(v) for k, v in svc._snapshot().items()}
    res = B.result_from_arrays(events, policy, {
        k: v.numpy() for k, v in B._finalize(st, snap).items()})
    if res.accepted_ids != svc.accepted_ids():
        raise AssertionError("the snapshot's accepted VMs differ from the "
                             "service's decisions")
    return res


def profile_service(torch, svc, reqs, n=640):
    """Where a service stream's time goes: ``torch.profiler`` over the
    first ``n`` requests submitted and drained through ``svc`` (its
    runner's graphs captured already).  Returns the device's busy share
    of the profiled wall time, device µs per request, device operations
    and copies per batch, and the share of device time in the copies
    between device buffers (the state and tables copied into the runner
    and the state back)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs[:n]:
            while not svc.submit(r):
                svc.drain(max_batches=1)
        svc.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in dev)
    kinds = {}
    for e in dev:
        k = e.name[:60]
        c, us = kinds.get(k, (0, 0.0))
        kinds[k] = (c + 1, us + e.time_range.elapsed_us())
    copies = {k: v for k, v in kinds.items() if k.startswith("Memcpy")}
    dtod_us = sum(us for k, (_, us) in copies.items() if "DtoD" in k)
    return {"requests": n, "batches": svc.batches,
            "profiled_wall_us_per_request": wall_us / n,
            "device_busy_share": dev_us / wall_us if dev else None,
            "device_us_per_request": dev_us / n if dev else None,
            "device_ops_per_batch": len(dev) / max(svc.batches, 1),
            "copies_per_batch": {k: c / max(svc.batches, 1)
                                 for k, (c, _) in copies.items()},
            "device_to_device_copy_share": dtod_us / dev_us if dev else None,
            "top_device_ops_by_time": sorted(
                ([k, c, us] for k, (c, us) in kinds.items()),
                key=lambda r: -r[2])[:8]}


def serve_configs(B):
    """(name, policy, ServeConfig knobs) of phase 4's five replays."""
    return [(name, pol, {k: v for k, v in kw.items()
                         if k != "score_backend"})
            for name, pol, kw in replay_configs(B)]


def run_service(torch):
    """Phase 6: the placement service on the card.  (a) The full-scale
    request stream through ``PlacementService.for_trace`` at micro-batches
    of 64, all five policies, twice (the first captures the graphs): the
    second stream's results equal ``DIGESTS``, MCC/MECC launch their pick
    once per arrival and nothing else launches, the runners hold graphs,
    host synchronisations number at most one per batch plus GRMU's
    consolidating step-ends (a third stream, in torch's sync debug mode),
    and device memory is flat across the five streams.  (b) The flash
    crowd at BENCH_serve.json's size: online == offline, 373 accepted;
    the ("GRMU", "FF") ladder at slo_s=0 degrades once and ends on FF.
    (c) Checkpoint at half the full-scale GRMU stream, restore into a
    fresh service: the decisions equal the uninterrupted stream's.
    (d) The ("ILP", "GRMU", "FF") ladder on the small stream: card ==
    CPU.  (e) The sweep at full scale equals ``SWEEP_ACCEPTED``.  Returns
    the pick kernels' launches over the five timed streams."""
    import gc
    import tempfile
    import warnings
    from repro_torch.core import batched as B
    from repro_torch.core.bucketing import pad_events
    from repro_torch.kernels import mask_scores as K
    from repro_torch.serve import (PlacementService, ServeConfig,
                                   requests_from_trace)
    from repro_torch.workload.alibaba import TraceConfig, generate
    from repro_torch.workload.flashcrowd import (FlashCrowdConfig,
                                                 generate_flash_crowd)
    from repro_torch.workload.synthetic import (SyntheticConfig,
                                                generate_events)
    cluster, vms = generate(TraceConfig(scale=1.0, seed=1))
    events = B.build_events(vms, cluster)
    reqs, horizon = requests_from_trace(events)
    n_arr = sum(type(r).__name__ == "Arrival" for r in reqs)
    if (len(reqs), n_arr) != (SERVE_REQUESTS, SERVE_ARRIVALS):
        raise AssertionError(f"{len(reqs)} requests, {n_arr} arrivals")
    configs = serve_configs(B)

    def service(name, kw):
        return PlacementService.for_trace(
            events, ServeConfig(policy=name, micro_batch=SERVE_BATCH, **kw),
            device="cuda")

    # (a) The first pass captures every graph the streams need.
    for name, _, kw in configs:
        serve_stream(service(name, kw), reqs, horizon)
    torch.cuda.synchronize()
    gc.collect()
    mem = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    rows, totals, ref = [], {}, None
    for name, pol, kw in configs:
        K.reset_launches()
        t0 = time.perf_counter()
        svc = serve_stream(service(name, kw), reqs, horizon)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        pick = {"MCC": "mcc_pick", "MECC": "ecc_pick"}.get(name)
        if launches != {k: n_arr if k == pick else 0 for k in launches}:
            raise AssertionError(f"service {name}: mask kernels launched "
                                 f"{launches}")
        if result_digest(service_result(B, svc, events, pol)) \
                != DIGESTS[name]:
            raise AssertionError(f"service {name}: digest differs from the "
                                 "JAX reference")
        runner = svc.runner
        if not (runner.graphed and runner.graphs):
            raise AssertionError(f"service {name}: the runner holds no "
                                 "graph")
        st = svc.stats()
        rows.append({
            "phase": "6 service", "policy": name,
            "micro_batch": SERVE_BATCH, "requests": len(reqs),
            "arrivals": st["decisions"], "accepted": st["accepted"],
            "wall_s": wall, "arrivals_per_s": st["decisions"] / wall,
            "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
            "queue_high_watermark": st["queue_high_watermark"],
            "batches": svc.batches, "graphs": len(runner.graphs),
            "expiry_width": runner.step.width,
            "capture_s": runner.capture_s, "launches": launches,
            "digest_matches_jax": True})
        if name == "GRMU":
            ref = (decisions_of(svc), svc.accepted_ids(), svc.migrations())
        del svc, runner
    gc.collect()
    flat = mem == (torch.cuda.memory_allocated(),
                   torch.cuda.memory_reserved())
    for row, (name, _, kw) in zip(rows, configs):
        row["profile"] = profile_service(torch, service(name, kw), reqs)
    if not flat:
        raise AssertionError("device memory moved across the five service "
                             "streams")
    # Host synchronisations, a third stream each in sync debug mode.
    trace = B.trace_from_numpy(B.trace_arrays(events), "cpu")
    for row, (name, pol, kw) in zip(rows, configs):
        st = B.replay_statics(events, pol, **kw)
        n_cons = B.plan_events(st, trace, last_cons=0.0).keys.count(
            (B.STEP_END, True))
        svc = service(name, kw)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                serve_stream(svc, reqs, horizon)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message)
                    for w in seen)
        if syncs > svc.batches + n_cons or not syncs:
            raise AssertionError(f"service {name}: {syncs} host "
                                 f"synchronisations in {svc.batches} "
                                 f"batches, {n_cons} consolidating "
                                 "step-ends")
        row.update(host_syncs=syncs, consolidating_step_ends=n_cons,
                   memory_flat=flat)
        print(json.dumps(row), flush=True)

    # (b) The flash crowd at BENCH_serve.json's size.
    fc = generate_flash_crowd(FlashCrowdConfig(**FLASH_CFG))
    freqs, fh = requests_from_trace(fc)
    svc = serve_stream(PlacementService.for_trace(
        fc, ServeConfig(policy="GRMU", micro_batch=SERVE_BATCH),
        device="cuda"), freqs, fh)
    off = B.replay(pad_events(fc), B.GRMU, device="cuda")
    ladder = serve_stream(PlacementService.for_trace(
        fc, ServeConfig(policy="GRMU", tiers=("GRMU", "FF"),
                        micro_batch=SERVE_BATCH, slo_s=0.0),
        device="cuda"), freqs, fh)
    switches = [e["event"] for e in ladder.switch_events]
    if (svc.accepted_ids() != off.accepted_ids
            or svc.stats()["accepted"] != FLASH_ACCEPTED
            or switches != ["degrade"] or ladder.tier_name != "FF"):
        raise AssertionError(f"flash crowd: online {svc.stats()['accepted']}"
                             f", offline {off.accepted}, ladder {switches} "
                             f"ending on {ladder.tier_name}")
    print(json.dumps({
        "phase": "6 flash crowd", **FLASH_CFG, "requests": len(freqs),
        "accepted_online": svc.stats()["accepted"],
        "accepted_offline": off.accepted, "decisions_match": True,
        "p50_ms": svc.stats()["p50_ms"], "p99_ms": svc.stats()["p99_ms"],
        "ladder_switches": switches, "ladder_final_tier": ladder.tier_name,
        "ladder_occupancy": ladder.tier_occupancy}), flush=True)

    # (c) Checkpoint at half the full-scale GRMU stream, restore.
    half = len(reqs) // 2
    with tempfile.TemporaryDirectory() as tmp:
        a = service("GRMU", GRMU_FULL)
        for r in reqs[:half]:
            while not a.submit(r):
                a.drain(max_batches=1)
        a.drain()
        a.checkpoint(tmp)
        b = service("GRMU", GRMU_FULL)
        if not b.restore(tmp):
            raise AssertionError("no checkpoint to restore")
        for r in reqs[half:]:
            while not b.submit(r):
                b.drain(max_batches=1)
        b.drain()
        b.flush(horizon)
    got, (want, want_ids, want_mig) = decisions_of(b), ref
    if (b.accepted_ids() != want_ids or b.migrations() != want_mig
            or got != {v: want[v] for v in got}):
        raise AssertionError("restored GRMU service differs from the "
                             "uninterrupted stream")
    print(f"phase 6: GRMU checkpointed at request {half} of {len(reqs)}, "
          f"restored: {len(got)} later decisions and migrations "
          f"{b.migrations()} equal the uninterrupted stream's", flush=True)

    # (d) The ILP -> GRMU -> FF ladder, card == CPU.
    small = generate_events(SyntheticConfig(**SERVE_SMALL))
    sreqs, sh = requests_from_trace(small)
    runs = {dev: serve_stream(PlacementService.for_trace(
        small, ServeConfig(**ILP_LADDER), device=dev), sreqs, sh)
        for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    if (decisions_of(card) != decisions_of(cpu)
            or card.migrations() != cpu.migrations()
            or [e["to"] for e in card.switch_events] != ["GRMU", "FF"]):
        raise AssertionError("ILP ladder: card != CPU")
    print(f"phase 6: ({', '.join(ILP_LADDER['tiers'])}) ladder at slo_s=0: "
          f"card == CPU, occupancy {card.tier_occupancy}", flush=True)

    # (e) The heavy-capacity sweep at full scale.
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        got = B.sweep_heavy_capacity(events, SWEEP_FRACS, device="cuda")
        seconds.append(time.perf_counter() - t0)
        if got.tolist() != SWEEP_ACCEPTED:
            raise AssertionError(f"sweep: {got.tolist()}")
    print(json.dumps({
        "phase": "6 sweep", "fracs": SWEEP_FRACS,
        "accepted_totals": got.sum(axis=1).tolist(),
        "first_s": seconds[0], "s_per_capacity": seconds[1] / len(
            SWEEP_FRACS), "equals_jax": True}), flush=True)
    return totals


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
# float32 only: one row's softmax over 256 key tiles, where a tensor-core
# sum carried across tiles would drift (the kernel merges per tile).
F32_ATTN_CASES = {
    "long_noncausal": (1, 1024, 16384, 8, 2, 64, False, None),
}


def attention_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask keeps: the work these inputs need."""
    import numpy as np
    q = np.arange(Sq)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound_ms(B, Sq, Sk, H, KV, hd, causal, window, dtype_name):
    itemsize = {"bfloat16": 2, "float32": 4}[dtype_name]
    flops = 4.0 * B * H * hd * attention_pairs(Sq, Sk, causal, window)
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    t_ops = flops / PEAK_ATTN_FLOPS_PER_S[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_PER_S
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


def route_launches(FA, dtype):
    """The launches one wrapper call of ``dtype`` makes: its attention
    kernel once, and for float32 the split of q, k and v."""
    import torch
    key = FA.ROUTES[dtype][1]
    want = {n: int(n == key) for n in FA.LAUNCHES}
    if dtype == torch.float32:
        want[FA.SPLIT] = 3
    return want


def attention_on_its_route(torch, q, k, v, causal=True, window=None):
    """One wrapper call, checked to launch its dtype's kernels once
    (``route_launches``) and the other dtype's not at all."""
    from repro_torch.kernels import flash_attention as FA
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    moved = {n: FA.LAUNCHES[n] - before[n] for n in FA.LAUNCHES}
    if moved != route_launches(FA, q.dtype):
        raise AssertionError(f"{q.dtype} attention launched {moved}, "
                             f"expected {route_launches(FA, q.dtype)}")
    return got


def split_inputs(torch, n, seed):
    """float32 inputs of the split, length ``n``: normal values; tiny ones
    (1e-36 scale, mid and lo subnormal); zeros of both signs; values over
    float32's finite range (e^-87 to e^87)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda")
    zero = torch.zeros(n, device="cuda")
    zero[::3] = -0.0
    wide = torch.exp(torch.rand(n, generator=g, device="cuda") * 174 - 87)
    return {"normal": x, "tiny": x * 1e-36, "zero": zero,
            "wide": wide * x.sign()}


def check_split(torch):
    """Phase 2b: the split kernel equals ref.split_bf16x3 bit for bit on
    ``split_inputs`` at the prefill's k/v length, a ragged length and two
    elements, and on the view that drops the first element (unaligned,
    copied by the wrapper).  The six lengths leave every tail of 0 to 3
    elements past the kernel's four-element groups.  Returns the largest
    absolute difference seen (0 unless it raised)."""
    from repro_torch.kernels import flash_attention as FA, ref
    n_checked, diff = 0, 0.0
    for n in (PREFILL_B * PREFILL_S * 4 * 64, 1001, 2):
        for kind, x in split_inputs(torch, n, seed=n).items():
            for where, t in ((kind, x), (f"{kind} unaligned", x[1:])):
                got = FA.split_bf16x3(t)
                want = torch.stack(ref.split_bf16x3(t))
                diff = max(diff, (got.double() - want.double()).abs()
                           .nan_to_num(nan=math.inf).max().item())
                if not torch.equal(got.view(torch.int16),
                                   want.view(torch.int16)):
                    raise AssertionError(f"split_bf16x3 kernel != plain "
                                         f"version on {where} n {n}")
                n_checked += 1
    torch.cuda.synchronize()
    print(f"phase 2b: split kernel == plain version bit for bit in "
          f"{n_checked} comparisons", flush=True)
    return diff


def check_attention(torch):
    """Phase 2b: each kernel equals flash_attention_ref on the card at
    every case, bf16 through the tensor-core kernel and float32 through the
    split and its kernel (``hold_attention``); the split kernel equals its
    plain version bit for bit (``check_split``)."""
    err = {"split": check_split(torch)}
    cases = [(name, c, dtype) for name, c in ATTN_CASES.items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(name, c, torch.float32) for name, c in F32_ATTN_CASES.items()]
    for name, (B, Sq, Sk, H, KV, hd, causal, window), dtype in cases:
        q, k, v = _qkv(torch, B, Sq, Sk, H, KV, hd, dtype)
        got = attention_on_its_route(torch, q, k, v, causal, window)
        hold_attention(torch, name, got, q, k, v, causal, window, err)
    torch.cuda.synchronize()
    print(f"phase 2b: attention kernels == plain version at "
          f"{len(ATTN_CASES)} shapes x 2 dtypes and {len(F32_ATTN_CASES)} "
          f"float32 one(s); max abs diff {err}", flush=True)
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


def split_bound_ms(n):
    """The split's bytes floor: each float32 element read once (4 bytes)
    and its three bf16 planes written once (6)."""
    return 10 * n / PEAK_BYTES_PER_S * 1e3, "bytes"


def time_attention(torch, err):
    """Phase 2b at the slice's prefill shape, in bf16 (the tensor-core
    kernel) and in float32 (the split and the float32 kernel): each kernel
    held against its plain version (``hold_attention``, folded into
    ``err``), then timed beside the plain version and
    scaled_dot_product_attention (the yardstick; the port never calls it).
    In float32 the kernel and the plain version are also held against the
    float64 function, the kernel within ATTN_TOL, and the split of q is
    timed beside its plain version.  Returns {dtype name or "split":
    timings}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA, ref
    cfg = _tinyllama()
    B, S, H, KV = PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        q, k, v = _qkv(torch, B, S, S, H, KV, hd, dtype, seed=1)
        got = attention_on_its_route(torch, q, k, v)
        hold_attention(torch, "prefill", got, q, k, v, True, None, err)
        torch.cuda.synchronize()
        print(f"phase 2b: attention kernel == plain version at B {B} S {S} "
              f"{tname}; max abs diff {err}", flush=True)
        vs_f64 = None
        if dtype == torch.float32:
            truth = attention_f64(q, k, v)
            vs_f64 = {name: (x.double() - truth).abs().max().item()
                      for name, x in (("kernel", got), (
                          "plain", ref.flash_attention_ref(q, k, v)))}
            del truth
            print(f"phase 2b: float32 at B {B} S {S}, max abs error "
                  f"against float64: kernel {vs_f64['kernel']:.3g}, plain "
                  f"version {vs_f64['plain']:.3g}", flush=True)
            if not vs_f64["kernel"] <= ATTN_TOL[tname]:
                raise AssertionError(f"float32 attention kernel is "
                                     f"{vs_f64['kernel']} from float64 "
                                     f"(limit {ATTN_TOL[tname]})")
            s_ms, s_by = split_bound_ms(q.numel())
            out["split"] = dict(
                ms=event_ms(torch, lambda: FA.split_bf16x3(q), 20),
                plain_ms=event_ms(torch, lambda: torch.stack(
                    ref.split_bf16x3(q)), 5),
                bound_ms=s_ms, bound_by=s_by, library_ms=None,
                shape=dict(n=q.numel(), what="q at the prefill shape"))
            print(f"phase 2b: split of q ({q.numel()} float32): "
                  f"{out['split']['ms']:.4f} ms, plain "
                  f"{out['split']['plain_ms']:.4f} ms, bound {s_ms:.4f} ms "
                  f"({s_by})", flush=True)
        del got
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        b_ms, b_by = attention_bound_ms(B, S, S, H, KV, hd, True, None,
                                        tname)
        t = out[tname] = dict(
            ms=event_ms(torch, lambda: FA.flash_attention(q, k, v), 10),
            plain_ms=event_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v), 3),
            library_ms=event_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10),
            bound_ms=b_ms, bound_by=b_by, max_abs_err_vs_f64=vs_f64,
            shape=dict(B=B, S=S, H=H, KV=KV, hd=hd, dtype=tname,
                       causal=True))
        print(f"phase 2b: attention at B {B} S {S} H {H} KV {KV} hd {hd} "
              f"{tname} causal: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        del q, k, v, qt, kt, vt
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


class attention_as:
    """Within the block, the model's prefill attention calls ``fn`` (the
    plain version, to hold the kernel's prefill against it, or another
    function to compare with); restored on exit."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.models import layers as L
        self._saved = L.flash_attention
        L.flash_attention = self.fn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.flash_attention = self._saved
        return False


def prefill_attention_share(torch, step, model, batch, n_top=10):
    """The attention kernel's (``fa_fwd_wgmma``, either dtype) share of one
    prefill's device time, from torch.profiler (None when the trace holds
    no device events), the total device µs, and the ``n_top`` device
    operations that took the most time: [name, count, µs]."""
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
             if "fa_fwd_wgmma" in e.name)
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(([name[:120], n, us] for name, (n, us) in by_name.items()),
                 key=lambda r: r[2], reverse=True)[:n_top]
    return (fa / total if total else None), total, top


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


def run_f32_prefill(torch):
    """Phase 5, the float32 attention route's path: TinyLlama-1.1B at full
    width in float32 (random weights from a seeded generator), prefill of
    F32_PREFILL_B x PREFILL_S tokens through registry.make_step.  Launch
    counts are read over the timed calls alone: per call one float32
    kernel launch and three splits per layer, no bf16 launch.  Reports
    wall time, the kernel's share of device time and the logits against
    the same prefill with the plain attention.  Returns (launches,
    result)."""
    from repro_torch.kernels import flash_attention as FA, ref
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    cfg = _tinyllama()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = M.init_params(cfg, gen, torch.float32)
    prefill = registry.make_step(cfg, ShapeConfig(
        "prefill_4k_f32", PREFILL_S, F32_PREFILL_B, "prefill"))
    batch = {"tokens": torch.randint(0, cfg.vocab, (F32_PREFILL_B, PREFILL_S),
                                     generator=gen, device="cuda")}
    prefill(model, batch)                                # warm-up
    torch.cuda.synchronize()

    FA.reset_launches()
    n_calls = 2
    t0 = time.perf_counter()
    for _ in range(n_calls):
        logits = prefill(model, batch)
    torch.cuda.synchronize()
    wall_s = (time.perf_counter() - t0) / n_calls
    launches = dict(FA.LAUNCHES)
    want = {"flash_attention": 0,
            "flash_attention_f32": n_calls * cfg.n_layers,
            "split_bf16x3": 3 * n_calls * cfg.n_layers}
    if launches != want:
        raise AssertionError(f"float32 prefill launched {launches}, "
                             f"expected {want}")
    shape = (F32_PREFILL_B, 1, cfg.vocab)
    if (logits.dtype != torch.float32 or tuple(logits.shape) != shape
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"float32 prefill logits: {logits.dtype} "
                             f"{tuple(logits.shape)}, want float32 {shape}, "
                             f"finite")
    with attention_as(ref.flash_attention_ref):
        plain = prefill(model, batch)
    if not torch.isfinite(plain).all():
        raise AssertionError("float32 prefill with plain attention: logits "
                             "not finite")
    rel, elem = _rel_errors(torch, logits, plain)
    share, dev_us, top_ops = prefill_attention_share(torch, prefill, model,
                                                     batch)
    result = {"batch": F32_PREFILL_B, "seq": PREFILL_S, "dtype": "float32",
              "layers": cfg.n_layers, "wall_s": wall_s,
              "tokens_per_s": F32_PREFILL_B * PREFILL_S / wall_s,
              "device_ms": dev_us / 1e3 if share is not None else None,
              "attention_share_of_device_time": share,
              "top_device_ops": top_ops,
              "launches_per_call": {k: n // n_calls
                                    for k, n in launches.items()},
              "vs_plain_attention": {"relative_l2": rel,
                                     "max_over_scale": elem}}
    print(json.dumps({"f32_prefill": result}), flush=True)
    if share is None:
        raise AssertionError("the profiler saw no device time in the "
                             "float32 prefill")
    del model
    torch.cuda.empty_cache()
    return launches, result


def run_serving(torch):
    """Phase 5: TinyLlama-1.1B at full width on the card, through
    registry.make_step.  Returns the kernel's launches on this path."""
    from repro_torch.kernels import flash_attention as FA, ref
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
    if FA.LAUNCHES != {"flash_attention": n_prefill * cfg.n_layers,
                       "flash_attention_f32": 0, "split_bf16x3": 0}:
        raise AssertionError(
            f"prefill launched the attention kernels {FA.LAUNCHES} in "
            f"{n_prefill} calls, expected {cfg.n_layers} bf16 launches per "
            f"call and no float32 one or split")

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
    launches = dict(FA.LAUNCHES)
    # -- end of the main path -------------------------------------------------
    want = (n_prefill + 1) * cfg.n_layers
    if launches != {"flash_attention": want, "flash_attention_f32": 0,
                    "split_bf16x3": 0}:
        raise AssertionError(f"attention launches on the main path "
                             f"{launches}, expected {want} bf16 and no "
                             f"float32 one or split")

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
    with attention_as(ref.flash_attention_ref):
        plain = prefill(model, batch)
    torch.cuda.synchronize()
    pl_rel, pl_elem = _rel_errors(torch, logits, plain)
    share, dev_us, top_ops = prefill_attention_share(torch, prefill, model,
                                                     batch)
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
                    "top_device_ops": top_ops,
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


# ---------------------------------------------------------------------------
# Phase 5b: the bf16 kernel's accuracy against the exact function
# ---------------------------------------------------------------------------

def attention_f64(q, k, v, causal=True, window=None, q_chunk=512):
    """The attention function in float64 on the (exactly upcast) inputs:
    the truth the float32 plain version and both kernels approximate.
    Same masks as the plain version; (B, Sq, H, hd) float64."""
    import torch
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    kd = k.double().repeat_interleave(G, dim=2)
    vd = v.double().repeat_interleave(G, dim=2)
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qd = q[:, q0:q0 + q_chunk].double()
        qpos = q0 + torch.arange(qd.shape[1], device=q.device)
        s = torch.einsum("bqhd,bshd->bhqs", qd, kd) / math.sqrt(hd)
        keep = torch.ones(len(qpos), Sk, dtype=torch.bool, device=q.device)
        if causal:
            keep &= qpos[:, None] >= kpos[None, :]
        if window:
            keep &= kpos[None, :] > qpos[:, None] - window
        p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
        outs.append(torch.einsum("bhqs,bshd->bqhd", p, vd))
    return torch.cat(outs, dim=1)


def error_vs_truth(torch, got, truth):
    """A bf16 output's error against the float64 function: ``rel_l2``;
    ``max_half_ulps`` and ``n_over_half_ulp`` in hold_attention's measure;
    the mean signed error toward larger magnitude in those units with its
    standard error (a truncating accumulation reads below the plain
    version); and the elements that differ from bf16(truth) ("flips") with
    the share of them above it in magnitude (0.5 without a bias)."""
    g = got.double()
    sign = truth.sign()
    e = (g - truth) * sign / (BF16_HALF_ULP * truth.abs() + F32_ATOL)
    rn = truth.to(got.dtype).double()
    flip = g != rn
    n_flip = int(flip.sum().item())
    up = int((((g - rn) * sign)[flip] > 0).sum().item())
    return {"rel_l2": ((g - truth).norm() / truth.norm()).item(),
            "max_half_ulps": e.abs().max().item(),
            "n_over_half_ulp": int((e.abs() > 1).sum().item()),
            "mean_half_ulps": e.mean().item(),
            "se_half_ulps": (e.std() / e.numel() ** 0.5).item(),
            "flips": n_flip, "flips_up_share": up / n_flip if n_flip else None}


def against_truth(torch, q, k, v, causal=True, window=None):
    """(kernel output, {kernel, plain: error_vs_truth}) on one bf16 input;
    plain is the float32 plain version rounded once."""
    from repro_torch.kernels import flash_attention as FA, ref
    truth = attention_f64(q, k, v, causal, window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    outs = {"kernel": got,
            "plain": ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window)}
    return got, {n: error_vs_truth(torch, x, truth) for n, x in outs.items()}


def attention_accuracy(torch, seeds=(0, 1, 2, 3, 4)):
    """Phase 5b, after the main path: the bf16 kernel and the plain
    version, each against the float64 function, at the prefill shape on
    random inputs and layer by layer in a full-width prefill (seed 0: the
    main path's model and tokens); then
    prefill logits on several seeds with each of them, and with float64
    attention, as the model's attention (``_rel_errors`` against the
    float64-attention prefill, and kernel vs plain, PREFILL_TOL's
    measure)."""
    from repro_torch.kernels import ref
    from repro_torch.models import registry
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    cfg = _tinyllama()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _qkv(torch, PREFILL_B, PREFILL_S, PREFILL_S, H, KV, hd,
                   torch.bfloat16, seed=1)
    _, at_shape = against_truth(torch, q, k, v)
    del q, k, v
    prefill = registry.make_step(cfg, ShapeConfig("prefill_4k", PREFILL_S,
                                                  PREFILL_B, "prefill"))
    routes = {"plain": ref.flash_attention_ref,
              "f64": lambda q, k, v, causal=True, window=None: attention_f64(
                  q, k, v, causal, window).to(q.dtype)}
    layers, logits = [], []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = M.init_params(cfg, gen)
        batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                                         generator=gen, device="cuda")}
        out = {"kernel": prefill(model, batch)}
        for name, fn in routes.items():
            with attention_as(fn):
                out[name] = prefill(model, batch)
        row = {"seed": seed, "kernel_vs_plain": _rel_errors(
            torch, out["kernel"], out["plain"])}
        for name in ("kernel", "plain"):
            row[f"{name}_vs_f64"] = _rel_errors(torch, out[name], out["f64"])
        logits.append(row)
        if seed == seeds[0]:
            def watch(q, k, v, causal=True, window=None):
                got, errs = against_truth(torch, q, k, v, causal, window)
                layers.append(errs)
                return got
            with attention_as(watch):
                prefill(model, batch)
        del model, out
    torch.cuda.synchronize()
    result = {"at_prefill_shape": at_shape, "by_layer": layers,
              "prefill_logits": logits}
    print(json.dumps({"attention_accuracy": result}), flush=True)
    for where, errs in [("prefill shape", at_shape)] + [
            (f"layer {i}", e) for i, e in enumerate(layers)]:
        if errs["kernel"]["n_over_half_ulp"] > errs["plain"]["n_over_half_ulp"]:
            raise AssertionError(
                f"attention at the {where}: the kernel has more elements "
                f"beyond half a bf16 ulp of float64 than the plain version "
                f"({errs['kernel']['n_over_half_ulp']} > "
                f"{errs['plain']['n_over_half_ulp']})")
    kern, plain = (sum(r[f"{n}_vs_f64"][0] for r in logits) / len(logits)
                   for n in ("kernel", "plain"))
    if not kern <= ACCURACY_LOGITS_RATIO * plain:
        raise AssertionError(
            f"prefill logits vs float64 attention: kernel {kern}, plain "
            f"version {plain} (limit {ACCURACY_LOGITS_RATIO}x)")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import numpy as np
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"phase 1: built {sorted(libs)} from {SOURCE} and {FA_SOURCE} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"{name} took {time.perf_counter() - t:.1f} s", flush=True)
        return out

    err = timed_phase("phase 2 checks", check_kernels, torch, np)
    timing = timed_phase("phase 2 timing", time_kernels, torch, np)
    fa_err = timed_phase("phase 2b checks", check_attention, torch)
    fa_time = timed_phase("phase 2b timing", time_attention, torch, fa_err)
    timed_phase("phase 3", check_card_vs_cpu)
    launches, profiles = timed_phase("phase 4", run_main_path, torch)
    timed_phase("phase 4b", run_streaming_and_telemetry, torch, profiles)
    timed_phase("phase 4c", run_graph_path, torch)
    service_launches = timed_phase("phase 6", run_service, torch)
    timed_phase("phase 5 card vs CPU", check_card_vs_cpu_prefill, torch)
    fa_launches, _ = timed_phase("phase 5 bf16", run_serving, torch)
    f32_launches, _ = timed_phase("phase 5 float32", run_f32_prefill, torch)
    timed_phase("phase 5b", attention_accuracy, torch)

    rows = []
    floor = timing["launch_floor"]
    for name, replaces in KERNELS.items():
        main_t, big_t = timing[(name, N_MAIN)], timing[(name, N_BIG)]
        rows.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], on_main_path=launches[name] > 0,
            max_abs_err=err[name], max_abs_diff=err[name],
            ms=main_t["ms"], plain_ms=main_t["plain_ms"],
            bound_ms=main_t["bound_ms"], bound_by=main_t["bound_by"],
            library_ms=None, host_us_per_call=main_t["host_us"],
            launch_floor_us=floor["ms"] * 1e3,
            launch_floor_host_us=floor["host_us"],
            us_at_1860=main_t["ms"] * 1e3, us_at_1M=big_t["ms"] * 1e3,
            plain_us_at_1M=big_t["plain_ms"] * 1e3,
            bound_us_at_1M=big_t["bound_ms"] * 1e3,
            bound_by_at_1M=big_t["bound_by"],
            host_us_at_1M=big_t["host_us"]))
        if name in ("mcc_pick", "ecc_pick"):
            # The placement service's five full-scale streams (phase 6).
            rows[-1]["service_launches"] = service_launches.get(name, 0)
    # Attention: the bf16 kernel's launches from the serving path, the
    # float32 kernel's and the split's from the float32 prefill.
    for name, tname, path, runs in (
            ("flash_attention", "bfloat16", "bf16 serving", fa_launches),
            ("flash_attention_f32", "float32", "float32 prefill",
             f32_launches),
            ("split_bf16x3", "split", "float32 prefill", f32_launches)):
        t = fa_time[tname]
        rows.append(dict(
            name=name, route="cuda", source=FA_SOURCE, replaces=FA_REPLACES,
            launches=runs[name], on_main_path=tname == "bfloat16",
            path=path, max_abs_err=fa_err[tname], max_abs_err_by_dtype=fa_err,
            max_abs_err_vs_f64=t.get("max_abs_err_vs_f64"),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            shape=t["shape"]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
