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
  5. Prints the kernel table as one JSON line, the card line again, and
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
# integer/float32 scalar operations could issue at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

N_BIG, N_MAIN = 1 << 20, 1860
KERNELS = {
    "mcc": "src/repro/kernels/policy_score.py:77",
    "ecc": "src/repro/kernels/policy_score.py:94",
    "cc": "src/repro/kernels/cc_score.py:41",
    "frag": "src/repro/kernels/frag_score.py:49",
}
SOURCE = "src/repro_torch/kernels/csrc/mask_scores.cu"


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

    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1: built {SOURCE} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    err = check_kernels(torch, np)
    timing = time_kernels(torch, np)
    check_card_vs_cpu()
    launches = run_main_path(torch)

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
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
