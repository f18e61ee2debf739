#!/usr/bin/env python3
"""Probe two depth cuts of ``chip_smoke.py`` against float64, on one card.

Run from the repository root: ``python3 cut_probe.py [zamba2] [train]``
(both parts without arguments).  Each part prints one JSON line; the card
line comes first.

``zamba2``: Zamba2-7B at full width cut to 14 of its 81 layers, bf16,
the prefill cell of phase 5e (2 x 8,192, window 4,096, hd 112).  On each
of phase 5b's seeds (``chip_smoke.ACCURACY_SEEDS``, drawn as
``prefill_logits_vs_f64`` draws them): the prefill's logits with the
kernel, with the plain version and with float64 attention as the model's
attention, each against the float64-attention logits (the float64
gate's numbers, ``logits_ratio_gate``); and, on the exact q, k, v of every
windowed attention call of the kernel's prefill, the kernel's and the
plain version's output against the float64 function
(``chip_smoke.error_vs_truth``).  Beside them the same per-call measure
on phase 2b's random inputs at that shape.

``train``: phase 5g (b)'s model (TinyLlama-1.1B's width, 2 layers,
float32, the same draw) at 2 x 64 tokens: the first step's gradient of
``train.step.lm_loss`` on the card (the float32 attention kernels), on
the CPU (the plain version) and in float64 on the CPU (the model, its
float32 casts and the attention in float64): each float32 gradient's
relative L2 against float64, its global norm's relative error, and the
card's against the CPU's (phase 5g (b)'s ``first_grad_norm``); beside
them the same for the CPU under half a float32 ulp of noise at each norm
(phase 5g (b)'s yardstick), one run per seed of ``NOISE_SEEDS``.
"""
from __future__ import annotations

import json
import sys
import time

import chip_smoke as S

ZAMBA2_LAYERS = 14
TRAIN_SHAPE = (2, 64)
RANDOM_SEEDS = (0, 1)
NOISE_SEEDS = (0, 1, 2, 3)


def probe_zamba2(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as M
    cfg = get_config(S.ZAMBA2).scaled(n_layers=ZAMBA2_LAYERS)
    B, Sq = S.prefill_shape(cfg)
    window = cfg.sliding_window
    hd = cfg.resolved_head_dim
    inputs, run = S.prefill_step(torch, cfg)
    f64 = (lambda q, k, v, causal=True, window=None:
           S.attention_f64(q, k, v, causal, window).to(q.dtype))
    seeds, calls = [], []
    for seed in S.ACCURACY_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        model = M.init_params(cfg, gen)
        batch = inputs(gen)

        def watch(q, k, v, causal=True, window=None, seed=seed):
            got, errs = S.against_truth(torch, q, k, v, causal, window)
            calls.append({"seed": seed, "call": sum(
                c["seed"] == seed for c in calls), **errs})
            return got
        with torch.inference_mode():
            with S.attention_as(watch):
                kern = run(model, batch)
            with S.attention_as(S.plain_attention):
                plain = run(model, batch)
            with S.attention_as(f64):
                truth = run(model, batch)
        seeds.append({"seed": seed,
                      "kernel_vs_f64": S._rel_errors(torch, kern, truth),
                      "plain_vs_f64": S._rel_errors(torch, plain, truth),
                      "kernel_vs_plain": S._rel_errors(torch, kern, plain)})
        del model, kern, plain, truth
        torch.cuda.empty_cache()
    kern = sum(r["kernel_vs_f64"][0] for r in seeds) / len(seeds)
    plain = sum(r["plain_vs_f64"][0] for r in seeds) / len(seeds)
    rand = []
    for seed in RANDOM_SEEDS:
        q, k, v = S._qkv(torch, B, Sq, Sq, cfg.n_heads, cfg.n_kv_heads, hd,
                         torch.bfloat16, seed)
        rand.append({"seed": seed, **S.against_truth(
            torch, q, k, v, True, window)[1]})
    return {"model": cfg.name, "layers": ZAMBA2_LAYERS, "batch": B,
            "seq": Sq, "window": window, "head_dim": hd,
            "logits": seeds, "mean_kernel_vs_f64": kern,
            "mean_plain_vs_f64": plain, "ratio": kern / plain,
            "gate_limit": S.ACCURACY_LOGITS_RATIO,
            "calls_on_model_inputs": calls,
            "calls_on_random_inputs": rand}


def _grads(torch, M, TS, cfg, model, batch):
    from repro_torch.train.optimizer import tree_leaves
    grads, loss, _ = TS._backward(model, batch, cfg)
    return [g.detach().double().cpu() for g in tree_leaves(grads)], float(
        loss)


def probe_train(torch):
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as TS
    from repro_torch.train.optimizer import tree_map
    cfg = S._tinyllama().scaled(n_layers=S.TRAIN_SMALL_LAYERS)
    B, Sq = TRAIN_SHAPE
    cut = ShapeConfig("train small", Sq, B, "train")

    def model_on(device, dtype=torch.float32):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32, device)
        if dtype != torch.float32:
            tree = tree_map(lambda x: x.detach().to(dtype),
                            M.stacked_params(model))
            model = M.load_stacked(M.Transformer(cfg, device="meta",
                                                 dtype=dtype), tree)
        return M.make_trainable(model)

    out = {}
    for device in ("cuda", "cpu"):
        batch = batch_for_step(cfg, cut, 0, device=device)
        out[device] = _grads(torch, M, TS, cfg, model_on(device), batch)
    # float64: every float32 cast of the model code at float64, float64
    # attention in place of the kernel.
    saved = L.f32, M.f32, TS.f32
    L.f32 = M.f32 = TS.f32 = torch.float64
    try:
        with S.attention_as(lambda q, k, v, causal=True, window=None:
                            S.attention_f64(q, k, v, causal, window)):
            batch = batch_for_step(cfg, cut, 0, device="cpu")
            out["f64"] = _grads(torch, M, TS, cfg,
                                model_on("cpu", torch.float64), batch)
    finally:
        L.f32, M.f32, TS.f32 = saved

    def norm(gs):
        return sum(float((g * g).sum()) for g in gs) ** 0.5

    def rel_l2(a, b):
        return (sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))
                ** 0.5 / norm(b))
    # The yardstick of phase 5g (b): the CPU run under half a float32 ulp
    # of noise at each norm (``chip_smoke.half_ulp_noise``), per seed.
    for seed in NOISE_SEEDS:
        with S.half_ulp_noise(torch, seed):
            batch = batch_for_step(cfg, cut, 0, device="cpu")
            out[f"cpu_noise{seed}"] = _grads(torch, M, TS, cfg,
                                             model_on("cpu"), batch)
    truth = out["f64"][0]
    res = {"model": cfg.name, "layers": cfg.n_layers, "shape": TRAIN_SHAPE,
           "loss": {k: v[1] for k, v in out.items()},
           "grad_norm": {k: norm(v[0]) for k, v in out.items()}}
    for name in [k for k in out if k != "f64"]:
        res[f"{name}_vs_f64"] = {
            "rel_l2": rel_l2(out[name][0], truth),
            "grad_norm": abs(norm(out[name][0]) - norm(truth)) / norm(truth)}
    res["cuda_vs_cpu"] = {
        "rel_l2": rel_l2(out["cuda"][0], out["cpu"][0]),
        "grad_norm": abs(norm(out["cuda"][0]) - norm(out["cpu"][0]))
        / norm(out["cpu"][0])}
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cut_probe: no CUDA device", file=sys.stderr)
        return 1
    print(S.card_line(), flush=True)
    sys.path[:0] = [str(S.ROOT / "src")]
    torch.backends.cuda.matmul.allow_tf32 = False
    parts = sys.argv[1:] or ["zamba2", "train"]
    for part, fn in (("zamba2", probe_zamba2), ("train", probe_train)):
        if part in parts:
            t = time.perf_counter()
            res = fn(torch)
            res["seconds"] = time.perf_counter() - t
            print(json.dumps({part: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
