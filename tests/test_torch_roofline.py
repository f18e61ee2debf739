"""The port's roofline and memory fit on meta tensors (``repro_torch.launch.
{dryrun,roofline}``) vs the JAX package's tools and vs the arithmetic.

  * ``roofline_terms``' dominance at the H100's peaks (a mirror of
    tests/test_roofline.py's), and the per-class compute term;
  * ``depth_variants``: JAX's depths for every architecture, and the
    combiner equals the direct full-depth meta count exactly for a dense,
    a hybrid, an encdec and an RWKV-6 smoke config; ``roofline_cell``
    counts at full depth but for RWKV-6, which it combines;
  * the dense smoke prefill's flops are exactly 2 x its matmul parameters
    x tokens plus the attention kernel's pairs formula;
  * train-step flops order none < dots < full; full - none is one
    counted forward of the layer bodies but each layer's last product
    (torch's non-reentrant checkpoint stops recomputing once the tensors
    the backward saved are back, and no backward reads ``w2``'s output);
  * the fit: ``argument`` is the parameters, optimizer state and batch,
    the live-byte peak tracks allocations and frees;
  * ``model_flops`` equals JAX's for every ``supported_cells()`` entry;
  * the attention wrapper's meta route returns meta outputs, records the
    call only inside a count and launches nothing; it rejects the head
    dims and dtypes the card rejects; float32 calls count their splits'
    bytes;
  * the dryrun and roofline CLIs, and ``roofline --multi-pod`` (the 2 x 16
    x 16 mesh's fake group, in a subprocess).

Meta tensors allocate nothing and compute nothing, so the counts here are
the same on any machine; no device number is produced.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.roofline import depth_variants as jdepth_variants
from repro.models import registry as JR
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.models import flags
from repro_torch.models import registry as R
from repro_torch.models import transformer as M
from repro_torch.models.config import SHAPES, ShapeConfig

META = torch.device("meta")
ROOT = Path(__file__).resolve().parents[1]


def test_roofline_terms_dominance():
    chips = 1
    t = D.roofline_terms(flops=1e18, hbm_bytes=1e12, coll_bytes=1e12,
                         chips=chips)
    assert t["dominant"] == "compute"
    assert t["compute_s"] == pytest.approx(1e18 / (chips * D.PEAK_FLOPS))
    t2 = D.roofline_terms(1e12, 1e12, 1e15, chips)
    assert t2["dominant"] == "collective"
    assert t2["collective_s"] == pytest.approx(1e15 / (chips * D.ICI_BW))
    t3 = D.roofline_terms(1e12, 1e16, 1e12, chips)
    assert t3["dominant"] == "memory"
    assert t3["memory_s"] == pytest.approx(1e16 / (chips * D.HBM_BW))
    assert (D.PEAK_FLOPS, D.HBM_BW) == (989e12, 3.35e12)


def test_roofline_terms_take_each_class_at_its_peak():
    t = D.roofline_terms({"bfloat16": 989e12, "float32": 67e12,
                          "attention float32": 989e12 / 6}, 0.0, 0.0, 1)
    assert t["compute_s"] == pytest.approx(3.0)
    assert D.roofline_terms({"bfloat16": 1.0}, 0, 0, 1)["compute_s"] == (
        D.roofline_terms(1.0, 0, 0, 1)["compute_s"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_variants_equal_jax(arch):
    variants, combine = RL.depth_variants(get_config(arch))
    jvariants, jcombine = jdepth_variants(jget_config(arch))
    assert [(v.n_layers, v.n_enc_layers) for v in variants] == [
        (v.n_layers, v.n_enc_layers) for v in jvariants]
    costs = [torch.arange(3, dtype=torch.float64).numpy() * (i + 2) ** 2 + i
             for i in range(len(variants))]
    assert (combine(costs) == jcombine(costs)).all()


def _warm(arch, shape, micro):
    """One count first, so once-per-process work of the model code (the
    RoPE frequencies' copy to the device, cached) is out of every compared
    count."""
    D.lower_cell(arch, shape, n_micro=micro,
                 cfg_override=get_smoke_config(arch).scaled(n_layers=1))


@pytest.mark.parametrize("kind,micro", [("train", 2), ("prefill", 1),
                                        ("decode", 1)])
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "zamba2_7b",
                                  "whisper_base", "rwkv6_3b"])
def test_combiner_equals_the_direct_count(arch, kind, micro):
    cfg = get_smoke_config(arch)
    shape = ShapeConfig(kind, 64, 2, kind)
    _warm(arch, shape, micro)
    direct = D.lower_cell(arch, shape, n_micro=micro, cfg_override=cfg)
    variants, combine = RL.depth_variants(cfg)
    assert any(v.n_layers < cfg.n_layers for v in variants)
    est = combine([RL._measure(arch, shape, v, micro) for v in variants])
    want = [direct["flops_by_peak"].get(k, 0.0) for k in RL._KEYS] + [
        direct["hlo_bytes"]] + [direct["collectives"].get(k, 0.0)
                                for k in RL._KINDS]
    assert list(est[:len(want)]) == want
    assert direct["hlo_flops"] > 0 and direct["collective_bytes"] == 0.0


def _matmul_params(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    return attn + 3 * d * cfg.d_ff


def test_dense_prefill_flops_are_the_formula():
    cfg = get_smoke_config("tinyllama_1_1b")
    B, S = 2, 64
    r = D.lower_cell("tinyllama_1_1b", ShapeConfig("p", S, B, "prefill"),
                     cfg_override=cfg)
    layers = 2 * _matmul_params(cfg) * B * S * cfg.n_layers
    head = 2 * cfg.d_model * cfg.vocab * B           # last position only
    attn = cfg.n_layers * D.attention_flops(
        B, S, S, cfg.n_heads, cfg.resolved_head_dim, True, None)
    assert attn == 4 * B * cfg.n_heads * cfg.resolved_head_dim * (
        S * (S + 1) // 2) * cfg.n_layers
    assert r["flops_by_peak"] == {"bfloat16": layers + head,
                                  "attention bfloat16": attn}
    assert r["hlo_flops"] == layers + head + attn
    assert r["attention_calls"] == {"fwd bfloat16": cfg.n_layers}
    assert r["mesh"] == "1" and r["chips"] == 1 and not r["skipped"]


def _product_flops(cfg, shape, remat):
    old = flags.REMAT_MODE
    flags.REMAT_MODE = remat
    try:
        return D.count_cell(cfg, shape, n_micro=1)
    finally:
        flags.REMAT_MODE = old


def test_train_flops_by_remat_mode():
    cfg = get_smoke_config("tinyllama_1_1b")
    shape = ShapeConfig("t", 64, 2, "train")
    got = {m: _product_flops(cfg, shape, m)
           for m in ("none", "dots", "full")}
    attn = {m: D.attention_work(c["attention_calls"]) for m, c in got.items()}
    total = {m: got[m]["product_flops"] + sum(attn[m]["flops"].values())
             for m in got}
    assert total["none"] < total["dots"] < total["full"]
    # One forward of the layer bodies, counted alone (no grad).
    params = R.abstract_params(cfg)
    model = D.meta_model(cfg, params)
    tokens = torch.empty((2, 64), dtype=torch.int32, device=META)
    fwd = D.count_step(lambda m, t: M.forward(m, t, cfg)[0], model, tokens)
    w2 = 2 * cfg.d_model * cfg.d_ff * 2 * 64 * cfg.n_layers
    assert (got["full"]["product_flops"] - got["none"]["product_flops"]
            == fwd["product_flops"] - w2)
    # dots saves every plain product: its GEMMs are none's.
    assert got["dots"]["product_flops"] == got["none"]["product_flops"]
    # The attention forward is recomputed under full and dots, not none.
    assert attn["full"]["calls"] == attn["dots"]["calls"] == {
        "fwd bfloat16": 2 * cfg.n_layers, "bwd bfloat16": cfg.n_layers}
    assert attn["none"]["calls"] == {"fwd bfloat16": cfg.n_layers,
                                     "bwd bfloat16": cfg.n_layers}
    # The fit: the arguments are the parameters, the float32 moments, the
    # step and the batch; remat "none" holds the most between them.
    n = sum(p.numel() for p in M.Transformer(cfg, device="meta").parameters())
    assert got["full"]["argument"] == 2 * n + 8 * n + 4 + 2 * (2 * 64 * 4)
    assert got["none"]["temp"] > got["dots"]["temp"] > got["full"]["temp"]


def test_counter_tracks_live_bytes():
    c = D.Counter()
    with c:
        a = torch.empty(1000, device=META)            # 4000
        b = torch.zeros(500, device=META)             # 2000, written
        v = a.view(10, 100)                           # a view: no bytes
        del a
        s = v + 1.0                                   # 4000 more
        del v                                         # a's storage freed
        after = c.live
        del s
    assert c.peak == 10000 and after == 6000
    assert c.live == 2000                             # b remains
    assert c.bytes == 2000 + 4000 + 4000              # zeros; add in + out
    del b
    assert c.live == 0


def test_model_flops_equal_jax_for_every_cell():
    cells = R.supported_cells()
    assert len(cells) == len(ARCH_IDS) * len(SHAPES)
    for arch, shape, ok, why in cells:
        assert R.model_flops(get_config(arch), SHAPES[shape]) == (
            JR.model_flops(jget_config(arch), JSHAPES[shape])), (arch, shape)


def test_rwkv6_roofline_is_counted_at_its_depth_variants():
    """RWKV-6 (``COMBINE_FAMILIES``) takes the combiner, which gives its
    full-depth count: here at ``decode_32k``, whose count is quick."""
    assert RL.COMBINE_FAMILIES == ("rwkv6",)
    _warm("rwkv6_3b", "decode_32k", 1)
    c = RL.roofline_cell("rwkv6_3b", "decode_32k")
    r = D.lower_cell("rwkv6_3b", "decode_32k")
    assert c["counted_at"] == "depth variants"
    assert (c["flops_by_peak"], c["hlo_bytes"]) == (r["flops_by_peak"],
                                                    r["hlo_bytes"])
    assert c["dominant"] == r["dominant"] == "memory"


def test_skipped_cell_matches_jax_fields():
    r = D.lower_cell("tinyllama_1_1b", "long_500k")
    assert r["skipped"] and r["mesh"] == "1" and "524288" in r["reason"]


def test_attention_meta_route_records_and_launches_nothing():
    FA.reset_launches()
    before = dict(FA.LAUNCHES)
    q = torch.empty((2, 100, 8, 64), dtype=torch.bfloat16, device=META,
                    requires_grad=True)
    k = torch.empty((2, 300, 2, 64), dtype=torch.bfloat16, device=META,
                    requires_grad=True)
    v = torch.empty((2, 300, 2, 64), dtype=torch.bfloat16, device=META,
                    requires_grad=True)

    def step():
        out = FA.flash_attention(q, k, v, causal=False, window=None)
        assert out.device == META and out.shape == (2, 100, 8, 64)
        out.sum().backward()
        assert q.grad.device == META and k.grad.shape == k.shape
        o32 = FA.flash_attention(*(x.detach().float() for x in (q, k, v)),
                                 window=40)
        assert o32.dtype == torch.float32 and o32.device == META

    calls = D.count_step(step)["attention_calls"]
    assert calls == [
        FA.MetaCall(2, 100, 300, 8, 2, 64, 64, False, None, "bfloat16",
                    "fwd"),
        FA.MetaCall(2, 100, 300, 8, 2, 64, 64, False, None, "bfloat16",
                    "bwd"),
        FA.MetaCall(2, 100, 300, 8, 2, 64, 64, True, 40, "float32", "fwd")]
    assert FA.LAUNCHES == before
    # Outside a count nothing is recorded, so nothing accumulates.
    assert FA.META_CALLS is None
    FA.flash_attention(q.detach(), k.detach(), v.detach())
    assert FA.META_CALLS is None


@pytest.mark.parametrize("hd,hd_v,dtype,err", [
    (48, 48, torch.bfloat16, ValueError),      # not in HEAD_DIMS
    (24, 16, torch.bfloat16, ValueError),      # not in HEAD_DIM_PAIRS
    (64, 64, torch.float16, TypeError),        # not a route's dtype
])
def test_attention_meta_route_rejects_what_the_card_rejects(hd, hd_v, dtype,
                                                             err):
    """The meta route takes the head dims and dtypes the CUDA kernels
    take, so a count never passes a cell the card would refuse."""
    q = torch.empty((1, 8, 2, hd), dtype=dtype, device=META)
    k = torch.empty((1, 8, 2, hd), dtype=dtype, device=META)
    v = torch.empty((1, 8, 2, hd_v), dtype=dtype, device=META)
    with pytest.raises(err):
        FA.flash_attention(q, k, v)
    with pytest.raises(err):
        FA.flash_attention_bwd(q, k, v, v, torch.empty(
            (1, 2, 8), device=META), v)
    if dtype == torch.bfloat16:
        with pytest.raises(err):
            D.count_step(FA.flash_attention, q, k, v)
    assert FA.META_CALLS is None


def test_float32_calls_count_their_splits():
    """A float32 call's bytes add its ``split_bf16x3`` launches' (three a
    forward, four a backward): each split element read at 4 bytes and
    written as three bf16 planes; a bf16 call has none."""
    B, Sq, Sk, H, KV, hd = 2, 100, 300, 8, 2, 64
    call = {kind: FA.MetaCall(B, Sq, Sk, H, KV, hd, hd, True, None, dt,
                              kind)
            for kind in ("fwd", "bwd") for dt in ("float32",)}
    q_el, kv_el = B * Sq * H * hd, B * Sk * KV * hd
    assert D.split_bytes(call["fwd"]) == 10 * (q_el + 2 * kv_el)
    assert D.split_bytes(call["bwd"]) == 10 * (2 * q_el + 2 * kv_el)
    assert D.split_bytes(call["fwd"]._replace(dtype="bfloat16")) == 0
    w = D.attention_work(call.values())
    assert w["calls"] == {"fwd float32": 1, "bwd float32": 1,
                          "split_bf16x3": 7}
    assert w["bytes"] == (
        D.attention_bytes(B, Sq, Sk, H, KV, hd, 4)
        + D.attention_bwd_bytes(B, Sq, Sk, H, KV, hd, 4)
        + D.split_bytes(call["fwd"]) + D.split_bytes(call["bwd"]))


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    import json
    out = tmp_path / "d.json"
    assert D.main(["--arch", "whisper_base", "--shape", "decode_32k",
                   "--json", str(out)]) == 0
    (r,) = json.loads(out.read_text())
    assert r["mesh"] == "1" and r["chips"] == 1 and r["dominant"] == "memory"
    assert set(r["per_device_bytes"]) == {"argument", "output", "temp",
                                          "peak"}
    assert {"hlo_flops", "hlo_bytes", "collective_bytes", "collectives",
            "model_flops", "useful_flops_ratio", "compute_s", "memory_s",
            "collective_s", "compile_s"} <= set(r)
    out = tmp_path / "r.json"
    assert RL.main(["--arch", "whisper_base", "--shape", "decode_32k",
                    "--json", str(out)]) == 0
    (c,) = json.loads(out.read_text())
    assert c["hlo_flops"] == r["hlo_flops"]
    assert c["counted_at"] == "full depth"
    assert {"roofline_fraction", "useful_flops_ratio", "measure_s"} <= set(c)
    assert "[OK  ] whisper_base" in capsys.readouterr().out
    # --multi-pod: the 2x16x16 mesh's fake group of 512 ranks, in a process
    # of its own (one process holds one default group).
    out = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--arch",
         "tinyllama_1_1b", "--shape", "decode_32k", "--multi-pod", "--json",
         str(out)], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (m,) = json.loads(out.read_text())
    assert m["mesh"] == "2x16x16" and m["chips"] == 512
    assert m["counted_at"] == "depth variants"
    assert m["collective_bytes"] > 0 and m["collective_s"] > 0
    assert m["per_device_bytes"]["peak"] > 0
    assert "[OK  ] tinyllama_1_1b" in proc.stdout
