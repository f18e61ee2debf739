"""The port's CUDA kernels on the card (skipped where there is none).

Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each mask scorer must equal its plain version exactly, on every mask x
profile of the four device presets at a ragged length (masks with bits
above the model's blocks too, and an unaligned view); each fused pick
must equal its plain version on random fleets (tests/_torch_fleets.py)
at ragged sizes; the replay's kernel path must launch one pick per
MCC/MECC arrival, no score kernel, and decide as the CPU.
The attention kernels must equal ``flash_attention_ref`` at ragged and GQA
shapes and at the serving prefill's shape (2e-5 float32, 3e-2 bf16, the
tolerances of tests/test_flash_attention.py; bf16 also within half an ulp
of the plain version in float32), float32 also over a 16,384-key row;
bf16 must reach only the bf16 kernel and float32 only the split (three
launches) and the float32 kernel; the split kernel must equal
``ref.split_bf16x3`` bit for bit; and ``prefill`` must launch the bf16
kernel once per layer (TinyLlama's hd 64 and StableLM's hd 80); each new
architecture's smoke config (hd 16) must prefill on the card as on the
CPU; a head dim the kernels do not take must raise on a CUDA tensor,
naming the ones they do.  The (q/k 192, v 128) pair of DeepSeek-V2's MLA
must hold the same tolerances in both dtypes; its float32 narrow variant
must prefill and decode on the card as on the CPU, and a bf16 MLA model at
chip_smoke.DSV2_LAYERS layers must launch the bf16 kernel once a layer at
the pair; an unlisted pair must raise.  Whisper's smoke config must
encode and decode with cross attention on the card as on the CPU, and so
must Scout's MoE route, drop and compute (moe_apply).  RWKV-6 and the
Mamba-2 hybrid (float32, at the models' head dims) must prefill and
decode on the card as on the CPU, past the hybrid's ring, and the
hybrid's prefill must launch the bf16 kernel once per shared-block call,
with its window.  A replay with telemetry on must give the CPU's
decisions, reasons and series, with one pick per MCC/MECC arrival.  The
replay's captured graphs must give the eager loop's outputs for all five
policies, synchronise with the host only at GRMU's consolidations, and
count one pick per arrival and replay.  The placement service must decide
on the card as on the CPU (GRMU, MECC), capture its graphs again after
the compile cache evicted its runner, and read back at most once per
micro-batch (plus GRMU's consolidations).  One rank of a sharded fleet
over NCCL must decide through its captured graphs as the CPU.  The
p_bf16 attention routes (JAX's ATTN_P_BF16) must hold chip_smoke.py phase
2d's gate (within PB_SHARE of the flag's effect from the plain version,
two launches bitwise equal) over one and two key chunks in both dtypes,
launch their own kernels under grad (also when the backward is the
autograd thread's first CUDA work), refuse a backward without the
forward's chunk statistics, and leave the float32-p routes' results at
TinyLlama's shape on the parent commit's bits.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_fleets import CASES, fleet, weights

from repro_torch.core import batched as B
from repro_torch.core.mig import DEVICE_MODELS
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mask_scores as K, ref
from repro_torch.models import registry, transformer as M
from repro_torch.models.config import ShapeConfig
from repro_torch.workload.alibaba import TraceConfig, generate

pytestmark = pytest.mark.gpu


def _chip_smoke():
    """The card script, for its plain attention (``plain_attention``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _chip_smoke()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", sorted(DEVICE_MODELS))
def test_kernels_equal_plain_versions_on_card(name):
    _need_card()
    model = DEVICE_MODELS[name]
    base = torch.arange(model.num_masks, dtype=torch.int32)
    masks = base.repeat(1860 // model.num_masks + 1)[:1859].cuda()
    high = torch.from_numpy(fleet(model, 1859, 0, "high_bits")[0]).cuda()
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.dirichlet(np.ones(model.num_profiles)).astype(
        np.float32)).cuda()
    for m in (masks, high, masks[1:]):           # masks[1:]: unaligned
        assert torch.equal(K.cc(m, model), ref.cc_ref(m, model))
        assert torch.equal(K.frag(m, model), ref.frag_ref(m, model))
        for p in range(model.num_profiles):
            assert torch.equal(K.mcc(m, p, model),
                               ref.mcc_score_ref(m, p, model))
            assert torch.equal(K.ecc(m, p, w, model),
                               ref.ecc_score_ref(m, p, w, model))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(DEVICE_MODELS))
def test_pick_kernels_equal_plain_versions_on_card(name):
    _need_card()
    model = DEVICE_MODELS[name]
    for G in (1, 31, 1860, 100_003):
        for case in CASES:
            t = [torch.from_numpy(a).cuda()
                 for a in fleet(model, G, G + CASES.index(case), case)]
            for p in range(model.num_profiles):
                assert torch.equal(K.mcc_pick(*t, p, model),
                                   ref.mcc_pick_ref(*t, p, model))
                for w in weights(model, p):
                    w = torch.from_numpy(w).cuda()
                    assert torch.equal(K.ecc_pick(*t, p, w, model),
                                       ref.ecc_pick_ref(*t, p, w, model))
    torch.cuda.synchronize()


def test_multi_cta_picks_on_two_streams_do_not_share_state():
    """A fleet larger than one CTA reduces through scratch of its own
    launch: picks racing on two streams, many times over, each equal
    their plain version."""
    _need_card()
    model = DEVICE_MODELS["A100-40GB"]
    fleets = [[torch.from_numpy(a).cuda() for a in fleet(model, G, G)]
              for G in (K.PICK_PER_CTA + 1, 100_003)]
    want = [ref.mcc_pick_ref(*t, 0, model) for t in fleets]
    streams = [torch.cuda.Stream() for _ in fleets]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(50):
        for i, (t, s) in enumerate(zip(fleets, streams)):
            with torch.cuda.stream(s):
                got[i].append(K.mcc_pick(*t, 0, model))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert all(torch.equal(x, w) for x in g)


@pytest.mark.parametrize("policy", [B.MCC, B.MECC])
def test_replay_kernel_path_on_card(policy):
    _need_card()
    cluster, vms = generate(TraceConfig(scale=0.05, seed=2))
    events = B.build_events(vms, cluster)
    K.reset_launches()
    card = B.replay(events, policy, device="cuda", score_backend="kernel")
    arrivals = int((events.kind == B.ARRIVAL).sum())
    pick = "mcc_pick" if policy == B.MCC else "ecc_pick"
    assert K.LAUNCHES == {k: arrivals if k == pick else 0
                          for k in K.LAUNCHES}
    cpu = B.replay(events, policy, device="cpu", score_backend="tables")
    assert card.accepted_ids == cpu.accepted_ids
    assert card.hourly_active_hw == cpu.hourly_active_hw


@pytest.mark.parametrize("policy", [B.FF, B.BF, B.MCC, B.MECC, B.GRMU])
def test_telemetry_replay_on_card_equals_cpu(policy):
    """Scale 0.1 with telemetry: the same decisions, reasons and series on
    the card as on the CPU, and one pick per MCC/MECC arrival."""
    from repro_torch.obs import inscan
    _need_card()
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    events = B.build_events(vms, cluster)
    kw = dict(defrag=True, consolidation_interval=24.0) \
        if policy == B.GRMU else {}
    K.reset_launches()
    card, card_tele = inscan.replay_with_telemetry(events, policy,
                                                   device="cuda", **kw)
    arrivals = int((events.kind == B.ARRIVAL).sum())
    pick = {B.MCC: "mcc_pick", B.MECC: "ecc_pick"}.get(policy)
    assert K.LAUNCHES == {k: arrivals if k == pick else 0
                          for k in K.LAUNCHES}
    cpu, cpu_tele = inscan.replay_with_telemetry(events, policy,
                                                 device="cpu", **kw)
    assert card.accepted_ids == cpu.accepted_ids
    assert card.rejection_reasons == cpu.rejection_reasons
    assert card_tele.to_json_dict() == cpu_tele.to_json_dict()


@pytest.mark.parametrize("policy", [B.FF, B.BF, B.MCC, B.MECC, B.GRMU])
def test_telemetry_adds_no_host_synchronisation(policy):
    """torch's sync debug mode warns at each host synchronisation; over
    600 events, telemetry on warns exactly as often as off, once the
    first runs have put the tables on the card."""
    import warnings
    _need_card()
    cluster, vms = generate(TraceConfig(scale=0.1, seed=1))
    events = B.build_events(vms, cluster)
    kw = dict(defrag=True, consolidation_interval=24.0) \
        if policy == B.GRMU else {}
    trace = B.trace_from_numpy(B.trace_arrays(events), "cuda")

    def syncs(telemetry):
        st = B.replay_statics(events, policy, telemetry=telemetry, **kw)
        state = B.init_state(events, st, "cuda")
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                B.run_events(st, state, trace, B.default_heavy_capacity(
                    events), stop=600)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in seen)

    syncs(False), syncs(True)
    assert syncs(True) == syncs(False)


GRAPH_KW = {B.GRMU: dict(defrag=True, consolidation_interval=6.0)}


def _small_trace():
    cluster, vms = generate(TraceConfig(scale=0.05, seed=2))
    return B.build_events(vms, cluster)


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("policy", [B.FF, B.BF, B.MCC, B.MECC, B.GRMU])
def test_graph_replay_equals_the_eager_loop(policy, telemetry):
    """make_replay on the card replays captured graphs; its outputs equal
    the eager loop's (``run_events``) on the card, array for array."""
    _need_card()
    events = _small_trace()
    cap = B.default_heavy_capacity(events)
    kw = dict(GRAPH_KW.get(policy, {}), telemetry=telemetry)
    run = B.make_replay(events, policy, device="cuda", **kw)
    got = run(cap)
    assert run.runner.graphed and run.runner.graphs
    st = B.replay_statics(events, policy, **kw)
    state = B.run_events(st, B.init_state(events, st, "cuda"),
                         B.trace_from_numpy(B.trace_arrays(events), "cuda"),
                         cap)
    want = B._finalize(st, state)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("policy", [B.FF, B.BF, B.MCC, B.MECC, B.GRMU])
def test_graph_replay_synchronises_only_to_consolidate(policy):
    """Over a whole graph replay torch's sync debug mode warns at most once
    per consolidating step-end (GRMU's plan reads its candidates), so
    arrivals and departures make no host synchronisation."""
    import warnings
    _need_card()
    events = _small_trace()
    cap = B.default_heavy_capacity(events)
    run = B.make_replay(events, policy, device="cuda",
                        **GRAPH_KW.get(policy, {}))
    run(cap)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(cap)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # One warning per synchronising call; the mode's one-off notice that
    # it is a prototype does not count.
    syncs = sum("called a synchronizing" in str(w.message) for w in seen)
    n_cons = run.plan.keys.count((B.STEP_END, True))
    assert syncs <= n_cons
    assert (syncs > 0) == (n_cons > 0)     # the count sees real syncs
    if policy != B.GRMU:
        assert syncs == 0


@pytest.mark.parametrize("policy", [B.MCC, B.MECC])
def test_graph_replay_counts_its_picks(policy):
    """Each replay of a graph holding a pick adds the pick to LAUNCHES
    (one per arrival and replay); capture and warm-up add none, and a
    second make_replay of the same trace captures no new graph."""
    _need_card()
    events = _small_trace()
    arrivals = int((events.kind == B.ARRIVAL).sum())
    pick = "mcc_pick" if policy == B.MCC else "ecc_pick"
    K.reset_launches()
    run = B.make_replay(events, policy, device="cuda", score_backend="kernel")
    for _ in range(2):
        run(B.default_heavy_capacity(events))
    assert K.LAUNCHES == {k: 2 * arrivals if k == pick else 0
                          for k in K.LAUNCHES}
    graphs, seconds = len(run.runner.graphs), run.runner.capture_s
    again = B.make_replay(events, policy, device="cuda",
                          score_backend="kernel")
    again(B.default_heavy_capacity(events))
    assert again.runner is run.runner
    assert (len(run.runner.graphs), run.runner.capture_s) == (graphs,
                                                              seconds)


def test_each_mask_scores_entry_point_has_its_wrapper():
    """Every C entry point of mask_scores.cu (``mrt_<name>``) is loaded by
    the wrapper module and launched by ``mask_scores.<name>``, which
    counts it under ``LAUNCHES[<name>]``."""
    import inspect
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mask_scores.cu").read_text()
    block = src[src.index('extern "C" {'):]
    names = re.findall(r"^int mrt_(\w+)\(", block, re.M)
    assert sorted(names) == sorted(K.LAUNCHES) == sorted(
        ["cc", "frag", "mcc", "ecc", "mcc_pick", "ecc_pick"])
    for name in names:
        body = inspect.getsource(getattr(K, name))
        assert f'_launch("mrt_{name}"' in body
        assert f'LAUNCHES["{name}"] += 1' in body
        assert f'("mrt_{name}",' in inspect.getsource(K._lib.__wrapped__)


# (B, Sq, Sk, H, KV, hd, causal, window); hd an int, or MLA's (q/k, v)
# pair.
ATTN_CASES = [
    (2, 1000, 1000, 32, 4, 64, True, None),      # TinyLlama heads, ragged
    (1, 200, 333, 8, 2, 128, False, None),       # Sq != Sk, ragged
    (1, 300, 300, 4, 4, 32, True, 96),           # window, MHA
    (2, 256, 256, 8, 1, 64, True, None),         # MQA
    (8, 128, 128, 32, 4, 64, True, None),        # the requests' prefill
    (2, 450, 450, 8, 2, 32, True, 200),          # window over tiles, ragged
    (4, 4096, 4096, 32, 4, 64, True, None),      # the serving prefill
    (2, 256, 256, 4, 2, 16, True, None),         # the smoke configs' hd 16
    (1, 1000, 1000, 32, 32, 80, True, None),     # StableLM-3B, ragged
    (1, 1000, 1000, 32, 32, 112, True, 300),     # Zamba2-7B's shared attn
    (8, 1500, 1500, 8, 8, 64, False, None),      # Whisper's encoder
    (8, 448, 1500, 8, 8, 64, False, None),       # Whisper's cross attention
    (8, 448, 448, 8, 8, 64, True, None),         # Whisper's decoder
    (1, 1000, 1000, 40, 8, 128, True, None),     # Scout's GQA group of 5
    (2, 8192, 8192, 32, 32, 112, True, 4096),    # Zamba2-7B's prefill
    (1, 1000, 1000, 16, 16, (192, 128), True, None),  # MLA, ragged
    (1, 200, 333, 8, 2, (192, 128), False, None),     # MLA, Sq != Sk, GQA
    (4, 4096, 4096, 128, 128, (192, 128), True, None),  # MLA's prefill
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_kernel_equals_plain_version_on_card(case, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Sk, H, KV, hd, causal, window = case
    hd, hd_v = smoke.head_dims_of(hd)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd_v), generator=g, device="cuda").to(dtype)
    FA.reset_launches()
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    # One launch of this dtype's kernel, none of the other's, and for
    # float32 the split of q, k and v.
    key = FA.ROUTES[dtype][1]
    want = {k_: int(k_ == key) for k_ in FA.LAUNCHES}
    want[FA.SPLIT] = 3 if dtype == torch.float32 else 0
    assert FA.LAUNCHES == want
    # The plain version with chunks that divide Whisper's 1,500 frames.
    want = smoke.plain_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype and got.shape == (B, Sq, H, hd_v)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        # One rounding of a float32 result: within half a bf16 ulp of the
        # plain version in float32 (atol: float32 summation order).
        want32 = smoke.plain_attention(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        torch.testing.assert_close(got.float(), want32, rtol=2.0 ** -8,
                                   atol=1e-5)


def test_f32_attention_over_a_long_row_on_card():
    """Each key tile's p @ v is merged on the CUDA cores, so 256 tiles of
    one row hold the float32 tolerance (non-causal, Sk 16,384)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((1, 1024, 8, 64), generator=g, device="cuda")
    k = torch.randn((1, 16384, 2, 64), generator=g, device="cuda")
    v = torch.randn((1, 16384, 2, 64), generator=g, device="cuda")
    got = FA.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [1, 7, 1001, 4096, 1 << 20])
def test_split_kernel_equals_plain_version_bit_for_bit_on_card(n):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n + 1, generator=g, device="cuda")
    wide = torch.exp(torch.rand(n + 1, generator=g, device="cuda") * 174 - 87)
    for t in (x, x * 1e-36, wide * x.sign(), torch.zeros_like(x), x[1:]):
        got = FA.split_bf16x3(t)
        want = torch.stack(ref.split_bf16x3(t))
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_prefill_launches_the_kernel_once_per_layer():
    _need_card()
    cfg = get_config("tinyllama_1_1b").scaled(
        n_layers=3, d_model=512, n_heads=8, n_kv_heads=1, d_ff=1024,
        vocab=512)
    _prefill_launches_once_per_layer(cfg)


def test_hd80_prefill_launches_the_kernel_once_per_layer():
    """StableLM-3B's head dim 80 (d_model 320 over 4 heads), 3 layers."""
    _need_card()
    cfg = get_config("stablelm_3b").scaled(
        n_layers=3, d_model=320, n_heads=4, n_kv_heads=4, d_ff=640,
        vocab=512)
    assert cfg.resolved_head_dim == 80
    _prefill_launches_once_per_layer(cfg)


def _prefill_launches_once_per_layer(cfg):
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 100), device="cuda")
    step = registry.make_step(cfg, ShapeConfig("prefill_100", 100, 2,
                                               "prefill"))
    FA.reset_launches()
    logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert FA.LAUNCHES == smoke.launch_counts(
        FA, flash_attention=cfg.n_layers)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "deepseek_7b",
                                  "mistral_nemo_12b", "stablelm_3b"])
def test_smoke_config_prefill_on_card_equals_cpu(arch):
    """The smoke config (hd 16) in float32: prefill on the card (the
    float32 kernel) equals prefill on the CPU (the plain version, which
    tests/test_torch_llm.py holds against the JAX package)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import llm_decode as D
    cfg = get_smoke_config(arch)
    cpu, card = (M.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, device=dev)
                 for dev in ("cpu", "cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 200),
                           generator=torch.Generator().manual_seed(4))
    FA.reset_launches()
    got = D.prefill(card, tokens.cuda(), cfg, 200).cpu()
    assert FA.LAUNCHES["flash_attention_f32"] == cfg.n_layers
    want = D.prefill(cpu, tokens, cfg, 200)
    err = (got - want).norm() / want.norm()
    assert err <= 1e-4, err
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * max(1.0, want.abs().max().item()))


def test_whisper_smoke_on_card_equals_cpu():
    """Whisper's smoke config in float32: the encoder prefill (non-causal,
    64 frames) and forward over 24 tokens with cross attention to them
    (Sq != Sk) on the card (the float32 kernel) equal the CPU's (the plain
    version, which tests/test_torch_encdec.py holds against JAX)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("whisper_base")
    cpu, card = (M.init_params(cfg, torch.Generator().manual_seed(3),
                               torch.float32, device=dev)
                 for dev in ("cpu", "cuda"))
    g = torch.Generator().manual_seed(4)
    frames = torch.randn((2, 64, cfg.d_model), generator=g)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    step = {dev: registry.make_step(cfg, ShapeConfig("prefill_64", 64, 2,
                                                     "prefill"), device=dev)
            for dev in ("cpu", "cuda")}
    FA.reset_launches()
    got = step["cuda"](card, {"frames": frames.cuda()}).cpu()
    assert FA.LAUNCHES["flash_attention_f32"] == cfg.n_enc_layers
    want = step["cpu"](cpu, {"frames": frames})
    _hold_f32(got, want)
    enc = M.encode(cpu, frames, cfg)
    FA.reset_launches()
    got, _ = M.lm_forward(card, tokens.cuda(), cfg, encoder_out=enc.cuda())
    assert FA.LAUNCHES["flash_attention_f32"] == 2 * cfg.n_layers
    want, _ = M.lm_forward(cpu, tokens, cfg, encoder_out=enc)
    _hold_f32(got.cpu(), want)


@pytest.mark.parametrize("experts,T", [(4, 64), (16, 1024)])
def test_moe_apply_on_card_equals_cpu(experts, T):
    """Scout's smoke MoE (4 experts, capacity 8) and 16 experts at
    Scout's capacity 1.25 (drops) in float32: the same routes, slots and
    output on the card as on the CPU (which tests/test_torch_moe.py holds
    against JAX)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models.config import MoEConfig
    cfg = get_smoke_config("llama4_scout_17b_a16e")
    if experts != 4:
        cfg = cfg.scaled(moe=MoEConfig(n_experts=experts, top_k=1,
                                       n_shared=1, d_ff_expert=128))
    cpu, card = (M.init_params(cfg, torch.Generator().manual_seed(5),
                               torch.float32, device=dev)
                 for dev in ("cpu", "cuda"))
    x = torch.randn((1, T, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    got, aux = L.moe_apply(card.layers[0].ffn, x.cuda(), cfg)
    want, want_aux = L.moe_apply(cpu.layers[0].ffn, x, cfg)
    routes = [L.moe_route(m.layers[0].ffn, xt, cfg)
              for m, xt in ((card, x[0].cuda()), (cpu, x[0]))]
    for a, b in zip(routes[0][2:5], routes[1][2:5]):
        assert torch.equal(a.cpu(), b)
    assert (not routes[1][4].all()) == (experts == 16)
    _hold_f32(got.cpu(), want)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=0)


def _hold_f32(got, want):
    """tests/test_torch_llm.py's F32_TOL: relative L2 1e-4, max 1e-3 of
    max(1, max |want|)."""
    err = (got - want).norm() / want.norm()
    assert err <= 1e-4, err
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * max(1.0, want.abs().max().item()))


def test_head_dim_outside_the_list_raises_on_card():
    _need_card()
    q = torch.zeros((1, 64, 4, 72), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=re.escape(str(FA.HEAD_DIMS))):
        FA.flash_attention(q, q, q)
    # An unlisted (q/k, v) pair: 192 against 64.
    q = torch.zeros((1, 64, 4, 192), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match=re.escape(str(FA.HEAD_DIM_PAIRS))):
        FA.flash_attention(q, q, q[..., :64].contiguous())


def test_mla_model_on_card_equals_cpu():
    """chip_smoke's float32 narrow variant at MLA's head dims (q/k 192, v
    128; tests/test_torch_mla.py's hd192): prefill of 2 x 256 tokens (the
    float32 kernel at the pair, once a layer) and 32 decode steps on a
    float32 latent cache on the card equal the CPU's, caches too, within
    1e-4 / 1e-3 (``mla_card_vs_cpu``)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, res = smoke.mla_card_vs_cpu(torch)
    assert launches["flash_attention_f32"] == smoke.MLA_SMALL["n_layers"]
    assert set(res) == {"prefill", "decode", "cache c", "cache kr"}


def test_mla_prefill_launches_the_pair_kernel_once_per_layer():
    """A bf16 MLA model at DSV2_LAYERS layers (the narrow variant's widths,
    the real head dims): one launch of the bf16 kernel a layer, every call
    at q/k 192 against v 128, none on another route."""
    _need_card()
    cfg = smoke.mla_small_config().scaled(n_layers=smoke.DSV2_LAYERS)
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda")
    step = registry.make_step(cfg, ShapeConfig("prefill_256", 256, 2,
                                               "prefill"))
    dims = []

    def attend(q, k, v, causal=True, window=None):
        dims.append((q.shape[-1], k.shape[-1], v.shape[-1], causal))
        return FA.flash_attention(q, k, v, causal=causal, window=window)
    FA.reset_launches()
    with smoke.attention_as(attend):
        logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert dims == [(192, 192, 128, True)] * smoke.DSV2_LAYERS == [
        (192, 192, 128, True)] * 4
    assert FA.LAUNCHES == smoke.launch_counts(FA, flash_attention=4)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()


# ---------------------------------------------------------------------------
# The placement service on the card
# ---------------------------------------------------------------------------

SERVE_KW = {"GRMU": dict(consolidation_interval=6.0), "MECC": {},
            "FF": {}}


def _service(events, device, **cfg):
    from repro_torch.serve import PlacementService, ServeConfig
    return PlacementService.for_trace(events, ServeConfig(**cfg),
                                      device=device)


def _serve(events, device, svc=None, **cfg):
    from repro_torch.serve import requests_from_trace
    reqs, horizon = requests_from_trace(events)
    svc = svc or _service(events, device, **cfg)
    for r in reqs:
        while not svc.submit(r):
            svc.drain(max_batches=1)
    svc.drain()
    svc.flush(horizon)
    return svc


def _service_decisions(svc):
    return {v: (d.accepted, d.gpu, d.start, d.tier)
            for v, d in svc.decisions.items()}


@pytest.mark.parametrize("policy", ["GRMU", "MECC"])
def test_service_on_card_equals_cpu(policy):
    """A stream through the card's captured graphs decides as the CPU's
    eager step: every decision, the migrations, the accepted ids; MECC
    launches its pick once per arrival."""
    _need_card()
    events = _small_trace()
    cfg = dict(policy=policy, micro_batch=64, **SERVE_KW[policy])
    K.reset_launches()
    card = _serve(events, "cuda", **cfg)
    arrivals = int((events.kind == B.ARRIVAL).sum())
    assert K.LAUNCHES["ecc_pick"] == (arrivals if policy == "MECC" else 0)
    cpu = _serve(events, "cpu", **cfg)
    assert card.runner.graphed and card.runner.graphs
    assert _service_decisions(card) == _service_decisions(cpu)
    assert card.accepted_ids() == cpu.accepted_ids()
    assert card.migrations() == cpu.migrations()


def test_service_captures_again_after_eviction():
    """With the compile cache bounded to one entry, a GRMU -> FF -> GRMU
    ladder evicts each tier's runner when the other tier fetches its own;
    coming back, the service captures the graphs again (a closed runner
    refuses to replay keys it holds no graph for) and decides as the
    CPU."""
    from repro_torch.core import compile_cache
    _need_card()
    events = _small_trace()
    cfg = dict(tiers=("GRMU", "FF"), micro_batch=16, slo_s=0.0,
               recover_after=2)
    from repro_torch.serve import (PlacementService, ServeConfig,
                                   requests_from_trace)
    reqs, horizon = requests_from_trace(events)
    runs = {}
    prev = compile_cache.set_max_entries(1)
    try:
        for dev in ("cuda", "cpu"):
            svc = PlacementService.for_trace(events, ServeConfig(**cfg),
                                             device=dev)
            half = len(reqs) // 2
            for r in reqs[:half]:
                assert svc.submit(r)
            step = svc._step_fn
            svc.drain(max_batches=1)        # GRMU's batch, then FF
            first = step.runner
            svc.drain()
            assert svc.tier_name == "FF"
            svc.governor.slo_s = 1e9
            for r in reqs[half:]:
                assert svc.submit(r)
            svc.drain()
            svc.flush(horizon)
            assert svc.tier_name == "GRMU"
            if dev == "cuda":
                assert svc.runner.graphs and svc.runner is not first
                assert not first.graphs           # closed on eviction
                with pytest.raises(RuntimeError, match="no captured"):
                    first.replay([(B.DEPARTURE,)])
            runs[dev] = svc
    finally:
        compile_cache.set_max_entries(prev)
    assert compile_cache.cache_stats()["evictions"] > 0
    card, cpu = runs["cuda"], runs["cpu"]
    assert _service_decisions(card) == _service_decisions(cpu)
    assert card.migrations() == cpu.migrations()


@pytest.mark.parametrize("policy", ["FF", "MECC", "GRMU"])
def test_service_reads_back_once_per_batch(policy):
    """Once its graphs are captured, a stream synchronises with the host
    at most once per micro-batch (the copy of its arrivals' decisions)
    plus once per GRMU consolidating step-end.  (Building a service
    copies its tables to the card from pageable memory, which
    synchronises; that is outside the count.)"""
    import warnings
    _need_card()
    events = _small_trace()
    cfg = dict(policy=policy, micro_batch=64, **SERVE_KW[policy])
    _serve(events, "cuda", **cfg)
    svc = _service(events, "cuda", **cfg)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _serve(events, "cuda", svc)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message) for w in seen)
    st = B.replay_statics(events, B.__dict__[policy], **SERVE_KW[policy])
    n_cons = B.plan_events(
        st, B.trace_from_numpy(B.trace_arrays(events), "cpu"),
        last_cons=0.0).keys.count((B.STEP_END, True))
    assert 0 < syncs <= svc.batches + n_cons


def test_sharded_one_rank_over_nccl_on_card():
    """One rank on cuda:0 with NCCL, in a fresh process (this one may hold
    a gloo group already, and a process has one default group): the five
    policies through the sharded runners' captured graphs, unchunked and
    GRMU chunked, decide as the unsharded replay on the CPU."""
    from _torch_sharded_ranks import fleet_outputs
    from repro_torch.core import sharded as SH
    from repro_torch.core.bucketing import pad_events
    _need_card()
    events = pad_events(_small_trace(), shards=1)
    cap = B.default_heavy_capacity(events)
    grmu = dict(defrag=True, consolidation_interval=6.0)
    cfgs = {"FF": (B.FF, {}), "BF": (B.BF, {}), "MCC": (B.MCC, {}),
            "MECC": (B.MECC, {}), "GRMU": (B.GRMU, grmu)}
    runs = [(name, pol, kw, None) for name, (pol, kw) in cfgs.items()]
    runs.append(("GRMU-chunked", B.GRMU, grmu, 32))
    got = SH.spawn_fleet(fleet_outputs, 1, events, events, cap, runs,
                         timeout=300)
    assert got["indivisible"] is None
    for name, (pol, kw) in cfgs.items():
        res, _, graphs = got[name]
        assert graphs > 0, name
        cpu = B.replay(events, pol, cap, device="cpu", **kw)
        assert (res.accepted_ids, res.hourly_active_hw, res.migrations) == (
            cpu.accepted_ids, cpu.hourly_active_hw, cpu.migrations), name
    assert got["GRMU-chunked"][0].accepted_ids == got["GRMU"][0].accepted_ids


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_subquadratic_model_on_card_equals_cpu(arch):
    """chip_smoke's float32 variants (RWKV hd 64, 2 layers; the hybrid with
    window 64, attention hd 112, 5 layers of period 2): prefill of 2 x 256
    tokens and 100 decode steps on a float32 cache (the hybrid's 64-slot
    rings wrap) on the card equal the CPU's (which
    tests/test_torch_subquadratic.py holds against JAX), caches too:
    within 1e-4 / 1e-3, or twice what half a float32 ulp of noise moves
    the CPU's (``subq_card_vs_cpu``; the hybrid amplifies rounding)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    res = smoke.subq_card_vs_cpu(torch, arch)
    assert set(res) >= {"prefill", "decode"}
    if arch == "rwkv6_3b":
        assert all(r["bound"] == smoke.CARD_CPU_TOL for r in res.values())


def test_hybrid_prefill_launches_the_kernel_once_per_group():
    """A bf16 hybrid (3 groups of 2 and a layer left over, hd 112): one
    windowed launch of the bf16 kernel per shared-block call, none else."""
    _need_card()
    cfg = smoke.subq_small_config("zamba2_7b").scaled(n_layers=7)
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 256), device="cuda")
    step = registry.make_step(cfg, ShapeConfig("prefill_256", 256, 2,
                                               "prefill"))
    calls = []
    FA.reset_launches()
    with smoke.attention_as(smoke.recording_attention(calls)):
        logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert calls == [(True, 256, 256, 64)] * 3
    assert FA.LAUNCHES == smoke.launch_counts(FA, flash_attention=3)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", ["hd16_g1", "hd64_noncausal_g4",
                                  "hd64_window96", "hd128_g5",
                                  "mla_noncausal_g4"])
def test_attention_backward_equals_plain_version_on_card(name, dtype):
    """chip_smoke's phase 2c on a few of its cases: the forward's lse
    leaves its output bit for bit as serving's, the backward is
    deterministic, within half a bf16 ulp (+ float32 atol) of the plain
    backward, float32 within 2e-5 of float64 autograd, the lse within
    1e-5 of float64 logsumexp (``hold_attention_bwd``)."""
    _need_card()
    err = {}
    q, k, v, do, causal, window = smoke._bwd_inputs(
        torch, smoke.BWD_CASES[name], dtype)
    smoke.hold_attention_bwd(torch, name, q, k, v, do, causal, window, err)
    assert err["lse"] <= smoke.LSE_TOL


def test_attention_under_grad_launches_the_backward_on_card():
    """flash_attention under grad on CUDA tensors: one forward launch with
    its lse, one backward launch in backward(), gradients equal to
    flash_attention_bwd's."""
    _need_card()
    q, k, v, do, causal, window = smoke._bwd_inputs(
        torch, smoke.BWD_CASES["hd64_window96"], torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    FA.reset_launches()
    out = FA.flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == smoke.launch_counts(
        FA, flash_attention=1, flash_attention_bwd=1)
    o, lse, _ = FA._forward(q, k, v, causal, window, want_lse=True)
    want = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)


def test_backward_head_dim_outside_the_list_raises_on_card():
    _need_card()
    q = torch.zeros((1, 8, 2, 48), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="head dim 48"):
        FA.flash_attention_bwd(q, q, q, q, lse, q)


def test_train_step_on_card_launches_and_equals_cpu():
    """chip_smoke's phase 5g (b) on TinyLlama's smoke config (hd 16):
    two float32 train steps of 2 x 64 on the card equal the CPU's (losses,
    grad norms, the first step's gradient, moments, parameters) within
    CARD_CPU_TOL or TRAIN_NOISE_FACTOR times what half a float32 ulp of
    noise moves the CPU run, the whole trajectory held (the smoke config
    is not chaotic); each step launches the
    float32 forward twice a layer (the forward and its remat recompute)
    and the backward once (``train_card_vs_cpu``)."""
    _need_card()
    from repro_torch.configs import get_smoke_config
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("tinyllama_1_1b")
    launches, res = smoke.train_card_vs_cpu(torch, cfg, (2, 64), steps=2)
    assert launches["flash_attention_bwd_f32"] == 2 * cfg.n_layers
    assert not res["chaotic"] and set(res["bounds"]) == set(res["distances"])
    assert all(res["distances"][k] <= b for k, b in res["bounds"].items())


# The p_bf16 routes (JAX's ATTN_P_BF16; chip_smoke.py phase 2d's gates at
# smaller shapes): one case over one key chunk and one over two, a window
# crossing the chunk boundary, and a tie case (q and k from {-1, 0, 1}:
# exactly tied chunk maxima in many rows, held also on those rows alone
# and the forward's chunk statistics to ref.chunk_max_stats,
# ``hold_pbf16_ties`` / ``hold_pbf16_mstat``).
PB_GPU_CASES = {
    "g8_one_chunk": (2, 512, 512, 32, 4, 64, True, None),
    "window_two_chunks": (1, 2048, 2048, 8, 2, 64, True, 700),
    "mla_two_chunks": (1, 2048, 2048, 4, 4, (192, 128), True, None),
    "ties_window": (1, 2048, 2048, 8, 2, 64, True, 700),
    "ties_mla": (1, 2048, 2048, 4, 4, (192, 128), True, None),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PB_GPU_CASES))
def test_pbf16_forward_equals_plain_on_card(name, dtype):
    """Two launches of the p_bf16 forward under the flag are bitwise equal
    and lie within PB_SHARE of the flag's effect from the plain p_bf16
    version (``hold_pbf16_fwd``)."""
    _need_card()
    err = {}
    smoke.hold_pbf16_fwd(torch, name, PB_GPU_CASES[name],
                         getattr(torch, dtype), err)
    assert err[f"fwd {dtype}"][name] <= smoke.PB_SHARE


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(PB_GPU_CASES))
def test_pbf16_backward_equals_plain_on_card(name, dtype):
    """The p_bf16 backward (``hold_pbf16_bwd``): launches, two launches
    bitwise equal, each gradient within PB_SHARE of the flag's effect."""
    _need_card()
    err = {}
    smoke.hold_pbf16_bwd(torch, name, PB_GPU_CASES[name],
                         getattr(torch, dtype), err)
    assert len(err[f"bwd {dtype}"]) == 3


def test_pbf16_under_grad_launches_its_routes_on_card():
    """Under the flag and grad: one p_bf16 forward (with its lse and chunk
    statistics) and one p_bf16 backward launch, no float32-p route, and
    the gradients those of flash_attention_bwd on the same statistics; the
    flag restored after the block."""
    _need_card()
    from repro_torch.models import flags
    q, k, v, do, causal, window = smoke._bwd_inputs(
        torch, PB_GPU_CASES["window_two_chunks"], torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    FA.reset_launches()
    with smoke.p_bf16_flag():
        out = FA.flash_attention(*leaves, causal=causal, window=window)
    out.backward(do)
    torch.cuda.synchronize()
    assert flags.ATTN_P_BF16 is False
    assert FA.LAUNCHES == smoke.launch_counts(
        FA, flash_attention_pbf16=1, flash_attention_bwd_pbf16=1)
    o, lse, ms = FA._forward(q, k, v, causal, window, want_lse=True,
                             p_bf16=True)
    assert ms.shape == (1, 8, 2048, 2, FA.MSTAT_FIELDS)
    want = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window, p_bf16=True, mstat=ms)
    for x, w in zip(leaves, want):
        assert torch.equal(x.grad, w)


def test_pbf16_backward_without_its_statistics_raises_on_card():
    _need_card()
    q = torch.zeros((1, 8, 2, 64), device="cuda", dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="mstat"):
        FA.flash_attention_bwd(q, q, q, q, lse, q, p_bf16=True)


def test_default_routes_keep_the_parent_commits_bits_on_card():
    """Flag off, the float32-p routes' results at TinyLlama's shape equal
    the parent commit's (chip_smoke.DEFAULT_ROUTE_DIGESTS)."""
    _need_card()
    assert smoke.default_route_digests(torch) == smoke.DEFAULT_ROUTE_DIGESTS
