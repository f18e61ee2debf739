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
kernel once per layer.  A replay with telemetry on must give the CPU's
decisions, reasons and series, with one pick per MCC/MECC arrival.  The
replay's captured graphs must give the eager loop's outputs for all five
policies, synchronise with the host only at GRMU's consolidations, and
count one pick per arrival and replay.  The placement service must decide
on the card as on the CPU (GRMU, MECC), capture its graphs again after
the compile cache evicted its runner, and read back at most once per
micro-batch (plus GRMU's consolidations).
"""
import re

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


# (B, Sq, Sk, H, KV, hd, causal, window)
ATTN_CASES = [
    (2, 1000, 1000, 32, 4, 64, True, None),      # TinyLlama heads, ragged
    (1, 200, 333, 8, 2, 128, False, None),       # Sq != Sk, ragged
    (1, 300, 300, 4, 4, 32, True, 96),           # window, MHA
    (2, 256, 256, 8, 1, 64, True, None),         # MQA
    (8, 128, 128, 32, 4, 64, True, None),        # the requests' prefill
    (2, 450, 450, 8, 2, 32, True, 200),          # window over tiles, ragged
    (4, 4096, 4096, 32, 4, 64, True, None),      # the serving prefill
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_kernel_equals_plain_version_on_card(case, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Sq, Sk, H, KV, hd, causal, window = case
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device="cuda").to(dtype)
    FA.reset_launches()
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    # One launch of this dtype's kernel, none of the other's, and for
    # float32 the split of q, k and v.
    key = FA.ROUTES[dtype][1]
    want = {k_: int(k_ == key) for k_ in FA.LAUNCHES}
    want[FA.SPLIT] = 3 if dtype == torch.float32 else 0
    assert FA.LAUNCHES == want
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        # One rounding of a float32 result: within half a bf16 ulp of the
        # plain version in float32 (atol: float32 summation order).
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
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
    model = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 100), device="cuda")
    step = registry.make_step(cfg, ShapeConfig("prefill_100", 100, 2,
                                               "prefill"))
    FA.reset_launches()
    logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    assert FA.LAUNCHES == {"flash_attention": cfg.n_layers,
                           "flash_attention_f32": 0, "split_bf16x3": 0}
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
