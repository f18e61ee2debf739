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
kernel once per layer.
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
