"""The port's MLA + MoE (DeepSeek-V2, ``family="mla_moe"``) against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``) go through
both packages, on DeepSeek-V2's smoke config (q/k head dim 16 + 8 = 24
against v 16, 8 experts top-2, one shared, capacity 8) and on a 2-layer
variant at its real head dims (``CONFIGS["hd192"]``: nope 128 + rope 64 =
192 against v 128, d_model 256, 2 heads, 16 experts top-6 with 2 shared at
the published capacity 1.25, so prefill and decode drop tokens):

  * ``mla_apply`` (prefill attention through the kernel's wrapper, its
    plain version on the CPU) and ``mla_decode`` step by step against the
    latent cache (output and both cache entries, and a position past the
    cache, which writes nothing, as in JAX);
  * the slice: ``lm_forward`` (logits and the aux loss summed over
    layers), ``make_step``'s prefill and 8 ``decode_step``s (logits each
    step, the latent cache at the end); then the teacher-forced decode
    against prefill within 0.15 (the JAX package's bound), at a capacity
    where nothing drops (tests/test_torch_moe.py: at the served capacity
    the two are different functions);
  * the card script's MoE teacher-forced check on the MLA model
    (``chip_smoke.moe_teacher_forced``), its MLA form
    (``mla_teacher_forced``: bf16 reported, the gate in float32) and its
    float32 narrow variant (``chip_smoke.mla_small_config``, this file's
    hd192);
  * the plain attention at (192, 128) and (24, 16) against JAX's
    ``layers.flash_attention``, causal and non-causal (2e-5 in float32,
    tests/test_flash_attention.py's tolerance).

Tolerances are ``tests/test_torch_llm.py``'s (relative L2, max over
max(1, max |want|)): float32 F32_TOL (1e-4, 1e-3), bfloat16 BF16_TOL
(0.03, 0.15).  Measured at most: float32 (1.3e-5, 6.1e-5) on the slice's
logits (hd192's forward), 4.4e-6 on a decode step; bf16 (0.0034, 0.0071)
on the forward's logits, (1.0e-4, 2.7e-3) on hd192's q, k, v, and 0 on
every decode step and on the smoke config's layers.  In bf16
the JAX functions run under ``jax.disable_jit()`` (``_jax``): jitted on the
CPU, XLA skips the bf16 rounding of the router's bf16 matmul cast to
float32, which flips routes on bf16 ties (tests/test_torch_moe.py).  With
float32 weights the latent cache is float32 in both packages: the
reference's bf16 cache rounds ``c`` in decode only, which a float32 model's
prefill never does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JM
from repro.models.config import MLAConfig as JMLAConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.serve import llm_decode as JD
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import convert, layers as L, registry
from repro_torch.models import transformer as M
from repro_torch.models.config import MLAConfig, MoEConfig, ShapeConfig
from repro_torch.serve import llm_decode as D
from test_torch_llm import BF16_TOL, DTYPES, F32_TOL, _close, _np

torch.set_num_threads(1)

ARCH = "deepseek_v2_236b"
# The 2-layer variant at DeepSeek-V2's head dims (chip_smoke.py's float32
# narrow variant is this config).
HD192 = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, d_ff=512,
             vocab=512,
             mla=dict(kv_lora_rank=64, q_lora_rank=96, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
             moe=dict(n_experts=16, top_k=6, n_shared=2, d_ff_expert=64))


def _both(**kw):
    """(port cfg, JAX cfg): the smoke config scaled by ``kw`` (``mla`` and
    ``moe`` given as their configs' fields)."""
    out = []
    for get, Mla, Moe in ((get_smoke_config, MLAConfig, MoEConfig),
                          (jget_smoke, JMLAConfig, JMoEConfig)):
        extra = {k: C(**kw[k]) for k, C in (("mla", Mla), ("moe", Moe))
                 if k in kw}
        rest = {k: v for k, v in kw.items() if k not in extra}
        out.append(get(ARCH).scaled(**rest, **extra))
    return tuple(out)


CONFIGS = {"smoke": _both(), "hd192": _both(**HD192)}


def _pair(cfg_name, dtype_name, seed=0):
    """(port cfg, JAX cfg, port model, JAX params) with equal weights."""
    cfg, jcfg = CONFIGS[cfg_name]
    tdt, jdt = DTYPES[dtype_name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    assert model.embedding.dtype == tdt
    return cfg, jcfg, model, jp


def _jax(dtype_name, fn, *args, **kw):
    """A JAX function's result: jitted in float32, op by op in bf16."""
    if dtype_name == "f32":
        return fn(*args, **kw)
    with jax.disable_jit():
        return fn(*args, **kw)


def _tol(dtype_name):
    return F32_TOL if dtype_name == "f32" else BF16_TOL


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


def _x(cfg, dtype_name, shape, seed=3):
    """Activations of ``shape`` in the model dtype, the same in both."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype_name][1])
    return convert.tensor_from_numpy(np.asarray(jx)), jx


def _layer(jp, i, part):
    return jax.tree.map(lambda a: a[i], jp["layers"][part])


def test_config_head_dims():
    """DeepSeek-V2's published MLA and MoE, and the two configs' attention
    widths: q/k nope + rope against v."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == (
        60, 5120, 128, 102400)
    assert dataclasses.asdict(cfg.mla) == dict(
        kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
        nope_head_dim=128, v_head_dim=128)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared,
            cfg.moe.d_ff_expert) == (160, 6, 2, 1536)
    widths = {n: (c.mla.nope_head_dim + c.mla.rope_head_dim,
                  c.mla.v_head_dim) for n, (c, _) in CONFIGS.items()}
    assert widths == {"smoke": (24, 16), "hd192": (192, 128)}
    assert widths["hd192"] in FA.HEAD_DIM_PAIRS


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_params_from_numpy_carries_every_leaf(cfg_name):
    """The MLA leaves (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
    ``kv_norm``, ``wkv_b``, ``wo``) and the MoE's go across under the JAX
    names, leaf by leaf, with no special case."""
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    names = set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        a = np.asarray(leaf)
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                name = ".".join(["layers", str(i)] + keys[1:])
                names.add(name)
                np.testing.assert_array_equal(
                    _np(model.get_parameter(name)), a[i], err_msg=name)
        else:
            name = ".".join(keys)
            names.add(name)
            np.testing.assert_array_equal(_np(model.get_parameter(name)), a)
    assert names == {n for n, _ in model.named_parameters()}
    attn = model.layers[0].attn
    assert isinstance(attn, L.MLA)
    assert sorted(n for n, _ in attn.named_parameters()) == sorted(
        ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"])


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_mla_apply_equal_jax(cfg_name, dtype_name):
    """Layer 1's MLA over (2, 64, d) activations, positions 0..63; its
    attention call is the wrapper's with q/k at nope + rope against v."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    B, S = 2, 64
    x, jx = _x(cfg, dtype_name, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    calls = []

    def attend(q, k, v, causal=True, window=None):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      causal))
        return FA.flash_attention(q, k, v, causal=causal, window=window)
    saved = L.flash_attention
    L.flash_attention = attend
    try:
        got = L.mla_apply(model.layers[1].attn, x, cfg, torch.as_tensor(pos))
    finally:
        L.flash_attention = saved
    want = _jax(dtype_name, JL.mla_apply, _layer(jp, 1, "attn"), jx, jcfg,
                jnp.asarray(pos))
    assert got.dtype == x.dtype
    _close(got, want, _tol(dtype_name))
    m = cfg.mla
    qk = m.nope_head_dim + m.rope_head_dim
    H = cfg.n_heads
    assert calls == [((B, S, H, qk), (B, S, H, qk), (B, S, H, m.v_head_dim),
                      True)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_mla_qkv_equal_jax(cfg_name, dtype_name):
    """q, k, v, the latent and the shared rotated key; k's rope part is
    k_rope repeated over the heads, materialised (contiguous)."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    B, S = 2, 32
    x, jx = _x(cfg, dtype_name, (B, S, cfg.d_model), seed=8)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    got = L._mla_qkv(model.layers[0].attn, x, cfg, torch.as_tensor(pos))
    want = _jax(dtype_name, JL._mla_qkv, _layer(jp, 0, "attn"), jx, jcfg,
                jnp.asarray(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, _tol(dtype_name))
    k, k_rope = got[1], got[4]
    qk_n = cfg.mla.nope_head_dim
    assert k.is_contiguous()
    assert torch.equal(k[..., qk_n:],
                       k_rope.expand(B, S, cfg.n_heads, -1).to(k.dtype))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_mla_decode_step_by_step_equal_jax(cfg_name, dtype_name):
    """Layer 0's ``mla_decode`` over 8 steps from a zero latent cache of 12
    positions: each step's output and, after it, both cache entries.  The
    cache is the model's dtype (float32 for float32 weights)."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    tdt, jdt = DTYPES[dtype_name]
    B, S, T = 2, 12, 8
    m = cfg.mla
    cache = {"c": torch.zeros((B, S, m.kv_lora_rank), dtype=tdt),
             "kr": torch.zeros((B, S, 1, m.rope_head_dim), dtype=tdt)}
    jcache = {k: jnp.zeros(v.shape, jdt) for k, v in cache.items()}
    attn, jattn = model.layers[0].attn, _layer(jp, 0, "attn")
    xs, jxs = _x(cfg, dtype_name, (T, B, 1, cfg.d_model), seed=9)
    tol = _tol(dtype_name)
    for t in range(T):
        pos = np.array([t, t + 2], np.int32)
        got, cache = L.mla_decode(attn, xs[t], cfg, cache,
                                  torch.as_tensor(pos))
        want, jcache = _jax(dtype_name, JL.mla_decode, jattn, jxs[t], jcfg,
                            jcache, jnp.asarray(pos))
        _close(got, want, tol)
        for key in ("c", "kr"):
            assert cache[key].dtype == tdt
            _close(cache[key], jcache[key], tol)


def test_mla_decode_past_the_cache_writes_nothing():
    """A position at or past S writes no slot (JAX selects ``arange(S) ==
    pos``; there is no ring) and attends over all S; the others write
    theirs."""
    cfg, jcfg, model, jp = _pair("hd192", "f32")
    B, S = 3, 8
    m = cfg.mla
    rng = np.random.default_rng(11)
    c0 = rng.normal(size=(B, S, m.kv_lora_rank)).astype(np.float32)
    kr0 = rng.normal(size=(B, S, 1, m.rope_head_dim)).astype(np.float32)
    x, jx = _x(cfg, "f32", (B, 1, cfg.d_model), seed=12)
    pos = np.array([0, 5, S + 3], np.int32)
    cache = {"c": torch.as_tensor(c0.copy()),
             "kr": torch.as_tensor(kr0.copy())}
    got, cache = L.mla_decode(model.layers[1].attn, x, cfg, cache,
                              torch.as_tensor(pos))
    jcache = {"c": jnp.asarray(c0), "kr": jnp.asarray(kr0)}
    want, jcache = JL.mla_decode(_layer(jp, 1, "attn"), jx, jcfg, jcache,
                                 jnp.asarray(pos))
    _close(got, want, F32_TOL)
    for key, before in (("c", c0), ("kr", kr0)):
        _close(cache[key], jcache[key], F32_TOL)
        np.testing.assert_array_equal(cache[key][2].numpy(), before[2])
        assert not np.array_equal(cache[key][1].numpy(), before[1])


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_lm_forward_and_prefill_equal_jax(cfg_name, dtype_name):
    """Logits and the MoE's aux loss summed over the layers (as the moe
    family's); the prefill kind's last-token logits through make_step."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    tol = _tol(dtype_name)
    tok = _tokens(cfg, 2, 64)
    got, aux = M.lm_forward(model, torch.as_tensor(tok), cfg)
    want, jaux = _jax(dtype_name, JM.lm_forward, jp, jnp.asarray(tok), jcfg)
    assert got.dtype == DTYPES[dtype_name][0]
    _close(got, want, tol)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    shape = ShapeConfig("prefill_64", 64, 2, "prefill")
    got = registry.make_step(cfg, shape, device="cpu")(
        model, {"tokens": torch.as_tensor(tok)})
    want = _jax(dtype_name, JR.make_step(jcfg, shape), jp,
                {"tokens": jnp.asarray(tok)})
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    _close(got, want, tol)


def _nodrop(cfg, Moe):
    """``cfg`` at a capacity where nothing drops (cf = E / K, C = T)."""
    m = cfg.moe
    return cfg.scaled(moe=Moe(**{**dataclasses.asdict(m),
                                 "capacity_factor": m.n_experts / m.top_k}))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_decode_steps_equal_jax(cfg_name, dtype_name):
    """8 steps through make_step at the config's capacity: logits each step
    and the latent cache at the end (its dtype JAX's).  Then, at a
    capacity where nothing drops, the teacher-forced steps against
    prefill's logits within 0.15."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    tol = _tol(dtype_name)
    B, S, T = 2, 16, 8
    tok = _tokens(cfg, B, T)
    shape = ShapeConfig("decode_16", S, B, "decode")
    cache = D.init_cache(cfg, B, S, device="cpu")
    jcache = JD.init_cache(jcfg, B, S)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "c": ((cfg.n_layers, B, S, cfg.mla.kv_lora_rank), torch.bfloat16),
        "kr": ((cfg.n_layers, B, S, 1, cfg.mla.rope_head_dim),
               torch.bfloat16)}
    if dtype_name == "f32":
        cache = {k: v.float() for k, v in cache.items()}
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
    step = registry.make_step(cfg, shape, device="cpu")
    jstep = JR.make_step(jcfg, shape)
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        got, cache = step(model, {"cache": cache,
                                  "tokens": torch.as_tensor(tok[:, t:t + 1]),
                                  "pos": torch.as_tensor(pos)})
        want, jcache = _jax(dtype_name, jstep, jp, {
            "cache": jcache, "tokens": jnp.asarray(tok[:, t:t + 1]),
            "pos": jnp.asarray(pos)})
        _close(got, want, tol)
    for key in ("c", "kr"):
        assert str(cache[key].dtype) == "torch." + jcache[key].dtype.name
        _close(cache[key], jcache[key], tol)
    whole = _nodrop(cfg, MoEConfig)
    cache = {k: torch.zeros_like(v) for k, v in cache.items()}
    for t in range(T):
        got, cache = D.decode_step(model, cache,
                                   torch.as_tensor(tok[:, t:t + 1]),
                                   torch.full((B,), t), whole)
    last = D.prefill(model, torch.as_tensor(tok), whole, S)
    np.testing.assert_allclose(_np(got), _np(last), rtol=0.15, atol=0.15)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_float32_model_on_the_bf16_latent_cache_equals_jax(cfg_name):
    """``init_cache``'s bf16 latent cache under a float32 model, as both
    packages build it: the new latent is rounded into the cache, and the
    re-expansion ``c @ wkv_b`` and the concatenated key run in float32 (as
    jnp promotes bf16 with float32).  5 steps through make_step: logits and
    cache, float32 tolerance."""
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    B, S, T = 2, 8, 5
    tok = _tokens(cfg, B, T, seed=14)
    shape = ShapeConfig("decode_8", S, B, "decode")
    step = registry.make_step(cfg, shape, device="cpu")
    jstep = JR.make_step(jcfg, shape)
    cache = D.init_cache(cfg, B, S, device="cpu")
    jcache = JD.init_cache(jcfg, B, S)
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        got, cache = step(model, {"cache": cache,
                                  "tokens": torch.as_tensor(tok[:, t:t + 1]),
                                  "pos": torch.as_tensor(pos)})
        want, jcache = jstep(jp, {"cache": jcache,
                                  "tokens": jnp.asarray(tok[:, t:t + 1]),
                                  "pos": jnp.asarray(pos)})
        assert got.dtype == torch.float32
        _close(got, want, F32_TOL)
    for key in ("c", "kr"):
        assert cache[key].dtype == torch.bfloat16
        _close(cache[key], jcache[key], F32_TOL)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_teacher_forced_decode_equals_jax_prefill(cfg_name, dtype_name):
    """At a capacity where nothing drops, the port's decode over a prompt
    (its latent cache in the model's dtype) ends within 0.15 of JAX's
    prefill of the same prompt."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    whole, jwhole = _nodrop(cfg, MoEConfig), _nodrop(jcfg, JMoEConfig)
    B, T = 2, 8
    tok = _tokens(cfg, B, T, seed=6)
    cache = {k: v.to(model.embedding.dtype)
             for k, v in D.init_cache(whole, B, T, device="cpu").items()}
    for t in range(T):
        got, cache = D.decode_step(model, cache,
                                   torch.as_tensor(tok[:, t:t + 1]),
                                   torch.full((B,), t), whole)
    want = _jax(dtype_name, JD.prefill, jp, jnp.asarray(tok), jwhole, T)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.15, atol=0.15)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_chip_smoke_moe_teacher_forced_on_mla(cfg_name, dtype_name):
    """The card script's MoE teacher-forced check (decode steps taking
    prefill's routes, nothing dropped) runs the MLA model through its
    latent cache on the CPU; in float32 each step's own routes are
    prefill's."""
    from test_torch_boundary import _chip_smoke
    smoke = _chip_smoke()
    cfg, jcfg, model, _ = _pair(cfg_name, dtype_name)
    tok = torch.as_tensor(_tokens(cfg, 2, 8))
    got = smoke.moe_teacher_forced(torch, model, cfg, tok)
    assert got["capacity_factor"] == cfg.moe.n_experts / cfg.moe.top_k
    assert got["own_route_agreement"] >= smoke.MOE_ROUTE_AGREEMENT
    if dtype_name == "f32":
        assert got["own_route_agreement"] == 1.0
        assert got["relative_l2"] < 1e-5


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_chip_smoke_mla_teacher_forced(dtype_name):
    """The card script's MLA teacher-forced check on the CPU (smoke
    config): the model's own figures reported, its routes agreeing with
    prefill's, and the gate on a float32 model of DSV2_F32_LAYERS layers
    with a float32 latent cache of the prompts' length, within 0.15 and
    in fact to float32 rounding."""
    from test_torch_boundary import _chip_smoke
    smoke = _chip_smoke()
    cfg, _, model, _ = _pair("smoke", dtype_name)
    tok = torch.as_tensor(_tokens(cfg, 2, 8, seed=13))
    got = smoke.mla_teacher_forced(torch, cfg, model, tok)
    assert got["bf16"]["own_route_agreement"] >= smoke.MOE_ROUTE_AGREEMENT
    assert set(got["bf16"]) >= {"relative_l2", "within_0.15"}
    # On the CPU both prefills run the plain version: the same figures.
    assert got["bf16_plain_attention"] == got["bf16"]
    f32 = got["float32"]
    assert f32["layers"] == smoke.DSV2_F32_LAYERS == 2
    assert f32["within_0.15"] and f32["own_route_agreement"] == 1.0
    assert f32["relative_l2"] < 1e-5


def test_chip_smoke_narrow_variant_is_this_files():
    """chip_smoke.py's float32 card-vs-CPU model is this file's hd192
    variant, and it decodes past nothing: its cache holds the prefill and
    every step."""
    from test_torch_boundary import _chip_smoke
    smoke = _chip_smoke()
    assert smoke.mla_small_config() == CONFIGS["hd192"][0]
    assert smoke.MLA_SMALL_STEPS <= smoke.MLA_SMALL_S


# (B, Sq, Sk, H, hd, hd_v, causal): the plain attention at MLA's widths.
PAIR_CASES = {
    "hd192_causal": (1, 256, 256, 2, 192, 128, True),
    "hd192_noncausal": (1, 128, 320, 2, 192, 128, False),
    "smoke_causal": (2, 128, 128, 4, 24, 16, True),
    "smoke_noncausal": (2, 64, 192, 4, 24, 16, False),
}


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_plain_attention_at_unequal_widths_equals_jax(name):
    """``flash_attention_ref`` (and the wrapper on CPU tensors) with v
    narrower than q/k against JAX's ``layers.flash_attention`` (``hd_v =
    v.shape[-1]``, scale 1 / sqrt(hd)), float32 within 2e-5, at 64-row
    chunks and at the default ones."""
    B, Sq, Sk, H, hd, hd_v, causal = PAIR_CASES[name]
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (B, Sq, H, hd), (B, Sk, H, hd), (B, Sk, H, hd_v)))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for chunk in (64, None):
        kw = {} if chunk is None else dict(q_chunk=chunk, k_chunk=chunk)
        got = flash_attention_ref(tq, tk, tv, causal=causal, **kw)
        want = JL.flash_attention(jq, jk, jv, causal=causal, **kw)
        assert tuple(got.shape) == (B, Sq, H, hd_v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    FA.reset_launches()
    assert torch.equal(FA.flash_attention(tq, tk, tv, causal=causal),
                       flash_attention_ref(tq, tk, tv, causal=causal))
    assert sum(FA.LAUNCHES.values()) == 0
