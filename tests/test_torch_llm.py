"""The port's LLM serving slice against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``) go through
both packages:

  * module by module: ``rmsnorm``, ``apply_rope`` (M-RoPE too, and
    ``default_mrope_sections``), ``attention_apply``, ``attention_decode``
    (output and cache), ``mlp_apply``;
  * the slice: ``lm_forward``, ``prefill`` and 8 ``decode_step``s (logits
    and cache) through ``registry.make_step``, for every dense and vlm
    architecture (the moe and encdec families are in test_torch_moe.py and
    test_torch_encdec.py, rwkv6 and hybrid in test_torch_subquadratic.py,
    mla_moe in test_torch_mla.py):
    its smoke config, and a 2-layer variant at
    the config's own head dim (``VARIANTS``: TinyLlama hd 64 with GQA 8:1,
    DeepSeek MHA hd 128, Mistral-NeMo hd 128 with H * hd != d_model,
    StableLM hd 80, Qwen2-VL hd 128 with GQA 3:1 and M-RoPE over 3-axis
    positions that differ per axis);
  * the registry, for every architecture the port runs (``ARCH_IDS``):
    configs, parameter counts, ``model_flops``,
    ``supported_cells`` and ``input_specs`` (meta tensors against JAX's
    ``ShapeDtypeStruct``s).

Tolerances, as (relative L2 error, max error over max(1, max |want|)):
float32 weights (1e-4, 1e-3), measured at most (3.8e-5, 1.4e-4), from
float32 sums taken in another order and amplified by the peaked softmax
of the reference's init; with float32 weights the decode cache is float32
in both packages (see test_decode_steps_equal_jax).  bfloat16 weights
(0.03, 0.15), measured at most (0.015, 0.062) on the smoke config's
logits, from matmuls that round to bf16 at other places; the elementwise
bound is the JAX package's own 0.15 (tests/test_archs.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JM
from repro.models.config import SHAPES as JSHAPES
from repro.serve import llm_decode as JD
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import convert, layers as L, registry
from repro_torch.models import transformer as M
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.serve import llm_decode as D

torch.set_num_threads(1)

ARCH = "tinyllama_1_1b"
F32_TOL = (1e-4, 1e-3)
BF16_TOL = (0.03, 0.15)

# Per architecture, a 2-layer variant at the config's own head dim: its
# name and the fields scaled.
VARIANTS = {
    "tinyllama_1_1b": ("hd64", dict(d_model=512, n_heads=8, n_kv_heads=1,
                                    d_ff=1024)),
    "deepseek_7b": ("hd128", dict(d_model=512, n_heads=4, n_kv_heads=4,
                                  d_ff=1024)),
    # head_dim 128 stays: H * hd = 512 against d_model 320.
    "mistral_nemo_12b": ("hd128", dict(d_model=320, n_heads=4, n_kv_heads=1,
                                       d_ff=640, head_dim=128)),
    "stablelm_3b": ("hd80", dict(d_model=320, n_heads=4, n_kv_heads=4,
                                 d_ff=640)),
    "qwen2_vl_2b": ("hd128", dict(d_model=384, n_heads=3, n_kv_heads=1,
                                  d_ff=768)),
}


def _variant(cfg, arch):
    return cfg.scaled(n_layers=2, vocab=512, **VARIANTS[arch][1])


def _configs():
    """{name: (port cfg, JAX cfg)}: each dense or vlm architecture's smoke
    config and its variant (the moe and encdec families have their own
    files, tests/test_torch_moe.py and test_torch_encdec.py).  TinyLlama's
    keep their names "smoke" and "hd64"; the others are "<arch>.smoke" and
    "<arch>.<variant>"."""
    out = {}
    for arch in (a for a in ARCH_IDS if a in VARIANTS):
        pre = "" if arch == ARCH else f"{arch}."
        out[pre + "smoke"] = (get_smoke_config(arch), jget_smoke(arch))
        out[pre + VARIANTS[arch][0]] = (_variant(get_config(arch), arch),
                                        _variant(jget_config(arch), arch))
    return out


CONFIGS = _configs()
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    """``tol = (l2, elem)``: relative L2 error <= l2, and every element
    within elem * max(1, max |want|).  Random weights of the reference's
    std give activations in the hundreds and a very peaked softmax, so a
    per-element relative test would be ruled by entries near 0."""
    l2, elem = tol
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= l2, f"relative L2 error {rel} > {l2}"
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=elem * scale)


def _pair(cfg_name, dtype_name, seed=0):
    """(port cfg, JAX cfg, port model, JAX params) with equal weights."""
    cfg, jcfg = CONFIGS[cfg_name]
    tdt, jdt = DTYPES[dtype_name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    assert model.embedding.dtype == tdt
    return cfg, jcfg, model, jp


def test_configs_are_the_jax_ones():
    """All ten architectures of the JAX zoo, in the JAX list's order; each
    config and smoke config is JAX's; any other name raises."""
    assert ARCH_IDS == ["qwen2_vl_2b", "llama4_scout_17b_a16e",
                        "deepseek_v2_236b", "deepseek_7b",
                        "mistral_nemo_12b", "stablelm_3b", "tinyllama_1_1b",
                        "whisper_base", "rwkv6_3b", "zamba2_7b"]
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jget_config(arch))), arch
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jget_smoke(arch))), arch
    assert (dataclasses.asdict(get_config("tinyllama-1.1b"))
            == dataclasses.asdict(jget_config("tinyllama-1.1b")))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in sorted(set(JARCH_IDS) - set(ARCH_IDS)) + ["made_up_7b"]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)


# Counts pinned beside JAX's (total_param_count, active_param_count): the
# sub-quadratic models (each fits one card whole in bf16) and DeepSeek-V2
# (160 experts top-6 + 2 shared; no card holds it whole).
PARAM_COUNTS = {"rwkv6_3b": 2_905_459_200, "zamba2_7b": 6_633_487_952,
                "deepseek_v2_236b": 238_851_281_920}
ACTIVE_PARAM_COUNTS = {"deepseek_v2_236b": 20_852_331_520}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert registry.total_param_count(cfg) == JR.total_param_count(jcfg)
    if arch in PARAM_COUNTS:
        assert registry.total_param_count(cfg) == PARAM_COUNTS[arch]
    assert registry.active_param_count(cfg) == JR.active_param_count(jcfg)
    if arch in ACTIVE_PARAM_COUNTS:
        assert registry.active_param_count(cfg) == ACTIVE_PARAM_COUNTS[arch]
    for name in SHAPES:
        assert registry.model_flops(cfg, SHAPES[name]) == JR.model_flops(
            jcfg, JSHAPES[name])


def test_supported_cells_equal_jax():
    """JAX's matrix, every architecture ported, in order."""
    assert registry.ALL_CELLS == JR.ALL_CELLS
    assert registry.supported_cells() == JR.supported_cells()
    # long_500k: only the sub-quadratic architectures.
    assert {a for a, s, ok, _ in registry.supported_cells()
            if s == "long_500k" and ok} == {"rwkv6_3b", "zamba2_7b"}


def _spec_shapes(tree):
    """{dotted name: (shape, dtype name)} of a tree of meta tensors or of
    JAX ShapeDtypeStructs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": s for n, s in _spec_shapes(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    """Meta tensors of JAX's shapes and dtypes for every kind (the
    full-size decode cache allocates nothing; the train kind's tokens,
    labels and the vlm / encdec stub-frontend inputs)."""
    for smoke in (False, True):
        for name, shape in SHAPES.items():
            got = registry.input_specs(arch, name, smoke=smoke)
            want = JR.input_specs(arch, name, smoke=smoke)
            assert _spec_shapes(got) == _spec_shapes(want), (arch, name)
            assert all(t.device.type == "meta" for t in jax.tree.leaves(
                got, is_leaf=lambda x: isinstance(x, torch.Tensor)))


# ---------------------------------------------------------------------------
# Module by module
# ---------------------------------------------------------------------------

def test_rmsnorm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    got = L.rmsnorm(torch.as_tensor(scale), torch.as_tensor(x))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(got, want, (1e-5, 1e-5))


@pytest.mark.parametrize("hd", [16, 64])
def test_apply_rope(hd):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e4)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(got, want, (1e-5, 1e-5))


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_apply_mrope(hd):
    """Sectioned rotation over random (3, B, S) positions, one axis per
    section, against JAX's apply_rope; (B, S) positions ignore the
    sections in both."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 7, 4, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4096, size=(3, 2, 7)).astype(np.int32)
    sections = L.default_mrope_sections(hd)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6,
                       sections)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    _close(got, want, (1e-5, 1e-5))
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3[0]), 1e6,
                       sections)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos3[0]), 1e6)
    _close(got, want, (1e-5, 1e-5))


def test_default_mrope_sections_equal_jax():
    for hd in range(16, 257, 2):
        got = L.default_mrope_sections(hd)
        assert got == JL.default_mrope_sections(hd), hd
        assert sum(got) == hd // 2
    assert L.default_mrope_sections(128) == (16, 24, 24)


def _layer_inputs(cfg, B=2, S=64, seed=3):
    """x (B, S, d_model) and positions: (B, S) 0..S-1, or for M-RoPE
    random (3, B, S) ids that differ per axis."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        return x, rng.integers(0, 4 * S, size=(3, B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    return x, pos


def _jax_layer(jp, i, part):
    return jax.tree.map(lambda a: a[i], jp["layers"][part])


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_attention_apply(cfg_name):
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    x, pos = _layer_inputs(cfg)
    got = L.attention_apply(model.layers[1].attn, torch.as_tensor(x), cfg,
                            torch.as_tensor(pos))
    want = JL.attention_apply(_jax_layer(jp, 1, "attn"), jnp.asarray(x),
                              jcfg, jnp.asarray(pos))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_attention_decode_output_and_cache(cfg_name):
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    B, S = 3, 8
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    shape = (B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    pos = np.array([0, 5, 11], np.int32)         # 11 wraps the ring (S 8)
    cache = {"k": torch.as_tensor(k0.copy()), "v": torch.as_tensor(v0.copy())}
    got, cache = L.attention_decode(model.layers[0].attn, torch.as_tensor(x),
                                    cfg, cache, torch.as_tensor(pos))
    want, jcache = JL.attention_decode(
        _jax_layer(jp, 0, "attn"), jnp.asarray(x), jcfg,
        {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}, jnp.asarray(pos))
    _close(got, want, F32_TOL)
    _close(cache["k"], jcache["k"], F32_TOL)
    _close(cache["v"], jcache["v"], F32_TOL)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_mlp_apply(cfg_name):
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    x, _ = _layer_inputs(cfg)
    got = L.mlp_apply(model.layers[0].ffn, torch.as_tensor(x))
    want = JL.mlp_apply(_jax_layer(jp, 0, "ffn"), jnp.asarray(x))
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_params_from_numpy_carries_every_leaf(dtype_name):
    _check_every_leaf("smoke", dtype_name)


@pytest.mark.parametrize("cfg_name", sorted(set(CONFIGS) - {"smoke"}))
def test_params_from_numpy_loads_every_config(cfg_name):
    """Every other config's tree carries across leaf by leaf (Mistral's
    non-square wq / wo included)."""
    _check_every_leaf(cfg_name, "f32")


def _check_every_leaf(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    names = set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        a = np.asarray(leaf).astype(np.float32)
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                name = ".".join(["layers", str(i)] + keys[1:])
                names.add(name)
                got = model.get_parameter(name)
                np.testing.assert_array_equal(_np(got), a[i], err_msg=name)
        else:
            name = ".".join(keys)
            names.add(name)
            np.testing.assert_array_equal(_np(model.get_parameter(name)), a)
    assert names == {n for n, _ in model.named_parameters()}


def test_init_params_keeps_the_jax_std_rule():
    """Layer matrices have std 1/sqrt(n_layers) (init_tree sees the stacked
    spec), the embedding 1/sqrt(vocab), norms are ones."""
    cfg = get_smoke_config(ARCH).scaled(n_layers=4)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, device="cpu")
    jp = JM.init_params(jget_smoke(ARCH).scaled(n_layers=4),
                        jax.random.PRNGKey(0), jnp.float32)
    for w, jw in ((model.layers[2].ffn.w_up, jp["layers"]["ffn"]["w_up"]),
                  (model.layers[0].attn.wq, jp["layers"]["attn"]["wq"])):
        assert abs(float(w.std()) - 0.5) < 0.05
        assert abs(float(np.std(np.asarray(jw))) - 0.5) < 0.05
    assert abs(float(model.embedding.std()) - 1 / 16) < 0.005
    assert torch.equal(model.final_norm.scale, torch.ones(cfg.d_model))
    a = M.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = M.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    assert a.embedding.dtype == torch.bfloat16
    assert torch.equal(a.layers[3].attn.wo, b.layers[3].attn.wo)


def test_loaded_model_is_freed_without_the_garbage_collector():
    """Loading builds no reference cycle: a model goes with its last
    reference, so a serving process that frees one model before building
    the next holds one at a time on the card."""
    import gc
    import weakref
    cfg = get_smoke_config(ARCH)
    jp = JM.init_params(jget_smoke(ARCH), jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    gc.collect()
    gc.disable()
    try:
        for build in (lambda: M.init_params(cfg, torch.Generator(),
                                            device="cpu"),
                      lambda: convert.params_from_numpy(tree, cfg,
                                                        device="cpu")):
            model = build()
            ref = weakref.ref(model)
            del model
            assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_lm_forward_and_prefill_equal_jax(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    tol = F32_TOL if dtype_name == "f32" else BF16_TOL
    tok = _tokens(cfg, 2, 64)
    got, aux = M.lm_forward(model, torch.as_tensor(tok), cfg)
    want, _ = JM.lm_forward(jp, jnp.asarray(tok), jcfg)
    assert got.dtype == DTYPES[dtype_name][0] and float(aux) == 0.0
    _close(got, want, tol)
    if cfg.mrope:
        # The frontend stub's 3-axis position ids, different per axis.
        _, pos3 = _layer_inputs(cfg, 2, 64, seed=6)
        got, _ = M.lm_forward(model, torch.as_tensor(tok), cfg,
                              mrope_positions=torch.as_tensor(pos3))
        want, _ = JM.lm_forward(jp, jnp.asarray(tok), jcfg,
                                mrope_positions=jnp.asarray(pos3))
        _close(got, want, tol)
    shape = ShapeConfig("prefill_64", 64, 2, "prefill")
    step = registry.make_step(cfg, shape, device="cpu")
    got = step(model, {"tokens": torch.as_tensor(tok)})
    want = JR.make_step(jcfg, shape)(jp, {"tokens": jnp.asarray(tok)})
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_decode_steps_equal_jax(cfg_name, dtype_name):
    """8 steps through make_step: logits each step, the cache at the end,
    and the teacher-forced steps against prefill's logits."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    tol = F32_TOL if dtype_name == "f32" else BF16_TOL
    B, S, T = 2, 16, 8
    tok = _tokens(cfg, B, T)
    shape = ShapeConfig("decode_16", S, B, "decode")
    step = registry.make_step(cfg, shape, device="cpu")
    jstep = JR.make_step(jcfg, shape)
    cache = D.init_cache(cfg, B, S, device="cpu")
    jcache = JD.init_cache(jcfg, B, S)
    if dtype_name == "f32":
        # Both packages' init_cache are bf16.  With float32 weights the
        # comparison runs on a float32 cache: in a bf16 one, a k that the
        # two round to neighbouring bf16 values (1 ulp, a float32 tie)
        # moves a later step's logits by 0.25 through the reference's
        # peaked softmax (hd64, step 6).
        cache = {k: v.float() for k, v in cache.items()}
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        got, cache = step(model, {"cache": cache,
                                  "tokens": torch.as_tensor(tok[:, t:t + 1]),
                                  "pos": torch.as_tensor(pos)})
        want, jcache = jstep(jp, {"cache": jcache,
                                  "tokens": jnp.asarray(tok[:, t:t + 1]),
                                  "pos": jnp.asarray(pos)})
        _close(got, want, tol)
    for key in ("k", "v"):
        assert str(cache[key].dtype) == "torch." + jcache[key].dtype.name
        _close(cache[key], jcache[key], tol)
    last = D.prefill(model, torch.as_tensor(tok), cfg, S)
    np.testing.assert_allclose(_np(got), _np(last), rtol=0.15, atol=0.15)


def test_train_kind_and_other_families_raise():
    """The train kind's step trains (one finite step that moves the
    parameters, on a batch of its input specs' shapes cut to the smoke
    size); a family no config has (every family of the zoo is ported)
    raises at the model and at the cache."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.train.optimizer import adamw_init
    cfg = get_smoke_config(ARCH)
    step = registry.make_step(cfg, SHAPES["train_4k"], device="cpu")
    model = M.make_trainable(M.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    wq = model.layers[0].attn.wq.detach().clone()
    shape = ShapeConfig("t", 32, 2, "train")
    batch = batch_for_step(cfg, shape, 0, device="cpu")
    specs = registry.train_input_specs(cfg, shape)
    assert {k: (v.shape, v.dtype) for k, v in batch.items()} == {
        k: (v.shape, v.dtype) for k, v in specs.items()}
    opt, metrics = step(model, adamw_init(M.stacked_params(model)), batch)
    assert int(opt.step) == 1 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(model.layers[0].attn.wq, wq)
    other = dataclasses.replace(cfg, family="made_up_family")
    assert other.family not in {get_config(a).family for a in ARCH_IDS}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.Transformer(other, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        D.init_cache(other, 1, 4, device="cpu")


def test_device_none_means_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: M.init_params(cfg, gen),
                 lambda: M.Transformer(cfg),
                 lambda: D.init_cache(cfg, 1, 4),
                 lambda: registry.make_step(cfg, SHAPES["prefill_32k"]),
                 lambda: convert.params_from_numpy({}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = M.init_params(cfg, gen, device="cpu")
    step = registry.make_step(cfg, SHAPES["prefill_32k"], device="cpu")
    assert step(model, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
                ).shape == (1, 1, cfg.vocab)
