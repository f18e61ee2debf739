"""The port's sub-quadratic families against the JAX package, on the CPU:
RWKV-6 (``family="rwkv6"``, RWKV-6-3B) and the Mamba-2 hybrid with a
weight-shared, sliding-window attention block (``family="hybrid"``,
Zamba2-7B).

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``) go through
both packages, on each model's smoke config and on a narrow variant at the
model's own head dims (``CONFIGS``): RWKV hd 64; a hybrid of 5 Mamba-2
layers with period 2 (two groups and a layer left over, so
``hybrid_forward``'s remainder runs) whose shared attention has hd 112 and
window 64, SSM head dim 64, state 64, chunk 128 at S 256 (two chunks, the
window masking).  For each, in float32 and bf16:

  * ``lm_forward`` and ``make_step``'s prefill;
  * ``decode_step`` through ``make_step`` over more steps than the ring
    holds (the hybrid's ring wraps): logits every step, then every cache
    entry with its dtype (the RWKV carries float32 in a float32 model
    after the first step, as JAX's); and the teacher-forced decode's
    logits against ``lm_forward``'s at the same positions within 0.15
    (the ring holds the window, so both see the same keys): RWKV in both
    dtypes, the hybrid in float32 (``test_decode_steps_equal_jax``);
  * the loaded tree (the hybrid's unstacked ``shared`` block), the init's
    std rule, JAX ``forward``'s hybrid quirk (the Mamba-2 layers alone),
    and long_500k's meta ``input_specs`` (a cache the size of a 4,096-slot
    one).

Tolerances (``_hold``).  RWKV: ``tests/test_torch_llm.py``'s F32_TOL and
BF16_TOL.  The hybrid at the reference's init is the zoo's worst-
conditioned model: dt = softplus(x @ in_proj) reaches ~20 and the chunked
form takes differences of cumsums of -dt over 128 positions.  Each
Mamba-2 layer's float32 output is ~4e-6 (relative L2) from float64 in
both packages alike (hd112 layer 0: port 3.75e-6, JAX 4.11e-6; 4.9e-6
apart, though the port's ``_cumsum`` equals JAX's bit for bit: the
einsums and reductions sum in other orders), and seven blocks amplify
it: half a float32 ulp of noise on the shared attention's output alone
moves the hd112 logits by 4.1e-4.  Float32 logits measured at most
(1.07e-4, 7.5e-4) apart over a forward and (1.7e-4, 2.4e-4) at a decode
step, over three seeds, so HYBRID_F32_TOL.  In bf16
each block is ~3e-4 apart (a tenth of an ulp) but the model amplifies
roundings far more: the bf16 model's logits are 0.14-0.30 (relative L2)
from its own float32 model's in both packages, port and JAX 0.006-0.065
apart over a forward and 0.02-0.05 over a decode, elementwise up to 0.57
of the logits' scale.  So in bf16 the hybrid is held to a relative L2 of
HYBRID_BF16_L2 and to JAX's distance from the float32 model's logits
(JAX's bf16 weights upcast): the port's may be at most HYBRID_BF16_RATIO
times JAX's (measured 0.98-1.02).  The teacher-forced check runs on the
hybrid in float32 with float32 rings (decode and forward measured ~1e-5
apart: one function).  With the reference's bf16 rings a float32 model's
keys are rounded in decode and not in the forward, which moves the first
shared block's output by 2e-3 and the logits by 0.16; in bf16 the two
forms part by rounding in JAX itself (elementwise up to 4.6 times the
0.15 bound on hybrid.hd112), as in the port.  With float32 weights the
hybrid's rings are float32 in both packages throughout this file.  In bf16
the JAX functions run under ``jax.disable_jit()`` (``_jax``): jitted on
the CPU, XLA skips the bf16 rounding of a bf16 matmul cast to float32
(tests/test_torch_moe.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import registry as JR
from repro.models import transformer as JM
from repro.models.config import SSMConfig as JSSMConfig
from repro.serve import llm_decode as JD
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, registry
from repro_torch.models import transformer as M
from repro_torch.models.config import SHAPES, SSMConfig, ShapeConfig
from repro_torch.serve import llm_decode as D
from test_torch_llm import BF16_TOL, DTYPES, F32_TOL, _close, _np

torch.set_num_threads(1)


def _both(arch, **kw):
    """(port cfg, JAX cfg): ``arch``'s smoke config scaled by ``kw``
    (``ssm`` given as SSMConfig fields)."""
    ssm = kw.pop("ssm", None)
    out = []
    for get, SSM in ((get_smoke_config, SSMConfig),
                     (jget_smoke, JSSMConfig)):
        extra = {"ssm": SSM(**ssm)} if ssm else {}
        out.append(get(arch).scaled(**kw, **extra))
    return tuple(out)


# name: ((port cfg, JAX cfg), prefill length, decode cache length, decode
# steps).  The hybrids decode past their ring (W = min(window, max_seq)
# = the window) and prefill a multiple of their chunk.
CONFIGS = {
    "rwkv.smoke": (_both("rwkv6_3b"), 32, 16, 12),
    "rwkv.hd64": (_both("rwkv6_3b", d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab=512, ssm=dict(head_dim=64)),
                  32, 16, 12),
    "hybrid.smoke": (_both("zamba2_7b"), 64, 64, 96),
    "hybrid.hd112": (_both("zamba2_7b", n_layers=5, d_model=224, n_heads=2,
                           n_kv_heads=2, d_ff=448, vocab=512,
                           shared_attn_period=2, sliding_window=64,
                           ssm=dict(d_state=64, head_dim=64, expand=2,
                                    chunk=128)),
                     256, 256, 72),
}


def _pair(cfg_name, dtype_name, seed=0):
    """(port cfg, JAX cfg, port model, JAX params) with equal weights."""
    cfg, jcfg = CONFIGS[cfg_name][0]
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


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


HYBRID_F32_TOL = (3e-4, 3e-3)
HYBRID_BF16_L2 = 0.1
HYBRID_BF16_RATIO = 1.1


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _hold(cfg, dtype_name, got, want, f32_model=None):
    """The port's ``got`` against JAX's ``want`` at the family's tolerance
    (the module's docstring); for the bf16 hybrid also, where given, each
    against ``f32_model``, the float32 model's output."""
    if cfg.family != "hybrid":
        _close(got, want, F32_TOL if dtype_name == "f32" else BF16_TOL)
    elif dtype_name == "f32":
        _close(got, want, HYBRID_F32_TOL)
    else:
        rel = _rel(got, want)
        assert rel <= HYBRID_BF16_L2, f"relative L2 error {rel}"
        if f32_model is not None:
            port, jax_ = _rel(got, f32_model), _rel(want, f32_model)
            assert port <= HYBRID_BF16_RATIO * jax_, (port, jax_)


def _f32_logits(jp, jcfg, tok):
    """JAX's float32 model on ``jp``'s weights upcast: logits over tok."""
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return JM.lm_forward(jp32, jnp.asarray(tok), jcfg)[0]


def test_configs_resolve_the_families():
    """The narrow variants keep the models' head dims, and the hybrid's
    remainder branch runs (5 layers, period 2)."""
    assert CONFIGS["rwkv.hd64"][0][0].ssm.head_dim == 64
    cfg = CONFIGS["hybrid.hd112"][0][0]
    assert cfg.resolved_head_dim == 112 == get_config(
        "zamba2_7b").resolved_head_dim
    assert cfg.n_layers % cfg.shared_attn_period == 1
    full = get_config("zamba2_7b")
    assert (full.n_layers // full.shared_attn_period,
            full.n_layers % full.shared_attn_period) == (13, 3)
    assert M.FAMILIES == ("dense", "vlm", "moe", "mla_moe", "encdec",
                          "rwkv6", "hybrid")


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_lm_forward_and_prefill_equal_jax(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    S = CONFIGS[cfg_name][1]
    tok = _tokens(cfg, 2, S)
    ref = _f32_logits(jp, jcfg, tok)
    got, aux = M.lm_forward(model, torch.as_tensor(tok), cfg)
    want, _ = _jax(dtype_name, JM.lm_forward, jp, jnp.asarray(tok), jcfg)
    assert got.dtype == DTYPES[dtype_name][0] and float(aux) == 0.0
    _hold(cfg, dtype_name, got, want, ref)
    shape = ShapeConfig(f"prefill_{S}", S, 2, "prefill")
    step = registry.make_step(cfg, shape, device="cpu")
    got = step(model, {"tokens": torch.as_tensor(tok)})
    want = _jax(dtype_name, JR.make_step(jcfg, shape), jp,
                {"tokens": jnp.asarray(tok)})
    assert tuple(got.shape) == (2, 1, cfg.vocab)
    _hold(cfg, dtype_name, got, want, ref[:, -1:])


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_decode_steps_equal_jax(cfg_name, dtype_name):
    """T steps through make_step, past the hybrid's ring: logits each
    step, every cache entry and its dtype at the end, and the teacher-
    forced steps against lm_forward's logits at the same positions (the
    bf16 hybrid's logits are held over all steps at once, and not against
    its forward: the module's docstring)."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    _, _, max_seq, T = CONFIGS[cfg_name]
    bf16_hybrid = cfg.family == "hybrid" and dtype_name == "bf16"
    B = 2
    tok = _tokens(cfg, B, T)
    shape = ShapeConfig(f"decode_{max_seq}", max_seq, B, "decode")
    step = registry.make_step(cfg, shape, device="cpu")
    jstep = JR.make_step(jcfg, shape)
    if dtype_name == "f32":
        jstep = jax.jit(jstep)      # one compile, not one a step
    cache = D.init_cache(cfg, B, max_seq, device="cpu")
    jcache = JD.init_cache(jcfg, B, max_seq)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in cache.items()} == {
        k: (v.shape, "torch." + v.dtype.name) for k, v in jcache.items()}
    if cfg.family == "hybrid":
        assert cache["shared_k"].shape[2] == cfg.sliding_window < T
        if dtype_name == "f32":
            for k in ("shared_k", "shared_v"):
                cache[k] = cache[k].float()
                jcache[k] = jcache[k].astype(jnp.float32)
    steps, jsteps = [], []
    for t in range(T):
        pos = np.full((B,), t, np.int32)
        got, cache = step(model, {"cache": cache,
                                  "tokens": torch.as_tensor(tok[:, t:t + 1]),
                                  "pos": torch.as_tensor(pos)})
        want, jcache = _jax(dtype_name, jstep, jp, {
            "cache": jcache, "tokens": jnp.asarray(tok[:, t:t + 1]),
            "pos": jnp.asarray(pos)})
        if not bf16_hybrid:
            _hold(cfg, dtype_name, got, want)
        steps.append(got)
        jsteps.append(want)
    if bf16_hybrid:
        _hold(cfg, dtype_name, torch.cat(steps, dim=1),
              jnp.concatenate(jsteps, axis=1), _f32_logits(jp, jcfg, tok))
    assert cache.keys() == jcache.keys()
    for key in cache:
        assert str(cache[key].dtype) == "torch." + jcache[key].dtype.name, key
        _hold(cfg, dtype_name, cache[key], jcache[key])
    if cfg.family == "rwkv6":
        want_dtype = DTYPES[dtype_name][0]
        assert cache["tm_x"].dtype == cache["cm_x"].dtype == want_dtype
    if bf16_hybrid:
        return
    full, _ = M.lm_forward(model, torch.as_tensor(tok), cfg)
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full),
                               rtol=0.15, atol=0.15)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_params_from_numpy_carries_every_leaf(cfg_name):
    """Stacked ``layers.*`` leaves split into the ModuleList, the hybrid's
    ``shared.*`` loaded as it is; every parameter has its leaf."""
    cfg, _, model, jp = _pair(cfg_name, "f32")
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        keys = [p.key for p in path]
        a = np.asarray(leaf)
        rows = ([(f"layers.{i}." + ".".join(keys[1:]), a[i])
                 for i in range(cfg.n_layers)] if keys[0] == "layers"
                else [(".".join(keys), a)])
        for name, want in rows:
            names.add(name)
            np.testing.assert_array_equal(_np(model.get_parameter(name)),
                                          want, err_msg=name)
    assert names == {n for n, _ in model.named_parameters()}
    if cfg.family == "hybrid":
        assert "shared.attn.wq" in names


def test_init_params_keeps_the_jax_std_rule():
    """The stacked Mamba-2 matrices have std 1/sqrt(n_layers); the shared
    block is not stacked, so its matrices have 1/sqrt(d_model)."""
    cfg = CONFIGS["hybrid.hd112"][0][0]
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, device="cpu")
    in_proj = torch.stack([lay.mamba.in_proj for lay in model.layers])
    assert abs(float(in_proj.std()) - 5 ** -0.5) < 0.01
    assert abs(float(model.shared.attn.wq.std()) - 224 ** -0.5) < 0.005
    assert abs(float(model.shared.ffn.w_down.std()) - 448 ** -0.5) < 0.005
    assert torch.equal(model.layers[0].mamba.D, torch.ones(7))
    assert torch.equal(model.layers[0].mamba.A_log, torch.zeros(7))
    rwkv = M.init_params(CONFIGS["rwkv.hd64"][0][0],
                         torch.Generator().manual_seed(0), torch.float32,
                         device="cpu")
    assert abs(float(rwkv.layers[1].tm.wr.std()) - 2 ** -0.5) < 0.02
    assert torch.equal(rwkv.layers[0].tm.u, torch.zeros(4, 64))


@pytest.mark.parametrize("cfg_name", ["hybrid.smoke", "hybrid.hd112"])
def test_forward_on_a_hybrid_config_runs_the_mamba_layers_alone(cfg_name):
    """JAX ``forward`` on a hybrid config skips the shared block (every
    caller takes ``hybrid_forward``); the port keeps that."""
    cfg, jcfg, model, jp = _pair(cfg_name, "f32")
    tok = _tokens(cfg, 2, CONFIGS[cfg_name][1])
    got, _ = M.forward(model, torch.as_tensor(tok), cfg)
    want, _ = JM.forward(jp, jnp.asarray(tok), jcfg)
    _close(got, want, F32_TOL)
    hybrid, _ = M.hybrid_forward(model, torch.as_tensor(tok), cfg)
    assert (got - hybrid).norm() > 0.1 * hybrid.norm()


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_7b"])
def test_long_500k_specs_are_the_context_independent_cache(arch):
    """long_500k is supported; its decode input specs are JAX's, on the
    meta device, and the cache is the size of a 4,096-position one."""
    cfg = get_config(arch)
    assert registry.cell_supported(cfg, SHAPES["long_500k"]) == (True, "")
    assert (arch, "long_500k", True, "") in registry.supported_cells()
    specs = registry.input_specs(arch, "long_500k")
    jspecs = JR.input_specs(arch, "long_500k")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in specs["cache"].items()} == {
        k: (v.shape, v.dtype.name) for k, v in jspecs["cache"].items()}
    assert all(v.device.type == "meta" for v in specs["cache"].values())

    def nbytes(cache):
        return sum(v.numel() * v.element_size() for v in cache.values())
    small = D.init_cache(cfg, 1, 4096, device="meta")
    assert nbytes(specs["cache"]) == nbytes(small)
    assert registry.active_param_count(cfg) == registry.total_param_count(
        cfg) == JR.total_param_count(jget_config(arch))
