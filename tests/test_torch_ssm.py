"""The port's sub-quadratic mixers (``repro_torch.models.ssm``) against the
JAX package's ``models/ssm.py``, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``; the
vectors the reference inits to zeros or ones, ``dt_bias``, ``A_log``,
``D``, the RWKV mixes and bonus, are drawn here so that they matter) go
through both packages, in float32 and bf16:

  * ``mamba2_scan`` at one chunk and at several (the inter-chunk
    recurrence), on Zamba2's smoke config (chunk 32) and at its own head
    dim and state (hd 64, N 64, chunk 128);
  * ``mamba2_step`` from a nonzero state (output and new state);
  * the scan against S steps of the step function, in the port alone
    (two forms of one function, float32);
  * ``rwkv6_time_mix_scan`` with nonzero carries (out, ``x_last``,
    state), at the smoke config's hd 16 and RWKV-6-3B's hd 64, and
    ``rwkv6_channel_mix`` (out, ``x_last``); a bf16 carry joins a float32
    x as float32 (``jnp.concatenate``'s promotion).

Tolerances are ``tests/test_torch_llm.py``'s (relative L2, max over
max(1, max |want|)): F32_TOL, BF16_TOL.  In bf16 the JAX functions run
under ``jax.disable_jit()`` (``_jax``), one operation at a time as
written; jitted on the CPU, XLA skips the bf16 rounding of a bf16 matmul
cast to float32 (tests/test_torch_moe.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import ssm as JS
from repro.models import transformer as JM
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.models import ssm as S
from repro_torch.models.config import SSMConfig
from test_torch_llm import BF16_TOL, DTYPES, F32_TOL, _close, _np

torch.set_num_threads(1)


def _both(arch, **kw):
    """(port cfg, JAX cfg): ``arch``'s smoke config, scaled by ``kw``
    (``ssm`` given as SSMConfig fields)."""
    ssm = kw.pop("ssm", None)
    out = []
    for get, SSM in ((get_smoke_config, SSMConfig),
                     (jget_smoke, JSSMConfig)):
        extra = {"ssm": SSM(**ssm)} if ssm else {}
        out.append(get(arch).scaled(**kw, **extra))
    return tuple(out)


CONFIGS = {
    "mamba.smoke": _both("zamba2_7b"),
    # Zamba2-7B's SSM head dim, state and chunk, narrow.
    "mamba.hd64": _both("zamba2_7b", n_layers=2, d_model=128, n_heads=2,
                        n_kv_heads=2, d_ff=256, vocab=256,
                        ssm=dict(d_state=64, head_dim=64, expand=2,
                                 chunk=128)),
    "rwkv.smoke": _both("rwkv6_3b"),
    # RWKV-6-3B's head dim 64.
    "rwkv.hd64": _both("rwkv6_3b", d_model=128, n_heads=2, n_kv_heads=2,
                       d_ff=256, vocab=256, ssm=dict(head_dim=64)),
}
# Parameters the reference inits to a constant, redrawn here: (std, mean).
REDRAW = {"dt_bias": (1.0, 0.0), "A_log": (0.5, 0.0), "D": (0.5, 1.0),
          "mu_r": (1.0, 0.0), "mu_k": (1.0, 0.0), "mu_v": (1.0, 0.0),
          "mu_g": (1.0, 0.0), "mu_w": (1.0, 0.0), "w0": (0.5, 0.0),
          "u": (0.5, 0.0), "ln_scale": (0.2, 1.0), "norm": (0.2, 1.0)}


def _redraw(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw(v, rng)
        elif k in REDRAW:
            std, mean = REDRAW[k]
            a = rng.normal(size=v.shape) * std + mean
            out[k] = jnp.asarray(a.astype(np.float32)).astype(v.dtype)
        else:
            out[k] = v
    return out


def _pair(cfg_name, dtype_name, seed=0):
    """(port cfg, JAX cfg, port model, JAX params) with equal weights."""
    cfg, jcfg = CONFIGS[cfg_name]
    tdt, jdt = DTYPES[dtype_name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    jp = dict(jp, layers=_redraw(jp["layers"], np.random.default_rng(seed)))
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


def _layer(jp, i, part):
    return jax.tree.map(lambda a: a[i], jp["layers"][part])


def _array(shape, dtype_name, seed, scale=1.0):
    """The same values for both packages: (torch tensor, JAX array) in the
    dtype, rounded once from float32."""
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    ja = jnp.asarray(a).astype(DTYPES[dtype_name][1])
    return convert.tensor_from_numpy(np.asarray(ja)), ja


def _tol(dtype_name):
    return F32_TOL if dtype_name == "f32" else BF16_TOL


def _state_shape(cfg, B):
    s = cfg.ssm
    return (B, s.expand * cfg.d_model // s.head_dim, s.head_dim, s.d_state)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name,chunks", [("mamba.smoke", 1),
                                             ("mamba.smoke", 4),
                                             ("mamba.hd64", 1),
                                             ("mamba.hd64", 2)])
def test_mamba2_scan(cfg_name, chunks, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    S_len = chunks * cfg.ssm.chunk
    x, jx = _array((2, S_len, cfg.d_model), dtype_name, seed=1)
    got = S.mamba2_scan(model.layers[1].mamba, x, cfg)
    want = _jax(dtype_name, JS.mamba2_scan, _layer(jp, 1, "mamba"), jx, jcfg)
    assert got.dtype == DTYPES[dtype_name][0]
    _close(got, want, _tol(dtype_name))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", ["mamba.smoke", "mamba.hd64"])
def test_mamba2_step_from_a_nonzero_state(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    x, jx = _array((3, 1, cfg.d_model), dtype_name, seed=2)
    st = np.random.default_rng(3).normal(size=_state_shape(cfg, 3)).astype(
        np.float32)
    got, got_st = S.mamba2_step(model.layers[0].mamba, x,
                                torch.as_tensor(st), cfg)
    want, want_st = _jax(dtype_name, JS.mamba2_step, _layer(jp, 0, "mamba"),
                         jx, jnp.asarray(st), jcfg)
    assert got.dtype == DTYPES[dtype_name][0] and got_st.dtype == torch.float32
    _close(got, want, _tol(dtype_name))
    _close(got_st, want_st, _tol(dtype_name))


@pytest.mark.parametrize("cfg_name,chunks", [("mamba.smoke", 3),
                                             ("mamba.hd64", 1)])
def test_mamba2_scan_equals_its_steps(cfg_name, chunks):
    """The chunked form and S recurrent steps from the zero state are one
    function (float32)."""
    cfg, _, model, _ = _pair(cfg_name, "f32")
    mamba = model.layers[0].mamba
    S_len = chunks * cfg.ssm.chunk
    x, _ = _array((2, S_len, cfg.d_model), "f32", seed=4)
    got = S.mamba2_scan(mamba, x, cfg)
    st = S.mamba2_init_state(cfg, 2, x.device)
    steps = []
    for t in range(S_len):
        y, st = S.mamba2_step(mamba, x[:, t:t + 1], st, cfg)
        steps.append(y)
    _close(got, torch.cat(steps, dim=1), F32_TOL)


def _carries(cfg, B, dtype_name, seed):
    """Nonzero (x_last (B, D) in the dtype, state (B, H, hd, hd) float32)
    for both packages."""
    hd = cfg.ssm.head_dim
    x_last, jx_last = _array((B, cfg.d_model), dtype_name, seed)
    st = np.random.default_rng(seed + 1).normal(
        size=(B, cfg.d_model // hd, hd, hd)).astype(np.float32)
    return x_last, jx_last, torch.as_tensor(st), jnp.asarray(st)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name,S_len", [("rwkv.smoke", 1),
                                            ("rwkv.smoke", 24),
                                            ("rwkv.hd64", 16)])
def test_rwkv6_time_mix_scan_with_nonzero_carries(cfg_name, S_len,
                                                  dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    x, jx = _array((2, S_len, cfg.d_model), dtype_name, seed=5)
    x_last, jx_last, st, jst = _carries(cfg, 2, dtype_name, seed=6)
    got = S.rwkv6_time_mix_scan(model.layers[1].tm, x, cfg, x_last, st)
    want = _jax(dtype_name, JS.rwkv6_time_mix_scan, _layer(jp, 1, "tm"), jx,
                jcfg, jx_last, jst)
    tol = _tol(dtype_name)
    for name, g, w in zip(("out", "x_last", "state"), got, want):
        assert str(g.dtype) == "torch." + w.dtype.name, name
        _close(g, w, tol)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", ["rwkv.smoke", "rwkv.hd64"])
def test_rwkv6_channel_mix(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    x, jx = _array((2, 12, cfg.d_model), dtype_name, seed=7)
    x_last, jx_last, _, _ = _carries(cfg, 2, dtype_name, seed=8)
    got = S.rwkv6_channel_mix(model.layers[0].cm, x, x_last)
    want = _jax(dtype_name, JS.rwkv6_channel_mix, _layer(jp, 0, "cm"), jx,
                jx_last)
    for g, w in zip(got, want):
        assert str(g.dtype) == "torch." + w.dtype.name
        _close(g, w, _tol(dtype_name))


def test_a_bf16_carry_joins_a_float32_x_as_float32():
    """The zero carries are bf16 (``rwkv6_init_state``); with float32
    activations the shift, the outputs and the new carries are float32,
    as in JAX."""
    cfg, jcfg, model, jp = _pair("rwkv.smoke", "f32")
    x, jx = _array((2, 5, cfg.d_model), "f32", seed=9)
    st = S.rwkv6_init_state(cfg, 2, torch.device("cpu"))
    jst = JS.rwkv6_init_state(jcfg, 2)
    assert st["tm_x"].dtype == torch.bfloat16
    shifted = S._token_shift(x, st["tm_x"])
    assert shifted.dtype == torch.float32
    _close(shifted, JS._token_shift(jx, jst["tm_x"]), (0, 0))
    got = S.rwkv6_time_mix_scan(model.layers[0].tm, x, cfg, st["tm_x"],
                                st["tm_state"])
    want = JS.rwkv6_time_mix_scan(_layer(jp, 0, "tm"), jx, jcfg, jst["tm_x"],
                                  jst["tm_state"])
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        _close(g, w, F32_TOL)
    out, cm_x = S.rwkv6_channel_mix(model.layers[0].cm, x, st["cm_x"])
    assert out.dtype == cm_x.dtype == torch.float32
    np.testing.assert_array_equal(_np(cm_x), _np(x[:, -1]))
