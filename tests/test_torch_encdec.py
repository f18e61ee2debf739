"""The port's encoder-decoder (Whisper-base, ``family="encdec"``) against
the JAX package, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``) go through
both packages, on Whisper's smoke config (d 64, H 4, hd 16) and on a
2-layer variant at its own width (d 512, H 8, hd 64):

  * ``encode`` over 64 frames (bidirectional self attention);
  * ``forward`` / ``lm_forward`` over 24 tokens with an ``encoder_out`` of
    64 frames: causal self attention, then cross attention with Sq != Sk;
  * ``registry.make_step``'s prefill (encoder, last state's logits);
  * 8 ``decode_step``s through ``make_step`` with ``xk`` / ``xv`` filled
    alike in both packages from the JAX encoder's states (neither package
    fills them; see ``serve/llm_decode.py``): logits each step, the cache
    at the end, ``xk`` / ``xv`` untouched; then the teacher-forced decode
    against ``forward`` at the same positions, within 0.15 (the check the
    JAX package's own test skips for want of a cross-KV prefill).

Tolerances are ``tests/test_torch_llm.py``'s: relative L2 error and max
error over max(1, max |want|); float32 F32_TOL, bfloat16 BF16_TOL.  In
bfloat16 the JAX functions run under ``jax.disable_jit()``, one operation
at a time, as written (``_jax``): jitted on the CPU, XLA computes a bf16
matmul that is then cast to float32 (SwiGLU's ``(x @ w_gate).astype(f32)``)
as a float32 dot of the upcast inputs and never rounds its result to bf16,
while the port, like the JAX code as written, rounds it; against jitted
JAX the decoder's bf16 logits drift 0.02-0.2.  Against JAX as written,
the encoder and the encoder prefill hold BF16_TOL (0.015 at most).  The
decoder's outputs mostly do too (0.006 at most over 20 seeds of the two
configs), but not always: one-ulp differences of a bf16 matmul (torch's
and XLA's sums in other orders), through the reference init's peaked
cross attention, can land on a near-tied row and move the logits by 0.057
(hd64 on this file's seeds).  JAX's own bf16 logits are 0.02-0.30 from its
float32 function on the same bf16-valued weights, so the decoder's bf16
outputs are held to that (``_hold_bf16``): the port's relative L2 error
from it within a factor ACCURACY_RATIO of JAX's bf16 error, either way
(measured 0.99-1.02), and its distance from JAX's bf16 outputs within
that error (measured at most 0.21 of it).  The whole chain, each
package's decoder on its own encoder's states, is compared in float32
only.
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
from repro.serve import llm_decode as JD
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, layers as L, registry
from repro_torch.models import transformer as M
from repro_torch.models.config import ShapeConfig
from repro_torch.serve import llm_decode as D
from test_torch_llm import BF16_TOL, DTYPES, F32_TOL, _close, _np

torch.set_num_threads(1)

ARCH = "whisper_base"
ACCURACY_RATIO = 1.25
N_FRAMES, N_TOKENS, B = 64, 24, 2


def _configs():
    """{name: (port cfg, JAX cfg)}: the smoke config and the 2-layer
    variant at Whisper-base's width."""
    cut = dict(n_layers=2, n_enc_layers=2, vocab=512)
    return {"smoke": (get_smoke_config(ARCH), jget_smoke(ARCH)),
            "hd64": (get_config(ARCH).scaled(**cut),
                     jget_config(ARCH).scaled(**cut))}


CONFIGS = _configs()


def _pair(cfg_name, dtype_name, seed=0):
    """(port cfg, JAX cfg, port model, JAX params) with equal weights."""
    cfg, jcfg = CONFIGS[cfg_name]
    tdt, jdt = DTYPES[dtype_name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    assert model.embedding.dtype == tdt
    return cfg, jcfg, model, jp


def _frames(cfg, dtype_name, seed=1):
    """Frame embeddings (B, N_FRAMES, d) in the dtype, as (torch, JAX)."""
    x = np.random.default_rng(seed).normal(
        size=(B, N_FRAMES, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype_name][1])
    return convert.tensor_from_numpy(np.asarray(jx)), jx


def _tokens(cfg, n=N_TOKENS, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n)).astype(np.int32)


def _tol(dtype_name):
    return F32_TOL if dtype_name == "f32" else BF16_TOL


def _jax(dtype_name, fn, *args, **kw):
    """A JAX function's result: jitted in float32, op by op in bf16 (see
    the module's docstring)."""
    if dtype_name == "f32":
        return fn(*args, **kw)
    with jax.disable_jit():
        return fn(*args, **kw)


def _jax_encoder_states(cfg_name, dtype_name):
    """The port's model and JAX's, and JAX's encoder states over the
    frames, as (torch, JAX)."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    _, jframes = _frames(cfg, dtype_name)
    jenc = _jax(dtype_name, JM.encode, jp, jframes, jcfg)
    return cfg, jcfg, model, jp, convert.tensor_from_numpy(
        np.asarray(jenc)), jenc


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_encode_equal_jax(cfg_name, dtype_name):
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    frames, jframes = _frames(cfg, dtype_name)
    got = M.encode(model, frames, cfg)
    want = _jax(dtype_name, JM.encode, jp, jframes, jcfg)
    assert got.dtype == DTYPES[dtype_name][0]
    assert tuple(got.shape) == (B, N_FRAMES, cfg.d_model)
    _close(got, want, _tol(dtype_name))


def _hold_bf16(got, want, want_f32):
    """A bf16 decoder output: its relative L2 error from JAX's float32
    function ``want_f32`` within a factor ACCURACY_RATIO, either way, of
    JAX's bf16 output's (``want``), and its distance from JAX's bf16 output
    within that same error, so that the error's direction counts as well
    as its size."""
    ref = _np(want_f32)
    assert _np(got).shape == ref.shape

    def dist(x, y):
        return np.linalg.norm(_np(x) - _np(y)) / np.linalg.norm(ref)
    ratio = dist(got, ref) / dist(want, ref)
    assert 1 / ACCURACY_RATIO <= ratio <= ACCURACY_RATIO, (
        dist(got, ref), dist(want, ref))
    assert dist(got, want) <= dist(want, ref), (dist(got, want),
                                                dist(want, ref))


def _hold(got, want, want_f32, dtype_name):
    if dtype_name == "f32":
        _close(got, want, F32_TOL)
    else:
        _hold_bf16(got, want, want_f32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_forward_with_cross_attention_equal_jax(cfg_name, dtype_name):
    """Decoder hidden states and ``lm_forward``'s logits over 24 tokens,
    cross-attending to JAX's encoder states over 64 frames (Sq != Sk);
    aux is 0.  In float32 also the whole chain, each package from its own
    ``encode``."""
    cfg, jcfg, model, jp, enc, jenc = _jax_encoder_states(cfg_name,
                                                          dtype_name)
    tok = _tokens(cfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    for fn, jfn in ((M.forward, JM.forward), (M.lm_forward, JM.lm_forward)):
        got, aux = fn(model, torch.as_tensor(tok), cfg, encoder_out=enc)
        want, _ = _jax(dtype_name, jfn, jp, jnp.asarray(tok), jcfg,
                       encoder_out=jenc)
        want_f32, _ = jfn(jp32, jnp.asarray(tok), jcfg,
                          encoder_out=jenc.astype(jnp.float32))
        assert float(aux) == 0.0 and got.dtype == enc.dtype
        _hold(got, want, want_f32, dtype_name)
    if dtype_name == "f32":
        frames, jframes = _frames(cfg, dtype_name)
        got, _ = M.lm_forward(model, torch.as_tensor(tok), cfg,
                              encoder_out=M.encode(model, frames, cfg))
        want, _ = JM.lm_forward(jp, jnp.asarray(tok), jcfg,
                                encoder_out=JM.encode(jp, jframes, jcfg))
        _close(got, want, F32_TOL)


def test_forward_needs_encoder_out():
    cfg, _, model, _ = _pair("smoke", "f32")
    with pytest.raises(ValueError, match="encoder_out"):
        M.forward(model, torch.as_tensor(_tokens(cfg)), cfg)


def test_attention_calls_are_those_of_the_jax_model(monkeypatch):
    """``encode`` attends without a mask over the frames (Sq = Sk), the
    decoder causally over its tokens and without a mask over the encoder
    states (Sq != Sk): the calls the card's kernel serves."""
    cfg, _, model, _ = _pair("smoke", "f32")
    calls, real = [], L.flash_attention

    def record(q, k, v, causal=True, window=None):
        calls.append((causal, q.shape[1], k.shape[1]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(L, "flash_attention", record)
    frames, _ = _frames(cfg, "f32")
    enc = M.encode(model, frames, cfg)
    assert calls == [(False, N_FRAMES, N_FRAMES)] * cfg.n_enc_layers
    calls.clear()
    M.forward(model, torch.as_tensor(_tokens(cfg)), cfg, encoder_out=enc)
    assert calls == [(True, N_TOKENS, N_TOKENS),
                     (False, N_TOKENS, N_FRAMES)] * cfg.n_layers


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_make_step_encoder_prefill_equal_jax(cfg_name, dtype_name):
    """The prefill kind runs the encoder over ``frames`` and returns the
    last encoder state's logits (B, 1, V)."""
    cfg, jcfg, model, jp = _pair(cfg_name, dtype_name)
    frames, jframes = _frames(cfg, dtype_name)
    shape = ShapeConfig("prefill_64", N_FRAMES, B, "prefill")
    got = registry.make_step(cfg, shape, device="cpu")(
        model, {"frames": frames})
    want = _jax(dtype_name, JR.make_step(jcfg, shape), jp,
                {"frames": jframes})
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    _close(got, want, _tol(dtype_name))


def _cross_kv(jp, jenc, jcfg):
    """Each decoder layer's cross-attention K and V of the encoder states,
    (L, B, S, KV, hd) in the states' dtype, computed in JAX: the values
    both packages' caches get."""
    B_, S = jenc.shape[:2]
    shape = (B_, S, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    x = jp["dec_layers"]["xattn"]
    return tuple(jnp.stack([(jenc @ x[w][i]).reshape(shape)
                            for i in range(jcfg.n_layers)])
                 for w in ("wk", "wv"))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_decode_steps_equal_jax(cfg_name, dtype_name):
    """8 steps through make_step against a cache of N_FRAMES positions
    whose ``xk`` / ``xv`` hold the encoder's 64 states exactly (cross
    attention sees all of them, as in JAX): logits each step (bf16: the 8
    steps' logits by ``_hold_bf16``, against JAX's float32 steps on a
    float32 cache), the self K/V at the end, ``xk`` / ``xv`` untouched;
    then the teacher-forced logits against ``forward``'s at the same 8
    positions within 0.15."""
    cfg, jcfg, model, jp, enc, jenc = _jax_encoder_states(cfg_name,
                                                          dtype_name)
    T = 8
    tok = _tokens(cfg, T)
    shape = ShapeConfig("decode_64", N_FRAMES, B, "decode")
    step = registry.make_step(cfg, shape, device="cpu")
    jstep = JR.make_step(jcfg, shape)
    cache = D.init_cache(cfg, B, N_FRAMES, device="cpu")
    jcache = JD.init_cache(jcfg, B, N_FRAMES)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), torch.bfloat16) for k, v in jcache.items()}
    if dtype_name == "f32":
        # As in tests/test_torch_llm.py: with float32 weights both caches
        # are float32 (a one-ulp bf16 tie in k moves later steps), and so
        # is the cross-KV, as forward's is.
        jcache = {k: v.astype(jnp.float32) for k, v in jcache.items()}
    jcache["xk"], jcache["xv"] = _cross_kv(jp, jenc, jcfg)
    cache = {k: convert.tensor_from_numpy(np.asarray(v))
             for k, v in jcache.items()}
    xkv = {k: cache[k].clone() for k in ("xk", "xv")}
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jcache32 = {k: v.astype(jnp.float32) for k, v in jcache.items()}
    steps, jsteps, jsteps32 = [], [], []
    for t in range(T):
        batch = {"tokens": tok[:, t:t + 1], "pos": np.full((B,), t, np.int32)}
        got, cache = step(model, {"cache": cache, **{
            k: torch.as_tensor(v) for k, v in batch.items()}})
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        want, jcache = _jax(dtype_name, jstep, jp,
                            {"cache": jcache, **jbatch})
        steps.append(got)
        if dtype_name == "f32":
            _close(got, want, F32_TOL)
        else:
            want32, jcache32 = jstep(jp32, {"cache": jcache32, **jbatch})
            jsteps.append(np.asarray(want, np.float32))
            jsteps32.append(np.asarray(want32))
    if dtype_name == "bf16":
        _hold_bf16(torch.cat(steps, dim=1), np.concatenate(jsteps, axis=1),
                   np.concatenate(jsteps32, axis=1))
    for key in ("k", "v"):
        assert str(cache[key].dtype) == "torch." + jcache[key].dtype.name
        _hold(cache[key], jcache[key], jcache32[key], dtype_name)
    for key in ("xk", "xv"):
        assert torch.equal(cache[key], xkv[key])
    full, _ = M.lm_forward(model, torch.as_tensor(tok), cfg,
                           encoder_out=enc)
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)), _np(full),
                               rtol=0.15, atol=0.15)


def test_params_from_numpy_carries_every_leaf():
    """enc_layers, dec_layers (with ln_x / xattn) and enc_norm go across
    leaf by leaf, each stack split into its ModuleList."""
    cfg, _, model, jp = _pair("hd64", "f32")
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    names = set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        a = np.asarray(leaf)
        if keys[0] in ("enc_layers", "dec_layers"):
            for i in range(a.shape[0]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                names.add(name)
                np.testing.assert_array_equal(
                    _np(model.get_parameter(name)), a[i], err_msg=name)
        else:
            name = ".".join(keys)
            names.add(name)
            np.testing.assert_array_equal(_np(model.get_parameter(name)), a)
    assert names == {n for n, _ in model.named_parameters()}
    assert len(model.enc_layers) == cfg.n_enc_layers
    assert len(model.dec_layers) == cfg.n_layers
    assert not hasattr(model, "layers")
