"""The port's mixture of experts (Llama-4 Scout, ``family="moe"``) against
the JAX package, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a JAX
``init_params`` tree carried across with ``params_from_numpy``) go through
both packages:

  * ``moe_apply``, output and aux loss, on Scout's smoke config (4
    experts, top-1, one shared, capacity factor 8: nothing dropped), on a
    capacity-1.25 variant that drops tokens, on a top-2 variant, at a
    decode step's T = 8 tokens (capacity 1), and with an all-zero router,
    where every logit ties: every token's first choice is expert 0 (as
    ``jax.lax.top_k`` breaks ties), which keeps C tokens and drops the
    rest; routes and drops equal JAX's (``_jax_routes``);
  * the slice: ``lm_forward`` (logits and the aux summed over layers),
    ``make_step``'s prefill and 8 ``decode_step``s (logits and cache) on
    the smoke config and on a 2-layer variant at Scout's head dim 128 with
    its 40/8 heads' GQA group of 5 (16 experts, capacity 1.25 as Scout's,
    so prefill and decode drop tokens); then the teacher-forced decode
    against prefill within 0.15, on a capacity at which neither drops (at
    the reference's own capacity decode keeps C = 1 token per expert of a
    step's 2 while prefill keeps more, so the two are different
    functions);
  * the card script's form of that check (``chip_smoke.moe_teacher_forced``:
    the decode steps take prefill's routes, so that a bf16 rounding on a
    near-tied router logit cannot send a token to another expert).

Tolerances are ``tests/test_torch_llm.py``'s (relative L2, max over
max(1, max |want|)): float32 F32_TOL, bfloat16 BF16_TOL.  ``moe_apply`` in
bf16 measured 0 on equal inputs (the same bf16 roundings in the same
places).  In bfloat16 the JAX functions run under ``jax.disable_jit()``,
one operation at a time, as written (``_jax``).  Jitted on the CPU, XLA
computes the router's ``(xt @ router).astype(f32)`` as a float32 dot of
the upcast inputs and never rounds the logits to bf16, as the code as
written and the port do; at the reference init's logits of 16-32 (bf16
ulp 0.125) two experts often tie in bf16, and jitted JAX breaks the tie
by the unrounded values where the port takes the lower index, so a token
goes to another expert and, through the capacity, moves the ranks of the
tokens after it.  Against jitted JAX the port's bf16 logits were
0.011-0.151 (relative L2) apart over 10 seeds of each config; against JAX
as written 0.006 at most.
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
from repro.models.config import MoEConfig as JMoEConfig
from repro.serve import llm_decode as JD
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, layers as L, registry
from repro_torch.models import transformer as M
from repro_torch.models.config import MoEConfig, ShapeConfig
from repro_torch.serve import llm_decode as D
from test_torch_llm import BF16_TOL, DTYPES, F32_TOL, _close, _np

torch.set_num_threads(1)

ARCH = "llama4_scout_17b_a16e"


def _both(fn):
    """(port cfg, JAX cfg) = fn(port config module's names, JAX's)."""
    return (fn(get_config, get_smoke_config, MoEConfig),
            fn(jget_config, jget_smoke, JMoEConfig))


def _moe(cfg, Moe, **kw):
    return cfg.scaled(moe=Moe(**{**dataclasses.asdict(cfg.moe), **kw}))


# moe_apply's cases: the smoke config and its variants.
MOE_CONFIGS = {
    "smoke": _both(lambda c, s, Moe: s(ARCH)),
    "cf1.25": _both(lambda c, s, Moe: _moe(s(ARCH), Moe,
                                           capacity_factor=1.25)),
    "top2": _both(lambda c, s, Moe: _moe(s(ARCH), Moe, top_k=2,
                                         capacity_factor=1.0)),
}
# The slice's: the smoke config and the 2-layer variant at Scout's head
# dim and GQA group (H 5 / KV 1, hd 128), 16 experts at capacity 1.25.
CONFIGS = {
    "smoke": MOE_CONFIGS["smoke"],
    "hd128": _both(lambda c, s, Moe: c(ARCH).scaled(
        n_layers=2, d_model=640, n_heads=5, n_kv_heads=1, d_ff=256,
        vocab=512, moe=Moe(n_experts=16, top_k=1, n_shared=1,
                           d_ff_expert=256))),
}


def _pair(cfg, jcfg, dtype_name, seed=0):
    tdt, jdt = DTYPES[dtype_name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed), jdt)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    assert model.embedding.dtype == tdt
    return model, jp


def _x(cfg, dtype_name, T, seed=3):
    """(1, T, d) activations of the std a layer's FFN input has."""
    x = np.random.default_rng(seed).normal(
        size=(1, T, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype_name][1])
    return convert.tensor_from_numpy(np.asarray(jx)), jx


def _jax_routes(jffn, jx, jcfg):
    """JAX's (flat_e, slot) for the tokens of jx: moe_apply's routing
    steps, read back from its arrays (the JAX function returns only
    out, aux)."""
    m = jcfg.moe
    xt = jx.reshape(-1, jx.shape[-1])
    T, E, K = xt.shape[0], m.n_experts, m.top_k
    C = max(1, int(np.ceil(T * K / E * m.capacity_factor)))
    probs = jax.nn.softmax((xt @ jffn["router"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, K)
    flat_e = np.asarray(top_e).reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    run_start = np.searchsorted(flat_e[order], np.arange(E))
    rank = np.empty_like(flat_e)
    rank[order] = np.arange(len(flat_e)) - run_start[flat_e[order]]
    slot = np.where(rank < C, flat_e * C + rank, E * C)
    return flat_e, slot, C


def _hold_moe(cfg_name, dtype_name, T, zero_router=False):
    """moe_apply of layer 0 on (1, T, d) inputs: out and aux equal JAX's,
    and so do the routes and slots.  Returns (keep, C)."""
    cfg, jcfg = MOE_CONFIGS[cfg_name]
    model, jp = _pair(cfg, jcfg, dtype_name)
    ffn = model.layers[0].ffn
    jffn = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    if zero_router:
        ffn.router.zero_()
        jffn["router"] = jnp.zeros_like(jffn["router"])
    x, jx = _x(cfg, dtype_name, T)
    out, aux = L.moe_apply(ffn, x, cfg)
    jout, jaux = JL.moe_apply(jffn, jx, jcfg)
    tol = F32_TOL if dtype_name == "f32" else BF16_TOL
    assert out.dtype == x.dtype and aux.dtype == torch.float32
    _close(out, jout, tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    _, _, flat_e, slot, keep, C = L.moe_route(ffn, x.reshape(T, -1), cfg)
    jflat_e, jslot, jC = _jax_routes(jffn, jx, jcfg)
    assert C == jC
    np.testing.assert_array_equal(flat_e.numpy(), jflat_e)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    return keep, C


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(MOE_CONFIGS))
def test_moe_apply_equal_jax(cfg_name, dtype_name):
    """64 tokens: the smoke config (capacity 128 a expert) keeps every
    pair; capacity 1.25 (C 20) and top-2 at capacity 1 (C 32) drop
    some."""
    keep, C = _hold_moe(cfg_name, dtype_name, 64)
    assert keep.all() == (cfg_name == "smoke"), (cfg_name, int(keep.sum()))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_moe_apply_at_a_decode_step(dtype_name):
    """T = 8 at capacity 1.25 over 4 experts: C = 3."""
    keep, C = _hold_moe("cf1.25", dtype_name, 8)
    assert C == 3


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_moe_apply_with_every_logit_tied(dtype_name):
    """An all-zero router: uniform probabilities, every token's choice
    expert 0 (the lowest index, as jax.lax.top_k), the first C kept."""
    T = 64
    keep, C = _hold_moe("cf1.25", dtype_name, T, zero_router=True)
    assert int(keep.sum()) == C == 20
    assert keep[:C].all() and not keep[C:].any()


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_moe_apply_with_a_top2_tie(dtype_name):
    """top-2 over an all-zero router: experts 0 and 1 for every token."""
    cfg, jcfg = MOE_CONFIGS["top2"]
    model, jp = _pair(cfg, jcfg, dtype_name)
    ffn = model.layers[0].ffn
    ffn.router.zero_()
    x, _ = _x(cfg, dtype_name, 16)
    _, top_p, flat_e, _, _, _ = L.moe_route(ffn, x.reshape(16, -1), cfg)
    assert flat_e.tolist() == [0, 1] * 16
    assert torch.equal(top_p, torch.full((16, 2), 0.5))


def _jax(dtype_name, fn, *args, **kw):
    """A JAX function's result: jitted in float32, op by op in bf16 (see
    the module's docstring)."""
    if dtype_name == "f32":
        return fn(*args, **kw)
    with jax.disable_jit():
        return fn(*args, **kw)


def _tokens(cfg, B, S, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_lm_forward_and_prefill_equal_jax(cfg_name, dtype_name):
    """Logits and the aux loss summed over the layers; the prefill kind's
    last-token logits."""
    cfg, jcfg = CONFIGS[cfg_name]
    model, jp = _pair(cfg, jcfg, dtype_name)
    tol = F32_TOL if dtype_name == "f32" else BF16_TOL
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


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_decode_steps_equal_jax(cfg_name, dtype_name):
    """8 steps through make_step, at the config's capacity: logits each
    step and the cache at the end.  Then, at a capacity where nothing
    drops (cf = E / K, so C = T), the teacher-forced steps against
    prefill's logits within 0.15."""
    cfg, jcfg = CONFIGS[cfg_name]
    model, jp = _pair(cfg, jcfg, dtype_name)
    tol = F32_TOL if dtype_name == "f32" else BF16_TOL
    B, S, T = 2, 16, 8
    tok = _tokens(cfg, B, T)
    shape = ShapeConfig("decode_16", S, B, "decode")
    cache = D.init_cache(cfg, B, S, device="cpu")
    jcache = JD.init_cache(jcfg, B, S)
    if dtype_name == "f32":
        # As in tests/test_torch_llm.py: float32 caches with float32 weights.
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
    for key in ("k", "v"):
        assert str(cache[key].dtype) == "torch." + jcache[key].dtype.name
        _close(cache[key], jcache[key], tol)
    m = cfg.moe
    whole = _moe(cfg, MoEConfig, capacity_factor=m.n_experts / m.top_k)
    cache = {k: torch.zeros_like(v) for k, v in cache.items()}
    for t in range(T):
        got, cache = D.decode_step(model, cache,
                                   torch.as_tensor(tok[:, t:t + 1]),
                                   torch.full((B,), t), whole)
    last = D.prefill(model, torch.as_tensor(tok), whole, S)
    np.testing.assert_allclose(_np(got), _np(last), rtol=0.15, atol=0.15)


def test_params_from_numpy_carries_every_leaf():
    """The router, the shared expert and the (L, E, d, f) expert stacks go
    across leaf by leaf, each layer's experts (E, d, f)."""
    cfg, jcfg = CONFIGS["hd128"]
    model, jp = _pair(cfg, jcfg, "f32")
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
    ffn = model.layers[1].ffn
    assert tuple(ffn.w_gate.shape) == (16, 640, 256)
    assert tuple(ffn.w_down.shape) == (16, 256, 640)
    assert tuple(ffn.router.shape) == (640, 16)
    assert tuple(ffn.shared.w_up.shape) == (640, 256)



@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_chip_smoke_moe_teacher_forced(cfg_name, dtype_name):
    """The card script's MoE teacher-forced check (``moe_teacher_forced``)
    on the CPU: decode steps that take prefill's routes, at a capacity
    where nothing drops, within 0.15 of prefill (it raises otherwise); in
    float32 each step's own routes are prefill's and the logits agree to
    float32 rounding.  Recording keeps one (B, S, K) of experts a layer,
    and the model's router is its own again after each block."""
    from test_torch_boundary import _chip_smoke
    smoke = _chip_smoke()
    cfg, jcfg = CONFIGS[cfg_name]
    model, _ = _pair(cfg, jcfg, dtype_name)
    tok = torch.as_tensor(_tokens(cfg, 2, 8))
    route = L.moe_route
    got = smoke.moe_teacher_forced(torch, model, cfg, tok)
    assert L.moe_route is route
    assert got["capacity_factor"] == cfg.moe.n_experts / cfg.moe.top_k
    assert got["own_route_agreement"] >= smoke.MOE_ROUTE_AGREEMENT
    if dtype_name == "f32":
        assert got["own_route_agreement"] == 1.0
        assert got["relative_l2"] < 1e-5
    routes = smoke.moe_routes(2, 8)
    with routes.record():
        D.prefill(model, tok, cfg, 8)
    assert L.moe_route is route
    assert [tuple(e.shape) for e in routes.experts] == [
        (2, 8, cfg.moe.top_k)] * cfg.n_layers
