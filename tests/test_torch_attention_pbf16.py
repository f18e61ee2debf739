"""JAX's bf16-p attention (``flags.ATTN_P_BF16``) on the port, on the CPU.

With the flag on, JAX's ``layers._attend_block`` rounds p (against each key
chunk's own row max) and v to bf16 and takes p @ v in float32.  The port's
plain version is ``ref.flash_attention_ref(p_bf16=True)`` and its gradient
``ref.flash_attention_bwd_ref(p_bf16=True)``, which follows the jaxpr of
``jax.vjp`` of the JAX function: p's cotangent rounded to bf16, the chunk
max's cotangent T added at the row's maximal scores, each chunk pair's dV
rounded to bf16.  The same q, k, v and do, made with numpy from a seed, go
through JAX's ``layers.flash_attention`` under ``jax.disable_jit()``
(jitted on the CPU, XLA may fold a bf16 rounding away) and through the
port, at hd 16 / 64 and DeepSeek-V2's (192, 128) pair, GQA groups 1 / 2 /
4, causal, non-causal with Sq != Sk and a window, float32 and bf16, over
chunks of 16 (so that each row's chunk maxima differ) and once over JAX's
own 1,024-key chunks with Sk = 2,048.

Tolerances.  float32: the distance between the port and JAX, relative L2
over the whole tensor, is held to a fraction of the flag's own effect
(JAX's function with the flag against without it): the output within
``F32_FWD_SHARE`` (0.02; measured at most 0.006) of it, each gradient
within ``F32_BWD_SHARE`` (0.2; measured at most 0.042 here, 0.065 at Sq =
Sk = 256 over chunks of 64: p's cotangent is rounded from c dP, and the
port forms c = exp(m_b - lse) where JAX multiplies the merge weights out,
so a few of those roundings land on the other side).  Without T the gradients sit ~1.2x the flag's effect away
(measured), so the share tests the function and not the rounding noise.
bf16: every output is a bf16 rounding apart, so the test is elementwise,
over max(1, max |want|): the output 2**-8 (measured 5.2e-4), the
gradients ``BF16_TOL`` 2**-6 (tests/test_torch_attention_bwd.py's; measured
0.0074: JAX rounds each query head's dK / dV to bf16 before the group sum,
and sums bf16 chunk cotangents in bf16).  torch's and XLA's ``exp`` of the
same float32 arguments are held within 2 float32 ulps (measured 1) and to
send at most ``FLIP_SHARE`` (1e-4) of the p values to different bf16
roundings (measured 1 of 262,144).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flags as JF
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as K, ref
from repro_torch.models import flags

torch.set_num_threads(1)

F32_FWD_SHARE = 0.02
F32_BWD_SHARE = 0.2
BF16_FWD_TOL = 2.0 ** -8
BF16_TOL = 2.0 ** -6
FLIP_SHARE = 1e-4
CHUNK = 16
H = 4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (Sq, Sk, causal, window, chunk)
MASKS = {
    "causal": (64, 64, True, None, CHUNK),
    "noncausal": (48, 80, False, None, CHUNK),
    "window": (64, 64, True, 24, CHUNK),
    "long": (128, 2048, False, None, 1024),
}


def _cases():
    out, groups, i = [], (1, 2, 4), 0
    for hd in (16, 64, (192, 128)):
        for mask in ("causal", "noncausal", "window"):
            for dt in DTYPES:
                out.append((hd, groups[i % 3], mask, dt))
                i += 1
    for dt in DTYPES:
        out.append((16, 2, "long", dt))
    return out


CASES = _cases()


@pytest.fixture
def p_bf16():
    """Both packages' ATTN_P_BF16 on for one test, restored after it."""
    old = flags.ATTN_P_BF16, JF.ATTN_P_BF16
    flags.ATTN_P_BF16 = JF.ATTN_P_BF16 = True
    yield
    flags.ATTN_P_BF16, JF.ATTN_P_BF16 = old


def _inputs(hd, G, mask, dt, seed=0):
    hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
    Sq, Sk, causal, window, chunk = MASKS[mask]
    H_ = 2 if mask == "long" else H
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (1, Sq, H_, hd), (1, Sk, H_ // G, hd), (1, Sk, H_ // G, hd_v),
        (1, Sq, H_, hd_v))]
    arrs[0] *= 1.5          # peaked rows: p far from uniform
    arrs[1] *= 1.5
    tdt, jdt = DTYPES[dt]
    torch_in = [torch.tensor(a).to(tdt) for a in arrs]
    jax_in = [jnp.asarray(a, jdt) for a in arrs]
    return torch_in, jax_in, dict(causal=causal, window=window), chunk


def _jax(jq, jk, jv, jdo, kw, chunk, flag):
    old = JF.ATTN_P_BF16
    JF.ATTN_P_BF16 = flag
    try:
        with jax.disable_jit():
            o, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(
                q, k, v, q_chunk=chunk, k_chunk=chunk, **kw), jq, jk, jv)
            grads = vjp(jdo)
    finally:
        JF.ATTN_P_BF16 = old
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _port(tq, tk, tv, tdo, kw, chunk):
    o, lse = ref.flash_attention_ref(tq, tk, tv, q_chunk=chunk,
                                     k_chunk=chunk, return_lse=True,
                                     p_bf16=True, **kw)
    grads = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                        q_chunk=chunk, k_chunk=chunk,
                                        p_bf16=True, **kw)
    return [x.float().numpy() for x in (o, *grads)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_equals_jax_with_the_flag(case):
    hd, G, mask, dt = case
    (tq, tk, tv, tdo), (jq, jk, jv, jdo), kw, chunk = _inputs(*case)
    want = _jax(jq, jk, jv, jdo, kw, chunk, True)
    got = _port(tq, tk, tv, tdo, kw, chunk)
    if dt == "f32":
        off = _jax(jq, jk, jv, jdo, kw, chunk, False)
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            effect = _rel(want[i], off[i])
            share = F32_FWD_SHARE if name == "o" else F32_BWD_SHARE
            assert effect > 1e-4, (name, effect)   # the flag did something
            assert _rel(got[i], want[i]) <= share * effect, (
                name, _rel(got[i], want[i]), effect)
    else:
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            tol = BF16_FWD_TOL if name == "o" else BF16_TOL
            scale = max(1.0, float(np.abs(want[i]).max()))
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=tol * scale, err_msg=name)


def test_p_rounding_boundaries_of_torch_and_xla_exp():
    """p = exp(s - m) in float32 from the same scores by torch and by XLA
    (jnp): the share of p whose bf16 roundings differ is at most
    FLIP_SHARE (and the float32 values within 2 ulps)."""
    rng = np.random.default_rng(3)
    s = (rng.normal(size=(64, 4096)) * 3).astype(np.float32)
    x = s - s.max(axis=1, keepdims=True)
    pt = torch.exp(torch.from_numpy(x))
    pj = torch.from_numpy(np.array(jnp.exp(jnp.asarray(x))))
    ulps = ((pt - pj).abs() / torch.finfo(torch.float32).eps
            / pt.abs().clamp_min(1e-30))
    assert ulps.max().item() <= 2.0
    flips = (pt.to(torch.bfloat16) != pj.to(torch.bfloat16)).sum().item()
    assert flips <= FLIP_SHARE * x.size, flips


def test_the_flag_moves_the_function_and_off_is_untouched():
    """Off, the plain version is the float32-p one bit for bit; on, it is
    a different function (the rounding of p)."""
    (tq, tk, tv, tdo), _, kw, chunk = _inputs(64, 2, "causal", "f32")
    base = ref.flash_attention_ref(tq, tk, tv, q_chunk=chunk, k_chunk=chunk,
                                   **kw)
    off = ref.flash_attention_ref(tq, tk, tv, q_chunk=chunk, k_chunk=chunk,
                                  p_bf16=False, **kw)
    on = ref.flash_attention_ref(tq, tk, tv, q_chunk=chunk, k_chunk=chunk,
                                 p_bf16=True, **kw)
    assert torch.equal(base, off) and not torch.equal(base, on)


@pytest.mark.parametrize("dt", DTYPES)
def test_wrapper_reads_the_flag_on_the_cpu(dt, p_bf16):
    """Under the flag the wrapper's CPU route is the p_bf16 plain version,
    forward and (under grad) backward; no kernel launch is counted."""
    (tq, tk, tv, tdo), _, kw, _ = _inputs(16, 2, "long", dt)
    K.reset_launches()
    got = K.flash_attention(tq, tk, tv, **kw)
    want, lse = ref.flash_attention_ref(tq, tk, tv, p_bf16=True,
                                        return_lse=True, **kw)
    assert torch.equal(got, want)
    q, k, v = (x.clone().requires_grad_() for x in (tq, tk, tv))
    K.flash_attention(q, k, v, **kw).backward(tdo)
    wg = ref.flash_attention_bwd_ref(tq, tk, tv, want, lse, tdo,
                                     p_bf16=True, **kw)
    for g, w in zip((q.grad, k.grad, v.grad), wg):
        assert torch.equal(g, w)
    assert not any(K.LAUNCHES.values())


def test_flag_fixture_restores_both_packages(p_bf16):
    assert flags.ATTN_P_BF16 is True and JF.ATTN_P_BF16 is True


def test_flags_default_off():
    assert flags.ATTN_P_BF16 is False and JF.ATTN_P_BF16 is False


def test_kernel_sources_carry_the_p_bf16_routes():
    """Each source has the p_bf16 entries of both dtypes, instantiated
    over the same HEAD_DIMS and HEAD_DIM_PAIRS X-macros as the float32-p
    routes (forward<F32, PB> / backward<T, PB> expand them), and the
    wrapper's route tables name them."""
    from repro_torch.kernels import _build
    fwd = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    bwd = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    for entry, _ in K.PB_ROUTES.values():
        assert f'extern "C" int {entry}(' in fwd
    for entry, _ in K.PB_BWD_ROUTES.values():
        assert f'extern "C" int {entry}(' in bwd
    assert "forward<false, true>(" in fwd and "forward<true, true>(" in fwd
    assert ("backward<__nv_bfloat16, true>(" in bwd
            and "backward<float, true>(" in bwd)
    assert "constexpr int CHUNK_KEYS = 1024;" in fwd
    assert "constexpr int CHUNK_KEYS = 1024;" in bwd
    assert K.CHUNK_KEYS == 1024


def _named(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else v, np.float32)
    return out


def _tinyllama_loss_and_grads(flag):
    """TinyLlama's smoke config: JAX's loss and grads (jax.value_and_grad
    of train.step.lm_loss, under jax.disable_jit()) and the port's (torch
    autograd of its lm_loss through kernels.flash_attention), float32, the
    same weights and batch, with both ATTN_P_BF16 at ``flag``."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.data import pipeline as JP
    from repro.models import transformer as JM
    from repro.models.config import ShapeConfig as JShapeConfig
    from repro.train import step as JS
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import pipeline as P
    from repro_torch.models import convert
    from repro_torch.models import transformer as M
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import step as S
    arch = "tinyllama_1_1b"
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    model = M.make_trainable(convert.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))
    jb = dict(JP.batch_for_step(jcfg, JShapeConfig("t", 32, 2, "train"), 3))
    b = P.batch_for_step(cfg, ShapeConfig("t", 32, 2, "train"), 3,
                         device="cpu")
    old = flags.ATTN_P_BF16, JF.ATTN_P_BF16
    flags.ATTN_P_BF16 = JF.ATTN_P_BF16 = flag
    try:
        M.zero_grads(model)
        loss_t, _ = S.lm_loss(model, b, cfg)
        loss_t.backward()
        grads = _named(M.stacked_grads(model))
        with jax.disable_jit():
            (jloss, _), jgrads = jax.value_and_grad(
                JS.lm_loss, has_aux=True)(jp, jb, jcfg)
    finally:
        flags.ATTN_P_BF16, JF.ATTN_P_BF16 = old
    return float(loss_t.detach()), grads, float(jloss), _named(jgrads)


def test_tinyllama_smoke_loss_and_grads_with_the_flag_equal_jax():
    """With the flag on, the loss within 1e-5 relative of JAX's and every
    gradient leaf within F32_BWD_SHARE of the flag's own effect on it (in
    relative L2), or within 1e-6 of the leaf's max |grad| where the flag
    moves the leaf by less than that (its effect is then float32 noise)."""
    loss, grads, jloss, jgrads = _tinyllama_loss_and_grads(True)
    _, _, jloss_off, jgrads_off = _tinyllama_loss_and_grads(False)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert jloss != jloss_off
    assert sorted(grads) == sorted(jgrads)
    moved = 0
    for name, g in grads.items():
        w, w0 = jgrads[name], jgrads_off[name]
        effect = _rel(w, w0) if np.linalg.norm(w) else 0.0
        scale = max(float(np.abs(w).max()), 1e-30)
        if effect * np.linalg.norm(w) <= 1e-6 * scale:
            assert np.abs(g - w).max() <= 1e-5 * scale, name
            continue
        moved += 1
        assert _rel(g, w) <= F32_BWD_SHARE * effect, (name, _rel(g, w),
                                                      effect)
    assert moved >= 4     # the attention's weights and what feeds them


# Inputs with exactly tied maximal scores.  Per KV head a key row is scaled
# up (so that it is the chunk's maximum for about half the queries) and
# copied over others of the same chunk: keys 5 / 40 / 41 lie in one of the
# kernels' 64-key tiles (a three-way tie), 100 / 130 across their 64- and
# 128-key tiles, and 1030 / 1500 in the second of JAX's 1,024-key chunks;
# the causal case ties 5 / 40 and 60 / 70 (across a 64-key tile) in its
# first 128-key chunk and 150 / 200 in its second.  "ints" instead draws
# q and k from {-1, 0, 1}: every score is exact, and many rows tie between
# keys whose rows differ, so dQ's share of T tells the rules apart too.
# (Sq, Sk, causal, chunk, groups of tied keys.)
TIE_CASES = {
    "long": (128, 2048, False, 1024, ((5, 40, 41), (100, 130), (1030, 1500))),
    "causal": (256, 256, True, 128, ((5, 40), (60, 70), (150, 200))),
    "ints": (128, 1024, True, 1024, ()),
}


def _tie_inputs(mask, hd, dt, seed=1):
    Sq, Sk, causal, chunk, groups = TIE_CASES[mask]
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (
        (1, Sq, H, hd), (1, Sk, H // 2, hd), (1, Sk, H // 2, hd),
        (1, Sq, H, hd))]
    arrs[0] *= 1.5
    if not groups:
        arrs[0], arrs[1] = (rng.integers(-1, 2, size=a.shape).astype(
            np.float32) for a in arrs[:2])
    for keys in groups:
        # Rounded to the dtype first, so that the copies are equal in it.
        src = arrs[1][:, keys[0]] * 3.0
        if dt == "bf16":
            src = torch.tensor(src).to(torch.bfloat16).float().numpy()
        for j in keys:
            arrs[1][:, j] = src
    tdt, jdt = DTYPES[dt]
    torch_in = [torch.tensor(a).to(tdt) for a in arrs]
    jax_in = [jnp.asarray(a, jdt) for a in arrs]
    return torch_in, jax_in, dict(causal=causal, window=None), chunk


def _tied_rows(tq, tk, kw, chunk):
    """(dq rows, dk rows): boolean (B, Sq, H) of the query rows with a tied
    maximal score in some chunk, and (B, Sk, KV) of the keys that hold
    such a tie (``ref.chunk_max_stats``, whose scores are these)."""
    st = ref.chunk_max_stats(tq, tk, k_chunk=chunk, **kw)
    tied = st[..., 3] > 1                               # (B, H, Sq, NC)
    B, Sk, KV, hd = tk.shape
    Hh, Sq = tq.shape[2], tq.shape[1]
    s = torch.einsum("bqhd,bshd->bhqs", tq.float(),
                     tk.float().repeat_interleave(Hh // KV, 2))
    s = s * (1.0 / math.sqrt(hd))
    keys = torch.zeros((B, Hh, Sk), dtype=torch.bool)
    for c in range(st.shape[3]):
        ks = slice(c * chunk, (c + 1) * chunk)
        hit = (s[..., ks] == st[..., c, :1]) & tied[..., c:c + 1]
        if kw["causal"]:
            hit &= (torch.arange(Sq)[:, None]
                    >= torch.arange(Sk)[None, ks])
        keys[..., ks] |= hit.any(2)
    keys = keys.transpose(1, 2).reshape(B, Sk, KV, Hh // KV).any(-1)
    return tied.any(-1).transpose(1, 2), keys


def _share_on(got, want, off, rows):
    return _rel(got[rows], want[rows]) / _rel(want[rows], off[rows])


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("hd", (16, 64))
@pytest.mark.parametrize("mask", sorted(TIE_CASES))
def test_plain_version_splits_tied_maxima_as_jax(mask, hd, dt):
    """On inputs whose rows have exactly tied chunk maxima (two and three
    keys, in one tile and across tiles and chunks), the plain p_bf16
    forward and gradient equal JAX's with the file's tolerances, over the
    whole tensors and (float32) on the tied rows alone: dQ's rows with a
    tie and dK's tied keys within F32_BWD_SHARE of the flag's effect on
    those rows."""
    (tq, tk, tv, tdo), (jq, jk, jv, jdo), kw, chunk = _tie_inputs(mask, hd,
                                                                  dt)
    rows, keys = _tied_rows(tq, tk, kw, chunk)
    assert rows.sum() >= 64 and keys.sum() >= 4, (rows.sum(), keys.sum())
    want = _jax(jq, jk, jv, jdo, kw, chunk, True)
    got = _port(tq, tk, tv, tdo, kw, chunk)
    if dt == "f32":
        off = _jax(jq, jk, jv, jdo, kw, chunk, False)
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            effect = _rel(want[i], off[i])
            share = F32_FWD_SHARE if name == "o" else F32_BWD_SHARE
            assert _rel(got[i], want[i]) <= share * effect, name
        for i, r in ((1, rows.numpy()), (2, keys.numpy())):
            assert _share_on(got[i], want[i], off[i], r) <= F32_BWD_SHARE
    else:
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            tol = BF16_FWD_TOL if name == "o" else BF16_TOL
            scale = max(1.0, float(np.abs(want[i]).max()))
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("hd", (16, 64))
@pytest.mark.parametrize("mask", sorted(TIE_CASES))
def test_first_key_rule_misses_jax_on_tied_rows(mask, hd):
    """Giving T whole to the first maximal key (``split_ties=False``, the
    rule JAX does not follow) lands beyond F32_BWD_SHARE of the flag's
    effect on the tied rows of dQ or dK (measured 0.48-0.68), so the tie
    test above tells the two rules apart."""
    (tq, tk, tv, tdo), (jq, jk, jv, jdo), kw, chunk = _tie_inputs(mask, hd,
                                                                  "f32")
    rows, keys = _tied_rows(tq, tk, kw, chunk)
    want = _jax(jq, jk, jv, jdo, kw, chunk, True)
    off = _jax(jq, jk, jv, jdo, kw, chunk, False)
    o, lse = ref.flash_attention_ref(tq, tk, tv, q_chunk=chunk,
                                     k_chunk=chunk, return_lse=True,
                                     p_bf16=True, **kw)
    first = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo,
                                        q_chunk=chunk, k_chunk=chunk,
                                        p_bf16=True, split_ties=False, **kw)
    shares = [_share_on(first[i - 1].numpy(), want[i], off[i], r.numpy())
              for i, r in ((1, rows), (2, keys))]
    assert max(shares) > F32_BWD_SHARE, shares


def _stats_direct(q, k, causal, window, chunk):
    """ref.chunk_max_stats by loops over rows and chunks in float64 of the
    same float32 scores."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                     k.float().repeat_interleave(G, 2)) * (1 / math.sqrt(hd))
    s = s.double().numpy()
    nc = -(-Sk // chunk)
    out = np.zeros((B, H, Sq, nc, 4))
    for b, h, i in np.ndindex(B, H, Sq):
        for c in range(nc):
            ks = [j for j in range(c * chunk, min(Sk, (c + 1) * chunk))
                  if (not causal or j <= i)
                  and (window is None or j > i - window)]
            if not ks:
                out[b, h, i, c] = (np.float32(-1e30), 0, 0, 0)
                continue
            m = max(s[b, h, i, j] for j in ks)
            hit = [j for j in ks if s[b, h, i, j] == m]
            out[b, h, i, c] = (m, hit[0], hit[-1], len(hit))
    return out


@pytest.mark.parametrize("mask", ("causal", "noncausal", "window", "ints"))
def test_chunk_max_stats_counts_every_tied_key(mask):
    """ref.chunk_max_stats, the plain version of the forward's mstat: each
    row's chunk max, first and last maximal key and their count, equal to
    a direct loop over rows and chunks; rows that see no key of a chunk
    (-1e30, 0, 0, 0); the "ints" inputs have counts above 2."""
    if mask == "ints":
        (tq, tk, _, _), _, kw, chunk = _tie_inputs(mask, 16, "f32")
        tq, tk, chunk = tq[:, :64], tk[:, :256], 64
    else:
        (tq, tk, _, _), _, kw, chunk = _inputs(16, 2, mask, "f32")
    got = ref.chunk_max_stats(tq, tk, k_chunk=chunk, **kw)
    want = _stats_direct(tq, tk, kw["causal"], kw["window"], chunk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.double().numpy(), want)
    if mask == "ints":
        assert (want[..., 3] > 2).sum() >= 10
    if mask == "window":
        assert (want[..., 3] == 0).any()


def test_check_mstat_takes_the_forwards_layout_and_raises_else():
    """The wrapper's mstat contract, checked on the CPU: float32 (B, H,
    Sq, ceil(Sk / 1024), MSTAT_FIELDS = 4), what ref.chunk_max_stats
    gives; a missing tensor, the pre-tie layout with two fields, a wrong
    chunk count or float64 raise."""
    B, H, Sq, Sk = 2, 4, 8, 1500
    q = torch.zeros((B, Sq, H, 16))
    k = torch.zeros((B, Sk, 2, 16))
    good = ref.chunk_max_stats(q, k)
    assert K.MSTAT_FIELDS == 4 and good.shape == (B, H, Sq, 2, 4)
    K.check_mstat(good, B, H, Sq, Sk)
    for bad in (None, good[..., :2], good[..., :1, :], good.double()):
        with pytest.raises(ValueError, match="mstat"):
            K.check_mstat(bad, B, H, Sq, Sk)
