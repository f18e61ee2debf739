"""The attention kernels' exact bf16 splits (``ref.split_bf16x3``), and
the float32 kernel's arithmetic, on the CPU.

``fa_fwd_wgmma`` runs p @ v on the tensor cores without rounding p: it
splits each float32 p into three bf16 terms, hi = bf16(p), mid =
bf16(p - hi), lo = bf16(p - hi - mid), and issues one bf16 product per
term into a float32 accumulator.  These tests pin the two facts that make
that the JAX package's float32 p @ v (``ATTN_P_BF16 = False``):

- hi + mid + lo == p bit for bit, for p over [1e-30, 1] and for the
  exp(s - m) of realistic score rows.  Below 1e-30 the low terms may be
  subnormal (the tensor cores may flush them); that is harmless, since
  every row holds a p of exactly 1, so l >= 1 and such terms fall far
  under float32 rounding.  The tests state this and bound the error there
  instead of asserting exactness.
- each term times a bf16 v is exact in float32, and hi@v + mid@v + lo@v,
  each taken in float64, equals p@v in float64 to float32 rounding and the
  JAX function's float32 p @ v to its summation error.

Float32 q, k and v take the same split (the ``split_bf16x3`` kernel) and
``fa_fwd_wgmma<hd, true>`` forms each float32 product from six of the
nine plane products.  These tests pin:

- the split is exact on float32 values of either sign from 2^-110 (below
  it lo is a bf16 subnormal too coarse for the last bits) to 3.39e38
  (just under where bf16 rounding overflows, about 3.396e38);
- six plane products are within 2^-23 |x y| of the float32 product x y,
  nine give it exactly, and each plane product is exact in float32;
- a plain torch emulation of the kernel's arithmetic (the planes, the six
  passes smallest first, float32 sums, each key tile's p @ v merged as
  acc * alpha + tile) equals the JAX chunked function at 2e-5 on the
  float32 cases of tests/test_torch_attention.py, and at MLA's q/k 192
  against v 128 (BK 32, the tile ``Cfg`` takes there).

Inputs are made by numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels.ref import split_bf16x3
from test_torch_attention import CASES, TOL, _inputs

F32_EPS = 2.0 ** -24          # float32 unit roundoff
BF16_SUBNORMAL_ULP = 2.0 ** -133


def _terms64(p):
    return [t.to(torch.float64) for t in split_bf16x3(p)]


def _score_rows(seed, hd, n_rows=64, n_keys=512, peak=1.0):
    """float32 p = exp(s - rowmax(s)) of bf16 q, k scores times
    1/sqrt(hd), as the kernel computes them; ``peak`` scales q to the
    reference init's large activations (very peaked rows)."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(n_rows, hd)) * peak).to(
        torch.bfloat16).float()
    k = torch.as_tensor(rng.normal(size=(n_keys, hd))).to(
        torch.bfloat16).float()
    s = (q @ k.T) * np.float32(1.0 / np.sqrt(hd))
    return torch.exp(s - s.amax(dim=1, keepdim=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_is_exact_over_the_range(seed):
    rng = np.random.default_rng(seed)
    p = (10.0 ** rng.uniform(-30, 0, size=200_000)).astype(np.float32)
    # Edges: 1, the range's ends, values next to powers of two.
    edges = np.float32([1.0, 1e-30, 0.5, 0.25])
    p = np.concatenate([p, edges, np.nextafter(edges, np.float32(0)),
                        np.nextafter(edges, np.float32(2))])
    p = torch.as_tensor(p)
    hi, mid, lo = split_bf16x3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(sum(_terms64(p)), p.to(torch.float64))
    # hi is p rounded to nearest; each lower term is under half an ulp of
    # the term above it.
    assert torch.equal(hi, p.to(torch.bfloat16))
    assert (mid.abs().double() <= hi.abs().double() * 2.0 ** -8).all()
    assert (lo.abs().double() <= mid.abs().double() * 2.0 ** -8).all()


@pytest.mark.parametrize("hd,peak", [(32, 1.0), (64, 1.0), (64, 30.0),
                                     (128, 1.0)])
def test_split_is_exact_on_softmax_rows(hd, peak):
    p = _score_rows(hd, hd, peak=peak)
    # Every row holds a p of exactly 1, so l >= 1.
    assert torch.equal(p.amax(dim=1), torch.ones(p.shape[0]))
    err = (sum(_terms64(p)) - p.to(torch.float64)).abs()
    normal = p >= 1e-30
    assert normal.sum() >= p.shape[0] * 64
    assert torch.equal(err[normal], torch.zeros_like(err[normal]))
    # Below 1e-30 the split is not asserted exact: the error stays under
    # one bf16 subnormal ulp, some 2^-110 of l.
    assert (err[~normal] <= BF16_SUBNORMAL_ULP).all()


@pytest.mark.parametrize("hd,peak", [(32, 1.0), (64, 1.0), (64, 30.0),
                                     (128, 1.0)])
def test_split_products_sum_to_the_float32_pv(hd, peak):
    p = _score_rows(100 + hd, hd, peak=peak)
    rng = np.random.default_rng(200 + hd)
    v = torch.as_tensor(rng.normal(size=(p.shape[1], hd))).to(torch.bfloat16)
    v64 = v.to(torch.float64)
    terms = _terms64(p)
    # Each term times a bf16 v is exact in float32 (8 + 8 significant
    # bits): the tensor cores form it without rounding.  Asserted for p >=
    # 1e-30 and |v| >= 2^-16; smaller products reach below float32's
    # subnormal floor (2^-149), under 2^-130 of l.
    exact = (p >= 1e-30)[:, :, None] & (v64.abs() >= 2.0 ** -16)[None]
    for t in terms:
        prod32 = (t[:, :, None].float() * v64[None].float()).to(torch.float64)
        prod64 = t[:, :, None] * v64[None]
        assert torch.equal(prod32[exact], prod64[exact])
    split = sum(t @ v64 for t in terms)
    want64 = p.to(torch.float64) @ v64
    scale = p.abs().to(torch.float64) @ v64.abs()
    assert ((split - want64).abs() <= F32_EPS * scale).all()
    # The JAX function's p @ v: a float32 dot of p and the upcast v, which
    # differs from the exact sum by its own float32 summation error.
    jax_pv = jax.lax.dot_general(
        jnp.asarray(p.numpy()), jnp.asarray(v.float().numpy()),
        (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    jax_pv = torch.from_numpy(np.array(jax_pv, np.float64))
    assert ((split - jax_pv).abs() <= p.shape[1] * F32_EPS * scale).all()


# The float32 kernel's plane products, smallest first (the source's
# pass_a / pass_b): (plane of the left operand, plane of the right), 0 hi,
# 1 mid, 2 lo.
SIX_PASSES = [(1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0)]
NINE_PASSES = [(a, b) for a in range(3) for b in range(3)]
SPLIT_MIN, SPLIT_MAX = 2.0 ** -110, 3.39e38


def _log_uniform(rng, n, lo, hi):
    """float32 values of random sign, log-uniform in magnitude on [lo, hi]."""
    mag = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_exact_on_qkv_values_over_the_range(seed):
    rng = np.random.default_rng(10 + seed)
    x = _log_uniform(rng, 400_000, SPLIT_MIN, SPLIT_MAX)
    # Edges: the range's ends, powers of two and their neighbours, values
    # one float32 ulp either side of a bf16 rounding tie.
    edges = np.float32([SPLIT_MIN, SPLIT_MAX, 1.0, 2.0 ** 100, 2.0 ** -100,
                        1.0 + 2.0 ** -8, 3.0 * 2.0 ** -9])
    near = np.concatenate([np.nextafter(edges, np.float32(0)),
                           np.nextafter(edges, np.float32(np.inf))])
    near = near[(near >= SPLIT_MIN) & (near <= SPLIT_MAX)]
    x = torch.as_tensor(np.concatenate([x, edges, -edges, near, -near]))
    hi, mid, lo = split_bf16x3(x)
    assert torch.equal(sum(_terms64(x)), x.to(torch.float64))
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert torch.isfinite(hi.float()).all()
    assert (mid.abs().double() <= hi.abs().double() * 2.0 ** -8).all()
    assert (lo.abs().double() <= mid.abs().double() * 2.0 ** -8).all()


def test_split_range_ends_are_where_exactness_stops():
    """Just outside the stated range the split fails as the range says:
    below 2^-110 some value loses its last bits in a subnormal lo, and past
    bf16's overflow threshold hi is infinite."""
    rng = np.random.default_rng(3)
    tiny = torch.as_tensor(_log_uniform(rng, 100_000, 2.0 ** -126,
                                        2.0 ** -112))
    assert not torch.equal(sum(_terms64(tiny)), tiny.to(torch.float64))
    big = torch.as_tensor(np.float32([3.3962e38, 3.4e38]))
    assert torch.isinf(split_bf16x3(big)[0].float()).all()


def _plane_products(x, y, passes):
    """sum over ``passes`` of x_a * y_b, each product and the sum in
    float64 (exact: 8 + 8 significant bits a product, at most 6 + 33 bits
    across the sum)."""
    xs, ys = _terms64(x), _terms64(y)
    return sum(xs[a] * ys[b] for a, b in passes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_six_plane_products_are_within_float32_rounding(seed):
    rng = np.random.default_rng(20 + seed)
    x = torch.as_tensor(_log_uniform(rng, 300_000, 1e-20, 1e20))
    y = torch.as_tensor(_log_uniform(rng, 300_000, 1e-20, 1e20))
    exact = x.double() * y.double()          # exact: 24 + 24 bits <= 53
    six = _plane_products(x, y, SIX_PASSES)
    assert ((six - exact).abs() < 2.0 ** -23 * exact.abs()).all()
    assert torch.equal(_plane_products(x, y, NINE_PASSES), exact)
    # The error of six products sits at float32's own rounding of x y.
    assert ((six - exact).abs() / exact.abs()).max() > 2.0 ** -26


def test_each_plane_product_is_exact_in_float32():
    """The tensor cores form each plane product in float32; it is exact
    where it is a normal float32 (here |x|, |y| in [1e-15, 1e15])."""
    rng = np.random.default_rng(30)
    x = torch.as_tensor(_log_uniform(rng, 200_000, 1e-15, 1e15))
    y = torch.as_tensor(_log_uniform(rng, 200_000, 1e-15, 1e15))
    xs, ys = split_bf16x3(x), split_bf16x3(y)
    for a, b in NINE_PASSES:
        p32 = xs[a].float() * ys[b].float()
        p64 = xs[a].double() * ys[b].double()
        normal = p64.abs() >= 2.0 ** -126
        assert torch.equal(p32.double()[normal], p64[normal])
    assert normal.float().mean() > 0.9      # lo * lo: most still normal


def _kernel_bk(hd):
    """Keys per tile of fa_fwd_wgmma<hd, true> (Cfg: BK)."""
    return 32 if hd == 128 else 64


def emulate_f32_kernel(q, k, v, causal, window, bk=None):
    """fa_fwd_wgmma<hd, hd_v, true>'s arithmetic in plain torch on the CPU
    (``bk`` keys a tile, by default ``_kernel_bk(hd)``): q, k
    and v as bf16 planes; per key tile, S = the six plane passes of q k^T
    summed in float32, smallest first, times 1/sqrt(hd); the Pallas masks
    (-1e30 masked; keys past Sk are absent, the kernel's -inf weighs 0);
    an online softmax in float32; p split into its planes and the tile's
    p @ v from six passes into a fresh float32 sum, merged as acc * alpha
    + tile; the output acc / max(l, 1e-30).  Every row visits every key
    tile: a tile the kernel skips is fully masked, and visiting it changes
    nothing (after a real key alpha = 1 and p = 0 exactly; before one its
    junk is wiped by alpha = 0)."""
    B, Sq, H, hd = q.shape
    Sk, G = k.shape[1], H // k.shape[2]

    def planes(x, expand):
        ps = [t.float() for t in split_bf16x3(x)]
        if expand:
            ps = [t.repeat_interleave(G, dim=2) for t in ps]
        return [t.transpose(1, 2) for t in ps]       # (B, H, S, hd)

    qp, kp, vp = planes(q, False), planes(k, True), planes(v, True)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    acc = torch.zeros(B, H, Sq, v.shape[-1])
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros(B, H, Sq)
    qpos = torch.arange(Sq)[:, None]
    BK = bk or _kernel_bk(hd)
    for k0 in range(0, Sk, BK):
        kb = [t[:, :, k0:k0 + BK] for t in kp]
        vb = [t[:, :, k0:k0 + BK] for t in vp]
        s = torch.zeros(B, H, Sq, kb[0].shape[2])
        for a, b in SIX_PASSES:
            s = s + qp[a] @ kb[b].transpose(-1, -2)
        s = s * scale
        kpos = k0 + torch.arange(s.shape[-1])[None, :]
        keep = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            keep &= qpos >= kpos
        if window is not None:
            keep &= kpos > qpos - window
        s = torch.where(keep, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pp = [t.float() for t in split_bf16x3(p)]
        tile = torch.zeros_like(acc)
        for a, b in SIX_PASSES:
            tile = tile + pp[a] @ vb[b]
        acc = acc * alpha[..., None] + tile
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


F32_CASES = sorted(n for n, c in CASES.items() if c[-1] == "f32")


@pytest.mark.parametrize("name", F32_CASES)
def test_f32_kernel_arithmetic_equals_jax_attention(name):
    B, Sq, Sk, H, KV, hd, causal, window, dt = CASES[name]
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Sk, H, KV, hd, dt, seed=7)
    got = emulate_f32_kernel(q, k, v, causal, window)
    want = jax_flash(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=TOL["f32"], atol=TOL["f32"])


@pytest.mark.parametrize("causal,Sq,Sk,KV", [(True, 200, 200, 2),
                                             (False, 96, 160, 1)])
def test_f32_kernel_arithmetic_at_the_mla_pair_equals_jax(causal, Sq, Sk,
                                                          KV):
    """The float32 kernel's arithmetic at q/k 192 against v 128 in BK 32
    tiles (Cfg at the pair: one stage), ragged tiles and GQA, against the
    JAX chunked function with hd_v = v.shape[-1], float32 within 2e-5."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (1, Sq, 2, 192), (1, Sk, KV, 192), (1, Sk, KV, 128)))
    got = emulate_f32_kernel(*(torch.as_tensor(a) for a in (q, k, v)),
                             causal, None, bk=32)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    assert tuple(got.shape) == (1, Sq, 2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=TOL["f32"], atol=TOL["f32"])
