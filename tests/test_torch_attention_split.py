"""The bf16 attention kernel's split of p (``ref.split_bf16x3``), on the CPU.

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

Inputs are made by numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import split_bf16x3

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
