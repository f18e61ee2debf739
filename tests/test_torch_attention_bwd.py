"""The attention gradient's plain version against the JAX package, on the CPU.

``ref.flash_attention_bwd_ref(q, k, v, o, lse, do)`` is the plain version
of the backward kernel (``csrc/flash_attention_bwd_sm90.cu``); the JAX
package has no Pallas backward and trains through ``jax.vjp`` of its jnp
chunked attention ``layers.flash_attention``, the function the forward
kernel computes.  The same q, k, v and do, made with numpy from a seed, go
through:

  * ``jax.vjp`` of JAX's ``layers.flash_attention``, jitted;
  * torch autograd of the port's ``ref.flash_attention_ref``;
  * ``ref.flash_attention_bwd_ref`` from ``flash_attention_ref``'s output
    and log-sum-exp (``return_lse``);
  * ``kernels.flash_attention`` under grad on CPU tensors (the
    ``torch.autograd.Function`` of the kernels, whose CPU route is the
    plain forward and backward): the same gradients bit for bit;

at hd 16 / 64 / 80 / 112 / 128 and the (192, 128) pair of DeepSeek-V2's
MLA, GQA groups 1 / 2 / 4, causal, non-causal with Sq != Sk, and a
window, in float32 and bfloat16, over several chunks.  The lse is held
against ``torch.logsumexp`` of float64 scores.

Tolerances, elementwise over max(1, max |want|) of each gradient: float32
1e-5 against JAX (measured at most 1.1e-6) and against torch autograd of
the plain forward; bfloat16 2**-6 (two bf16 ulps at the largest entry),
measured at most 0.0091 (0.0075 without GQA).  The plain backward rounds
each float32 gradient once to bf16, from the bf16 output ``o`` (its D =
rowsum(do * o) carries o's rounding); JAX's transpose uses the unrounded
float32 output and, since ``jnp.repeat`` expands the bf16 k and v before
their cast to float32, rounds each query head's dk / dv to bf16 before it
sums the group.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA, ref

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -6
CHUNK = 16

# (name, Sq, Sk, causal, window)
MASKS = {
    "causal": (64, 64, True, None),
    "noncausal": (48, 80, False, None),
    "window": (64, 64, True, 24),
}
H = 4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _cases():
    """Every head dim (and the pair) x mask x dtype, the GQA group taking
    1, 2 and 4 in turn; then every group at hd 64."""
    out, groups = [], (1, 2, 4)
    dims = (16, 64, 80, 112, 128, (192, 128))
    i = 0
    for hd in dims:
        for mask in MASKS:
            for dt in DTYPES:
                out.append((hd, groups[i % 3], mask, dt))
                i += 1
    for g in groups:
        for mask in MASKS:
            for dt in DTYPES:
                if (64, g, mask, dt) not in out:
                    out.append((64, g, mask, dt))
    return out


CASES = _cases()


def _ids(case):
    hd, g, mask, dt = case
    hd = "x".join(map(str, hd)) if isinstance(hd, tuple) else hd
    return f"hd{hd}-g{g}-{mask}-{dt}"


def _inputs(hd, group, mask, seed=0):
    hd_q, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
    Sq, Sk, causal, window = MASKS[mask]
    rng = np.random.default_rng(seed)
    KV = H // group
    q = rng.standard_normal((2, Sq, H, hd_q), np.float32)
    k = rng.standard_normal((2, Sk, KV, hd_q), np.float32)
    v = rng.standard_normal((2, Sk, KV, hd_v), np.float32)
    do = rng.standard_normal((2, Sq, H, hd_v), np.float32)
    return q, k, v, do, causal, window


def _t(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jax_grads(q, k, v, do, causal, window, jdt):
    """``jax.vjp`` of JAX's attention at (q, k, v), pulled back from do,
    jitted (one compile a case, ~1.5 s; eagerly each query chunk's scan
    compiles on its own, ~3 s)."""
    def f(q, k, v):
        return JL.flash_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=CHUNK, k_chunk=CHUNK)
    grads = jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    return grads(*(jnp.asarray(x, jdt) for x in (q, k, v, do)))


def _plain(q, k, v, do, causal, window):
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_chunk=CHUNK, k_chunk=CHUNK,
                                     return_lse=True)
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, q_chunk=CHUNK,
                                       k_chunk=CHUNK)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bwd_ref_equals_jax_vjp(case):
    hd, group, mask, dt = case
    tdt, jdt = DTYPES[dt]
    q, k, v, do, causal, window = _inputs(hd, group, mask)
    want = _jax_grads(q, k, v, do, causal, window, jdt)
    got = _plain(*(_t(x, tdt) for x in (q, k, v, do)), causal, window)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tdt, name
        _close(g, w, tol)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("hd", (64, (192, 128)), ids=("hd64", "hd192x128"))
def test_bwd_ref_equals_torch_autograd_of_the_plain_forward(hd, mask):
    q, k, v, do, causal, window = _inputs(hd, 2, mask, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                  q_chunk=CHUNK, k_chunk=CHUNK)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = _plain(*(torch.from_numpy(x) for x in (q, k, v, do)), causal,
                 window)
    for g, w in zip(got, want):
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mask", MASKS)
def test_wrapper_under_grad_is_the_plain_forward_and_backward(mask, dt):
    """On CPU tensors the kernels' autograd Function runs the plain
    forward (with its lse) and the plain backward, bit for bit; without
    grad it returns the same output and saves nothing."""
    tdt = DTYPES[dt][0]
    q, k, v, do, causal, window = (
        _t(x, tdt) if isinstance(x, np.ndarray) else x
        for x in _inputs(64, 2, mask, seed=2))
    Sq, Sk = q.shape[1], k.shape[1]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FA.flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    assert torch.equal(out.detach(), o)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        plain = FA.flash_attention(*leaves, causal=causal, window=window)
    assert plain.grad_fn is None and torch.equal(plain, o)
    assert (Sq, Sk) == MASKS[mask][:2]


@pytest.mark.parametrize("mask", MASKS)
def test_lse_is_the_logsumexp_of_the_scores(mask):
    q, k, v, _, causal, window = _inputs(80, 4, mask, seed=3)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_chunk=CHUNK, k_chunk=CHUNK,
                                     return_lse=True)
    Sq, Sk = q.shape[1], k.shape[1]
    kk = k.double().repeat_interleave(H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), kk) / np.sqrt(80)
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= kpos > qpos - window
    want = torch.logsumexp(s.masked_fill(~keep, -torch.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_masked_rows_get_no_gradient():
    """A query row whose keys are all masked (causal, a window, Sq past
    Sk) has P = 0: dq is 0 there and dk / dv equal the gradients without
    those rows."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 32, 2, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 2, 16), np.float32))
    do = torch.from_numpy(rng.standard_normal((1, 32, 2, 16), np.float32))
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, window=4,
                                     return_lse=True)
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                             causal=True, window=4)
    # rows 11.. see no key (kpos <= 7 < qpos - 3)
    assert torch.equal(dq[:, 11:], torch.zeros_like(dq[:, 11:]))
    do_cut = do.clone()
    do_cut[:, 11:] = 0
    _, dk2, dv2 = ref.flash_attention_bwd_ref(q, k, v, o, lse, do_cut,
                                              causal=True, window=4)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_backward_source_instantiates_the_forward_head_dims():
    """The backward source's HEAD_DIMS and HEAD_DIM_PAIRS X-macros are the
    wrapper's lists (the forward source's, held by
    tests/test_torch_attention.py), each expanded in backward<T>."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    (dims,) = re.findall(r"#define HEAD_DIMS\(X\) ((?:X\(\d+\) ?)+)", src)
    assert tuple(int(d) for d in re.findall(r"\d+", dims)) == FA.HEAD_DIMS
    (pairs,) = re.findall(
        r"#define HEAD_DIM_PAIRS\(X\) ((?:X\(\d+, \d+\) ?)+)", src)
    got = tuple(tuple(int(x) for x in p)
                for p in re.findall(r"X\((\d+), (\d+)\)", pairs))
    assert got == FA.HEAD_DIM_PAIRS
    assert "HEAD_DIMS(SAME)" in src and "HEAD_DIM_PAIRS(CASE)" in src


# The bf16 kernels' arithmetic plan (csrc/flash_attention_bwd_sm90.cu):
# P and dS in float32 from the exact products of the bf16 inputs, each
# split into three bf16 terms (ref.split_bf16x3, the kernels' split3), one
# tensor-core product per term.  Below SPLIT_EXACT_FROM the last term may
# be a bf16 subnormal, which the tensor core may flush.
SPLIT_EXACT_FROM = 1e-30
# Float64 sums of the same products in two orders.
F64_REL = 1e-12
BWD_F32_ATOL = 1e-5  # chip_smoke.BWD_F32_ATOL: of the gradient's max |grad|
TRIPLES = sorted({c[:3] for c in CASES}, key=str)


def _triple_id(t):
    return _ids((*t, "bf16"))[:-5]


def _plan(hd, group, mask, seed=5, q_mul=1.0):
    """What the kernels form from bf16 inputs: q, k (expanded), v
    (expanded), do as float32, P and dS (B, H, Sq, Sk) by
    ``ref.flash_attention_bwd_ref``'s formulas in float32 (lse and o from
    the plain forward, D = rowsum(do * o)), and the scale."""
    q, k, v, do, causal, window = _inputs(hd, group, mask, seed)
    q, k, v, do = (_t(x, torch.bfloat16) for x in (q * q_mul, k, v, do))
    o, lse = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     q_chunk=CHUNK, k_chunk=CHUNK,
                                     return_lse=True)
    f = torch.float32
    Hq, Sq, Sk = q.shape[2], q.shape[1], k.shape[1]
    qf, dof = q.to(f), do.to(f)
    kf = k.to(f).repeat_interleave(Hq // k.shape[2], dim=2)
    vf = v.to(f).repeat_interleave(Hq // v.shape[2], dim=2)
    scale = 1.0 / np.sqrt(q.shape[-1])
    D = (dof * o.to(f)).sum(-1).transpose(1, 2)[..., None]
    keep = ref._mask(torch.arange(Sq), torch.arange(Sk), causal, window)
    s = torch.einsum("bqhd,bshd->bhqs", qf, kf) * scale
    p = torch.where(keep, torch.exp(torch.where(keep, s - lse[..., None],
                                                0.0)), 0.0)
    dp = torch.einsum("bqhd,bshd->bhqs", dof, vf)
    return qf, kf, vf, dof, p, p * (dp - D), scale


def _grads(terms, qf, kf, dof, scale):
    """dV, dK and dQ per query head (float64) with P and dS given as sums
    of terms: dV = P^T do, dK = scale dS^T q, dQ = scale dS k."""
    d = torch.float64
    p = [t[0].to(d) for t in terms]
    ds = [t[1].to(d) for t in terms]
    dv = sum(torch.einsum("bhqs,bqhd->bshd", x, dof.to(d)) for x in p)
    dk = sum(torch.einsum("bhqs,bqhd->bshd", x, qf.to(d)) for x in ds)
    dq = sum(torch.einsum("bhqs,bshd->bqhd", x, kf.to(d)) for x in ds)
    return dv, dk * scale, dq * scale


@pytest.mark.parametrize("triple", TRIPLES, ids=_triple_id)
def test_bwd_three_term_split_of_p_and_ds_is_exact(triple):
    """hi + mid + lo == x exactly (in float32 and in float64) for every P
    and dS the kernels split with |x| >= 1e-30, and no term of those is a
    bf16 subnormal the tensor core could flush; then each term's products
    with the bf16 do, q and k, summed in float64, give dV, dK and dQ to
    within float64 rounding of the float32 operands' products."""
    qf, kf, _, dof, p, ds, scale = _plan(*triple)
    tiny = torch.finfo(torch.float32).tiny  # bf16's least normal too
    for x in (p, ds):
        hi, mid, lo = ref.split_bf16x3(x)
        big = x.abs() >= SPLIT_EXACT_FROM
        assert big.any()
        total = hi.double() + mid.double() + lo.double()
        assert torch.equal(total[big], x.double()[big])
        f32 = (hi.float() + mid.float()) + lo.float()
        assert torch.equal(f32[big], x[big])
        for t in (hi, mid, lo):
            t = t.float()[big]
            assert not ((t != 0) & (t.abs() < tiny)).any()
    split = [ref.split_bf16x3(x) for x in (p, ds)]
    got = _grads(list(zip(*split)), qf, kf, dof, scale)
    want = _grads([(p, ds)], qf, kf, dof, scale)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= F64_REL * w.abs().max().item()


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("hd", (64, (192, 128)), ids=("hd64", "hd192x128"))
def test_bwd_flushed_tiny_terms_move_no_gradient(hd, mask):
    """Scores thirty times the usual size put many P and dS below 1e-30.
    Flushing every bf16 subnormal term there (what the tensor core may do)
    and the last term of every such value moves no gradient by more than
    BWD_F32_ATOL of its max |grad|."""
    qf, kf, _, dof, p, ds, scale = _plan(hd, 2, mask, seed=6, q_mul=30.0)
    tiny = torch.finfo(torch.float32).tiny
    flushed = []
    for x in (p, ds):
        small = (x != 0) & (x.abs() < SPLIT_EXACT_FROM)
        assert small.any()
        hi, mid, lo = (t.float() for t in ref.split_bf16x3(x))
        lo = torch.where(small, 0.0, lo)
        flushed.append([torch.where(t.abs() < tiny, 0.0, t)
                        for t in (hi, mid, lo)])
    got = _grads(list(zip(*flushed)), qf, kf, dof, scale)
    want = _grads([(p, ds)], qf, kf, dof, scale)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= (
            BWD_F32_ATOL * w.abs().max().item())
