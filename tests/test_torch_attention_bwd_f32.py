"""The float32 attention backward kernels' arithmetic, on the CPU.

``fa_bwd_dq_wgmma<hd, hd_v, true>`` then ``fa_bwd_dkdv_wgmma<hd, hd_v,
true>`` (``csrc/flash_attention_bwd_sm90.cu``) take float32 q, k, v and do
as three bf16 planes each (``ref.split_bf16x3``, the split kernel's
planes) and form every float32 product from six plane products on the
tensor cores, the forward's passes (``SIX_PASSES``, smallest first).
``emulate_f32_bwd_kernel`` is that arithmetic in plain torch:

- S = q k^T and dP = do v^T as the six passes summed in float32;
- P = exp(scale S - lse) where the pair is visible, else 0, and dS = P
  (dP - D), with D = rowsum(do * o) summed as the dQ kernel sums it
  (sixteen float32 partial sums a row, then a half-warp tree);
- P and dS split into three bf16 terms, each term against the B operand's
  planes by the same six passes into a fresh float32 sum per ring tile,
  merged into the running dV, dK or dQ in the kernels' tile order and
  tile sizes (``bwd_tiling``, the source's ``BwdCfg``), dK and dQ times
  the scale once at the end.

It is held against ``jax.vjp`` of JAX's ``layers.flash_attention`` in
float32 at every head dim of ``HEAD_DIMS`` and MLA's (192, 128) pair,
causal, non-causal with Sq != Sk, and windowed, GQA groups 1, 2 and 4,
over lengths that leave ragged tiles.  The tolerance is F32_TOL = 2e-5
of max(1, max |grad|) per gradient, the float32 backward's tolerance on
the card (``chip_smoke.BWD_F32_TOL``).  The lse and o come from the plain
forward (``ref.flash_attention_ref``): this file tests the backward.

A source test pins the route: ``backward<float>`` instantiates the wgmma
kernels at every head dim and pair, and no CUDA-core float32 kernel is
left.  Inputs are made by numpy from a seed.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import _build, flash_attention as FA, ref
from test_torch_attention_split import SIX_PASSES

torch.set_num_threads(1)

F32_TOL = 2e-5
CHUNK = 16          # the JAX function's chunks (lengths are multiples)
H = 4
# (Sq, Sk, causal, window): lengths past one 128-row tile, not multiples
# of the kernels' tiles.
MASKS = {
    "causal": (208, 208, True, None),
    "noncausal": (144, 272, False, None),
    "window": (208, 208, True, 72),
}
HEAD_DIMS = (16, 32, 64, 80, 112, 128, (192, 128))

SMEM_MAX = 232448   # sm90_common.cuh: dynamic shared memory a CTA may take


def _dims(hd):
    return hd if isinstance(hd, tuple) else (hd, hd)


def _bwd_smem(planes, width, rows, tile, stages, stat):
    """The source's bwd_smem: shared-memory bytes of either kernel."""
    return (1024 + planes * 2 * width * (rows + stages * tile)
            + stages * stat * tile + 8 * (1 + 2 * stages))


def bwd_tiling(hd, hd_v, f32=True):
    """``BwdCfg<hd, hd_v, F32>``'s tiling: {"dq": (rows, BK, stages), "dkdv":
    (rows, BQ, stages)}.  bf16 keeps 128 rows, the register plan's tile
    and three stages; float32 takes 128 rows where they fit beside two
    stages of that tile, else 64, then the widest tile (halved at most
    twice) that fits two stages, and three stages where they fit."""
    w = hd + hd_v
    bq_max = 64 if w <= 160 else 32 if w <= 256 else 16
    bk_max = 64 if hd <= 128 else 32
    out = {}
    for kernel, tile_max, stat in (("dq", bk_max, 0), ("dkdv", bq_max, 8)):
        if not f32:
            out[kernel] = (128, tile_max, 3)
            continue

        def fits(rows, tile, stages):
            return _bwd_smem(3, w, rows, tile, stages, stat) <= SMEM_MAX
        rows = 128 if fits(128, tile_max, 2) else 64
        tile = next(t for t in (tile_max, tile_max // 2, tile_max // 4)
                    if fits(rows, t, 2) or t == tile_max // 4)
        out[kernel] = (rows, tile, 3 if fits(rows, tile, 3) else 2)
    return out


def _planes(x):
    """float32 x -> its three bf16 planes, as float32 tensors."""
    return [t.float() for t in ref.split_bf16x3(x)]


def _six(a, b, eq):
    """sum over SIX_PASSES of einsum(eq, a[pa], b[pb]) in float32, in the
    passes' order (each plane product exact in float32)."""
    out = None
    for pa, pb in SIX_PASSES:
        term = torch.einsum(eq, a[pa], b[pb])
        out = term if out is None else out + term
    return out


def _row_d(do, o):
    """D = rowsum(do * o) (B, H, Sq) as the float32 dQ kernel sums it:
    lane t of a half-warp sums columns t, t + 16, ... by FMA (a float64
    product and sum rounded once to float32), then the sixteen lanes add
    in a tree (xor 8, 4, 2, 1)."""
    B, Sq, Hq, hd_v = do.shape
    x = do.double().reshape(B, Sq, Hq, hd_v // 16, 16)
    y = o.double().reshape(B, Sq, Hq, hd_v // 16, 16)
    part = torch.zeros(B, Sq, Hq, 16, dtype=torch.float32)
    for c in range(hd_v // 16):
        part = (x[..., c, :] * y[..., c, :] + part.double()).float()
    lanes = torch.arange(16)
    for off in (8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    return part[..., 0].transpose(1, 2)


def emulate_f32_bwd_kernel(q, k, v, o, lse, do, causal, window):
    """(dq, dk, dv) by the float32 backward kernels' arithmetic (the note
    at the top), float32 tensors in the kernels' layouts."""
    B, Sq, Hq, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // KV
    tiles = bwd_tiling(hd, hd_v)
    BK, BQ = tiles["dq"][1], tiles["dkdv"][1]
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)

    def heads(x, expand):          # (B, S, heads, d) -> (B, H, S, d)
        x = x.repeat_interleave(G, dim=2) if expand else x
        return x.transpose(1, 2)
    qp = [heads(t, False) for t in _planes(q)]
    dop = [heads(t, False) for t in _planes(do)]
    kp = [heads(t, True) for t in _planes(k)]
    vp = [heads(t, True) for t in _planes(v)]
    s = _six(qp, kp, "bhqd,bhkd->bhqk")
    dp = _six(dop, vp, "bhqd,bhkd->bhqk")
    keep = ref._mask(torch.arange(Sq), torch.arange(Sk), causal, window)
    p = torch.where(keep, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dp - _row_d(do, o)[..., None])
    pt, dst = _planes(p), _planes(ds)

    # dQ: per query row, key tiles of BK in order, each into a fresh sum.
    dq = torch.zeros(B, Hq, Sq, hd)
    for k0 in range(0, Sk, BK):
        dq = dq + _six([t[..., k0:k0 + BK] for t in dst],
                       [t[:, :, k0:k0 + BK] for t in kp],
                       "bhqk,bhkd->bhqd")
    # dK / dV: per key row, the G query heads in turn, query tiles of BQ
    # in order; the group is summed in the running sum, never expanded.
    dk = torch.zeros(B, KV, Sk, hd)
    dv = torch.zeros(B, KV, Sk, hd_v)
    for g in range(G):
        hs = torch.arange(KV) * G + g   # head kvh * G + g of each KV head
        for q0 in range(0, Sq, BQ):
            rows = slice(q0, q0 + BQ)
            dv = dv + _six([t[:, hs, rows] for t in pt],
                           [t[:, hs, rows] for t in dop], "bhqk,bhqd->bhkd")
            dk = dk + _six([t[:, hs, rows] for t in dst],
                           [t[:, hs, rows] for t in qp], "bhqk,bhqd->bhkd")
    return ((dq * scale).transpose(1, 2), (dk * scale).transpose(1, 2),
            dv.transpose(1, 2))


def _cases():
    """Every head dim and the pair x mask, the GQA group taking 1, 2 and 4
    in turn; then every group at hd 64."""
    out, groups, i = [], (1, 2, 4), 0
    for hd in HEAD_DIMS:
        for mask in MASKS:
            out.append((hd, groups[i % 3], mask))
            i += 1
    for g in groups:
        for mask in MASKS:
            if (64, g, mask) not in out:
                out.append((64, g, mask))
    return out


def _ids(case):
    hd, g, mask = case
    hd = "x".join(map(str, hd)) if isinstance(hd, tuple) else hd
    return f"hd{hd}-g{g}-{mask}"


def _inputs(hd, group, mask, seed):
    hd_q, hd_v = _dims(hd)
    Sq, Sk, causal, window = MASKS[mask]
    rng = np.random.default_rng(seed)
    KV = H // group
    q = rng.standard_normal((1, Sq, H, hd_q), np.float32)
    k = rng.standard_normal((1, Sk, KV, hd_q), np.float32)
    v = rng.standard_normal((1, Sk, KV, hd_v), np.float32)
    do = rng.standard_normal((1, Sq, H, hd_v), np.float32)
    return q, k, v, do, causal, window


def _jax_grads(q, k, v, do, causal, window):
    def f(q, k, v):
        return JL.flash_attention(q, k, v, causal=causal, window=window,
                                  q_chunk=CHUNK, k_chunk=CHUNK)
    grads = jax.jit(lambda q, k, v, do: jax.vjp(f, q, k, v)[1](do))
    return grads(*(jnp.asarray(x, jnp.float32) for x in (q, k, v, do)))


@pytest.mark.parametrize("case", _cases(), ids=_ids)
def test_f32_bwd_kernel_arithmetic_equals_jax_vjp(case):
    hd, group, mask = case
    q, k, v, do, causal, window = _inputs(hd, group, mask, seed=11)
    want = _jax_grads(q, k, v, do, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window, return_lse=True)
    got = emulate_f32_bwd_kernel(tq, tk, tv, o, lse, tdo, causal, window)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=F32_TOL * scale, err_msg=name)


def test_f32_bwd_tiling_is_the_sources_table():
    """``bwd_tiling`` gives the tiles the source's note lists, every one
    within the shared-memory budget and at least one k16 step; bf16 keeps
    its 128 rows and three stages."""
    want = {16: ((128, 64, 3), (128, 64, 3)),
            32: ((128, 64, 3), (128, 64, 3)),
            64: ((128, 64, 2), (128, 64, 2)),
            80: ((64, 64, 2), (64, 64, 2)),
            112: ((64, 32, 3), (64, 32, 3)),
            128: ((64, 32, 2), (64, 32, 2)),
            (192, 128): ((64, 16, 3), (64, 16, 3))}
    for hd, (dq, dkdv) in want.items():
        hd_q, hd_v = _dims(hd)
        got = bwd_tiling(hd_q, hd_v)
        assert got == {"dq": dq, "dkdv": dkdv}, hd
        for kernel, stat in (("dq", 0), ("dkdv", 8)):
            rows, tile, stages = got[kernel]
            assert tile >= 16 and tile % 16 == 0
            assert _bwd_smem(3, hd_q + hd_v, rows, tile, stages,
                             stat) <= SMEM_MAX
        bf16 = bwd_tiling(hd_q, hd_v, f32=False)
        assert bf16["dq"][0] == bf16["dkdv"][0] == 128
        assert bf16["dq"][2] == bf16["dkdv"][2] == 3
    assert "constexpr int SMEM_MAX = 232448;" in (
        _build.CSRC / "sm90_common.cuh").read_text()


def test_f32_backward_routes_every_head_dim_to_the_wgmma_kernels():
    """``backward<float>`` (fa_backward_f32) and ``backward<bf16>`` reach
    one launcher, which launches the wgmma kernels of the dtype at every
    HEAD_DIMS entry and pair; no CUDA-core float32 kernel or route is
    left; the wrapper splits q, k, v and do before the float32 entry."""
    import inspect
    src = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    (dims,) = re.findall(r"#define HEAD_DIMS\(X\) ((?:X\(\d+\) ?)+)", src)
    assert tuple(int(d) for d in re.findall(r"\d+", dims)) == FA.HEAD_DIMS
    assert "HEAD_DIMS(SAME)" in src and "HEAD_DIM_PAIRS(CASE)" in src
    assert "constexpr bool F32 = std::is_same_v<T, float>;" in src
    assert "return launch<HD, HDV, F32>(" in src
    assert "return backward<float>(" in src
    assert "return backward<__nv_bfloat16>(" in src
    for kernel in ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma"):
        assert f"{kernel}<HD, HDV, F32><<<" in src
    assert len(re.findall(r"<<<", src)) == 2
    for gone in ("fa_bwd_dq<", "fa_bwd_dkdv<", "fa_bwd_dq(", "fa_bwd_dkdv(",
                 "launch_cuda_cores", "tile_grad", "load_tile", "dq_smem",
                 "dkdv_smem", "CUDA cores\n// ----"):
        assert gone not in src, gone
    body = inspect.getsource(FA.flash_attention_bwd)
    assert "split_bf16x3(x) for x in (q, k, v, do)" in body
