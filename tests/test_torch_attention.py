"""The port's attention (``flash_attention_ref``, and the wrapper on CPU
tensors) against the JAX package's two attention functions, on the CPU.

The cases are those of tests/test_flash_attention.py — MHA, GQA 4:1, MQA,
head dims 32/64/128, non-causal with Sq != Sk, a 96-key sliding window,
bf16 — plus a ragged S = 1000 and the zoo's other head dims (16, the smoke
configs; 80, StableLM-3B; 112 windowed, Zamba2-7B's shared attention),
with inputs made by numpy from a seed.  (MLA's q/k 192 against v 128 is
in tests/test_torch_mla.py; here, the wrapper's list of such pairs and
its checks.)
Each is held against ``repro.models.layers.flash_attention`` (the jnp
chunked function the port copies) and, for a few, against
``flash_attention_pallas(interpret=True)`` (each of those costs a Pallas
compile).  Tolerances are that file's: 2e-5 for float32, 3e-2 for bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as K
from repro_torch.kernels.ref import flash_attention_ref, split_bf16x3
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 3e-2}

# name: (B, Sq, Sk, H, KV, hd, causal, window, dtype)
CASES = {
    "mha": (1, 128, 128, 4, 4, 64, True, None, "f32"),
    "gqa4": (2, 256, 256, 8, 2, 64, True, None, "f32"),
    "mqa_hd128": (1, 256, 256, 4, 1, 128, True, None, "f32"),
    "hd32": (2, 128, 128, 4, 4, 32, True, None, "f32"),
    "noncausal": (1, 128, 256, 4, 4, 64, False, None, "f32"),
    "window96": (1, 256, 256, 4, 2, 64, True, 96, "f32"),
    "bf16": (1, 128, 128, 4, 4, 64, True, None, "bf16"),
    "ragged1000": (1, 1000, 1000, 4, 1, 64, True, None, "f32"),
    "hd16": (2, 128, 128, 4, 2, 16, True, None, "f32"),
    "hd80": (1, 256, 256, 4, 4, 80, True, None, "f32"),
    "hd112_window": (1, 256, 256, 4, 4, 112, True, 96, "f32"),
}
PALLAS_CASES = ["gqa4", "window96", "bf16", "hd80"]


def _inputs(B, Sq, Sk, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    if dtype == "bf16":
        tq = [torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v)]
        jq = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    else:
        tq = [torch.as_tensor(a) for a in (q, k, v)]
        jq = [jnp.asarray(a) for a in (q, k, v)]
    return tq, jq


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_equals_jax_chunked_attention(name):
    B, Sq, Sk, H, KV, hd, causal, window, dt = CASES[name]
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Sk, H, KV, hd, dt)
    chunk = 64 if Sq % 64 == 0 else Sq
    got = flash_attention_ref(q, k, v, causal=causal, window=window,
                              q_chunk=chunk, k_chunk=chunk)
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     q_chunk=chunk, k_chunk=chunk)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, hd)
    _close(got, want, TOL[dt])
    # Default chunks (min(1024, S)), as the model calls it.
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    want = jax_flash(jq, jk, jv, causal=causal, window=window)
    _close(got, want, TOL[dt])


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_ref_equals_pallas_kernel_interpreted(name):
    B, Sq, Sk, H, KV, hd, causal, window, dt = CASES[name]
    (q, k, v), (jq, jk, jv) = _inputs(B, Sq, Sk, H, KV, hd, dt, seed=1)
    got = flash_attention_ref(q, k, v, causal=causal, window=window)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True)
    _close(got, want, TOL[dt])


def test_wrapper_on_cpu_runs_the_plain_version():
    (q, k, v), _ = _inputs(1, 128, 128, 4, 2, 64, "f32", seed=2)
    K.reset_launches()
    got = K.flash_attention(q, k, v, causal=True, window=96)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True,
                                                window=96))
    assert L.flash_attention is K.flash_attention
    assert K.LAUNCHES == {"flash_attention": 0, "flash_attention_f32": 0,
                          "split_bf16x3": 0, "flash_attention_bwd": 0,
                          "flash_attention_bwd_f32": 0,
                          "flash_attention_pbf16": 0,
                          "flash_attention_f32_pbf16": 0,
                          "flash_attention_bwd_pbf16": 0,
                          "flash_attention_bwd_f32_pbf16": 0}


def test_split_wrapper_on_cpu_runs_the_plain_version():
    """The split's wrapper stacks ref.split_bf16x3's planes for a CPU
    tensor, counts no launch, and takes float32 only."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 5, 3, 32)).astype(np.float32))
    K.reset_launches()
    got = K.split_bf16x3(x)
    assert got.dtype == torch.bfloat16 and got.shape == (3, *x.shape)
    for plane, want in zip(got, split_bf16x3(x)):
        assert torch.equal(plane, want)
    assert torch.equal(got.double().sum(0), x.double())
    assert K.LAUNCHES["split_bf16x3"] == 0
    with pytest.raises(TypeError, match="float32"):
        K.split_bf16x3(x.to(torch.bfloat16))


def test_each_cuda_dtype_has_one_kernel():
    """bf16 goes to fa_forward_bf16 and float32 to fa_forward_f32, both
    entries of the one tensor-core source, each counted under its own key;
    float32 reaches its kernel only through the split's bf16 planes, and
    the CUDA-core float32 source (csrc/flash_attention.cu) is gone.  The
    backward is the other source's two entries, one a dtype, each counted
    under its own key, both launching the two wgmma kernels of their
    dtype (float32 on the split's planes; the CUDA-core float32 kernels
    are gone).  Both sources take their Hopper primitives from one
    header."""
    import inspect
    from repro_torch.kernels import _build
    assert K.SOURCE == "flash_attention_sm90"
    assert K.ROUTES == {
        torch.bfloat16: ("fa_forward_bf16", "flash_attention"),
        torch.float32: ("fa_forward_f32", "flash_attention_f32")}
    assert {s.stem for s in _build.CSRC.glob("*.cu")} == {
        "mask_scores", "flash_attention_sm90", "flash_attention_bwd_sm90"}
    assert K.BWD_SOURCE == "flash_attention_bwd_sm90"
    assert K.BWD_ROUTES == {
        torch.bfloat16: ("fa_backward_bf16", "flash_attention_bwd"),
        torch.float32: ("fa_backward_f32", "flash_attention_bwd_f32")}
    bwd = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    for entry, _ in K.BWD_ROUTES.values():
        assert f'extern "C" int {entry}(' in bwd
    assert ("backward<__nv_bfloat16, false>(" in bwd
            and "backward<float, false>(" in bwd)
    # Both dtypes launch the two wgmma kernels, float32 its instantiation
    # (and the p_bf16 route its own, PB).
    for kernel in ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma"):
        assert f"{kernel}<HD, HDV, F32, PB><<<" in bwd
    assert "fa_bwd_dq<" not in bwd and "fa_bwd_dkdv<" not in bwd
    assert "std::is_same_v<T, float>" in bwd
    sm90 = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    for entry in ("fa_forward_bf16", "fa_forward_f32", K.SPLIT):
        assert f'extern "C" int {entry}(' in sm90
    # The wgmma / TMA primitives live in one header both sources include.
    common = (_build.CSRC / "sm90_common.cuh").read_text()
    assert "wgmma.mma_async" in common and "cp.async.bulk.tensor" in common
    assert "wgmma.mma_async" not in sm90 and "wgmma.mma_async" not in bwd
    for text in (sm90, bwd):
        assert '#include "sm90_common.cuh"' in text
    assert "fa_fwd_wgmma(" in sm90
    assert "split_bf16x3_kernel(" in sm90
    assert "fa_fwd_kernel" not in sm90
    # Both entries launch the one wgmma kernel, float32 with its planes.
    assert ("forward<false, false>(" in sm90
            and "forward<true, false>(" in sm90)
    assert "fa_fwd_wgmma<HD, HDV, F32, PB><<<" in sm90
    # The wrapper splits q, k and v before the float32 entry, and nowhere
    # else.
    body = inspect.getsource(K._forward)
    assert ("q, k, v = split_bf16x3(q), split_bf16x3(k), split_bf16x3(v)"
            in body)
    assert body.count("split_bf16x3(") == 3


def test_wrapper_knows_the_bf16_kernels_error_codes():
    """The wrapper's names for fa_forward_bf16's and fa_backward_bf16's
    own (negative) error codes are the constants the shared header
    defines and both sources return."""
    import re
    from repro_torch.kernels import _build
    common = (_build.CSRC / "sm90_common.cuh").read_text()
    codes = {int(v): name for name, v in re.findall(
        r"constexpr int (ERR_\w+) = (-\d+);", common)}
    assert sorted(codes) == sorted(K._TMA_ERRORS) == [-2, -1]
    for stem in (K.SOURCE, K.BWD_SOURCE):
        src = (_build.CSRC / f"{stem}.cu").read_text()
        assert all(f"return {name};" in src for name in codes.values())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (q, k, v), _ = _inputs(1, 64, 64, 4, 2, 64, "f32", seed=3)
    with pytest.raises(ValueError, match="H % KV"):
        K.flash_attention(q, k[:, :, :1].expand(1, 64, 3, 64).contiguous(),
                          v[:, :, :1].expand(1, 64, 3, 64).contiguous())
    with pytest.raises(TypeError, match="dtypes differ"):
        K.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="window"):
        K.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="positions_q0"):
        K.flash_attention(q, k, v, positions_q0=64)


def test_head_dims_are_the_kernel_sources_list():
    """The wrapper's HEAD_DIMS is the list the CUDA source instantiates
    (its HEAD_DIMS X-macro, expanded in forward<F32>'s switch), and the
    docstring refers to it by name, with no list of its own to drift."""
    import re
    from repro_torch.kernels import _build
    sm90 = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    (listed,) = re.findall(r"#define HEAD_DIMS\(X\) ((?:X\(\d+\) ?)+)",
                           sm90)
    assert tuple(int(d) for d in re.findall(r"\d+", listed)) == K.HEAD_DIMS
    assert K.HEAD_DIMS == (16, 32, 64, 80, 112, 128)
    assert "HEAD_DIMS(CASE)" in sm90
    doc = K.flash_attention.__doc__
    assert "``HEAD_DIMS``" in doc and not re.search(r"\{\d+(, \d+)*\}", doc)
    assert all(hd % 16 == 0 for hd in K.HEAD_DIMS)


def test_head_dim_pairs_are_the_kernel_sources_list():
    """The wrapper's HEAD_DIM_PAIRS is the (q/k, v) list the CUDA source
    instantiates (its HEAD_DIM_PAIRS X-macro, expanded in forward<F32>
    beside HEAD_DIMS): DeepSeek-V2's MLA, 192 against 128."""
    import re
    from repro_torch.kernels import _build
    sm90 = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    (listed,) = re.findall(
        r"#define HEAD_DIM_PAIRS\(X\) ((?:X\(\d+, \d+\) ?)+)", sm90)
    pairs = tuple(tuple(int(d) for d in pair) for pair in re.findall(
        r"X\((\d+), (\d+)\)", listed))
    assert pairs == K.HEAD_DIM_PAIRS == ((192, 128),)
    assert "HEAD_DIM_PAIRS(PAIR)" in sm90
    assert all(hd % 16 == 0 and hd_v % 16 == 0 and hd != hd_v
               for hd, hd_v in K.HEAD_DIM_PAIRS)


def test_wrapper_checks_unequal_head_dims():
    """``check_head_dims`` (the CUDA path's test) takes equal dims in
    HEAD_DIMS and the listed pairs only: an unlisted pair (192 / 64, the
    smoke config's 24 / 16) raises naming the pairs.  The shape checks of
    either path raise when v's leading dims are not k's; on the CPU the
    plain version takes any v width and returns (B, Sq, H, hd_v)."""
    for hd in K.HEAD_DIMS:
        K.check_head_dims(hd, hd)
    K.check_head_dims(192, 128)
    for hd, hd_v in ((192, 64), (24, 16), (128, 192), (192, 192)):
        with pytest.raises(ValueError, match=r"\(192, 128\)|16, 32"):
            K.check_head_dims(hd, hd_v)
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.normal(size=(1, 64, 4, 24)).astype(np.float32))
    k = torch.as_tensor(rng.normal(size=(1, 64, 2, 24)).astype(np.float32))
    v = torch.as_tensor(rng.normal(size=(1, 64, 2, 16)).astype(np.float32))
    K.reset_launches()
    got = K.flash_attention(q, k, v)
    assert tuple(got.shape) == (1, 64, 4, 16)
    assert torch.equal(got, flash_attention_ref(q, k, v))
    assert sum(K.LAUNCHES.values()) == 0
    for bad in (v[:, :32], v[:, :, :1], v[0]):
        with pytest.raises(ValueError, match="hd_v"):
            K.flash_attention(q, k, bad)
