"""Port mask scorers vs the JAX package's.

The port's plain versions (``repro_torch.kernels.ref``, what a wrapper
runs on a CPU tensor) are held against the JAX package's jnp oracles
(``repro.kernels.ref``) and its mask tables, over every mask x profile of
all four device presets.  Integer results (cc, mcc) and float32 results
(frag, ecc with integer weights or real probabilities) must be equal
exactly: both sides do the same float32 operations in the same order,
one rounding each.  tests/test_torch_kernels_pallas.py holds them
against the Pallas kernels in interpret mode.
The CUDA kernels themselves are checked against the plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.kernels import ref as jref
from repro_torch.core import mig
from repro_torch.core.tables import tables_for_model
from repro_torch.kernels import mask_scores, ops, ref

torch.set_num_threads(1)

PRESETS = sorted(mig.DEVICE_MODELS)


def _models(name):
    return mig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]


def _weights(model, seed):
    """(integer counts, real probabilities) as float32, made with numpy."""
    rng = np.random.default_rng(seed)
    n = model.num_profiles
    return (rng.integers(0, 60, n).astype(np.float32),
            rng.dirichlet(np.ones(n)).astype(np.float32))


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", PRESETS)
def test_plain_versions_match_jax_oracles(name):
    model, jmodel = _models(name)
    masks = np.arange(model.num_masks, dtype=np.int32)
    t, j = torch.from_numpy(masks), jnp.asarray(masks)
    _eq(ref.cc_ref(t, model), jref.cc_ref(j, jmodel))
    _eq(ref.frag_ref(t, model), jref.frag_ref(j, jmodel))
    for p in range(model.num_profiles):
        _eq(ref.mcc_score_ref(t, p, model), jref.mcc_score_ref(j, p, jmodel))
        for w in _weights(model, p):
            _eq(ref.ecc_score_ref(t, p, torch.from_numpy(w), model),
                jref.ecc_score_ref(j, p, jnp.asarray(w), jmodel))


@pytest.mark.parametrize("name", PRESETS)
def test_plain_versions_match_tables(name):
    """Closes the loop to the mask tables the replay's tables path reads."""
    model = mig.DEVICE_MODELS[name]
    T = tables_for_model(model)
    t = torch.arange(model.num_masks, dtype=torch.int32)
    _eq(ref.cc_ref(t, model), T.cc.astype(np.int32))
    _eq(ref.frag_ref(t, model), T.frag)
    for p in range(model.num_profiles):
        _eq(ref.mcc_score_ref(t, p, model), T.cc_after[:, p].astype(np.int32))
        w = torch.from_numpy(_weights(model, p)[0])
        want = np.where(T.fits[:, p],
                        T.counts_after[:, p].astype(np.int64)
                        @ w.numpy().astype(np.int64), -1)
        _eq(ref.ecc_score_ref(t, p, w, model), want.astype(np.float32))


@pytest.mark.parametrize("n", [1, 7, 127, 1860, 8193])
def test_ops_on_ragged_n(n):
    rng = np.random.default_rng(n)
    masks = rng.integers(0, 256, size=n).astype(np.uint8)
    T = tables_for_model(mig.A100_40GB)
    i = masks.astype(np.int64)
    _eq(ops.cc_scores(masks, device="cpu"), T.cc[i].astype(np.int32))
    _eq(ops.frag_scores(masks, device="cpu"), T.frag[i])
    for p in (0, 3, 5):
        got = ops.mcc_scores(masks, p, device="cpu")
        _eq(got, T.cc_after[i, p].astype(np.int32))
        probs = np.array([0.42, 0.06, 0.16, 0.11, 0.06, 0.19], np.float32)
        _eq(ops.ecc_scores(masks, p, probs, device="cpu"),
            jref.ecc_score_ref(jnp.asarray(masks), p, jnp.asarray(probs)))


def test_ops_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is checked "
                    "without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.cc_scores(np.arange(8))


def test_cpu_tensor_runs_plain_version_and_is_not_counted():
    mask_scores.reset_launches()
    masks = torch.arange(256, dtype=torch.int32)
    w = torch.ones(6)
    mask_scores.cc(masks, mig.A100_40GB)
    mask_scores.frag(masks, mig.A100_40GB)
    mask_scores.mcc(masks, 2, mig.A100_40GB)
    mask_scores.ecc(masks, 2, w, mig.A100_40GB)
    fleet = (torch.zeros(256, dtype=torch.int64), torch.zeros((1, 2)),
             torch.ones((256, 2)), torch.zeros(2))
    mask_scores.mcc_pick(masks, *fleet, 2, mig.A100_40GB)
    mask_scores.ecc_pick(masks, *fleet, 2, w, mig.A100_40GB)
    assert mask_scores.LAUNCHES == {"cc": 0, "frag": 0, "mcc": 0, "ecc": 0,
                                    "mcc_pick": 0, "ecc_pick": 0}


def test_wrappers_validate_inputs():
    m = mig.A100_40GB
    with pytest.raises(TypeError):
        mask_scores.cc(torch.arange(4, dtype=torch.int64), m)
    with pytest.raises(TypeError):
        mask_scores.mcc(torch.zeros((2, 2), dtype=torch.int32), 0, m)
    with pytest.raises(ValueError):
        mask_scores.mcc(torch.arange(4, dtype=torch.int32), 6, m)
    with pytest.raises(TypeError):
        mask_scores.ecc(torch.arange(4, dtype=torch.int32), 0,
                        torch.ones(5), m)


@pytest.mark.parametrize("name", PRESETS)
def test_kernel_slot_templates(name):
    """The struct handed to the kernels lists each profile's slots."""
    model = mig.DEVICE_MODELS[name]
    st = mask_scores.model_struct(model)
    assert (st.num_blocks, st.num_profiles, st.num_slots) == (
        model.num_blocks, model.num_profiles, model.num_slots)
    for p, masks in enumerate(model.profile_slot_masks):
        got = list(st.slot_mask[st.prof_start[p]:st.prof_start[p + 1]])
        assert got == list(masks)
        assert st.prof_size[p] == model.profiles[p].size
        assert set(st.slot_shift[st.prof_start[p]:st.prof_start[p + 1]]) <= {
            4 * p}
        # A profile's count fits its 4-bit field.
        assert len(masks) <= mask_scores.MAX_PROFILE_SLOTS < 16


def test_build_flags_per_source():
    """mask_scores.cu keeps the flags (so the library name) it was built
    with before `_build` took per-source flags; the attention sources
    (forward and backward) build with FMA contraction on, and none with
    fast math (the exact splits of p and of float32 q, k, v need their
    roundings as written)."""
    import hashlib
    from repro_torch.kernels import _build
    old = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
    assert _build.nvcc_flags("mask_scores") == old
    src = _build.CSRC / "mask_scores.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(old).encode())
    want = f"libmask_scores_{h.hexdigest()[:16]}.so"
    assert _build._target(src).name == want
    attention = ("flash_attention_sm90", "flash_attention_bwd_sm90")
    for stem in attention:
        flags = _build.nvcc_flags(stem)
        assert "-fmad=false" not in flags
        assert flags == tuple(f for f in old if f != "-fmad=false")
    assert {s.stem for s in _build.CSRC.glob("*.cu")} == {
        "mask_scores", *attention}
    # The attention sources share one header, hashed into their names;
    # mask_scores.cu includes none.
    assert {h.name for h in _build.CSRC.glob("*.cuh")} == {"sm90_common.cuh"}
    for stem in attention:
        assert _build.headers(_build.CSRC / f"{stem}.cu") == (
            _build.CSRC / "sm90_common.cuh",)
    assert _build.headers(src) == ()
    for stem in ("mask_scores", *attention):
        assert not any("fast_math" in f for f in _build.nvcc_flags(stem))


def test_build_target_hashes_the_included_headers(tmp_path):
    """A library's name changes with every header its source includes,
    directly or through another header, and with nothing else: a stale
    header would otherwise load the library built before it changed."""
    from repro_torch.kernels import _build
    src = tmp_path / "kern.cu"
    src.write_text('#include <cuda.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#pragma once\n")
    (tmp_path / "unused.cuh").write_text("#pragma once\n")
    assert _build.headers(src) == (tmp_path / "a.cuh", tmp_path / "b.cuh")
    names = [_build._target(src).name]
    for header, text in (("a.cuh", "#pragma once\n#include \"b.cuh\"\n"),
                         ("b.cuh", "#pragma once\nint g();\n")):
        (tmp_path / header).write_text(text)
        names.append(_build._target(src).name)
    (tmp_path / "unused.cuh").write_text("int h();\n")
    names.append(_build._target(src).name)
    assert len(set(names[:3])) == 3 and names[3] == names[2]
    assert all(n.startswith("libkern_") and n.endswith(".so") for n in names)
