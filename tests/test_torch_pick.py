"""The port's fused MCC/MECC picks vs the JAX package's composition.

``mask_scores.mcc_pick`` / ``ecc_pick`` compute the replay's whole
kernel-path pick of one arrival: host headroom, the Alg. 6 / Alg. 7 score
and the first maximizer.  On a CPU tensor they run the plain versions
``ref.mcc_pick_ref`` / ``ecc_pick_ref``, held here against what the JAX
replay's ``_kernel_pick`` composes (``repro/core/batched.py``):
``engine_mcc_scores`` / ``engine_ecc_scores`` in interpret mode, masked by
``all(host_used[gpu_host] + need <= cap_g)``, then
``where(any(scores >= 0), argmax(scores), -1)``, jitted as the replay
jits it.  Inputs are numpy draws from a seed; every comparison is exact.
The CUDA pick kernels are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st
from _torch_fleets import CASES, fleet as _fleet, weights as _weights

from repro.core import mig as jmig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.policy_score import (LANES, engine_ecc_scores,
                                        engine_mcc_scores)
from repro_torch.core import mig
from repro_torch.core import policy_core as pc
from repro_torch.kernels import mask_scores as K, ref

torch.set_num_threads(1)

PRESETS = sorted(mig.DEVICE_MODELS)
G_ALIGNED = 256          # a multiple of 128, as the JAX engine bridge needs


@functools.lru_cache(maxsize=None)
def _jax_pick(name: str, kind: str):
    """The JAX replay's kernel-path pick for one preset, jitted (the
    profile is traced, as in the replay's scan)."""
    model = jmig.DEVICE_MODELS[name]

    @jax.jit
    def pick(free, ghost, host_used, cap_g, need, profile, w):
        host_ok = jnp.all(host_used[ghost] + need <= cap_g, axis=1)
        if kind == "mcc":
            cc = engine_mcc_scores(free, profile, model=model, interpret=True)
            scores = jnp.where(host_ok, cc, -1)
        else:
            row = jnp.zeros((1, LANES), jnp.float32).at[0, :w.shape[0]].set(w)
            ecc = engine_ecc_scores(free, profile, row, model=model,
                                    interpret=True)
            scores = jnp.where(host_ok, ecc, jnp.float32(-1))
        return jnp.where(jnp.any(scores >= 0), jnp.argmax(scores), -1)

    return pick


def _port_pick(kind, fleet, profile, w, model) -> int:
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in fleet]
    if kind == "mcc":
        got = K.mcc_pick(*t, profile, model)
        plain = ref.mcc_pick_ref(*t, profile, model)
    else:
        wt = torch.from_numpy(w)
        got = K.ecc_pick(*t, profile, wt, model)
        plain = ref.ecc_pick_ref(*t, profile, wt, model)
    assert got.dtype == torch.int64 and got.shape == (1,)
    assert torch.equal(got, plain)
    return int(got)


def _jax_pick_of(name, kind, fleet, profile, w) -> int:
    free, ghost, used, cap_g, need = fleet
    return int(_jax_pick(name, kind)(
        jnp.asarray(free), jnp.asarray(ghost), jnp.asarray(used),
        jnp.asarray(cap_g), jnp.asarray(need), jnp.int32(profile),
        jnp.asarray(w)))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", PRESETS)
def test_mcc_pick_matches_jax_composition(name, case):
    model = mig.DEVICE_MODELS[name]
    w0 = np.ones(model.num_profiles, np.float32)
    for p in range(model.num_profiles):
        fleet = _fleet(model, G_ALIGNED, seed=10 * p + CASES.index(case),
                       case=case)
        got = _port_pick("mcc", fleet, p, w0, model)
        assert got == _jax_pick_of(name, "mcc", fleet, p, w0), (name, p)
        if case in ("none_fit", "blocked"):
            assert got == -1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", PRESETS)
def test_ecc_pick_matches_jax_composition(name, case):
    model = mig.DEVICE_MODELS[name]
    for p in range(model.num_profiles):
        fleet = _fleet(model, G_ALIGNED, seed=10 * p + CASES.index(case),
                       case=case)
        for w in _weights(model, p):
            got = _port_pick("ecc", fleet, p, w, model)
            assert got == _jax_pick_of(name, "ecc", fleet, p, w), (name, p)
            if case in ("none_fit", "blocked"):
                assert got == -1


def test_ties_go_to_the_first_maximizer():
    """Every GPU fully free and every host open: each scores the same, so
    the pick is the first GPU whose host is open."""
    model = mig.A100_40GB
    G = 128
    free = np.full(G, model.full_mask, np.int32)
    ghost = np.arange(G, dtype=np.int64) % 4
    used = np.array([[9, 0], [9, 0], [0, 0], [0, 0]], np.float32)
    cap_g = np.full((G, 2), 8.0, np.float32)
    need = np.array([1.0, 1.0], np.float32)
    fleet = (free, ghost, used, cap_g, need)
    w = np.ones(model.num_profiles, np.float32)
    for p in range(model.num_profiles):
        for kind in ("mcc", "ecc"):
            assert _port_pick(kind, fleet, p, w, model) == 2
            assert _jax_pick_of(model.name, kind, fleet, p, w) == 2


@pytest.mark.parametrize("G", [1, 31, 1860])
@pytest.mark.parametrize("name", PRESETS)
def test_pick_on_ragged_fleet_equals_score_then_first_max(name, G):
    """At any G the pick is the replay's former composition: the score
    wrapper, ``where(host_ok)`` and ``policy_core.first_max``."""
    model = mig.DEVICE_MODELS[name]
    for case in CASES:
        fleet = _fleet(model, G, seed=G + CASES.index(case), case=case)
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in fleet]
        free, ghost, used, cap_g, need = t
        host_ok = (used[ghost] + need <= cap_g).all(dim=1)
        for p in range(model.num_profiles):
            scores = torch.where(host_ok, K.mcc(free, p, model), -1)
            want = pc.first_max(scores, (scores >= 0).any())
            assert torch.equal(K.mcc_pick(*t, p, model), want)
            for w in map(torch.from_numpy, _weights(model, p)):
                scores = torch.where(host_ok, K.ecc(free, p, w, model), -1.0)
                want = pc.first_max(scores, (scores >= 0).any())
                assert torch.equal(K.ecc_pick(*t, p, w, model), want)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1),
       name=st.sampled_from(PRESETS),
       case=st.sampled_from(CASES),
       kind=st.sampled_from(["mcc", "ecc_int", "ecc_prob"]),
       hosts=st.integers(1, G_ALIGNED))
def test_pick_on_random_fleets(seed, name, case, kind, hosts):
    model = mig.DEVICE_MODELS[name]
    rng = np.random.default_rng(seed)
    p = int(rng.integers(model.num_profiles))
    free, ghost, used, cap_g, need = _fleet(model, G_ALIGNED, seed,
                                            case=case, H=hosts)
    # GPUs on the first ``hosts`` of G_ALIGNED host rows (one jit shape).
    rows = np.zeros((G_ALIGNED, 2), np.float32)
    rows[:hosts] = used
    fleet = (free, ghost, rows, cap_g, need)
    w = _weights(model, seed)[kind == "ecc_prob"]
    k = "mcc" if kind == "mcc" else "ecc"
    assert _port_pick(k, fleet, p, w, model) == _jax_pick_of(
        name, k, fleet, p, w)


@pytest.mark.parametrize("name", PRESETS)
def test_score_refs_ignore_bits_above_the_blocks(name):
    """Masks with bits set above num_blocks (bit 31 included): the score
    refs equal the JAX Pallas kernels in interpret mode (mcc, ecc with
    integer weights) and the jnp oracle (ecc with probabilities), and
    equal their own scores of ``mask & full``."""
    model, jmodel = mig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    free = _fleet(model, 4 * model.num_masks, seed=7, case="high_bits")[0]
    free[:model.num_masks] = (np.arange(model.num_masks)
                              | (1 << model.num_blocks) | (-2 ** 31))
    low = free & model.full_mask
    t, tl, j = (torch.from_numpy(free), torch.from_numpy(low),
                jnp.asarray(free))
    for p in range(model.num_profiles):
        got = ref.mcc_score_ref(t, p, model)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jops.mcc_scores(j, p, model=jmodel, interpret=True)))
        assert torch.equal(got, ref.mcc_score_ref(tl, p, model))
        w_int, w_prob = map(torch.from_numpy, _weights(model, p))
        got = ref.ecc_score_ref(t, p, w_int, model)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jops.ecc_scores(j, p, jnp.asarray(w_int.numpy()), model=jmodel,
                            interpret=True)))
        assert torch.equal(got, ref.ecc_score_ref(tl, p, w_int, model))
        got = ref.ecc_score_ref(t, p, w_prob, model)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref.ecc_score_ref(j, p, jnp.asarray(w_prob.numpy()), jmodel)))
        assert torch.equal(got, ref.ecc_score_ref(tl, p, w_prob, model))


def test_pick_wrappers_validate_inputs():
    model = mig.A100_40GB
    free = torch.zeros(4, dtype=torch.int32)
    fleet = dict(gpu_host=torch.zeros(4, dtype=torch.int64),
                 host_used=torch.zeros((1, 2)), cap_g=torch.ones((4, 2)),
                 need=torch.zeros(2))
    w = torch.ones(model.num_profiles)
    assert int(K.mcc_pick(free, *fleet.values(), 0, model)) == -1
    for key, bad in (("gpu_host", torch.zeros(4, dtype=torch.int32)),
                     ("host_used", torch.zeros((1, 3))),
                     ("cap_g", torch.ones((2, 4)).t()),
                     ("need", torch.zeros(3))):
        args = dict(fleet, **{key: bad})
        with pytest.raises(TypeError, match=key):
            K.mcc_pick(free, *args.values(), 0, model)
        with pytest.raises(TypeError, match=key):
            K.ecc_pick(free, *args.values(), 0, w, model)
    with pytest.raises(ValueError):
        K.mcc_pick(free[:0], fleet["gpu_host"][:0], fleet["host_used"],
                   fleet["cap_g"][:0], fleet["need"], 0, model)
    with pytest.raises(ValueError):
        K.mcc_pick(free, *fleet.values(), model.num_profiles, model)
    with pytest.raises(TypeError):
        K.ecc_pick(free, *fleet.values(), 0, w[:-1], model)


def test_wrapper_limits_match_the_kernel_defines():
    """The wrapper's limits are the kernel's #defines: it checks models
    against MRT_MAX_*, and gives a pick scratch of its own exactly when
    the kernel's grid has more than one CTA."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "mask_scores.cu").read_text()
    define = {k: int(v) for k, v in
              re.findall(r"^#define (MRT_\w+) (\d+)", src, re.M)}
    assert (K.MAX_SLOTS, K.MAX_PROFILES, K.MAX_PROFILE_SLOTS) == (
        define["MRT_MAX_SLOTS"], define["MRT_MAX_PROFILES"],
        define["MRT_MAX_BLOCKS"])
    assert K.PICK_PER_CTA == (define["MRT_PICK_THREADS"]
                              * define["MRT_PICK_ITEMS"])
    free = torch.zeros(K.PICK_PER_CTA, dtype=torch.int32)
    assert K._scratch(free) is None
    assert torch.equal(K._scratch(torch.zeros(K.PICK_PER_CTA + 1,
                                              dtype=torch.int32)),
                       torch.zeros(2, dtype=torch.int64))
