"""Port policy core (torch, CPU) vs the JAX package's (``xp=numpy``).

Every scoring, selection, defrag and consolidation function is run on the
same random fleet states (made with numpy) through both, on the A100 fleet
and on the mixed A30+A100+H100 fleet; results must be equal exactly.
"""
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.core import policy_core as jpc
from repro_torch.core import mig
from repro_torch.core import policy_core as pc

torch.set_num_threads(1)

FLEETS = {"a100": ("A100-40GB",),
          "mixed": ("A30-24GB", "A100-40GB", "H100-80GB")}


def _fleet(name):
    names = FLEETS[name]
    T = pc.tables_for(tuple(mig.DEVICE_MODELS[n] for n in names), "cpu")
    J = jpc.tables_for(np, tuple(jmig.DEVICE_MODELS[n] for n in names))
    return T, J


def _state(rng, J, G=24):
    """Random per-GPU model ids, valid free masks, request and host_ok."""
    mid = rng.integers(0, J.num_models, G).astype(np.int32)
    full = J.full_mask[mid]
    free = (rng.integers(0, 256, G) & full).astype(np.int32)
    pids = np.array([rng.integers(0, m.num_profiles) for m in J.models],
                    np.int32)
    host_ok = rng.random(G) < 0.8
    return mid, free, pids, host_ok


def _t(x):
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind in "iu"
                           else x.copy())


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("policy", ["FF", "BF", "MCC", "MECC"])
def test_select_gpu_matches(fleet, policy):
    T, J = _fleet(fleet)
    pid = pc.POLICY_IDS[policy]
    rng = np.random.default_rng(pid)
    for _ in range(40):
        mid, free, pids, host_ok = _state(rng, J)
        w = rng.integers(0, 40, (J.num_models, J.num_profiles)).astype(
            np.int32)
        w_t = torch.as_tensor(w)
        want = jpc.select_gpu(pid, np, J, mid, free, pids, host_ok, w)
        got = pc.select_gpu(pid, T, _t(mid), torch.as_tensor(free),
                            _t(pids), torch.as_tensor(host_ok), w_t)
        assert got.shape == (1,) and int(got) == int(want)
        prof_g = pids[mid]
        fits = J.fits[mid, free, prof_g] & host_ok
        np.testing.assert_array_equal(
            pc.placement_scores(pid, T, _t(mid), _t(free), _t(prof_g),
                                torch.as_tensor(fits), w_t).numpy(),
            jpc.placement_scores(pid, np, J, mid, free, prof_g, fits, w))


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_grmu_select_matches(fleet):
    T, J = _fleet(fleet)
    rng = np.random.default_rng(7)
    for _ in range(60):
        mid, free, pids, host_ok = _state(rng, J)
        basket = rng.integers(-1, 3, mid.size).astype(np.int32)
        heavy = bool(rng.random() < 0.4)
        caps = (int(rng.integers(0, 8)), int(rng.integers(0, 20)))
        want = jpc.grmu_select(np, J, mid, free, pids, heavy, host_ok,
                               basket, *caps)
        got = pc.grmu_select(T, _t(mid), torch.as_tensor(free), _t(pids),
                             heavy, torch.as_tensor(host_ok),
                             torch.as_tensor(basket), *caps)
        assert [int(x) for x in got] == [int(x) for x in want]


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_defrag_and_repack_match(fleet):
    T, J = _fleet(fleet)
    rng = np.random.default_rng(11)
    for _ in range(60):
        mid, free, _, _ = _state(rng, J)
        light = rng.random(mid.size) < 0.6
        want = jpc.defrag_target(np, J, mid, free, light)
        got = pc.defrag_target(T, _t(mid), torch.as_tensor(free),
                               torch.as_tensor(light))
        assert int(got) == int(want)
        # A random resident set on one GPU, packed left to right.
        m = int(rng.integers(0, J.num_models))
        model = J.models[m]
        prof = np.full(J.max_blocks, -1, np.int64)
        b = 0
        while b < model.num_blocks:
            p = int(rng.integers(0, model.num_profiles))
            size = model.profiles[p].size
            if b + size <= model.num_blocks and rng.random() < 0.7:
                prof[b] = p
                b += size
            else:
                b += 1
        want = jpc.repack_gpu(np, J, m, prof)
        got = pc.repack_gpu(T, torch.tensor([m]), torch.as_tensor(prof))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_consolidation_matches(fleet):
    T, J = _fleet(fleet)
    rng = np.random.default_rng(13)
    pairs = 0
    for _ in range(30):
        G, H = 24, 9
        mid, _, _, _ = _state(rng, J, G)
        half = np.where(rng.random(G) < 0.5, J.lower_half[mid],
                        J.upper_half[mid])
        free = np.where(rng.random(G) < 0.7, half,
                        rng.integers(0, 256, G) & J.full_mask[mid])
        free = free.astype(np.int32)
        light = rng.random(G) < 0.8
        vm_count = rng.integers(0, 3, G).astype(np.int32)
        sole_pids = np.stack([rng.integers(-1, m.num_profiles, G)
                              for m in J.models], axis=1).astype(np.int32)
        sole_own = sole_pids[np.arange(G), mid]
        want_c = jpc.consolidation_candidates(np, J, mid, free, light,
                                              vm_count, sole_own)
        got_c = pc.consolidation_candidates(
            T, _t(mid), torch.as_tensor(free), torch.as_tensor(light),
            torch.as_tensor(vm_count), _t(sole_own))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        host = rng.integers(0, H, G).astype(np.int32)
        cpu = rng.choice([1.0, 2.0, 4.0], G).astype(np.float32)
        ram = rng.choice([4.0, 16.0], G).astype(np.float32)
        used = rng.uniform(0, 8, (2, H)).astype(np.float32)
        cap = np.full((2, H), 9.0, np.float32)
        want = jpc.consolidation_plan(np, J, mid, free, want_c, sole_pids,
                                      cpu, ram, host, used[0], used[1],
                                      cap[0], cap[1])
        got = pc.consolidation_plan(
            T, _t(mid), torch.as_tensor(free), got_c, _t(sole_pids),
            torch.as_tensor(cpu), torch.as_tensor(ram), _t(host),
            torch.as_tensor(used[0]), torch.as_tensor(used[1]),
            torch.as_tensor(cap[0]), torch.as_tensor(cap[1]), host)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        pairs += int((want[0] >= 0).sum())
    assert pairs > 0                    # sources did merge onto targets


def test_first_true_and_mecc_weights():
    m = torch.tensor([False, True, True])
    assert int(pc.first_true(m)) == 1
    assert int(pc.first_true(torch.zeros(3, dtype=torch.bool))) == -1
    c = torch.zeros((1, 6), dtype=torch.int32)
    assert torch.equal(pc.mecc_weights(c), torch.ones_like(c))
    c[0, 2] = 3
    assert torch.equal(pc.mecc_weights(c), c)
