"""The port's copy of the pod-slice sizing (``repro_torch.core.podsched``):
the pod-slice tests of tests/test_scale_features.py on the copy, and the
copy against the JAX package's module over a grid of requests."""
import pytest

from repro.core import podsched as jpodsched
from repro_torch.core.mig import PROFILES
from repro_torch.core.podsched import (SLICE_OF_PROFILE, chips_for_profile,
                                       demand_fraction,
                                       profile_for_request)


def test_demand_fraction_monotone():
    assert demand_fraction(1024, 1) < demand_fraction(32768, 16)
    assert 0 < demand_fraction(1, 1) <= 1.0


def test_profile_for_request_extremes():
    assert profile_for_request(32768, 16) == "7g.40gb"   # max demand
    small = profile_for_request(1024, 1)
    assert chips_for_profile(small) == 1                 # min demand


def test_profile_chip_counts_match_mig_sizes():
    for p in PROFILES:
        # slice chips ~ memory-block footprint (8 blocks ~ 8-chip row)
        assert chips_for_profile(p.name) in (1, 2, 4, 8)


@pytest.mark.parametrize("batch", [1, 2, 3, 8, 16, 64])
def test_pod_slice_sizing_equals_jax(batch):
    assert SLICE_OF_PROFILE == jpodsched.SLICE_OF_PROFILE
    for context in (1, 100, 1024, 4096, 9000, 16384, 32768, 65536):
        assert demand_fraction(context, batch) == jpodsched.demand_fraction(
            context, batch)
        name = profile_for_request(context, batch)
        assert name == jpodsched.profile_for_request(context, batch)
        assert chips_for_profile(name) == jpodsched.chips_for_profile(name)
