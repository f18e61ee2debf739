"""The port's copy of the configuration-space enumeration
(``repro_torch.core.enumerate``): the paper §5.1 counts of
tests/test_enumerate.py on the copy, and the copy against the JAX
package's module on every device model."""
import pytest

from repro.core import enumerate as jenumerate
from repro.core.mig import DEVICE_MODELS as JDEVICE_MODELS
from repro_torch.core.enumerate import (all_configurations, config_cc,
                                        default_policy_reachable,
                                        free_blocks, gi_multiset,
                                        is_terminal, per_profile_capacity,
                                        suboptimal_configurations, summary,
                                        terminal_configurations, used_mask)
from repro_torch.core.mig import (A30_24GB, A100_40GB, DEVICE_MODELS,
                                  H100_80GB, available_starts)
from repro_torch.core.tables import tables_for_model


def test_723_unique_configurations():
    """§5.1: 'The finalized tree encompasses 723 unique configurations.'"""
    assert len(all_configurations()) == 723


def test_78_terminal_configurations():
    """§3/§5.1: '78 valid combinations' / '78 terminal nodes'."""
    assert len(terminal_configurations()) == 78
    for c in terminal_configurations():
        assert is_terminal(c)


def test_482_suboptimal_arrangements():
    """§5.1: '67% of the 723 configurations, or 482 in total, are in
    suboptimal arrangements'."""
    sub = suboptimal_configurations()
    assert len(sub) == 482
    assert round(100 * len(sub) / 723) == 67


def test_terminal_configs_are_packings():
    """Terminal configs can accept no further GI: CC of free blocks == 0."""
    for c in terminal_configurations():
        assert config_cc(c) == 0


def test_default_policy_reachable_bounds():
    """The paper reports 248 default-policy configurations; the exact count
    depends on an unspecified driver tie-break.  Our deterministic
    first-maximizer policy reaches 179 and the any-tie closure reaches 297,
    bracketing the paper's 248 (see DESIGN.md repro notes)."""
    first = default_policy_reachable(explore_ties=False)
    anytie = default_policy_reachable(explore_ties=True)
    assert len(first) == 179
    assert len(anytie) == 297
    assert first <= anytie
    assert len(first) <= 248 <= len(anytie)
    assert anytie <= all_configurations()


def test_suboptimality_is_about_arrangement_not_content():
    """A suboptimal config has a same-multiset sibling with higher CC."""
    sub = suboptimal_configurations()
    allc = all_configurations()
    some = list(sub)[:25]
    for c in some:
        siblings = [d for d in allc if gi_multiset(d) == gi_multiset(c)]
        assert max(config_cc(d) for d in siblings) > config_cc(c)


def test_table3_per_profile_capacity_tradeoff():
    """Fig. 3 / Table 3: two same-CC configurations of the same multiset can
    differ in per-profile capacity (more 1g.10gb at the cost of 4g.20gb)."""
    # Find a same-multiset pair with equal CC but different capacity vectors.
    from collections import defaultdict
    groups = defaultdict(list)
    for c in all_configurations():
        groups[gi_multiset(c)].append(c)
    found = False
    for cs in groups.values():
        if len(cs) < 2:
            continue
        by_cc = defaultdict(list)
        for c in cs:
            by_cc[config_cc(c)].append(c)
        for cc_val, same_cc in by_cc.items():
            caps = {tuple(sorted(per_profile_capacity(c).items()))
                    for c in same_cc}
            if len(caps) > 1:
                found = True
                break
        if found:
            break
    assert found, "no same-CC capacity trade-off found (contradicts Table 3)"


def test_summary_keys():
    s = summary()
    assert s["unique_configurations"] == 723
    assert s["terminal_configurations"] == 78
    assert s["suboptimal_configurations"] == 482


# -- DeviceModel parameterization (beyond the paper's single A100) ----------


def test_h100_enumeration_matches_a100_geometry():
    """H100-80GB has the A100's block geometry with renamed profiles, so
    its configuration space must have identical counts."""
    assert summary(H100_80GB) == summary(A100_40GB)


def test_a30_enumeration_counts():
    """A30-24GB: 4 blocks, 9 slots — a small space we can sanity-bound.
    Counts are pinned as a regression reference (derived, not from the
    paper, which only covers the A100-40GB)."""
    s = summary(A30_24GB)
    assert s["unique_configurations"] == 37
    assert s["terminal_configurations"] == 10
    assert s["suboptimal_configurations"] == 4
    for c in terminal_configurations(A30_24GB):
        assert config_cc(c, A30_24GB) == 0


@pytest.mark.parametrize("model", [A30_24GB, H100_80GB],
                         ids=lambda m: m.name)
def test_enumeration_cross_checks_model_tables(model):
    """Every enumerated configuration's CC, per-profile fit and start
    counts must agree with the mask-indexed ModelTables for that model —
    the enumerator and the table builder are independent implementations
    of the same §5 quantities."""
    T = tables_for_model(model)
    for c in all_configurations(model):
        fmask = model.full_mask & ~used_mask(c, model)
        free = free_blocks(c, model)
        assert int(T.cc[fmask]) == config_cc(c, model)
        assert int(T.popcount[fmask]) == len(free)
        for pi, p in enumerate(model.profiles):
            starts = available_starts(free, p)
            assert int(T.counts[fmask, pi]) == len(starts)
            assert bool(T.fits[fmask, pi]) == (len(starts) > 0)


@pytest.mark.parametrize("name", sorted(DEVICE_MODELS))
def test_enumeration_equals_jax(name):
    """The copy and the JAX module enumerate the same configurations
    (slot-index sets), with the same CC, terminal and suboptimal sets,
    default-policy closures and per-profile capacities."""
    model, jmodel = DEVICE_MODELS[name], JDEVICE_MODELS[name]
    configs = all_configurations(model)
    assert configs == jenumerate.all_configurations(jmodel)
    assert summary(model) == jenumerate.summary(jmodel)
    assert terminal_configurations(model) == \
        jenumerate.terminal_configurations(jmodel)
    assert suboptimal_configurations(model) == \
        jenumerate.suboptimal_configurations(jmodel)
    for ties in (False, True):
        assert default_policy_reachable(ties, model) == \
            jenumerate.default_policy_reachable(ties, jmodel)
    for c in configs:
        assert config_cc(c, model) == jenumerate.config_cc(c, jmodel)
        assert per_profile_capacity(c, model) == \
            jenumerate.per_profile_capacity(c, jmodel)
