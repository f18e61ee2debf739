"""Port mask scorers vs the JAX package's Pallas kernels (interpret mode).

The port's plain versions (``repro_torch.kernels.ref``) against
``repro.kernels.ops.*(interpret=True)`` over every mask x profile of all
four device presets.  cc, mcc, frag and ecc with integer weights are
exact.  ecc with real probabilities is held to 1 ulp: the JAX wrappers
are jitted, and XLA's CPU backend contracts the kernel's
``ecc + w * count`` into a fused multiply-add (one rounding), where the
port and the eager jnp oracle round the product and the sum separately
(test_torch_kernels.py holds the port to that oracle exactly).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.kernels import ops as jops
from repro_torch.core import mig
from repro_torch.kernels import ref

torch.set_num_threads(1)

PRESETS = sorted(mig.DEVICE_MODELS)


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
def test_plain_versions_match_pallas_interpret(name):
    model, jmodel = mig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    masks = np.arange(model.num_masks, dtype=np.int32)
    t, j = torch.from_numpy(masks), jnp.asarray(masks)
    _eq(ref.cc_ref(t, model), jops.cc_scores(j, model=jmodel,
                                             interpret=True))
    _eq(ref.frag_ref(t, model), jops.frag_scores(j, model=jmodel,
                                                 interpret=True))
    for p in range(model.num_profiles):
        _eq(ref.mcc_score_ref(t, p, model),
            jops.mcc_scores(j, p, model=jmodel, interpret=True))
        w_int, w_prob = _weights(model, p)
        # One compile per profile: the weights are a traced argument.
        _eq(ref.ecc_score_ref(t, p, torch.from_numpy(w_int), model),
            jops.ecc_scores(j, p, jnp.asarray(w_int), model=jmodel,
                            interpret=True))
        got = ref.ecc_score_ref(t, p, torch.from_numpy(w_prob), model)
        want = np.asarray(jops.ecc_scores(j, p, jnp.asarray(w_prob),
                                          model=jmodel, interpret=True))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
