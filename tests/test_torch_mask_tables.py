"""The identity the CUDA mask scorers' lookup tables rest on, on the CPU.

Each scorer in ``kernels/csrc/mask_scores.cu`` builds a table of its score
over every mask t < 2^num_blocks and scores a mask m as table[m & full].
That is exact only if the score reads no bit above ``num_blocks``.  Here,
on random int32 masks drawn with numpy (negatives and high bits
included), the port's plain versions must equal their own table looked
up at ``m & full`` bit for bit, and the JAX package's Pallas kernels in
interpret mode, on all four device presets.
"""
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mig as jmig
from repro.kernels import ops as jops
from repro_torch.core import mig
from repro_torch.kernels import _build, ref

torch.set_num_threads(1)

PRESETS = sorted(mig.DEVICE_MODELS)
SCORERS = {"cc": (ref.cc_ref, jops.cc_scores),
           "frag": (ref.frag_ref, jops.frag_scores)}


def _bits(x) -> np.ndarray:
    """The result's 32-bit words (float32 compared bit for bit)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.dtype in (np.int32, np.float32)
    return x.view(np.int32)


@pytest.mark.parametrize("scorer", sorted(SCORERS))
@pytest.mark.parametrize("name", PRESETS)
def test_score_is_its_table_at_the_low_bits(name, scorer):
    model, jmodel = mig.DEVICE_MODELS[name], jmig.DEVICE_MODELS[name]
    plain, pallas = SCORERS[scorer]
    rng = np.random.default_rng(PRESETS.index(name))
    masks = rng.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64).astype(
        np.int32)
    masks[:4] = [-1, -2 ** 31, 2 ** 31 - 1, model.full_mask + 1]
    assert (masks < 0).any() and (masks > model.full_mask).any()
    table = plain(torch.arange(model.num_masks, dtype=torch.int32), model)
    got = plain(torch.from_numpy(masks), model)
    lookup = table[torch.from_numpy(masks & model.full_mask).long()]
    np.testing.assert_array_equal(_bits(got), _bits(lookup))
    np.testing.assert_array_equal(
        _bits(got), _bits(pallas(jnp.asarray(masks), model=jmodel,
                                 interpret=True)))


def test_every_scorer_entry_point_launches_the_lookup_kernel():
    """mrt_cc, mrt_frag, mrt_mcc and mrt_ecc each launch the one streaming
    kernel with their own table kind, and the file's only kernels are it
    and the picks: no per-mask walk over the templates is left."""
    src = (_build.CSRC / "mask_scores.cu").read_text()
    kinds = {"cc": "MRT_CC", "frag": "MRT_FRAG", "mcc": "MRT_MCC",
             "ecc": "MRT_ECC"}
    for name, kind in kinds.items():
        body = src[src.index(f"int mrt_{name}("):]
        body = body[:body.index("\n}\n")]
        assert re.findall(r"(\w+)<([\w ?:]+)><<<", body) == [
            ("score_kernel", kind)]
    assert sorted(re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?"
                             r"\s+(\w+)\(", src)) == ["pick_kernel",
                                                      "score_kernel"]


def _mask_probe():
    spec = importlib.util.spec_from_file_location(
        "mask_probe", Path(__file__).resolve().parents[1] / "mask_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def test_mask_probe_counts_opcodes_per_kernel():
    """mask_probe.py's reading of ``cuobjdump -sass``: opcodes per kernel,
    predicates and modifiers dropped (what its local-memory and
    constant-load counts rest on)."""
    probe = _mask_probe()
    text = """
        Function : _Z1aPi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 LDC.64 R10, c[0x4][RZ] ;
        /*0020*/                   STL [R1], R2 ;
        /*0030*/               @UP0 LDL R3, [R1] ;
                                                                 /* 0x000 */
        Function : _Z1bPi
        /*0000*/                   EXIT ;
    """
    ops = probe.sass_opcodes(text)
    assert set(ops) == {"_Z1aPi", "_Z1bPi"}
    assert ops["_Z1aPi"] == {"LDC": 2, "STL": 1, "LDL": 1}
    assert ops["_Z1bPi"] == {"EXIT": 1}


def test_mask_probe_marks_every_point_of_the_score_kernel():
    """mask_probe.py's cycle marks find each of their anchors once in the
    kernel source, so the probe follows the kernel as it is."""
    probe = _mask_probe()
    src = (_build.CSRC / "mask_scores.cu").read_text()
    marked = probe.with_marks(src)
    body = marked[marked.index("score_kernel(const int*"):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"MRT_MARK\((\d)\);", body) == ["0", "1", "2", "3", "4"]
    assert 'extern "C" int probe_marks(' in marked
    with pytest.raises(ValueError):
        probe.with_marks(src.replace("build_table<KIND>(", "build<KIND>("))
