"""The port's checkpointing (``repro_torch.launch.checkpoint``) against
the JAX package's ``repro.launch.checkpoint``.

The port flattens trees itself (no ``jax.tree_util``) and stores bf16
without ml_dtypes; the checkpoints of the two packages must be the same
files: the same manifest (leaf order, ``path`` strings, shapes, logical
dtypes) and the same ``.npy`` bytes, and each package restores the
other's.  Plus the JAX checkpoint tests (round trip with bf16, fallback
past a corrupted checkpoint, pruning) on torch leaves, and the rule that
host (numpy) leaves keep their int64 / float64 dtype.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import checkpoint as JCK
from repro_torch.launch import checkpoint as CK


def _np_tree():
    """A service-checkpoint-shaped tree of host leaves: nested dicts out
    of key order, a list and a tuple, scalars, int64 and float64."""
    rng = np.random.default_rng(0)
    return {
        "snap": {"vmrow": rng.integers(-1, 9, (5, 3)).astype(np.int32),
                 "last_cons": np.float32(6.0), "intra": np.int32(3),
                 "free": rng.integers(0, 255, 7).astype(np.int32)},
        "vm": {"ids": np.arange(5, dtype=np.int64) * (1 << 40),
               "arrival": rng.random(5)},
        "scalars": np.array([5, 5, 2, 0, 1], np.int64),
        "step_t": np.float64(2.0),
        "seq": [np.zeros(2, np.int16), (np.ones(3, bool), np.float32(1.5))],
    }


def _files(d, step):
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, [np.load(os.path.join(path, leaf["file"]))
                      for leaf in manifest["leaves"]]


def test_checkpoint_files_equal_the_jax_package(tmp_path):
    tree = _np_tree()
    JCK.save(str(tmp_path / "jax"), 7, tree)
    CK.save(str(tmp_path / "port"), 7, tree)
    jm, jarrs = _files(str(tmp_path / "jax"), 7)
    pm, parrs = _files(str(tmp_path / "port"), 7)
    assert pm == jm
    for a, b in zip(parrs, jarrs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_restores_the_others_checkpoint(writer, tmp_path):
    tree = _np_tree()
    (JCK if writer == "jax" else CK).save(str(tmp_path), 4, tree)
    reader = CK if writer == "jax" else JCK
    step, got = reader.restore_latest(str(tmp_path), _np_tree())
    assert step == 4
    flat = [leaf for _, leaf in CK._flatten(got)]
    want = [leaf for _, leaf in CK._flatten(tree)]
    assert len(flat) == len(want) == 11
    for a, b in zip(flat, want):
        assert isinstance(a, np.ndarray)
        assert a.dtype == np.asarray(b).dtype          # no narrowing
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got["vm"]["ids"][-1] == 4 << 40
    assert isinstance(got["seq"][1], tuple)


def _torch_tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.full((4,), 1.5, dtype=torch.bfloat16),
                  "d": torch.tensor([2.0 ** -9, 3.0],
                                    dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip_with_torch_leaves(tmp_path):
    """Torch leaves go back as tensors at the like leaf's dtype and
    device, bf16 bit for bit through its uint16 view."""
    d = str(tmp_path)
    t = _torch_tree()
    CK.save(d, 3, t)
    like = {"a": torch.zeros(2, 3),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16),
                  "d": torch.zeros(2, dtype=torch.bfloat16)}}
    step, restored = CK.restore_latest(d, like)
    assert step == 3
    for a, b in zip(CK._flatten(t), CK._flatten(restored)):
        assert a[0] == b[0] and b[1].dtype == a[1].dtype
        assert torch.equal(a[1], b[1])
    manifest, _ = _files(d, 3)
    assert [(x["path"], x["dtype"]) for x in manifest["leaves"]] == [
        ("a", "float32"), ("b/c", "bfloat16"), ("b/d", "bfloat16")]


def test_bf16_checkpoint_restores_in_the_jax_package(tmp_path):
    d = str(tmp_path)
    CK.save(d, 1, _torch_tree())
    like = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.bfloat16),
                                          "d": jnp.zeros(2, jnp.bfloat16)}}
    _, got = JCK.restore_latest(d, like)
    assert got["b"]["c"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]["d"], np.float32),
                                  [2.0 ** -9, 3.0])


def test_checkpoint_corruption_fallback(tmp_path):
    d = str(tmp_path)
    t = _torch_tree()
    CK.save(d, 1, t)
    CK.save(d, 2, t)
    os.remove(os.path.join(d, "step_00000002", "0.npy"))
    out = CK.restore_latest(d, t)
    assert out is not None and out[0] == 1     # falls back to step 1


def test_checkpoint_refuses_another_structure(tmp_path):
    d = str(tmp_path)
    CK.save(d, 1, _np_tree())
    assert CK.restore_latest(d, {"x": np.zeros(1)}) is None
    assert CK.restore_latest(str(tmp_path / "none"), _np_tree()) is None


def test_checkpoint_prune(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        CK.save(d, s, _torch_tree())
    CK.prune(d, keep=2)
    assert CK.available_steps(d) == [4, 5]
