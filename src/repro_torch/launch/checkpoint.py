# Port of repro/launch/checkpoint.py (the JAX package): the same layout, manifest and guarantees, with its own tree flattening in place of jax.tree_util and no ml_dtypes.
"""Fault-tolerant checkpointing: atomic numpy-pytree snapshots.

Layout:  <dir>/step_<N>/
            manifest.json    — tree structure, shapes, dtypes, step
            <idx>.npy        — one file per leaf (host-gathered)
         <dir>/LATEST        — atomic pointer (written via rename)

Guarantees used by the restart path:
  * a checkpoint directory is only pointed to by LATEST after fsync +
    rename, so a crash mid-write can never corrupt the restore source;
  * ``restore_latest`` validates the manifest and falls back to the
    previous checkpoint on corruption;
  * ``prune`` keeps the newest ``keep`` checkpoints.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
numpy or Python scalars and torch tensors; ``None`` holds no leaf.  It is
flattened as JAX flattens it (dict keys sorted, sequences in order), so
the leaf order, the manifest's ``path`` strings and the file layout are
the JAX package's, and either package restores the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

# numpy can't round-trip bfloat16 through .npy; store the raw uint16 view
# and record the logical dtype in the manifest.
_VIEW_DTYPES = {"bfloat16": np.uint16}


def _flatten(tree, path=()):
    """(path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        kids = [_unflatten(v, leaves) for v in like]
        if isinstance(like, list):
            return kids
        return (type(like)(*kids) if hasattr(like, "_fields")
                else type(like)(kids))
    return next(leaves)


def _flatten_with_paths(tree):
    flat = list(_flatten(tree))
    paths = ["/".join(str(k) for k in path) for path, _ in flat]
    return paths, [leaf for _, leaf in flat]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf on the host and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    logical = str(arr.dtype)
    if logical in _VIEW_DTYPES:
        arr = arr.view(_VIEW_DTYPES[logical])
    return arr, logical


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically save ``tree`` as checkpoint ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": int(step), "leaves": []}
    try:
        for i, (p, leaf) in enumerate(zip(paths, leaves)):
            arr, logical = _to_numpy(leaf)
            np.save(os.path.join(tmp, f"{i}.npy"), arr)
            manifest["leaves"].append(
                {"path": p, "file": f"{i}.npy",
                 "shape": list(arr.shape), "dtype": logical})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
        f.flush()
        os.fsync(f.fileno())
    os.rename(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def _validate(path: str) -> bool:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        for leaf in manifest["leaves"]:
            fp = os.path.join(path, leaf["file"])
            if not os.path.exists(fp):
                return False
        return True
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def available_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def _cast(raw: np.ndarray, logical: str, like_leaf):
    """A loaded leaf at ``like_leaf``'s type: a torch leaf goes back to a
    tensor at its dtype and device; a host (numpy or scalar) leaf stays
    numpy at its dtype, so int64 and float64 host state never narrows."""
    if isinstance(like_leaf, torch.Tensor):
        if logical in _VIEW_DTYPES:
            t = torch.from_numpy(np.ascontiguousarray(raw).view(np.int16)
                                 ).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(raw))
        return t.to(device=like_leaf.device, dtype=like_leaf.dtype)
    dtype = np.asarray(like_leaf).dtype
    if logical in _VIEW_DTYPES and str(dtype) == logical:
        return raw.view(dtype)
    return np.asarray(raw).astype(dtype)


def restore_latest(ckpt_dir: str, like: Any
                   ) -> Optional[Tuple[int, Any]]:
    """Restore the newest valid checkpoint matching ``like``'s structure.
    Corrupted checkpoints are skipped (crash-during-save tolerance)."""
    candidates = []
    ptr = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            candidates.append(os.path.join(ckpt_dir, f.read().strip()))
    for s in reversed(available_steps(ckpt_dir)):
        p = os.path.join(ckpt_dir, f"step_{s:08d}")
        if p not in candidates:
            candidates.append(p)
    flat_like = [leaf for _, leaf in _flatten(like)]
    for path in candidates:
        if not _validate(path):
            continue
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if len(flat_like) != len(manifest["leaves"]):
            continue                      # structure changed -> unusable
        leaves = [_cast(np.load(os.path.join(path, leaf["file"])),
                        leaf["dtype"], like_leaf)
                  for leaf, like_leaf in zip(manifest["leaves"], flat_like)]
        return manifest["step"], _unflatten(like, iter(leaves))
    return None


def prune(ckpt_dir: str, keep: int = 3) -> None:
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


__all__ = ["save", "restore_latest", "available_steps", "prune"]
