"""Build and load the CUDA sources in ``csrc/`` at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  Libraries go to ``build/repro_torch_kernels/``
at the repository root, named by a hash of the source, the ``csrc/*.cuh``
headers it includes and the flags, so a changed source or header is
rebuilt and an unchanged one is loaded as built.  All sources are
compiled in parallel, one ``nvcc`` each, with the flags :func:`nvcc_flags`
gives that source.

Nothing is built at import time: CPU-only callers import the kernel
modules freely, and the first kernel launch on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_SHARED = ("-shared", "-Xcompiler", "-fPIC")
# Flags a source needs beyond the common ones.  The mask scorers must equal
# their plain versions bit for bit, so nvcc may not contract a*b+c into an
# FMA there; attention keeps contraction on.  No source is built with
# --use_fast_math: the bf16 kernel's exact split of p needs round-to-nearest
# conversions and subtractions as written.
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {"mask_scores": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def nvcc_flags(stem: str) -> Tuple[str, ...]:
    """The nvcc flags of ``csrc/<stem>.cu``."""
    return _ARCH + SOURCE_FLAGS.get(stem, ()) + _SHARED


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.M)


def headers(src: Path) -> Tuple[Path, ...]:
    """The ``csrc/*.cuh`` headers that ``src`` includes, directly or
    through another header, in the order first reached."""
    seen, todo = [], [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_bytes()):
            h = src.parent / name.decode()
            if h not in seen:
                seen.append(h)
                todo.append(h)
    return tuple(seen)


def _target(src: Path) -> Path:
    """The library of ``src``: named by a hash of the source, the headers
    it includes and its flags, so a change to any of them rebuilds it (a
    source that includes none keeps the name it had before headers were
    hashed)."""
    h = hashlib.sha256(src.read_bytes()
                       + b"".join(p.read_bytes() for p in headers(src))
                       + " ".join(nvcc_flags(src.stem)).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every stale ``csrc/*.cu`` (in parallel) and load them all.
    Returns ``{source stem: CDLL}``.  Raises with nvcc's output on a
    failed build."""
    with _LOCK:
        sources = sorted(CSRC.glob("*.cu"))
        todo = [(s, _target(s)) for s in sources
                if s.stem not in _LIBS and not _target(s).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = nvcc_path()
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *nvcc_flags(src.stem), "-o", str(tmp),
                       str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failures = []
            for src, out, tmp, proc in procs:
                log = proc.communicate()[0].decode(errors="replace")
                if proc.returncode != 0:
                    failures.append(f"{src.name}:\n{log}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, out)
            if failures:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        for src in sources:
            if src.stem not in _LIBS:
                _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
        return dict(_LIBS)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _LIBS.get(stem)
    return lib if lib is not None else build_all()[stem]
