"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
with ``nvcc`` for ``sm_90a`` into a shared library under the ignored
``cocoa_torch/_build/`` directory at first use, and loaded with
``ctypes``.  The library's name carries a hash of its source, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import time: a machine without ``nvcc`` imports the package and runs
the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCES = {"sparse_sdca": _PKG / "csrc" / "sparse_sdca.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def library_path(name: str) -> Path:
    tag = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def build(name: str) -> str:
    """Compile kernel ``name`` unless its library exists.  Returns nvcc's
    output ("" when the library was already built)."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}:\n{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return res.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
