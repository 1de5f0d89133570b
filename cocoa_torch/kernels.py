"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
with ``nvcc`` for ``sm_90a`` into a shared library under the ignored
``cocoa_torch/_build/`` directory at first use, and loaded with
``ctypes``.  The library's name carries a hash of its source and of the
shared headers (``csrc/*.cuh``), so an edited source or header is rebuilt
and a stale library is never loaded.  Nothing here runs at import time: a
machine without ``nvcc`` imports the package and runs the plain versions.
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

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
SOURCES = {name: _PKG / "csrc" / f"{name}.cu"
           for name in ("sparse_sdca", "dense_sdca", "block_chain",
                        "sparse_block", "draw_tables")}
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
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(SOURCES[name].parent.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = h.hexdigest()[:16]
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
    """The kernel library ``name``, built first if needed, with its
    ``cuda_error_string`` declared."""
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def declare(lib: ctypes.CDLL, names, n_ptr: int, rest: list) -> None:
    """Declare C entry points taking ``n_ptr`` pointers, then ``rest``
    (ctypes types), then the stream; pointers and the stream are
    c_void_p, so ctypes does not cut them to 32 bits."""
    for name in names:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + list(rest) \
            + [ctypes.c_void_p]


# every kernel wrapper's launch counts, as (wrapper, attribute)
_COUNTS: list = []


def count_launches(wrapper, *attrs) -> None:
    """Give a kernel wrapper its launch counts, plain integers named
    ``attrs`` on the function, each 0; the wrapper adds one where it
    launches its kernel.  A captured CUDA graph's launches count at each
    replay (:func:`launch_counts`, :func:`add_launches`)."""
    for attr in attrs:
        setattr(wrapper, attr, 0)
        _COUNTS.append((wrapper, attr))


def launch_counts() -> list:
    """Every wrapper's launch counts, in :func:`count_launches` order."""
    return [getattr(fn, attr) for fn, attr in _COUNTS]


def add_launches(delta) -> None:
    """Add ``delta`` (a list in :func:`launch_counts` order) to the counts:
    the launches of one replay of a captured graph, whose wrappers counted
    once while it was captured and launched nothing then."""
    for (fn, attr), n in zip(_COUNTS, delta):
        setattr(fn, attr, getattr(fn, attr) + n)


DTYPES = (torch.float32, torch.float64)


def takes_dtype(dtype) -> bool:
    """Whether the kernels are built for ``dtype``: float32 and float64.
    The solvers' routes send any other dtype to the plain versions, on
    every device, as the JAX auto-select keeps 2-byte dtypes off its
    kernels."""
    return dtype in DTYPES


def check_dtype(dtype, what: str) -> None:
    """A kernel wrapper's refusal of a dtype it is not built for (2-byte
    dtypes), as cocoa_tpu/ops/pallas_sdca.py ``check_dtype`` refuses
    them."""
    if not takes_dtype(dtype):
        raise ValueError(f"{what} takes float32 or float64, got {dtype}")


def check_tensor(name, t, dtype, shape, device) -> None:
    """What a kernel takes: ``dtype``, ``shape``, contiguous, on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def runs_plain(device) -> bool:
    """The port's device rule, for every kernel wrapper and the solvers'
    routes: on the CPU a wrapper runs its kernel's plain version; on any
    other device it launches the kernel or raises."""
    return torch.device(device).type == "cpu"


def require_cuda(t, name: str) -> None:
    """A kernel wrapper's rule for a tensor that is not on the CPU: CUDA,
    or a refusal."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")


@functools.lru_cache(maxsize=None)
def _properties(device):
    return torch.cuda.get_device_properties(device)


def smem_optin(device) -> int:
    """The opt-in shared memory of a block on CUDA ``device``, in bytes
    (232 448 on an H100): the budget a kernel's plan is held to."""
    return _properties(device).shared_memory_per_block_optin


def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device`` (132 on an H100
    SXM): the blocks a kernel's plan counts to fill the card."""
    return _properties(device).multi_processor_count


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an int."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.cuda_error_string(rc).decode()})")
