"""ctypes bridge to the C++ LIBSVM parser ``native/libsvm_parser.cpp``
(counterpart of cocoa_tpu/data/native_loader.py, with a build of its own).

The parser is host code: it memory-maps the text and writes the CSR
arrays straight into numpy buffers in two passes (a count, then the
parse), so a multi-GB file parses in seconds with about the parsed
arrays' memory.  The shared library is compiled from that source with the
host's C++ compiler into the port's ignored build directory
(``cocoa_torch/_build/``), at the first parse, never at import.  Its name
carries a hash of the source, so an edited parser is rebuilt, and it is
written to a process-suffixed temporary file and renamed into place, so
two processes building at once never load a half-written library.  The
repository's ``native/`` directory is only read.

Without a compiler, or when the build fails, :func:`available` is False,
a ``RuntimeWarning`` says so, and :func:`cocoa_torch.data.libsvm.load_libsvm`
runs the Python parser, whose results are the same bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from cocoa_torch.data.libsvm import LibsvmData

SOURCE = Path(__file__).resolve().parents[2] / "native" / "libsvm_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# portable: no -march=native, which would tie the library to one CPU model
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def library_path(build_dir=None) -> Path:
    """The library's path in ``build_dir`` (default :data:`BUILD_DIR`),
    named by the source's hash."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libsvm_parser_{tag}.so"


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def build(build_dir=None) -> Path:
    """Compile the parser into ``build_dir`` (default :data:`BUILD_DIR`)
    unless its library is there;
    returns the library's path.  Raises (OSError, RuntimeError or
    subprocess's errors) when it cannot be built."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX, or install g++)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _bind(path: Path) -> ctypes.CDLL:
    """The library with JAX's argument types
    (cocoa_tpu/data/native_loader.py ``_load``)."""
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.cocoa_libsvm_count.restype = ctypes.c_int
    lib.cocoa_libsvm_count.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.cocoa_libsvm_parse.restype = ctypes.c_int
    lib.cocoa_libsvm_parse.argtypes = [
        ctypes.c_char_p, f64p, i64p, i32p, f64p,  # labels indptr idx vals
        i64, i64,                                 # cap_rows, cap_pairs
        i64p, i64p]                               # rows, pairs out
    lib.cocoa_libsvm_count_range.restype = ctypes.c_int
    lib.cocoa_libsvm_count_range.argtypes = [ctypes.c_char_p, i64, i64,
                                             i64p, i64p]
    lib.cocoa_libsvm_parse_range.restype = ctypes.c_int
    lib.cocoa_libsvm_parse_range.argtypes = [
        ctypes.c_char_p, i64, i64,                # path, byte range lo, hi
        f64p, i64p, i32p, f64p, i64p,             # ... row_off
        i64, i64, i64p, i64p]
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None (with a
    ``RuntimeWarning``) when it cannot be built or loaded."""
    try:
        return _bind(build())
    except (OSError, RuntimeError, AttributeError,
            subprocess.SubprocessError) as e:
        detail = ""
        if isinstance(e, subprocess.CalledProcessError) and e.stderr:
            detail = ": " + e.stderr.decode(errors="replace").strip()[-200:]
        warnings.warn(f"native LIBSVM parser unavailable ({type(e).__name__}"
                      f"{detail}); falling back to the Python parser",
                      RuntimeWarning)
        return None


def available() -> bool:
    return _load() is not None


def _buffers(rows: int, pairs: int):
    """Output arrays sized from the count pass (at least one entry each,
    so every pointer is valid)."""
    return (np.empty(max(rows, 1), np.float64),
            np.empty(rows + 2, np.int64),
            np.empty(max(pairs, 1), np.int32),
            np.empty(max(pairs, 1), np.float64))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_file(path: str, num_features: int) -> Optional[LibsvmData]:
    """Parse ``path`` with the C++ library; None when the library is not
    built, the path cannot be memory-mapped (missing or not a regular
    file) or the file changed between the two passes: the Python parser
    owns those cases."""
    lib = _load()
    if lib is None:
        return None
    rows_b, pairs_b = ctypes.c_int64(), ctypes.c_int64()
    if lib.cocoa_libsvm_count(path.encode(), ctypes.byref(rows_b),
                              ctypes.byref(pairs_b)) != 0:
        return None
    labels, indptr, indices, values = _buffers(rows_b.value, pairs_b.value)
    rows, pairs = ctypes.c_int64(), ctypes.c_int64()
    if lib.cocoa_libsvm_parse(
            path.encode(), _ptr(labels, ctypes.c_double),
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            _ptr(values, ctypes.c_double), len(labels), len(indices),
            ctypes.byref(rows), ctypes.byref(pairs)) != 0:
        return None
    n, nnz = rows.value, pairs.value
    return LibsvmData(labels=labels[:n], indptr=indptr[:n + 1],
                      indices=indices[:nnz], values=values[:nnz],
                      num_features=num_features)


def parse_range(path: str, lo: int, hi: int, num_features: int):
    """The rows owned by the byte range [lo, hi) (a line belongs to the
    range holding its first byte; the last owned line parses to its own
    end) with the C++ library: ``(LibsvmData, row_off)``, ``row_off[i]``
    the byte offset of row i's line; None as :func:`parse_file`."""
    lib = _load()
    if lib is None:
        return None
    rows_b, pairs_b = ctypes.c_int64(), ctypes.c_int64()
    if lib.cocoa_libsvm_count_range(path.encode(), lo, hi,
                                    ctypes.byref(rows_b),
                                    ctypes.byref(pairs_b)) != 0:
        return None
    labels, indptr, indices, values = _buffers(rows_b.value, pairs_b.value)
    row_off = np.empty(max(rows_b.value, 1), np.int64)
    rows, pairs = ctypes.c_int64(), ctypes.c_int64()
    if lib.cocoa_libsvm_parse_range(
            path.encode(), lo, hi, _ptr(labels, ctypes.c_double),
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            _ptr(values, ctypes.c_double), _ptr(row_off, ctypes.c_int64),
            len(labels), len(indices), ctypes.byref(rows),
            ctypes.byref(pairs)) != 0:
        return None
    n, nnz = rows.value, pairs.value
    return LibsvmData(labels=labels[:n], indptr=indptr[:n + 1],
                      indices=indices[:nnz], values=values[:nnz],
                      num_features=num_features), row_off[:n]
