"""LIBSVM text ingestion (counterpart of cocoa_tpu/data/libsvm.py): the
native parser (data/native_loader.py) where it builds, and the Python
parser, its reference and fallback.

Semantics of the reference loader (OptUtils.scala:11-53): a label token
containing ``+`` or equal to 1 is +1, anything else -1; ``idx:val`` pairs
are 1-based; ``num_features`` comes from the caller.  A malformed pair ends
its line's pair list; earlier pairs and later lines are kept.  A column
repeated within a row stays in the CSR as given; densifying keeps its last
occurrence.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# the whitespace set the native parser skips (C-locale isspace minus '\n');
# str.split() would also split on Unicode whitespace
_WS_SPLIT = re.compile(r"[ \t\r\v\f]+")
# plain ASCII decimal only (no underscores, hex floats, inf/nan)
_INT_CHARS = frozenset("+-0123456789")
_NUM_CHARS = frozenset("+-.eE0123456789")


@dataclasses.dataclass
class LibsvmData:
    """The whole dataset as one host-side CSR triple."""

    labels: np.ndarray     # (n,) float64 in {-1, +1}
    indptr: np.ndarray     # (n+1,) int64
    indices: np.ndarray    # (nnz,) int32, 0-based
    values: np.ndarray     # (nnz,) float64
    num_features: int

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.indptr[i], self.indptr[i + 1]
        return self.indices[lo:hi], self.values[lo:hi]

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        """(n, d) dense matrix; a repeated column keeps its LAST value."""
        out = np.zeros((self.n, self.num_features), dtype=dtype)
        rows = np.repeat(np.arange(self.n), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out

    @property
    def max_nnz(self) -> int:
        return int(np.max(np.diff(self.indptr))) if self.n else 0


def _parse_label(token: str) -> float:
    if "+" in token:
        return 1.0
    try:
        if _NUM_CHARS.issuperset(token) and float(token) == 1.0:
            return 1.0
    except ValueError:
        pass
    return -1.0


def _parse_line(line: str):
    """One line -> ``(label, idx, val)``, or None for a blank line."""
    parts = [t for t in _WS_SPLIT.split(line.rstrip("\n")) if t]
    if not parts:
        return None
    label = _parse_label(parts[0])
    row_idx = np.empty(len(parts) - 1, dtype=np.int32)
    row_val = np.empty(len(parts) - 1, dtype=np.float64)
    m = 0
    for tok in parts[1:]:
        head, sep, val = tok.partition(":")
        if (not sep or not head or not val
                or not _INT_CHARS.issuperset(head)
                or not _NUM_CHARS.issuperset(val)):
            break
        try:
            i = int(head)
            v = float(val)
        except ValueError:
            break
        # the 1-based index must land in int32 after the shift
        if i < 1 or i - 1 > 2**31 - 1:
            break
        row_idx[m] = i - 1
        row_val[m] = v
        m += 1
    return label, row_idx[:m], row_val[:m]


def _parse_python_stream(path: str, num_features: int, lo: int, hi):
    """The rows whose line starts in the byte range [lo, hi) (``hi`` None:
    to the end; ``lo`` 0 reads the file strictly in order, so a pipe
    works), as ``(LibsvmData, row_off)``, ``row_off[i]`` the byte offset
    of row i's line.  Reads bytes and decodes latin-1, so every byte
    decodes and a lone ``\\r`` stays in-line whitespace, as the native
    parser sees the file."""
    labels: list[float] = []
    indptr: list[int] = [0]
    indices: list[np.ndarray] = []
    values: list[np.ndarray] = []
    offsets: list[int] = []
    nnz = 0
    with open(path, "rb") as f:
        pos = 0
        if lo > 0:
            # a line belongs to the range holding its first byte: start
            # one past the first newline at or after lo - 1
            f.seek(lo - 1)
            pos, probe = -1, lo - 1
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                j = chunk.find(b"\n")
                if j >= 0:
                    pos = probe + j + 1
                    f.seek(pos)
                    break
                probe += len(chunk)
        while pos >= 0:
            start = pos
            if hi is not None and start >= hi:
                break
            line = f.readline()
            if not line:
                break
            pos = start + len(line)
            row = _parse_line(line.decode("latin-1"))
            if row is None:
                continue
            label, row_idx, row_val = row
            labels.append(label)
            indices.append(row_idx)
            values.append(row_val)
            nnz += len(row_idx)
            indptr.append(nnz)
            offsets.append(start)
    data = LibsvmData(
        labels=np.asarray(labels, dtype=np.float64),
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=(np.concatenate(indices) if indices
                 else np.empty(0, dtype=np.int32)),
        values=(np.concatenate(values) if values
                else np.empty(0, dtype=np.float64)),
        num_features=num_features,
    )
    return data, np.asarray(offsets, dtype=np.int64)


def load_libsvm_python(path: str, num_features: int) -> LibsvmData:
    """The Python parser over the whole file (the native parser's
    reference), unvalidated."""
    return _parse_python_stream(path, num_features, 0, None)[0]


def load_libsvm_python_range(path: str, num_features: int, lo: int,
                             hi: int):
    """The Python parser over the rows owned by the byte range [lo, hi):
    ``(LibsvmData, row_off)``.  Ranges that tile the file give the whole
    file's rows, each once."""
    return _parse_python_stream(path, num_features, max(0, lo), hi)


def _validate(data: LibsvmData, path: str) -> LibsvmData:
    if data.indices.size:
        if int(data.indices.max()) >= data.num_features:
            raise ValueError(
                f"{path}: feature index {int(data.indices.max()) + 1} "
                f"(1-based) exceeds num_features={data.num_features}; pass "
                f"a larger --numFeatures")
        if int(data.indices.min()) < 0:
            raise ValueError(f"{path}: negative feature index after the "
                             f"1-based shift")
    return data


def load_libsvm(path: str, num_features: int,
                prefer_native: bool = True) -> LibsvmData:
    """Parse a LIBSVM file: with the native parser
    (data/native_loader.py) where it builds, else, or for a path it
    cannot map (a missing file, a pipe), with the Python parser; the two
    agree bit for bit."""
    if prefer_native:
        from cocoa_torch.data import native_loader

        data = native_loader.parse_file(path, num_features)
        if data is not None:
            return _validate(data, path)
    return _validate(load_libsvm_python(path, num_features), path)


def load_libsvm_range(path: str, num_features: int, lo: int, hi: int,
                      prefer_native: bool = True):
    """The rows owned by the byte range [lo, hi), as
    :func:`load_libsvm_python_range` returns them, with the native parser
    where it builds and the Python one otherwise."""
    if prefer_native:
        from cocoa_torch.data import native_loader

        out = native_loader.parse_range(path, lo, hi, num_features)
        if out is not None:
            return _validate(out[0], path), out[1]
    data, row_off = load_libsvm_python_range(path, num_features, lo, hi)
    return _validate(data, path), row_off
