"""LIBSVM text ingestion (counterpart of cocoa_tpu/data/libsvm.py, Python
parser only).

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


def load_libsvm(path: str, num_features: int) -> LibsvmData:
    """Parse a LIBSVM file.  Reads bytes and decodes latin-1, so every
    byte decodes and a lone ``\\r`` stays in-line whitespace."""
    labels: list[float] = []
    indptr: list[int] = [0]
    indices: list[np.ndarray] = []
    values: list[np.ndarray] = []
    nnz = 0
    with open(path, "rb") as f:
        for line in f:
            row = _parse_line(line.decode("latin-1"))
            if row is None:
                continue
            label, row_idx, row_val = row
            labels.append(label)
            indices.append(row_idx)
            values.append(row_val)
            nnz += len(row_idx)
            indptr.append(nnz)
    data = LibsvmData(
        labels=np.asarray(labels, dtype=np.float64),
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=(np.concatenate(indices) if indices
                 else np.empty(0, dtype=np.int32)),
        values=(np.concatenate(values) if values
                else np.empty(0, dtype=np.float64)),
        num_features=num_features,
    )
    if data.indices.size and int(data.indices.max()) >= num_features:
        raise ValueError(
            f"{path}: feature index {int(data.indices.max()) + 1} (1-based) "
            f"exceeds num_features={num_features}; pass a larger "
            f"--numFeatures")
    return data
