"""K contiguous row shards stacked on a leading axis (counterpart of
cocoa_tpu/data/sharding.py, single process, dense and padded-CSR).

- **dense**: ``X`` is (K, n_shard, d).
- **sparse** (padded CSR): ``sp_indices``/``sp_values`` are
  (K, n_shard, W) with W the dataset's max row nnz; a row's slots past its
  nnz carry index 0 / value 0.

Shards are padded to the largest shard's row count; padded rows carry
``mask=0``, ``y=0``, ``x=0`` and are never sampled.  Unlike the JAX
package the row count is not rounded up to a TPU tile, so padded shapes
may differ from it; the unpadded contents do not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.device import resolve_device


def resolve_layout(data: LibsvmData, layout: str) -> str:
    """``auto``: sparse below 10% density (rcv1-like), dense otherwise."""
    if layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"layout must be auto|dense|sparse, got {layout!r}")
    if layout != "auto":
        return layout
    density = int(data.indptr[-1]) / max(1, data.n * data.num_features)
    return "sparse" if density < 0.10 else "dense"


def segment_sq_norms(values, ptr) -> np.ndarray:
    """Exact per-segment float64 sum of squares for CSR ``(values, ptr)``
    (per segment, not a prefix-sum difference, so a small row keeps its
    own precision; empty segments are 0)."""
    nseg = len(ptr) - 1
    if nseg <= 0:
        return np.zeros(0)
    sq = np.empty(len(values) + 1)
    np.square(np.asarray(values, np.float64), out=sq[:-1])
    sq[-1] = 0.0
    out = np.add.reduceat(sq, np.asarray(ptr[:-1], dtype=np.intp))
    out[np.diff(ptr) == 0] = 0.0
    return out


def split_sizes(n: int, k: int) -> np.ndarray:
    """Balanced contiguous split: the first n % k shards get one extra row."""
    sizes = np.full(k, n // k, dtype=np.int64)
    sizes[: n % k] += 1
    return sizes


@dataclasses.dataclass
class ShardedDataset:
    """All tensors lead with K and live on one device."""

    layout: str                        # "dense" | "sparse"
    n: int                             # total real examples
    num_features: int                  # d
    counts: np.ndarray                 # (K,) real rows per shard (host)
    labels: torch.Tensor               # (K, n_shard)
    mask: torch.Tensor                 # (K, n_shard) 1 real / 0 pad
    sq_norms: torch.Tensor             # (K, n_shard) ||x_i||^2
    X: Optional[torch.Tensor] = None           # dense: (K, n_shard, d)
    sp_indices: Optional[torch.Tensor] = None  # sparse: (K, n_shard, W) int32
    sp_values: Optional[torch.Tensor] = None   # sparse: (K, n_shard, W)

    @property
    def k(self) -> int:
        return self.labels.shape[0]

    @property
    def n_shard(self) -> int:
        return self.labels.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.labels.dtype

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def shard_arrays(self) -> dict:
        """The per-shard tensors the local solvers read."""
        out = {"labels": self.labels, "mask": self.mask,
               "sq_norms": self.sq_norms}
        if self.layout == "dense":
            out["X"] = self.X
        else:
            out["sp_indices"] = self.sp_indices
            out["sp_values"] = self.sp_values
        return out


def shard_dataset(data: LibsvmData, k: int, layout: str = "auto",
                  dtype: torch.dtype = torch.float32,
                  device=None) -> ShardedDataset:
    """Partition ``data`` into K balanced contiguous shards on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA).
    Host arrays are built in float64 and cast once, so ``sq_norms`` is
    the exact float64 sum of squares rounded to ``dtype``."""
    device = resolve_device(device)
    n, d = data.n, data.num_features
    layout = resolve_layout(data, layout)
    sizes = split_sizes(n, k)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n_shard = int(sizes.max()) if k > 0 else 0
    row_nnz = np.diff(data.indptr)
    row_sq = segment_sq_norms(data.values, data.indptr)
    width = max(1, int(row_nnz.max(initial=1)))

    labels = np.zeros((k, n_shard))
    mask = np.zeros((k, n_shard))
    sq = np.zeros((k, n_shard))
    if layout == "dense":
        X = np.zeros((k, n_shard, d))
    else:
        spi = np.zeros((k, n_shard, width), np.int32)
        spv = np.zeros((k, n_shard, width))
    for s in range(k):
        lo, hi = offsets[s], offsets[s + 1]
        m = hi - lo
        labels[s, :m] = data.labels[lo:hi]
        mask[s, :m] = 1.0
        sq[s, :m] = row_sq[lo:hi]
        a, b = data.indptr[lo], data.indptr[hi]
        rows = np.repeat(np.arange(m), row_nnz[lo:hi])
        if layout == "dense":
            X[s, rows, data.indices[a:b]] = data.values[a:b]
        else:
            cols = (np.arange(a, b)
                    - np.repeat(data.indptr[lo:hi], row_nnz[lo:hi]))
            spi[s, rows, cols] = data.indices[a:b]
            spv[s, rows, cols] = data.values[a:b]

    def put(arr, dt=dtype):
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return ShardedDataset(
        layout=layout, n=n, num_features=d,
        counts=sizes.astype(np.int64),
        labels=put(labels), mask=put(mask), sq_norms=put(sq),
        X=put(X) if layout == "dense" else None,
        sp_indices=put(spi, torch.int32) if layout == "sparse" else None,
        sp_values=put(spv) if layout == "sparse" else None,
    )
