"""Column (feature) shards for ProxCoCoA+ (counterpart of
cocoa_tpu/data/columns.py).

The L1 solver partitions the design A (n x d) by columns: worker k owns a
coordinate block x_[k] and its columns A_[k], and the n-vector r = Ax - b
is the replicated state -- the mirror of the dual solvers, where examples
are sharded and w is shared.  The result is a :class:`ShardedDataset`
with the roles transposed: a shard's "rows" are columns a_j (length n),
``labels`` are all ones (the prox rules have no y factor), ``sq_norms``
are |a_j|^2, ``counts`` the columns per shard and ``num_features`` n.

Shards are padded only to the largest shard's column count, and n is not
padded; the JAX package pads both for the TPU, so padded shapes differ
from its, and the unpadded contents do not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.data.sharding import ShardedDataset, gang_fields, \
    part_range, segment_sq_norms, split_sizes
from cocoa_torch.device import resolve_device


def shard_columns(data: LibsvmData, k: int,
                  dtype: torch.dtype = torch.float32, device=None,
                  layout: str = "auto",
                  max_col_nnz: Optional[int] = None,
                  part: Optional[tuple] = None):
    """Partition A's d columns into K balanced contiguous blocks on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Returns
    ``(ds, b)``: the transposed-role dataset (shard "row" j is column
    offs[k] + j of A) and b (n,), the regression target
    (``data.labels``).

    - ``dense``: each column a dense (n,) vector;
    - ``sparse``: padded CSC, each column's (row, value) pairs padded to
      the widest column; ``max_col_nnz`` refuses a widest column past it
      (hot features make the padded width approach n);
    - ``auto``: sparse below 10% density when the widest column keeps the
      padded encoding under half of dense (2 * widest < n) and within
      ``max_col_nnz``, else dense.

    Host arrays are built in float64 and cast once.  ``part=(rank,
    world)`` builds only that rank's column shards, as
    :func:`cocoa_torch.data.sharding.shard_dataset` builds its rows: the
    layout and padded width still from the whole design."""
    if layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"layout must be auto|dense|sparse, got {layout!r}")
    device = resolve_device(device)
    n, d = data.n, data.num_features
    sizes = split_sizes(d, k)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    d_shard = int(sizes.max())

    # CSR -> CSC once (also gives each column's nnz for the layout rule)
    row_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(data.indptr))
    order = np.argsort(data.indices, kind="stable")
    csc_rows = row_ids[order]
    csc_vals = np.asarray(data.values, np.float64)[order]
    col_nnz = np.bincount(data.indices, minlength=d).astype(np.int64)
    col_ptr = np.concatenate([[0], np.cumsum(col_nnz)])
    widest = int(col_nnz.max(initial=1))

    if layout == "auto":
        density = int(data.indptr[-1]) / max(1, n * d)
        layout = ("sparse" if density < 0.10 and widest * 2 < n
                  and (max_col_nnz is None or widest <= max_col_nnz)
                  else "dense")
    if layout == "sparse" and max_col_nnz is not None \
            and widest > max_col_nnz:
        raise ValueError(
            f"widest column has {widest} nonzeros > max_col_nnz="
            f"{max_col_nnz}; hot features make padded-CSC degenerate -- "
            f"use layout='dense'")

    lo_s, hi_s = part_range(k, part)
    m_loc = hi_s - lo_s
    labels = np.zeros((m_loc, d_shard))
    mask = np.zeros((m_loc, d_shard))
    sq = np.zeros((m_loc, d_shard))
    col_sq = segment_sq_norms(csc_vals, col_ptr)
    if layout == "dense":
        X = np.zeros((m_loc, d_shard, n))
    else:
        spi = np.zeros((m_loc, d_shard, widest), np.int32)
        spv = np.zeros((m_loc, d_shard, widest))
    for s in range(m_loc):
        lo, hi = offsets[lo_s + s], offsets[lo_s + s + 1]
        labels[s, :hi - lo] = 1.0
        mask[s, :hi - lo] = 1.0
        sq[s, :hi - lo] = col_sq[lo:hi]
        a, e = col_ptr[lo], col_ptr[hi]
        cols = np.repeat(np.arange(hi - lo), col_nnz[lo:hi])
        if layout == "dense":
            X[s, cols, csc_rows[a:e]] = csc_vals[a:e]
        else:
            slots = np.arange(a, e) - np.repeat(col_ptr[lo:hi], col_nnz[lo:hi])
            spi[s, cols, slots] = csc_rows[a:e]
            spv[s, cols, slots] = csc_vals[a:e]

    def put(arr, dt=dtype):
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    ds = ShardedDataset(
        layout=layout, n=d, num_features=n,
        counts=sizes[lo_s:hi_s].astype(np.int64),
        labels=put(labels), mask=put(mask), sq_norms=put(sq),
        X=put(X) if layout == "dense" else None,
        sp_indices=put(spi, torch.int32) if layout == "sparse" else None,
        sp_values=put(spv) if layout == "sparse" else None,
        **gang_fields(k, lo_s, hi_s, sizes, part))
    return ds, put(np.asarray(data.labels, np.float64))
