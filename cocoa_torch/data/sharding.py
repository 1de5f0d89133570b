"""K contiguous row shards stacked on a leading axis (counterpart of
cocoa_tpu/data/sharding.py, single process, dense and padded-CSR).

- **dense**: ``X`` is (K, n_shard, d).
- **sparse** (padded CSR): ``sp_indices``/``sp_values`` are
  (K, n_shard, W) with W the dataset's max row nnz; a row's slots past its
  nnz carry index 0 / value 0.
- **hybrid** (sparse with ``hot_cols`` > 0, ``--hotCols``, data/hybrid.py):
  a dense hot panel ``X_hot`` (K, n_shard, n_hot) over the globally
  hottest columns, ``hot_cols`` (K, n_hot) its column ids, and the
  padded CSR holding only the cold residual, at the residual's width.
- **eval twin** (sparse or hybrid with ``eval_dense``, ``--evalDense``):
  ``X_eval`` (K, n_shard, d), the rows dense, read only by the
  evaluation's margins (ops/rows.py ``eval_margins``); training never
  reads it.

Shards are padded to the largest shard's row count; padded rows carry
``mask=0``, ``y=0``, ``x=0`` and are never sampled.

A rank of a gang (``part=(rank, world size)``, parallel/mesh.py) builds
only its own m = K/P consecutive shards [rank*m, (rank+1)*m): the same
rows, padding, hot panel and twin as those shards of the single-process
build, while ``n``, ``k`` and ``all_counts`` stay the whole dataset's
(the certificate divides by n, the scaling laws read K).  Unlike the JAX
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


# the dense eval twin's device-memory budget under ``--evalDense=auto``
# (cocoa_tpu/data/sharding.py EVAL_DENSE_HBM_BUDGET): kept at the JAX
# package's value, so that auto decides as the JAX CLI decides
EVAL_DENSE_HBM_BUDGET = 2 << 30


def eval_dense_fits(n: int, d: int, k: int, dtype: torch.dtype,
                    budget: int = EVAL_DENSE_HBM_BUDGET) -> bool:
    """Whether the sparse layout's dense eval twin fits ``budget``
    (``--evalDense=auto``), counted as the JAX package counts it: its
    shards' rows rounded up to a multiple of 16 (cocoa_tpu/data/sharding.py
    ``pad_rows``), though this port stores them unrounded."""
    n_shard = -(-int(split_sizes(n, k).max()) // 16) * 16 if k > 0 else 0
    return k * n_shard * d * dtype.itemsize <= budget


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
    X_hot: Optional[torch.Tensor] = None       # hybrid: (K, n_shard, n_hot)
    hot_cols: Optional[torch.Tensor] = None    # hybrid: (K, n_hot) int32
    X_eval: Optional[torch.Tensor] = None      # eval twin: (K, n_shard, d)
    # a gang's rank: the whole dataset's K, the first global shard it
    # holds, every shard's real rows, and the mesh its sums cross
    k_total: Optional[int] = None
    shard_lo: int = 0
    all_counts: Optional[np.ndarray] = None
    mesh: Optional[object] = None

    @property
    def k(self) -> int:
        """The whole dataset's shard count K (what the scaling laws and
        sigma' read)."""
        return self.labels.shape[0] if self.k_total is None \
            else self.k_total

    @property
    def m(self) -> int:
        """The shards this process holds (the tensors' leading axis)."""
        return self.labels.shape[0]

    @property
    def global_counts(self) -> np.ndarray:
        """(K,) real rows of every shard of the whole dataset."""
        return self.counts if self.all_counts is None else self.all_counts

    @property
    def n_shard(self) -> int:
        return self.labels.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.labels.dtype

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @property
    def n_hot(self) -> int:
        """The hot panel's width; 0 without a panel."""
        return 0 if self.X_hot is None else self.X_hot.shape[-1]

    def shard_arrays(self) -> dict:
        """The per-shard tensors the local solvers read."""
        out = {"labels": self.labels, "mask": self.mask,
               "sq_norms": self.sq_norms}
        if self.layout == "dense":
            out["X"] = self.X
        else:
            out["sp_indices"] = self.sp_indices
            out["sp_values"] = self.sp_values
            if self.X_hot is not None:
                out["X_hot"] = self.X_hot
                out["hot_cols"] = self.hot_cols
            if self.X_eval is not None:
                out["X_eval"] = self.X_eval
        return out


def part_range(k: int, part: Optional[tuple]) -> tuple:
    """The shards [lo, hi) that rank r of P builds, ``part=(r, P)``: the
    m = K/P consecutive shards [r*m, (r+1)*m) (parallel/mesh.py
    ``dp_local_shards``); all K without a part.  Raises with the JAX
    package's message when P does not divide K."""
    if part is None:
        return 0, k
    rank, world = part
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"part must be (rank, world) with 0 <= rank < "
                         f"world, got {part}")
    if k % world != 0:
        raise ValueError(
            f"multi-process runs need numSplits divisible by the dp "
            f"mesh size: K={k} shards cannot multiplex onto "
            f"{world} devices")
    m = k // world
    return rank * m, (rank + 1) * m


def gang_fields(k: int, lo: int, hi: int, sizes: np.ndarray,
                 part: Optional[tuple]) -> dict:
    """The fields that make a rank's dataset one part of the whole."""
    if part is None:
        return {}
    return dict(k_total=k, shard_lo=lo, all_counts=sizes.astype(np.int64))


def shard_dataset(data: LibsvmData, k: int, layout: str = "auto",
                  dtype: torch.dtype = torch.float32, device=None,
                  hot_cols: int = 0, eval_dense: bool = False,
                  part: Optional[tuple] = None) -> ShardedDataset:
    """Partition ``data`` into K balanced contiguous shards on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA).
    Host arrays are built in float64 and cast once, so ``sq_norms`` is
    the exact float64 sum of squares rounded to ``dtype``.

    ``hot_cols`` > 0 (sparse layout only) builds the hybrid layout with a
    panel of ``pad_panel(min(hot_cols, d))`` lanes over the data's own
    hottest columns (data/hybrid.py), the same split as
    ``resolve_hot_cols`` measured.

    ``eval_dense`` (sparse layout only, hybrid included) adds the dense
    eval twin ``X_eval``, built one shard at a time on the host.

    ``part=(rank, world)`` builds only that rank's shards
    (:func:`part_range`), a pure function of the pair: the hot columns
    still come from the whole file's histogram and the residual's width
    from its widest row, so the result is rows [lo, hi) of the whole
    build."""
    device = resolve_device(device)
    n, d = data.n, data.num_features
    layout = resolve_layout(data, layout)
    if eval_dense and layout != "sparse":
        raise ValueError("eval_dense only applies to the sparse layout "
                         "(the dense layout's eval is already a matvec)")
    sizes = split_sizes(n, k)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n_shard = int(sizes.max()) if k > 0 else 0
    lo_s, hi_s = part_range(k, part)
    m_loc = hi_s - lo_s
    row_nnz = np.diff(data.indptr)
    row_sq = segment_sq_norms(data.values, data.indptr)
    width = max(1, int(row_nnz.max(initial=1)))
    n_hot = 0
    if hot_cols:
        from cocoa_torch.data import hybrid

        if layout != "sparse":
            raise ValueError("hot_cols (the hot/cold column split) only "
                             "applies to the sparse layout")
        n_hot = hybrid.pad_panel(min(int(hot_cols), d))
        hot_ids = hybrid.hottest_columns(hybrid.column_counts(data), n_hot)
        rank = hybrid.hot_rank(d, hot_ids)
        # the residual is as wide as the largest row's cold nonzeros
        cold_rows = np.repeat(np.arange(n, dtype=np.int64),
                              row_nnz)[rank[data.indices] < 0]
        width = max(1, int(np.bincount(cold_rows, minlength=max(1, n))
                           .max(initial=0)))
        # the panel is built in the working precision where that is
        # float32 (one rounding either way): 427 MB at rcv1-like size
        hot_np = np.float32 if dtype == torch.float32 else np.float64
        X_hot = np.zeros((m_loc, n_shard, n_hot), hot_np)

    labels = np.zeros((m_loc, n_shard))
    mask = np.zeros((m_loc, n_shard))
    sq = np.zeros((m_loc, n_shard))
    if layout == "dense":
        X = np.zeros((m_loc, n_shard, d))
    else:
        spi = np.zeros((m_loc, n_shard, width), np.int32)
        spv = np.zeros((m_loc, n_shard, width))
    for s in range(m_loc):
        lo, hi = offsets[lo_s + s], offsets[lo_s + s + 1]
        m = hi - lo
        labels[s, :m] = data.labels[lo:hi]
        mask[s, :m] = 1.0
        sq[s, :m] = row_sq[lo:hi]
        a, b = data.indptr[lo], data.indptr[hi]
        rows = np.repeat(np.arange(m), row_nnz[lo:hi])
        if layout == "dense":
            X[s, rows, data.indices[a:b]] = data.values[a:b]
        elif n_hot:
            X_hot[s], spi[s], spv[s] = hybrid.split_slab(
                data, lo, hi, n_shard, rank, n_hot, width, np.float64)
        else:
            cols = (np.arange(a, b)
                    - np.repeat(data.indptr[lo:hi], row_nnz[lo:hi]))
            spi[s, rows, cols] = data.indices[a:b]
            spv[s, rows, cols] = data.values[a:b]

    def put(arr, dt=dtype):
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    extra = {}
    if eval_dense:
        # a repeated column keeps its last value, as the dense layout
        # does; float32 is built as float32 (one rounding either way)
        twin_np = np.float32 if dtype == torch.float32 else np.float64
        extra["X_eval"] = torch.empty((m_loc, n_shard, d), dtype=dtype,
                                      device=device)
        for s in range(m_loc):
            lo, hi = offsets[lo_s + s], offsets[lo_s + s + 1]
            a, b = data.indptr[lo], data.indptr[hi]
            slab = np.zeros((n_shard, d), twin_np)
            slab[np.repeat(np.arange(hi - lo), row_nnz[lo:hi]),
                 data.indices[a:b]] = data.values[a:b]
            extra["X_eval"][s].copy_(torch.from_numpy(slab))
    if n_hot:
        # lanes past the real hot count carry column 0 and value 0
        hc = np.zeros(n_hot, dtype=np.int32)
        hc[:len(hot_ids)] = hot_ids
        extra.update(X_hot=put(X_hot),
                     hot_cols=put(np.tile(hc[None], (m_loc, 1)),
                                  torch.int32))
    return ShardedDataset(
        layout=layout, n=n, num_features=d,
        counts=sizes[lo_s:hi_s].astype(np.int64),
        labels=put(labels), mask=put(mask), sq_norms=put(sq),
        X=put(X) if layout == "dense" else None,
        sp_indices=put(spi, torch.int32) if layout == "sparse" else None,
        sp_values=put(spv) if layout == "sparse" else None,
        **extra, **gang_fields(k, lo_s, hi_s, sizes, part),
    )
