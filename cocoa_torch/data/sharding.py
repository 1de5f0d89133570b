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

Each shard is built on the host by :func:`_build_shard_slabs` and copied
to the device by :func:`assemble`; the whole-file build here, the
streamed one and the slab cache (data/ingest.py, data/slab_cache.py) all
go through the two, so their shards are equal bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.device import resolve_device


def resolve_layout_stats(n: int, d: int, nnz: int, layout: str) -> str:
    """The one place the ``layout="auto"`` rule lives, from the dataset's
    counts alone (streamed ingest resolves before any shard is parsed):
    sparse below 10% density (rcv1-like), dense otherwise."""
    if layout not in ("auto", "dense", "sparse"):
        raise ValueError(f"layout must be auto|dense|sparse, got {layout!r}")
    if layout != "auto":
        return layout
    return "sparse" if nnz / max(1, n * d) < 0.10 else "dense"


def resolve_layout(data: LibsvmData, layout: str) -> str:
    """``layout="auto"`` against a parsed dataset."""
    return resolve_layout_stats(data.n, data.num_features,
                                int(data.indptr[-1]), layout)


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
    residual_max_nnz: int = 0          # hybrid: its residual's widest row
                                       # as the ingest measured it
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


# a bfloat16 array on the host: its 16-bit patterns as the 2-byte void
# type, the form checkpoint.py stores (numpy has no bfloat16)
BF16_HOST = np.dtype("V2")


def _build_np(dtype: torch.dtype):
    """The precision a slab's float fields are built in: float32 runs
    build in float32 (each value rounded once on assignment, as a cast
    would round it); float64 and bfloat16 runs in float64."""
    return np.float32 if dtype == torch.float32 else np.float64


def _finish_np(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """A built float field in the run's dtype: bfloat16 rounded once from
    float64 by torch's cast and kept as its 16-bit patterns."""
    if dtype != torch.bfloat16:
        return arr
    return (torch.from_numpy(arr).to(torch.bfloat16).view(torch.int16)
            .numpy().view(BF16_HOST))


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A slab field as a CPU tensor, a ``|V2`` one as bfloat16.  A
    read-only array (a cache artifact's memmap) is copied first, so
    torch never holds a view it could write through."""
    if not arr.flags.writeable:
        arr = np.array(arr)
    if arr.dtype == BF16_HOST:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _densify_rows(piece, lo, hi, n_shard, d, np_dtype, row_nnz):
    """Rows [lo, hi) of the CSR ``piece`` as a zero-padded (n_shard, d)
    dense slab (a repeated column keeps its last value): the dense layout
    and the eval twin."""
    a, b = piece.indptr[lo], piece.indptr[hi]
    X = np.zeros((n_shard, d), np_dtype)
    X[np.repeat(np.arange(hi - lo), row_nnz[lo:hi]),
      piece.indices[a:b]] = piece.values[a:b]
    return X


def _build_shard_slabs(piece, lo, hi, n_shard, layout, dtype, d, width,
                       row_nnz, row_sq, *, rank=None, n_hot=0,
                       eval_dense=False) -> dict:
    """One shard's host arrays (rows [lo, hi) of the CSR ``piece``) in the
    run's ``dtype``: labels, mask and sq_norms, then the dense ``X``, the
    padded CSR, or (``n_hot`` > 0) the hot panel and the cold residual,
    and the eval twin.  ``row_nnz`` and ``row_sq`` (the exact float64
    sums of squares) index ``piece`` as ``lo`` and ``hi`` do.  Every
    build (whole file, streamed, cached) makes its shards here, so equal
    rows give equal bits."""
    np_dtype = _build_np(dtype)
    m = hi - lo
    labels = np.zeros(n_shard, np_dtype)
    labels[:m] = piece.labels[lo:hi]
    mask = np.zeros(n_shard, np_dtype)
    mask[:m] = 1.0
    sq = np.zeros(n_shard, np_dtype)
    sq[:m] = row_sq[lo:hi]
    out = dict(labels=labels, mask=mask, sq_norms=sq)
    if layout == "dense":
        out["X"] = _densify_rows(piece, lo, hi, n_shard, d, np_dtype,
                                 row_nnz)
    elif n_hot:
        from cocoa_torch.data import hybrid

        out["X_hot"], out["sp_indices"], out["sp_values"] = \
            hybrid.split_slab(piece, lo, hi, n_shard, rank, n_hot, width,
                              np_dtype)
    else:
        a, b = piece.indptr[lo], piece.indptr[hi]
        rows = np.repeat(np.arange(m), row_nnz[lo:hi])
        cols = np.arange(a, b) - np.repeat(piece.indptr[lo:hi],
                                           row_nnz[lo:hi])
        spi = np.zeros((n_shard, width), np.int32)
        spv = np.zeros((n_shard, width), np_dtype)
        spi[rows, cols] = piece.indices[a:b]
        spv[rows, cols] = piece.values[a:b]
        out["sp_indices"], out["sp_values"] = spi, spv
    if eval_dense:
        out["X_eval"] = _densify_rows(piece, lo, hi, n_shard, d, np_dtype,
                                      row_nnz)
    return {f: v if f == "sp_indices" else _finish_np(v, dtype)
            for f, v in out.items()}


def assemble(slabs, *, layout: str, n: int, d: int, k: int,
             sizes: np.ndarray, dtype: torch.dtype, device,
             part: Optional[tuple], hot_ids=None, n_hot: int = 0,
             residual_max_nnz: int = 0) -> ShardedDataset:
    """A rank's :class:`ShardedDataset` from ``slabs``, an iterable of
    ``(global shard id, slab dict)`` over its shards (in any order): each
    slab is copied once into its row of the (m, ...) tensors on
    ``device`` and then dropped, so the host holds one slab at a time."""
    lo_s, hi_s = part_range(k, part)
    fields: dict = {}
    for s, slab in slabs:
        for f, v in slab.items():
            t = host_tensor(v)
            if f not in fields:
                fields[f] = torch.empty((hi_s - lo_s, *t.shape),
                                        dtype=t.dtype, device=device)
            fields[f][s - lo_s].copy_(t)
    if n_hot:
        # lanes past the real hot count carry column 0 and value 0
        hc = np.zeros(n_hot, dtype=np.int32)
        hc[:len(hot_ids)] = hot_ids
        fields["hot_cols"] = torch.from_numpy(
            np.tile(hc[None], (hi_s - lo_s, 1))).to(device)
    return ShardedDataset(
        layout=layout, n=n, num_features=d,
        counts=sizes[lo_s:hi_s].astype(np.int64), **fields,
        residual_max_nnz=int(residual_max_nnz),
        **gang_fields(k, lo_s, hi_s, sizes, part))


def cached_or_built(view, s: int, build):
    """Shard ``s`` through the optional slab-cache view
    (data/slab_cache.py): a valid artifact is used as it is, a miss is
    built and published."""
    if view is not None:
        slab = view.load(s)
        if slab is not None:
            return slab
    slab = build()
    if view is not None:
        view.store(s, slab)
    return slab


def shard_dataset(data: LibsvmData, k: int, layout: str = "auto",
                  dtype: torch.dtype = torch.float32, device=None,
                  hot_cols: int = 0, eval_dense: bool = False,
                  part: Optional[tuple] = None,
                  cache=None, counts=None) -> ShardedDataset:
    """Partition ``data`` into K balanced contiguous shards on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA), one
    shard at a time through :func:`_build_shard_slabs`, so ``sq_norms``
    is the exact float64 sum of squares rounded once to ``dtype``.

    ``hot_cols`` > 0 (sparse layout only) builds the hybrid layout with a
    panel of ``pad_panel(min(hot_cols, d))`` lanes over the data's own
    hottest columns (data/hybrid.py), the same split as
    ``resolve_hot_cols`` measured; ``counts`` is the data's column
    histogram (``hybrid.column_counts``) where the caller holds it.  The
    residual's widest row is kept as ``residual_max_nnz``.

    ``eval_dense`` (sparse layout only, hybrid included) adds the dense
    eval twin ``X_eval``.

    ``part=(rank, world)`` builds only that rank's shards
    (:func:`part_range`), a pure function of the pair: the hot columns
    still come from the whole file's histogram and the residual's width
    from its widest row, so the result is rows [lo, hi) of the whole
    build.

    ``cache`` (a ``slab_cache.FileCacheHandle``, ``--ingestCache``)
    serves each shard from its artifact where one is valid and publishes
    each shard built, with the hybrid residual's width beside them."""
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
    row_nnz = np.diff(data.indptr)
    row_sq = segment_sq_norms(data.values, data.indptr)
    width = max(1, int(row_nnz.max(initial=1))) if layout == "sparse" \
        else 0
    n_hot, rank, hot_ids, resid_max = 0, None, None, 0
    if hot_cols:
        from cocoa_torch.data import hybrid

        if layout != "sparse":
            raise ValueError("hot_cols (the hot/cold column split) only "
                             "applies to the sparse layout")
        n_hot = hybrid.pad_panel(min(int(hot_cols), d))
        if counts is None:
            counts = hybrid.column_counts(data)
        hot_ids = hybrid.hottest_columns(counts, n_hot)
        rank = hybrid.hot_rank(d, hot_ids)
        # the residual is as wide as the largest row's cold nonzeros
        resid_max = hybrid.residual_max_nnz(data, rank)
        width = max(1, resid_max)
        if cache is not None:
            cache.store_hybrid_meta(n_hot, resid_max)
    view = None if cache is None else cache.view(
        layout=layout, k=k, n_shard=n_shard, width=width, n_hot=n_hot, d=d,
        dtype=dtype, eval_dense=eval_dense)
    slabs = ((s, cached_or_built(view, s, lambda s=s: _build_shard_slabs(
        data, offsets[s], offsets[s + 1], n_shard, layout, dtype, d, width,
        row_nnz, row_sq, rank=rank, n_hot=n_hot, eval_dense=eval_dense)))
        for s in range(lo_s, hi_s))
    return assemble(slabs, layout=layout, n=n, d=d, k=k, sizes=sizes,
                    dtype=dtype, device=device, part=part, hot_ids=hot_ids,
                    n_hot=n_hot, residual_max_nnz=resid_max)
