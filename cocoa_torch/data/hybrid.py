"""The hot/cold column split of the padded-CSR layout, ``--hotCols``
(counterpart of cocoa_tpu/data/hybrid.py).

Sparse text data (rcv1-like) has Zipf column popularity: a few thousand
globally hot columns carry about three quarters of all nonzeros.  The
split moves them into a dense panel and keeps the rest as padded CSR:

- a **hot panel** ``X_hot`` (K, n_shard, n_hot): each row's values at the
  globally hottest ``n_hot`` columns, zero where the row lacks the column,
  n_hot a multiple of 128; ``hot_cols`` maps panel lanes back to column
  ids, and lanes past the real hot count carry column 0 and value 0;
- a **cold residual** padded CSR holding the remaining nonzeros, as wide
  as the largest row's residual.

The panel is chosen once from the whole dataset's column histogram, so it
is the same for every shard and every round.  The split partitions each
row's nonzeros by column, so every per-row sum the solvers compute is a
permutation of the unsplit one.

The resolved width and the hot column ids equal the JAX package's for the
same data: that includes the 128-column rounding and the budget's
accounting, which counts the JAX layout's rows (:func:`pad_rows`, shards
rounded up to 16 rows).  The width decides which columns are hot, and so
the residual and every result.
"""

from __future__ import annotations

import numpy as np

from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.data.sharding import split_sizes

PANEL_LANES = 128            # panel width granularity
HOT_COVERAGE_TARGET = 0.75   # --hotCols=auto aims at this nonzero coverage
HOT_PANEL_HBM_BUDGET = 2 << 30   # 2 GiB for the panel


def pad_rows(n_rows: int) -> int:
    """A shard's row count in the JAX package's layout (rounded up to 16);
    the budget accounting reads it so that the width matches the JAX
    package's.  The port's own shards are not padded."""
    return -(-n_rows // 16) * 16


def pad_panel(n: int) -> int:
    """Panel width rounded up to whole blocks of 128 columns (padded lanes
    carry value 0 everywhere and column id 0, inert in every dot and
    scatter)."""
    return -(-n // PANEL_LANES) * PANEL_LANES


def column_counts(data: LibsvmData) -> np.ndarray:
    """(d,) global column histogram: how many nonzeros each column has."""
    return np.bincount(data.indices, minlength=data.num_features)


def hottest_columns(counts: np.ndarray, n_hot: int) -> np.ndarray:
    """The ``n_hot`` most frequent column ids, sorted ascending (count
    descending, id ascending on ties, then sorted by id)."""
    n_hot = min(int(n_hot), len(counts))
    if n_hot <= 0:
        return np.zeros(0, dtype=np.int32)
    order = np.lexsort((np.arange(len(counts)), -counts))
    return np.sort(order[:n_hot]).astype(np.int32)


def hot_rank(num_features: int, hot_ids: np.ndarray) -> np.ndarray:
    """(d,) lookup: column id -> panel lane, or -1 for a cold column."""
    rank = np.full(num_features, -1, dtype=np.int64)
    rank[hot_ids] = np.arange(len(hot_ids))
    return rank


def split_stats(data: LibsvmData, hot_ids: np.ndarray) -> dict:
    """One candidate split's nonzero coverage and the residual's per-row
    nnz, mean and max (the max is the residual's padded width)."""
    rank = hot_rank(data.num_features, hot_ids)
    is_hot = rank[data.indices] >= 0
    row_nnz = np.diff(data.indptr)
    rows = np.repeat(np.arange(data.n, dtype=np.int64), row_nnz)
    cold_per_row = np.bincount(rows[~is_hot], minlength=data.n)
    total = max(1, int(data.indptr[-1]))
    return {
        "coverage": float(is_hot.sum() / total),
        "residual_mean_nnz": float(cold_per_row.mean()) if data.n else 0.0,
        "residual_max_nnz": int(cold_per_row.max(initial=0)),
        "total_nnz": int(data.indptr[-1]),
    }


def residual_max_nnz(data: LibsvmData, rank: np.ndarray) -> int:
    """The largest row's count of cold nonzeros (``rank`` < 0): the
    residual's padded width before its floor of 1."""
    rows = np.repeat(np.arange(data.n, dtype=np.int64), np.diff(data.indptr))
    cold = rows[rank[data.indices] < 0]
    return int(np.bincount(cold, minlength=max(1, data.n)).max(initial=0))


def panel_bytes(n_hot: int, k: int, n_shard: int, itemsize: int) -> int:
    """Device bytes of the (K, n_shard, n_hot) hot panel."""
    return k * n_shard * n_hot * itemsize


def normalize_spec(spec) -> str:
    """The ``--hotCols`` value, lower-cased; None is ``off``."""
    return ("off" if spec is None else str(spec)).strip().lower()


def _n_shard(n: int, k: int) -> int:
    return pad_rows(int(split_sizes(n, k).max())) if k > 0 else 0


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    size = getattr(dtype, "itemsize", None)
    return size if isinstance(size, int) else np.dtype(dtype).itemsize


def resolve_hot_width(spec, counts: np.ndarray, n: int, k: int, dtype, *,
                      coverage_target: float = HOT_COVERAGE_TARGET,
                      budget: "int | None" = None) -> int:
    """``--hotCols=auto|off|<n>`` -> the panel width (0 = off), from the
    column histogram alone.  ``dtype`` is a numpy dtype or anything with
    an ``itemsize``.  Raises for a bad spec and for an explicit width
    over the budget."""
    if budget is None:
        budget = HOT_PANEL_HBM_BUDGET
    spec_s = normalize_spec(spec)
    if spec_s in ("off", "false", "0", "none", ""):
        return 0
    d = len(counts)
    itemsize = _itemsize(dtype)
    n_shard = _n_shard(n, k)
    per_lane_block = panel_bytes(PANEL_LANES, k, n_shard, itemsize)

    if spec_s == "auto":
        desc = np.sort(counts)[::-1]
        cums = np.cumsum(desc)
        total = max(1, int(cums[-1]) if len(cums) else 1)
        need = int(np.searchsorted(cums, coverage_target * total)) + 1
        width = pad_panel(min(need, d))
        max_width = (budget // per_lane_block) * PANEL_LANES \
            if per_lane_block > 0 else width
        width = min(width, max_width)
        # not even one block of 128 lanes fits the budget: keep the streams
        return int(width) if width >= PANEL_LANES else 0

    try:
        want = int(spec_s)
    except ValueError:
        raise ValueError(f"--hotCols must be auto|off|<n>, "
                         f"got {spec!r}") from None
    if want <= 0:
        raise ValueError(f"--hotCols must be auto|off|<positive n>, "
                         f"got {spec!r}")
    width = pad_panel(min(want, d))
    pb = panel_bytes(width, k, n_shard, itemsize)
    if pb > budget:
        raise ValueError(
            f"--hotCols={want}: the hot panel needs {pb / 2**20:.1f} MiB "
            f"of HBM (K={k} x n_shard={n_shard} x {width} lanes x "
            f"{itemsize} B) against the {budget / 2**20:.0f} MiB "
            f"budget; lower --hotCols or use --hotCols=auto"
        )
    return int(width)


def stats_from_counts(spec, counts: np.ndarray, width: int,
                      residual_max_nnz: int, n: int, k: int,
                      dtype) -> dict:
    """The split's record from the column histogram and the residual's
    widest row (exchanged across a gang): what :func:`resolve_hot_cols`
    records, for a streamed or cached build that holds no whole dataset.
    Coverage and the residual's mean come from exact integer totals, so
    the record equals the whole-file one; ``panel_bytes`` counts the rows
    as :func:`resolve_hot_cols` counts them (the JAX layout's)."""
    total = max(1, int(counts.sum()))
    hot_total = int(counts[hottest_columns(counts, width)].sum()) \
        if width else 0
    spec_s = normalize_spec(spec)
    if width == 0 and spec_s != "auto":
        spec_s = "off"
    return {
        "coverage": float(hot_total / total) if width else 0.0,
        "residual_mean_nnz": float((total - hot_total) / n) if n else 0.0,
        "residual_max_nnz": int(residual_max_nnz),
        "total_nnz": int(counts.sum()),
        "spec": spec_s,
        "hot_cols": int(width),
        "panel_bytes": panel_bytes(width, k, _n_shard(n, k),
                                   _itemsize(dtype)),
    }


def resolve_hot_cols(spec, data: LibsvmData, k: int, dtype, *,
                     coverage_target: float = HOT_COVERAGE_TARGET,
                     budget: "int | None" = None):
    """Resolve ``--hotCols`` to ``(n_hot, stats)``: the panel width (0 =
    the plain stream layout) and the split's record (spec, hot_cols,
    coverage, residual_mean_nnz, residual_max_nnz, panel_bytes,
    total_nnz).

    - ``auto``: the smallest multiple of 128 whose hottest columns cover
      ``coverage_target`` of all nonzeros, clamped down to the largest
      width the ``budget`` admits, and 0 when not even 128 lanes fit;
    - ``<n>``: that width rounded up to 128, refused over the budget;
    - ``off``/``0``: the unchanged stream layout.
    """
    spec_s = normalize_spec(spec)
    counts = column_counts(data)
    width = resolve_hot_width(spec, counts, data.n, k, dtype,
                              coverage_target=coverage_target, budget=budget)
    if width == 0:
        row_nnz = np.diff(data.indptr)
        return 0, {"spec": spec_s if spec_s == "auto" else "off",
                   "hot_cols": 0, "coverage": 0.0,
                   "residual_mean_nnz": (float(row_nnz.mean())
                                         if data.n else 0.0),
                   "residual_max_nnz": int(row_nnz.max(initial=0)),
                   "panel_bytes": 0,
                   "total_nnz": int(data.indptr[-1])}
    stats = split_stats(data, hottest_columns(counts, width))
    stats.update(spec=spec_s, hot_cols=int(width),
                 panel_bytes=panel_bytes(width, k, _n_shard(data.n, k),
                                         _itemsize(dtype)))
    return int(width), stats


def split_slab(data: LibsvmData, lo: int, hi: int, n_shard: int,
               rank: np.ndarray, n_hot: int, width_res: int, np_dtype):
    """One shard's hot panel (n_shard, n_hot) and cold-residual padded CSR
    (n_shard, width_res) for rows [lo, hi).  The residual keeps the
    surviving nonzeros in their original order within the row."""
    m = hi - lo
    a, b = data.indptr[lo], data.indptr[hi]
    row_nnz = np.diff(data.indptr[lo:hi + 1])
    rows = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    cols = np.asarray(data.indices[a:b], dtype=np.int64)
    vals = np.asarray(data.values[a:b])
    lanes = rank[cols]
    hot = lanes >= 0

    X_hot = np.zeros((n_shard, n_hot), np_dtype)
    X_hot[rows[hot], lanes[hot]] = vals[hot]

    crows = rows[~hot]
    cold_per_row = np.bincount(crows, minlength=m)
    cptr = np.concatenate([[0], np.cumsum(cold_per_row)])
    slots = np.arange(len(crows), dtype=np.int64) - cptr[crows]
    spi = np.zeros((n_shard, width_res), np.int32)
    spv = np.zeros((n_shard, width_res), np_dtype)
    spi[crows, slots] = cols[~hot]
    spv[crows, slots] = vals[~hot]
    return X_hot, spi, spv
