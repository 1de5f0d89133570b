"""Synthetic rcv1-like sparse data from a seed, numpy only (counterpart of
cocoa_tpu/data/synth.py ``synth_sparse`` / ``write_libsvm``).

rcv1.binary itself (20 242 x 47 236, about 75 nonzeros a row) is not in the
repository; ``synth_sparse`` makes a stand-in with its shape and
statistics: log-normal row lengths, Zipf column popularity, tf-idf values
on L2-normalised rows, and labels from a planted separator with label-flip
noise.  Same seed, same arrays as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np

from cocoa_torch.data.libsvm import LibsvmData


def _plant_labels(margins: np.ndarray, flip: float, rng) -> np.ndarray:
    """sign(x . w*) labels with probability-``flip`` label noise."""
    y = np.where(margins >= 0, 1.0, -1.0)
    if flip > 0:
        y = np.where(rng.random(y.shape) < flip, -y, y)
    return y


def synth_sparse(n: int, d: int, *, nnz_mean: int = 75, seed: int = 0,
                 flip: float = 0.02, nnz_sigma: float = 0.7) -> LibsvmData:
    """rcv1-like sparse data; ``nnz_mean`` is the mean of unique terms per
    row, and a row holds at most ``min(d, 12 * nnz_mean)`` token draws."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, d + 1)
    probs = weights / weights.sum()
    cdf = np.cumsum(probs)
    # log-normal token counts inflated by the measured dedup shrinkage of
    # Zipf draws (~0.79 unique per draw), so the unique mean is nnz_mean
    mu = np.log(nnz_mean * 1.27) - 0.5 * nnz_sigma ** 2
    row_nnz = np.clip(
        np.round(rng.lognormal(mu, nnz_sigma, size=n)), 1,
        min(d, 12 * nnz_mean),
    ).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)])
    cols = np.searchsorted(cdf, rng.random(int(indptr[-1]))).astype(np.int32)
    idf = np.log(1.0 / np.maximum(probs, 1.0 / (50.0 * n)))
    indices_list = []
    values_list = []
    w_star = rng.standard_normal(d) / np.sqrt(nnz_mean)
    margins = np.empty(n)
    out_ptr = [0]
    for i in range(n):
        c, tf = np.unique(cols[indptr[i]:indptr[i + 1]], return_counts=True)
        v = (1.0 + np.log(tf)) * idf[c]
        nrm = np.linalg.norm(v)
        v = v / (nrm if nrm > 0 else 1.0)
        indices_list.append(c)
        values_list.append(v)
        out_ptr.append(out_ptr[-1] + c.size)
        margins[i] = v @ w_star[c]
    y = _plant_labels(margins, flip, rng)
    return LibsvmData(
        labels=y.astype(np.float64),
        indptr=np.asarray(out_ptr, dtype=np.int64),
        indices=np.concatenate(indices_list).astype(np.int32),
        values=np.concatenate(values_list).astype(np.float64),
        num_features=d,
    )


def write_libsvm(data: LibsvmData, path: str, precision: int = 8) -> None:
    """LIBSVM text: 1-based indices, ``+1``/``-1`` labels."""
    with open(path, "w") as f:
        for i in range(data.n):
            idx, val = data.row(i)
            lab = "+1" if data.labels[i] > 0 else "-1"
            pairs = " ".join(
                f"{j + 1}:{v:.{precision}g}" for j, v in zip(idx, val))
            f.write(f"{lab} {pairs}\n" if pairs else f"{lab}\n")
