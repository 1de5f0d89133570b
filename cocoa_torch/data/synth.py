"""Synthetic epsilon-like dense and rcv1-like sparse data from a seed
(counterpart of cocoa_tpu/data/synth.py).

``synth_dense`` (epsilon-like: unit rows, planted labels) and
``synth_sparse`` are numpy and give the JAX package's arrays for the same
seed; ``synth_dense_sharded`` builds the (K, n_shard, d) shards on the
device at epsilon's full size (400 000 x 2000) with its own draws.

rcv1.binary itself (20 242 x 47 236, about 75 nonzeros a row) is not in the
repository; ``synth_sparse`` makes a stand-in with its shape and
statistics: log-normal row lengths, Zipf column popularity, tf-idf values
on L2-normalised rows, and labels from a planted separator with label-flip
noise.  Same seed, same arrays as the JAX package's generator.
"""

from __future__ import annotations

import numpy as np
import torch

from cocoa_torch.data.libsvm import LibsvmData
from cocoa_torch.data.sharding import ShardedDataset, split_sizes
from cocoa_torch.device import resolve_device


def _plant_labels(margins: np.ndarray, flip: float, rng) -> np.ndarray:
    """sign(x . w*) labels with probability-``flip`` label noise."""
    y = np.where(margins >= 0, 1.0, -1.0)
    if flip > 0:
        y = np.where(rng.random(y.shape) < flip, -y, y)
    return y


def synth_dense(n: int, d: int, *, seed: int = 0,
                flip: float = 0.02) -> LibsvmData:
    """Host-side epsilon-like dense data (small n*d only), as CSR rows."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    w_star = rng.standard_normal(d) / np.sqrt(d)
    y = _plant_labels(X @ w_star, flip, rng)
    return LibsvmData(
        labels=y.astype(np.float64),
        indptr=np.arange(0, (n + 1) * d, d, dtype=np.int64),
        indices=np.tile(np.arange(d, dtype=np.int32), n),
        values=X.reshape(-1).astype(np.float64),
        num_features=d,
    )


def synth_dense_sharded(n: int, d: int, k: int, *, seed: int = 0,
                        flip: float = 0.02, dtype=torch.float32,
                        device=None) -> ShardedDataset:
    """Epsilon-like dense data made on ``device`` (``cuda`` unless
    ``"cpu"`` is asked for) in the (K, n_shard, d) layout of
    ``shard_dataset``; nothing of it exists on the host.  Same
    distribution as the JAX package's ``synth_dense_sharded``: normal
    rows scaled to unit norm, labels sign(x . w*) with w* ~ N(0, 1/d)
    shared by all shards and ``flip`` label noise, padded rows zero with
    mask 0.  The draws are this port's own (``torch.Generator`` streams
    seeded from ``seed`` and the shard number), not those of JAX's
    ``jax.random``, so the two packages' arrays differ.  Deterministic in
    (n, d, k, seed, flip, dtype, device type)."""
    device = resolve_device(device)
    sizes = split_sizes(n, k)
    n_shard = int(sizes.max())

    def gen(stream: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + stream)

    w_star = torch.randn(d, generator=gen(0), device=device,
                         dtype=dtype) / np.sqrt(d)
    X = torch.empty(k, n_shard, d, dtype=dtype, device=device)
    labels = torch.zeros(k, n_shard, dtype=dtype, device=device)
    mask = torch.zeros_like(labels)
    sq = torch.zeros_like(labels)
    for s, m in enumerate(sizes.tolist()):
        g = gen(1 + s)
        xs = torch.randn(n_shard, d, generator=g, device=device, dtype=dtype)
        xs /= torch.linalg.vector_norm(xs, dim=1, keepdim=True)
        xs[m:] = 0
        y = torch.where(xs[:m] @ w_star >= 0, 1.0, -1.0).to(dtype)
        flips = torch.rand(m, generator=g, device=device) < flip
        labels[s, :m] = torch.where(flips, -y, y)
        mask[s, :m] = 1
        sq[s] = (xs * xs).sum(-1)
        X[s] = xs
    return ShardedDataset(
        layout="dense", n=n, num_features=d, counts=sizes.astype(np.int64),
        labels=labels, mask=mask, sq_norms=sq, X=X)


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
