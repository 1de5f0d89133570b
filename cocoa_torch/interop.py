"""Numpy in, tensors out: feed the port the JAX package's state.

This system has no model weights.  Its parameters are the primal-dual
state (w, alpha) and the sharded data, so these two functions turn numpy
arrays -- for example ``np.asarray`` of the JAX package's
``ShardedDataset.shard_arrays()``, w and alpha -- into the port's tensors,
so that both packages can be run on identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.device import resolve_device


def state_from_numpy(w, alpha, device=None, dtype=torch.float64):
    """(w (d,), alpha (K, n_shard)) as tensors of ``dtype`` on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; raises without CUDA)."""
    device = resolve_device(device)
    def put(a):
        return torch.tensor(np.asarray(a)).to(device=device, dtype=dtype)
    return put(w), put(alpha)


def dataset_from_numpy(arrays: dict, layout: str, n: int, d: int,
                       device=None) -> ShardedDataset:
    """A :class:`ShardedDataset` from per-shard arrays: ``labels``,
    ``mask``, ``sq_norms`` (K, n_shard) and ``X`` (K, n_shard, d) or
    ``sp_indices``/``sp_values`` (K, n_shard, W), with ``X_hot``
    (K, n_shard, n_hot) and ``hot_cols`` (K, n_hot) for the hybrid
    layout.  The float arrays keep
    their dtype; the real-row counts come from the mask.  Padded shapes are
    kept as given: padded rows and slots are inert.  ``device`` is
    ``cuda`` unless ``"cpu"`` is asked for."""
    device = resolve_device(device)
    if layout not in ("dense", "sparse"):
        raise ValueError(f"layout must be dense or sparse, got {layout!r}")
    if ("X_hot" in arrays) != ("hot_cols" in arrays) or (
            "X_hot" in arrays and layout != "sparse"):
        raise ValueError("X_hot and hot_cols come together, on the sparse "
                         "layout")
    t = {name: torch.tensor(np.asarray(a)).to(device)
         for name, a in arrays.items()}
    mask = np.asarray(arrays["mask"])
    return ShardedDataset(
        layout=layout, n=n, num_features=d,
        counts=(mask != 0).sum(axis=1).astype(np.int64),
        labels=t["labels"], mask=t["mask"], sq_norms=t["sq_norms"],
        X=t["X"] if layout == "dense" else None,
        sp_indices=(t["sp_indices"].to(torch.int32)
                    if layout == "sparse" else None),
        sp_values=t["sp_values"] if layout == "sparse" else None,
        X_hot=t.get("X_hot"),
        hot_cols=(t["hot_cols"].to(torch.int32) if "hot_cols" in t
                  else None),
    )
