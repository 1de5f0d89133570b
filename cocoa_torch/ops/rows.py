"""Row access over the shard layouts (counterpart of cocoa_tpu/ops/rows.py,
dense and padded CSR).

The JAX package reads one row of one shard per step and vmaps over the K
shards; here every accessor works on all K shards at once: a step picks
one row index per shard, ``idx`` of shape (K,), and the d-vectors it
touches are (K, d).  Padded CSR slots carry index 0 / value 0, so they
add exactly 0 to every dot and axpy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Row(NamedTuple):
    """One row per shard, in whichever layout the shards use."""

    dense: Optional[torch.Tensor] = None   # (K, d)
    idx: Optional[torch.Tensor] = None     # (K, W) int64
    val: Optional[torch.Tensor] = None     # (K, W)


def get_row(shards: dict, idx: torch.Tensor) -> Row:
    """Row ``idx[k]`` of shard k for every k; ``idx`` is (K,) int64."""
    ks = torch.arange(idx.shape[0], device=idx.device)
    if "X" in shards:
        return Row(dense=shards["X"][ks, idx])
    return Row(idx=shards["sp_indices"][ks, idx].long(),
               val=shards["sp_values"][ks, idx])


def row_dot(row: Row, vec: torch.Tensor) -> torch.Tensor:
    """x_k . vec_k for every shard: (K,)."""
    if row.dense is not None:
        return (row.dense * vec).sum(-1)
    return (vec.gather(1, row.idx) * row.val).sum(-1)


def row_axpy(row: Row, coef: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """vec_k += coef_k * x_k, in place (``vec`` is loop-local state)."""
    if row.dense is not None:
        return vec.add_(coef[:, None] * row.dense)
    return vec.scatter_add_(1, row.idx, coef[:, None] * row.val)


def shard_margins(w: torch.Tensor, shards: dict) -> torch.Tensor:
    """x_i . w for every row of every shard: (K, n_shard)."""
    if "X" in shards:
        return shards["X"] @ w
    return (w[shards["sp_indices"].long()] * shards["sp_values"]).sum(-1)


def eval_margins(w: torch.Tensor, shards: dict) -> torch.Tensor:
    """The evaluation's margins.  The JAX package may read a dense eval
    twin here; the port has none, so this is :func:`shard_margins`."""
    return shard_margins(w, shards)
