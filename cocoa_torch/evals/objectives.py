"""Objectives and the duality-gap certificate (counterpart of
cocoa_tpu/evals/objectives.py; math from OptUtils.scala:57-98).

- primal objective   mean loss + (lam/2)|w|^2
- dual objective     -(lam/2)|w|^2 + sum(dual_term(alpha))/n
- duality gap        primal - dual
- test error         mean over examples of [y*(x.w) <= 0]

Padded rows are excluded by the mask.  :func:`evaluate` fetches the three
numbers to the host in one transfer.  With ``alpha`` None (the primal-only
SGD and DistGD baselines) there is no dual objective and no gap.
"""

from __future__ import annotations

import math

import torch

from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import eval_margins


def eval_metrics(w, alpha, shard_arrays, lam, n, test_shard_arrays=None,
                 test_n: int = 0, loss: str = "hinge",
                 smoothing: float = 1.0) -> torch.Tensor:
    """(primal, gap, test_error) as one (3,) tensor on w's device, with no
    host sync; test_error is NaN without a test set, gap NaN without
    ``alpha``."""
    w_norm_sq = w @ w
    mask = shard_arrays["mask"]
    z = shard_arrays["labels"] * eval_margins(w, shard_arrays)
    loss_sum = (losses.primal(loss, z, smoothing=smoothing) * mask).sum()
    primal = loss_sum / n + 0.5 * lam * w_norm_sq
    if alpha is None:
        gap = torch.full_like(primal, math.nan)
    else:
        dual_sum = (losses.dual_term(loss, alpha, smoothing=smoothing)
                    * mask).sum()
        gap = primal - (-0.5 * lam * w_norm_sq + dual_sum / n)
    if test_shard_arrays is not None:
        wrong = (eval_margins(w, test_shard_arrays)
                 * test_shard_arrays["labels"]) <= 0.0
        test_err = (wrong.to(w.dtype) * test_shard_arrays["mask"]).sum() \
            / test_n
    else:
        test_err = torch.full_like(primal, math.nan)
    return torch.stack([primal, gap, test_err])


def evaluate(ds: ShardedDataset, w, alpha, lam, test_ds=None,
             loss: str = "hinge", smoothing: float = 1.0):
    """(primal, gap or None, test_error or None) with one device-to-host
    fetch; ``alpha`` None gives no gap."""
    out = eval_metrics(
        w, alpha, ds.shard_arrays(), lam, ds.n,
        test_shard_arrays=None if test_ds is None else test_ds.shard_arrays(),
        test_n=0 if test_ds is None else test_ds.n,
        loss=loss, smoothing=smoothing,
    ).cpu().tolist()
    primal, gap, test_err = out
    return (primal, None if math.isnan(gap) else gap,
            None if math.isnan(test_err) else test_err)

