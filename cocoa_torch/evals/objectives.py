"""Objectives and the duality-gap certificate (counterpart of
cocoa_tpu/evals/objectives.py; math from OptUtils.scala:57-98).

- primal objective   mean loss + (lam/2)|w|^2
- dual objective     -(lam/2)|w|^2 + sum(dual_term(alpha))/n
- duality gap        primal - dual
- test error         mean over examples of [y*(x.w) <= 0]

Padded rows are excluded by the mask.  :func:`eval_metrics` computes the
three numbers on the device with no host sync (the chunked loop's eval
and the device loop's, in its captured chunks); :func:`fetch_metrics`
fetches them to the host in one transfer.  With ``alpha`` None (the primal-only
SGD and DistGD baselines) there is no dual objective and no gap.
:func:`primal_objective`, :func:`dual_objective` and
:func:`classification_error` give the end-of-run summary as the JAX CLI's
``finish`` does: each device sum fetched on its own and combined on the
host in float64.
"""

from __future__ import annotations

import math

import torch

from cocoa_torch.data.sharding import ShardedDataset
from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import eval_margins
from cocoa_torch.parallel.fanout import all_reduce_sum


def eval_metrics(w, alpha, shard_arrays, lam, n, test_shard_arrays=None,
                 test_n: int = 0, loss: str = "hinge",
                 smoothing: float = 1.0, mesh=None) -> torch.Tensor:
    """(primal, gap, test_error) as one (3,) tensor on w's device, with no
    host sync; test_error is NaN without a test set, gap NaN without
    ``alpha``.  In a gang (``mesh``) the shard sums -- the loss sum, the
    dual sum and the test errors -- cross the ranks packed in ONE
    all-reduce; w.w and every other term of the replicated w are this
    rank's own, never summed across ranks."""
    w_norm_sq = w @ w
    mask = shard_arrays["mask"]
    z = shard_arrays["labels"] * eval_margins(w, shard_arrays)
    sums = [(losses.primal(loss, z, smoothing=smoothing) * mask).sum()]
    if alpha is not None:
        sums.append((losses.dual_term(loss, alpha, smoothing=smoothing)
                     * mask).sum())
    if test_shard_arrays is not None:
        wrong = (eval_margins(w, test_shard_arrays)
                 * test_shard_arrays["labels"]) <= 0.0
        sums.append((wrong.to(w.dtype) * test_shard_arrays["mask"]).sum())
    if mesh is not None:
        sums = list(all_reduce_sum(torch.stack(sums), mesh))
    loss_sum = sums.pop(0)
    primal = loss_sum / n + 0.5 * lam * w_norm_sq
    if alpha is None:
        gap = torch.full_like(primal, math.nan)
    else:
        dual_sum = sums.pop(0)
        gap = primal - (-0.5 * lam * w_norm_sq + dual_sum / n)
    if test_shard_arrays is not None:
        test_err = sums.pop(0) / test_n
    else:
        test_err = torch.full_like(primal, math.nan)
    return torch.stack([primal, gap, test_err])


def fetch_metrics(metrics: torch.Tensor):
    """(primal, gap or None, test_error or None) from a (3,) metrics
    tensor, with one device-to-host fetch; NaN means there is none."""
    primal, gap, test_err = metrics.cpu().tolist()
    return (primal, None if math.isnan(gap) else gap,
            None if math.isnan(test_err) else test_err)


def evaluate(ds: ShardedDataset, w, alpha, lam, test_ds=None,
             loss: str = "hinge", smoothing: float = 1.0):
    """(primal, gap or None, test_error or None) with one device-to-host
    fetch; ``alpha`` None gives no gap."""
    return fetch_metrics(eval_metrics(
        w, alpha, ds.shard_arrays(), lam, ds.n,
        test_shard_arrays=None if test_ds is None else test_ds.shard_arrays(),
        test_n=0 if test_ds is None else test_ds.n,
        loss=loss, smoothing=smoothing, mesh=ds.mesh))



def _sum_dtype(dtype):
    """The dtype a device sum accumulates in: float32 for a 2-byte dtype,
    whose products and sums XLA on the CPU keeps in float32 and rounds
    once at the end, else the dtype itself."""
    return torch.float32 if dtype.itemsize < 4 else dtype


def _shard_sum(per_row, mask, mesh=None) -> float:
    """The masked per-row values summed shard by shard, each sum rounded
    to their dtype, then the K shard sums, as the JAX package's fan-out
    sums them: in a gang (``mesh``) this rank's shard sums, then one
    all-reduce across the ranks."""
    acc = _sum_dtype(per_row.dtype)
    parts = (per_row.to(acc) * mask.to(acc)).sum(-1).to(per_row.dtype)
    total = all_reduce_sum(parts.to(acc).sum(), mesh)
    return float(total.to(per_row.dtype))


def _summary_margins(w, shards):
    """x.w of every row, the products summed unrounded in
    :func:`_sum_dtype` and rounded once to w's dtype."""
    acc = _sum_dtype(w.dtype)
    wide = {name: t.to(acc) if t.is_floating_point() else t
            for name, t in shards.items()}
    return eval_margins(w.to(acc), wide).to(w.dtype)


def primal_objective(ds: ShardedDataset, w, lam, loss: str = "hinge",
                     smoothing: float = 1.0) -> float:
    """The primal objective from the device's loss sum and w.w, combined
    on the host in float64 (cocoa_tpu/evals/objectives.py
    ``primal_objective``)."""
    shards = ds.shard_arrays()
    z = shards["labels"] * _summary_margins(w, shards)
    loss_sum = _shard_sum(losses.primal(loss, z, smoothing=smoothing),
                          shards["mask"], ds.mesh)
    return loss_sum / ds.n + 0.5 * lam * float(w @ w)


def dual_objective(ds: ShardedDataset, w, alpha, lam, loss: str = "hinge",
                   smoothing: float = 1.0) -> float:
    """The dual objective from the device's dual-term sum and w.w,
    combined on the host in float64 (cocoa_tpu/evals/objectives.py
    ``dual_objective``); ``alpha`` (K, n_shard)."""
    dual_sum = _shard_sum(losses.dual_term(loss, alpha, smoothing=smoothing),
                          ds.shard_arrays()["mask"], ds.mesh)
    return -0.5 * lam * float(w @ w) + dual_sum / ds.n


def classification_error(ds: ShardedDataset, w) -> float:
    """The share of rows with y * (x.w) <= 0: the device's count over n on
    the host (cocoa_tpu/evals/objectives.py ``classification_error``)."""
    shards = ds.shard_arrays()
    wrong = (_summary_margins(w, shards) * shards["labels"]) <= 0.0
    return _shard_sum(wrong.to(w.dtype), shards["mask"], ds.mesh) / ds.n
