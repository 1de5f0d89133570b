"""Full subgradient pass over every shard, DistGD's inner step
(counterpart of cocoa_tpu/ops/subgradient.py; reference
DistGD.scala:67-102).

No sequential dependency: every example's subgradient is taken at the
same frozen w, so the pass is a masked matvec pair (margins X.w, then
X^T.coef) for all K shards at once.  The reference's off-by-one
(``0 to nLocal`` inclusive, DistGD.scala:82, reads one row past the
shard) is fixed here as in the JAX package (PARITY.md).  Each worker's
regulariser term -lam*w (DistGD.scala:98) is included, so the K-worker
sum subtracts K*lam*w as the reference's aggregate does.

On the sparse layout X^T.coef is a scatter in which many rows share a
column.  It adds each column's terms in slot order on every device
(ops/rows.py ``_scatter_add``: a sorted ``index_put`` on the card, where
``scatter_add_`` races atomics), so a run is bit-reproducible.
"""

from __future__ import annotations

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import _scatter_add, nonzero_slots, shard_margins


def subgradient_pass(w: torch.Tensor, shards: dict, lam: float,
                     loss: str = "hinge", smoothing: float = 1.0,
                     slots=None, fp_sum=None) -> torch.Tensor:
    """Each shard's dw (K, d): sum_i y_i*g(z_i)*x_i - lam*w.  Padded rows
    have label 0, so they add nothing.  On the sparse layout the scatter
    runs over ``slots`` (ops/rows.py ``nonzero_slots``, which reads the
    values on the host: a caller that captures the pass makes it once,
    outside the capture; None makes it here).  On a feature-parallel
    gang ``fp_sum`` sums the margins over the fp peers."""
    losses.validate(loss, smoothing)
    labels = shards["labels"]
    margins = shard_margins(w, shards)
    if fp_sum is not None:
        margins = fp_sum(margins)
    coef = labels * losses.grad_factor(loss, labels * margins,
                                       smoothing=smoothing)
    if "X" in shards:
        return torch.matmul(coef[:, None, :], shards["X"])[:, 0] - lam * w
    k, d = coef.shape[0], w.shape[0]
    rows, cols, vals = nonzero_slots(shards) if slots is None else slots
    # one scatter into the flattened (K*d) dw, at k*d + column
    idx = rows // coef.shape[1] * d + cols
    terms = coef.reshape(-1)[rows] * vals
    dw = _scatter_add(torch.zeros(k * d, dtype=w.dtype, device=w.device),
                      idx, terms).view(k, d)
    if "X_hot" in shards:
        # the hybrid panel as one product per shard, added at the hot
        # column ids (disjoint from the residual's)
        # torchlint: allow=scatter-order -- distinct hot columns
        dw.scatter_add_(1, shards["hot_cols"].long(),
                        torch.matmul(coef[:, None, :], shards["X_hot"])[:, 0])
    return dw - lam * w
