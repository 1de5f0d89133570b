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
"""

from __future__ import annotations

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import shard_margins


def subgradient_pass(w: torch.Tensor, shards: dict, lam: float,
                     loss: str = "hinge",
                     smoothing: float = 1.0) -> torch.Tensor:
    """Each shard's dw (K, d): sum_i y_i*g(z_i)*x_i - lam*w.  Padded rows
    have label 0, so they add nothing."""
    losses.validate(loss, smoothing)
    labels = shards["labels"]
    coef = labels * losses.grad_factor(loss, labels * shard_margins(w, shards),
                                       smoothing=smoothing)
    if "X" in shards:
        dw = torch.matmul(coef[:, None, :], shards["X"])[:, 0]
    else:
        k = coef.shape[0]
        dw = torch.zeros(k, w.shape[0], dtype=w.dtype, device=w.device)
        dw.scatter_add_(1, shards["sp_indices"].reshape(k, -1).long(),
                        (shards["sp_values"] * coef[..., None]).reshape(k, -1))
        if "X_hot" in shards:
            # the hybrid panel as one product per shard, added at the hot
            # column ids (disjoint from the residual's)
            dw.scatter_add_(1, shards["hot_cols"].long(),
                            torch.matmul(coef[:, None, :],
                                         shards["X_hot"])[:, 0])
    return dw - lam * w
