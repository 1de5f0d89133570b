"""Local SGD / mini-batch SGD inner loop (counterpart of
cocoa_tpu/ops/local_sgd.py; reference SGD.scala:87-139), over all K
shards at once.

- ``local=True`` (Local SGD): H Pegasos steps on a private copy of w; per
  step w *= (1 - eta*lam) with eta = 1/(lam*(t_global + i)) (SGD.scala:
  106,117-121), then w += eta*y*g*x (:124-129); the update is
  dw = w - w_init (:132-134).
- ``local=False`` (mini-batch SGD): w stays frozen; the worker sums
  y*g*x over the H draws (:124-127); eta is applied by the driver.

g is the loss's -l'(z) factor (ops/losses.py ``grad_factor``; hinge: the
reference's 0/1 active indicator).
"""

from __future__ import annotations

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import get_row, row_axpy, row_dot


def local_sgd(w_init: torch.Tensor, shards: dict, idxs: torch.Tensor,
              lam: float, t_global, local: bool, loss: str = "hinge",
              smoothing: float = 1.0, fp_sum=None) -> torch.Tensor:
    """H SGD steps on each of the K shards from the shared ``w_init``
    (d,); ``idxs`` (K, H), ``t_global`` = (t-1)*H*K (SGD.scala:53).
    On a feature-parallel gang ``fp_sum`` sums each step's margin over
    the fp peers (ops/local_sdca.py).  Returns each shard's dw (K, d)."""
    losses.validate(loss, smoothing)
    labels = shards["labels"]
    k, d = idxs.shape[0], w_init.shape[0]
    dtype, device = w_init.dtype, w_init.device
    lam_c = torch.full((), lam, dtype=dtype, device=device)
    t0 = torch.as_tensor(t_global, dtype=dtype, device=device)
    w = w_init.expand(k, d)  # local steps rebind w before writing it
    dw = torch.zeros(k, d, dtype=dtype, device=device)
    idxs = idxs.long()
    for i in range(idxs.shape[1]):
        # the reference counts steps from 1 (SGD.scala:104-106)
        eta = 1.0 / (lam_c * (t0 + i + 1))
        idx = idxs[:, i]
        row = get_row(shards, idx)
        y = labels.gather(1, idx[:, None])[:, 0]
        z = row_dot(row, w)
        if fp_sum is not None:
            z = fp_sum(z)
        g = losses.grad_factor(loss, y * z, smoothing=smoothing)
        if local:
            w = w * (1.0 - eta * lam_c)
            row_axpy(row, y * eta * g, w)
        else:
            row_axpy(row, y * g, dw)
    return w - w_init if local else dw
