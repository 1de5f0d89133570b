"""Local SDCA, the per-shard inner solver of CoCoA / CoCoA+ (counterpart of
cocoa_tpu/ops/local_sdca.py:48-233).

The H coordinate steps are sequential: step i+1 reads the w/dw that step
i wrote (CoCoA.scala:159,183-185).  The JAX package runs them as a
``fori_loop`` per shard and vmaps over the K shards; here one Python
loop over the H steps advances all K shards together, each op batched
over the leading K axis.

Modes:

- ``cocoa``: CoCoA; the margin reads the locally advancing w, qii = |x|^2;
- ``plus``: CoCoA+; w frozen, margin x.(w + sigma'*dw), qii = |x|^2*sigma';
- ``frozen``: mini-batch CD; w frozen, plain margin, qii = |x|^2.

Sampled indices arrive precomputed as ``idxs`` (K, H).
"""

from __future__ import annotations

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.rows import get_row, row_axpy, row_dot

MODES = ("cocoa", "plus", "frozen")


def coef_divisor(mode: str, lam_n: float) -> float:
    """The dw axpy coefficient is y*(a_new - a)/(lam*n) (CoCoA.scala:181)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return lam_n


def _coef_staging(mode: str, lam: float, n: int, dtype, device):
    """(lam_n, coef_of): lam*n as a 0-d tensor of the working dtype, and
    the coefficient as ``y * delta / coef_div`` -- a division, as the JAX
    static path writes it, not a multiply by a reciprocal."""
    lam_n = torch.tensor(lam * n, dtype=dtype, device=device)
    coef_div = torch.tensor(coef_divisor(mode, lam * n), dtype=dtype,
                            device=device)

    def coef_of(y, delta):
        return y * delta / coef_div
    return lam_n, coef_of


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return v.gather(1, idx[:, None])[:, 0]


def local_sdca(w_init: torch.Tensor, alpha: torch.Tensor, shards: dict,
               idxs: torch.Tensor, lam: float, n: int, mode: str = "cocoa",
               sigma: float = 1.0, loss: str = "hinge",
               smoothing: float = 1.0):
    """H sequential SDCA steps on each of the K shards, in the reference's
    operation order.  ``w_init`` (d,), ``alpha`` (K, n_shard), ``idxs``
    (K, H).  Returns (delta_alpha (K, n_shard), delta_w (K, d))."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    losses.validate(loss, smoothing)
    labels, sq_norms = shards["labels"], shards["sq_norms"]
    k, d = labels.shape[0], w_init.shape[0]
    dtype, device = w_init.dtype, w_init.device
    lam_n, coef_of = _coef_staging(mode, lam, n, dtype, device)
    sigma_c = torch.tensor(sigma, dtype=dtype, device=device)
    # CoCoA's local view of w advances with every step (CoCoA.scala:182-184)
    w = w_init.expand(k, d).clone() if mode == "cocoa" else w_init.expand(k, d)
    dw = torch.zeros(k, d, dtype=dtype, device=device)
    a_vec = alpha.clone()
    idxs = idxs.long()
    for i in range(idxs.shape[1]):
        idx = idxs[:, i]
        row = get_row(shards, idx)
        y = _gather(labels, idx)
        a = _gather(a_vec, idx)
        margin = row_dot(row, w)
        qii = _gather(sq_norms, idx)
        if mode == "plus":
            margin = margin + sigma_c * row_dot(row, dw)
            qii = qii * sigma_c
        new_a = losses.alpha_step(loss, a, y * margin, qii, lam_n,
                                  smoothing=smoothing)
        coef = coef_of(y, new_a - a)
        row_axpy(row, coef, dw)
        if mode == "cocoa":
            row_axpy(row, coef, w)
        a_vec.scatter_(1, idx[:, None], new_a[:, None])
    return a_vec - alpha, dw


def mode_factors(mode: str, sigma: float):
    """(sig_eff, qii_factor) of the margin decomposition
    x.w_step = x.w0 + sig_eff * x.dw:

    - cocoa: w_step = w0 + dw exactly, so (1, 1);
    - plus: the subproblem reads sigma'*dw, so (sigma', sigma');
    - frozen: no dw term, so (0, 1).
    """
    if mode == "cocoa":
        return 1.0, 1.0
    if mode == "plus":
        return sigma, sigma
    if mode == "frozen":
        return 0.0, 1.0
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def local_sdca_fast(margins0: torch.Tensor, alpha: torch.Tensor,
                    shards: dict, idxs: torch.Tensor, lam: float, n: int,
                    dw_init: torch.Tensor, mode: str = "cocoa",
                    sigma: float = 1.0, loss: str = "hinge",
                    smoothing: float = 1.0):
    """Fast-math counterpart of :func:`local_sdca`, over all K shards:
    margin = margins0[idx] + sig_eff * x.dw, with ``margins0`` = X.w0
    (K, n_shard) computed once per round.  Equal in real arithmetic,
    rounded in another order.  ``dw_init`` (K, d) zeros is advanced in
    place.  Returns (delta_alpha, delta_w)."""
    losses.validate(loss, smoothing)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    labels, sq_norms = shards["labels"], shards["sq_norms"]
    dtype, device = margins0.dtype, margins0.device
    lam_n, coef_of = _coef_staging(mode, lam, n, dtype, device)
    sig_c = torch.tensor(sig_eff, dtype=dtype, device=device)
    qf = torch.tensor(qii_factor, dtype=dtype, device=device)
    dw = dw_init
    a_vec = alpha.clone()
    idxs = idxs.long()
    for i in range(idxs.shape[1]):
        idx = idxs[:, i]
        row = get_row(shards, idx)
        y = _gather(labels, idx)
        a = _gather(a_vec, idx)
        margin = _gather(margins0, idx)
        if mode != "frozen":
            margin = margin + sig_c * row_dot(row, dw)
        qii = _gather(sq_norms, idx) * qf
        new_a = losses.alpha_step(loss, a, y * margin, qii, lam_n,
                                  smoothing=smoothing)
        row_axpy(row, coef_of(y, new_a - a), dw)
        a_vec.scatter_(1, idx[:, None], new_a[:, None])
    return a_vec - alpha, dw
