"""Local SDCA, the per-shard inner solver of CoCoA / CoCoA+ (counterpart of
cocoa_tpu/ops/local_sdca.py), and its block-coordinate forms
(``--blockSize``: :func:`local_sdca_block`, :func:`local_sdca_block_batched`).

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
from cocoa_torch.ops.block_chain import chain_block_batched, fp32_matmul, \
    fused_block
from cocoa_torch.ops.rows import get_row, row_axpy, row_dot, row_lengths
from cocoa_torch.ops.sparse_block import sparse_block_apply, \
    sparse_block_gram

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


def _pad_blocks(idxs: torch.Tensor, block: int):
    """(K, H) draws padded with index 0 to whole blocks: (idxs (K, nb*B)
    int64, live (nb*B,) bool), live False on the padded steps."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    h = idxs.shape[1]
    nb = -(-h // block)
    padded = torch.nn.functional.pad(idxs.long(), (0, nb * block - h))
    return padded, torch.arange(nb * block, device=idxs.device) < h


def dense_rows(shards: dict, bidx: torch.Tensor, d: int) -> torch.Tensor:
    """(K, B, d) dense tile of rows ``bidx`` (K, B) of every shard; sparse
    rows are scattered into zeros (padded slots add 0 at column 0, a
    repeated column sums)."""
    ks = torch.arange(bidx.shape[0], device=bidx.device)[:, None]
    if "X" in shards:
        return shards["X"][ks, bidx]
    vals = shards["sp_values"][ks, bidx]
    return torch.zeros(*bidx.shape, d, dtype=vals.dtype,
                       device=vals.device).scatter_add_(
        2, shards["sp_indices"][ks, bidx].long(), vals)


def local_sdca_block(margins0: torch.Tensor, alpha: torch.Tensor,
                     shards: dict, idxs: torch.Tensor, lam: float, n: int,
                     dw_init: torch.Tensor, mode: str = "cocoa",
                     sigma: float = 1.0, loss: str = "hinge",
                     smoothing: float = 1.0, block: int = 16):
    """Block-coordinate form of :func:`local_sdca_fast`, over all K shards
    (counterpart of cocoa_tpu/ops/local_sdca.py ``local_sdca_block``, the
    portable form): the H draws run in blocks of B; per block the rows are
    densified into a (K, B, d) tile, its Delta-w margins and Gram are two
    products, the B steps are a scalar loop whose margin reads

        margins0[idx_j] + sig_eff * ((X_B dw)[j] + sum_i coef_i G[i, j])

    and Delta-w advances once by coef . X_B.  Equal in real arithmetic to
    the sequential loop; repeated draws read alpha through the shard
    vector.  H is padded to whole blocks with masked steps.  Returns
    (delta_alpha (K, n_shard), delta_w (K, d))."""
    losses.validate(loss, smoothing)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    labels, sq_norms = shards["labels"], shards["sq_norms"]
    dtype, device = margins0.dtype, margins0.device
    lam_n, coef_of = _coef_staging(mode, lam, n, dtype, device)
    sig_c = torch.tensor(sig_eff, dtype=dtype, device=device)
    d = dw_init.shape[1]
    padded, live = _pad_blocks(idxs, block)
    dw = dw_init
    a_vec = alpha.clone()
    for start in range(0, padded.shape[1], block):
        bidx = padded[:, start:start + block]
        xb = dense_rows(shards, bidx, d)
        yb = labels.gather(1, bidx)
        m0b = margins0.gather(1, bidx)
        qb = sq_norms.gather(1, bidx) * qii_factor
        if mode != "frozen":
            mb = torch.matmul(xb, dw[:, :, None])[..., 0]
            gram = torch.matmul(xb, xb.transpose(1, 2))
        coefs = torch.zeros_like(yb)
        for j in range(block):
            if not live[start + j]:
                continue  # a masked step: coef 0, alpha unchanged
            idx = bidx[:, j:j + 1]
            a = a_vec.gather(1, idx)[:, 0]
            margin = m0b[:, j]
            if mode != "frozen":
                margin = margin + sig_c * (
                    mb[:, j] + (coefs * gram[:, :, j]).sum(-1))
            new_a = losses.alpha_step(loss, a, yb[:, j] * margin, qb[:, j],
                                      lam_n, smoothing=smoothing)
            coefs[:, j] = coef_of(yb[:, j], new_a - a)
            a_vec.scatter_(1, idx, new_a[:, None])
        dw = dw + torch.matmul(coefs[:, None, :], xb)[:, 0]
    return a_vec - alpha, dw


BLOCK_ROUTES = ("fused", "split", "sparse_gram")


def local_sdca_block_batched(w: torch.Tensor, alpha: torch.Tensor,
                             shards: dict, idxs_kh: torch.Tensor, lam: float,
                             n: int, mode: str = "cocoa", sigma: float = 1.0,
                             loss: str = "hinge", smoothing: float = 1.0,
                             block: int = 128, route: str = "split"):
    """The block-coordinate round for all K shards on one device
    (counterpart of cocoa_tpu/ops/local_sdca.py
    ``local_sdca_block_batched``), the ``--blockSize`` path.  Only the
    sampled rows' margins are computed, from the rows each block gathers.
    ``route`` picks the branch (solvers/cocoa.py ``block_route``):

    - ``"fused"``: the gathered (K, B, d) tile goes to the fused kernel
      (ops/block_chain.py ``fused_block``: margins, Gram, chain and the
      Delta-w increment in one launch);
    - ``"split"``: margins and Gram as batched products in full float32
      (no TF32), then the chain kernel, then Delta-w += coef . X_B;
    - ``"sparse_gram"``: padded-CSR rows only; the Gram and margin base
      come from the rows' slots (ops/sparse_block.py), then the chain,
      then the sparse apply.  No (K, B, d) tile.

    The row gathers, the alpha gathers and scatter-adds and the (K, d)
    adds are plain tensor ops; every branch scatter-adds its alpha deltas
    once per block.  Returns (delta_alpha (K, n_shard), delta_w (K, d))."""
    if route not in BLOCK_ROUTES:
        raise ValueError(f"route must be one of {BLOCK_ROUTES}, got {route!r}")
    if route == "sparse_gram" and "sp_indices" not in shards:
        raise ValueError("the sparse_gram route needs the padded-CSR "
                         "(sparse) layout")
    losses.validate(loss, smoothing)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    frozen = mode == "frozen"
    chain_kw = dict(lam_n=lam * n, coef_div=coef_divisor(mode, lam * n),
                    sig_eff=sig_eff, frozen=frozen, loss=loss,
                    smoothing=smoothing)
    k, d = alpha.shape[0], w.shape[0]
    dtype = w.dtype
    labels = shards["labels"]
    q_all = shards["sq_norms"] * qii_factor
    padded, live_all = _pad_blocks(idxs_kh, block)
    dw = torch.zeros(k, d, dtype=dtype, device=w.device)
    a_vec = alpha.clone()
    if route == "sparse_gram":
        row_len = shards.get("sp_row_len")
        if row_len is None:
            row_len = row_lengths(shards["sp_values"])
    ks = torch.arange(k, device=w.device)[:, None]
    for start in range(0, padded.shape[1], block):
        bidx = padded[:, start:start + block]
        bidx32 = bidx.to(torch.int32)
        live_b = live_all[start:start + block]
        live = live_b.to(dtype).expand(k, block).contiguous()
        yb = labels.gather(1, bidx)
        qb = q_all.gather(1, bidx)
        zeros = torch.zeros_like(yb)
        if route == "sparse_gram":
            gidx = shards["sp_indices"][ks, bidx]
            gvals = shards["sp_values"][ks, bidx]
            cnts = torch.where(live_b, row_len.gather(1, bidx),
                               -1).to(torch.int32)
            gram, mbase = sparse_block_gram(w, dw, gidx, gvals, cnts,
                                            sig_eff, frozen)
            scal = torch.stack([mbase, yb, qb, a_vec.gather(1, bidx), zeros,
                                live], dim=1)
            delta, coefs = chain_block_batched(scal, gram, bidx32, **chain_kw)
            a_vec.scatter_add_(1, bidx, delta)
            sparse_block_apply(dw, gidx, gvals, cnts, coefs)
            continue
        xb = dense_rows(shards, bidx, d)
        if route == "fused":
            v = w.expand(k, d).contiguous() if frozen else w + sig_eff * dw
            delta, dwu = fused_block(xb, bidx32, yb, qb,
                                     a_vec.gather(1, bidx), live, v,
                                     **chain_kw)
            dw = dw + dwu
            a_vec.scatter_add_(1, bidx, delta)
            continue
        with fp32_matmul():
            if frozen:
                mbase, gram = torch.matmul(xb, w), None
            else:
                mbase = torch.matmul(xb, (w + sig_eff * dw)[:, :, None])[..., 0]
                gram = torch.matmul(xb, xb.transpose(1, 2))
        scal = torch.stack([mbase, yb, qb, a_vec.gather(1, bidx), zeros,
                            live], dim=1)
        delta, coefs = chain_block_batched(scal, gram, bidx32, **chain_kw)
        a_vec.scatter_add_(1, bidx, delta)
        with fp32_matmul():
            dw = dw + torch.matmul(coefs[:, None, :], xb)[:, 0]
    return a_vec - alpha, dw
