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
- ``frozen``: mini-batch CD; w frozen, plain margin, qii = |x|^2;
- ``prox``: ProxCoCoA+ coordinate descent; the shard's "rows" are columns
  a_j of the design, w is the residual r0 = Ax - b, alpha the shard's
  block of x; margins read like ``plus`` and feed a prox rule (``lasso``),
  and the dw coefficient is the raw coordinate delta (divisor 1).

Sampled indices arrive precomputed as ``idxs`` (K, H).
"""

from __future__ import annotations

from typing import Optional

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.block_chain import chain_block_batched, \
    chain_block_batched_plain, fp32_matmul, fused_block, fused_block_plain
from cocoa_torch.ops.rows import gather_rows, get_row, row_axpy, row_dot, \
    row_lengths
from cocoa_torch.ops.sparse_block import sparse_block_apply, \
    sparse_block_apply_plain, sparse_block_gram, sparse_block_gram_plain

MODES = ("cocoa", "plus", "frozen", "prox")


def coef_divisor(mode: str, lam_n: float) -> float:
    """The dw axpy coefficient is y*(a_new - a)/(lam*n) for the dual-ascent
    modes (CoCoA.scala:181) and the raw coordinate delta for ``prox``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return 1.0 if mode == "prox" else lam_n


def _coef_staging(mode: str, lam: float, n: int, dtype, device,
                  lam_n=None):
    """(lam_n, coef_of): lam*n as a 0-d tensor of the working dtype, and
    the coefficient as ``y * delta / coef_div`` -- a division, as the JAX
    static path writes it, not a multiply by a reciprocal.  The scalars
    here and in every round are filled on the device, never copied from
    the host, so a captured chunk of rounds replays them.

    ``lam_n`` given (a tensor, one value per shard row of the batch: the
    fleet's per-tenant lambda*n, counterpart of the JAX package's traced
    ``lam_n``) replaces lam*n; it holds the values this function would
    fill, float(lam)*n rounded once to the dtype, so each row divides by
    the same number as a solo run's."""
    if lam_n is None:
        lam_n = torch.full((), lam * n, dtype=dtype, device=device)
        coef_div = torch.full((), coef_divisor(mode, lam * n), dtype=dtype,
                              device=device)
    else:
        coef_div = torch.ones_like(lam_n) if mode == "prox" else lam_n

    def coef_of(y, delta):
        return y * delta / coef_div
    return lam_n, coef_of


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return v.gather(1, idx[:, None])[:, 0]


def _scalar(v, dtype, device) -> torch.Tensor:
    """A float as a 0-d tensor of the working dtype, or a tensor (a
    fleet's per-row sigma') as it is."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=dtype, device=device)


def local_sdca(w_init: torch.Tensor, alpha: torch.Tensor, shards: dict,
               idxs: torch.Tensor, lam: float, n: int, mode: str = "cocoa",
               sigma=1.0, loss: str = "hinge",
               smoothing: float = 1.0, lam_n=None):
    """H sequential SDCA steps on each of the K shards, in the reference's
    operation order.  ``w_init`` (d,), or (K, d) one w per shard row (a
    fleet's tenants, each expanded to its K shards), ``alpha``
    (K, n_shard), ``idxs`` (K, H).  ``lam_n`` and ``sigma`` may be
    tensors of shape (K,), a value per shard row (see
    :func:`_coef_staging`), in place of lam*n and a float sigma'.
    Returns (delta_alpha (K, n_shard), delta_w (K, d))."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    losses.validate(loss, smoothing)
    labels, sq_norms = shards["labels"], shards["sq_norms"]
    k, d = labels.shape[0], w_init.shape[-1]
    dtype, device = w_init.dtype, w_init.device
    lam_n, coef_of = _coef_staging(mode, lam, n, dtype, device, lam_n)
    sigma_c = _scalar(sigma, dtype, device)
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
        if mode in ("plus", "prox"):
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
    - frozen: no dw term, so (0, 1);
    - prox: the read structure of plus, so (sigma', sigma').
    """
    if mode == "cocoa":
        return 1.0, 1.0
    if mode in ("plus", "prox"):
        return sigma, sigma
    if mode == "frozen":
        return 0.0, 1.0
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def local_sdca_fast(margins0: torch.Tensor, alpha: torch.Tensor,
                    shards: dict, idxs: torch.Tensor, lam: float, n: int,
                    dw_init: torch.Tensor, mode: str = "cocoa",
                    sigma=1.0, loss: str = "hinge",
                    smoothing: float = 1.0, lam_n=None):
    """Fast-math counterpart of :func:`local_sdca`, over all K shards:
    margin = margins0[idx] + sig_eff * x.dw, with ``margins0`` = X.w0
    (K, n_shard) computed once per round.  Equal in real arithmetic,
    rounded in another order.  ``dw_init`` (K, d) zeros is advanced in
    place; ``lam_n`` and ``sigma`` as in :func:`local_sdca`.  Returns
    (delta_alpha, delta_w)."""
    losses.validate(loss, smoothing)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    labels, sq_norms = shards["labels"], shards["sq_norms"]
    dtype, device = margins0.dtype, margins0.device
    lam_n, coef_of = _coef_staging(mode, lam, n, dtype, device, lam_n)
    sig_c = _scalar(sig_eff, dtype, device)
    qf = _scalar(qii_factor, dtype, device)
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


def dense_rows(shards: dict, bidx: torch.Tensor, d: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(K, B, d) dense tile of rows ``bidx`` (K, B) of every shard, into
    ``out`` when given (the pipelined block round's buffers).  Dense rows
    are one ``index_select`` over the (K*n_shard, d) rows; sparse rows
    are scattered into zeros (padded slots add 0 at column 0, a repeated
    column sums), and a hybrid row's panel slice is added at the hot
    column ids, which no residual slot holds."""
    ks = torch.arange(bidx.shape[0], device=bidx.device)[:, None]
    if "X" in shards:
        x = shards["X"]
        flat = (bidx + x.shape[1] * ks).reshape(-1)
        rows = x.reshape(-1, x.shape[-1])
        if out is None:
            return rows.index_select(0, flat).view(*bidx.shape, -1)
        torch.index_select(rows, 0, flat, out=out.view(-1, out.shape[-1]))
        return out
    vals = shards["sp_values"][ks, bidx]
    tile = (torch.zeros(*bidx.shape, d, dtype=vals.dtype, device=vals.device)
            if out is None else out.zero_())
    tile.scatter_add_(2, shards["sp_indices"][ks, bidx].long(), vals)
    if "X_hot" in shards:
        cols = shards["hot_cols"].long()[:, None, :].expand(
            *bidx.shape, -1)
        tile.scatter_add_(2, cols, gather_rows(shards["X_hot"], bidx))
    return tile


class _TilePipeline:
    """The pipelined block round's row tiles (counterpart of the JAX
    package's ``pipelined_scan``, cocoa_tpu/ops/local_sdca.py:628-660):
    block b+1's (K, B, d) tile is gathered while block b's kernel runs,
    into one of two buffers allocated once, before the block loop, on the
    stream that runs the round.  The round takes block b's tile with
    :meth:`tile` and calls :meth:`prefetch` for block b+1 just before
    block b's kernel: the fused kernel, or on the split route the chain
    kernel, after the margin and Gram products, so that the gather meets
    the kernel and not the products.

    On the card the gathers run on a side stream forked from the current
    stream (inside a capture, the capture stream: the graph then holds
    the gathers as a parallel branch).  Events order the work both ways:
    before gathering block b+1 the side stream waits for everything the
    round stream has queued, block b-1's last read of that buffer
    included; before block b+1's work the round stream waits for that
    gather.  The last block's wait joins the side stream back into the
    round stream before the round returns, as a capture's end requires.
    On the CPU there is no second stream: the gather of block b+1 simply
    runs before block b's kernel.  Each kernel reads a tile gathered from
    the same indices by the same gather as the serial schedule, so the
    two schedules are bit for bit the same."""

    def __init__(self, shards: dict, padded: torch.Tensor, block: int,
                 d: int, dtype):
        self.shards, self.padded, self.block, self.d = shards, padded, \
            block, d
        self.nb = padded.shape[1] // block
        shape = (padded.shape[0], block, d)
        self.bufs = [torch.empty(shape, dtype=dtype, device=padded.device)
                     for _ in range(min(2, self.nb))]
        # one block has nothing to prefetch: no side stream to fork
        self.side = _side_stream(padded.device) if self.nb > 1 else None
        self._gather(0)

    def _gather(self, b: int) -> None:
        start = b * self.block
        dense_rows(self.shards, self.padded[:, start:start + self.block],
                   self.d, out=self.bufs[b % 2])

    def tile(self, b: int) -> torch.Tensor:
        """Block b's tile, once its gather (queued at block b-1) is done."""
        if self.side is not None and b > 0:
            torch.cuda.current_stream(self.padded.device).wait_stream(
                self.side)
        return self.bufs[b % 2]

    def prefetch(self, b: int) -> None:
        """Queue block b's gather (nothing past the last block)."""
        if b >= self.nb:
            return
        if self.side is None:
            self._gather(b)
            return
        # the buffer's last reader, block b-2's work, is queued
        self.side.wait_stream(torch.cuda.current_stream(self.padded.device))
        with torch.cuda.stream(self.side):
            self._gather(b)


def _side_stream(device: torch.device):
    """A side stream of PyTorch's pool on ``device`` for the pipeline's
    gathers (None on the CPU), never the stream that runs the round."""
    if device.type != "cuda":
        return None
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    while side == current:
        side = torch.cuda.Stream(device)
    return side


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
    sig_c = torch.full((), sig_eff, dtype=dtype, device=device)
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


def _block_alpha_add(a_vec: torch.Tensor, bidx: torch.Tensor,
                     delta: torch.Tensor) -> None:
    """a_vec[k, bidx[k, j]] += delta[k, j] in place, in an order that does
    not depend on the scheduling: each slot's total is the block's deltas
    of the slots that drew its row, summed through a (K, B, B)
    index-equality mask in one fixed order, and alpha + total is written
    to every slot of the row by ``scatter_``, each with the same value.
    ``scatter_add_`` would add a row drawn twice in a block with atomics
    on the card, in no fixed order.  A row drawn once gets alpha + delta,
    as before."""
    eq = (bidx[:, :, None] == bidx[:, None, :]).to(delta.dtype)
    total = (eq * delta[:, None, :]).sum(-1)
    a_vec.scatter_(1, bidx, a_vec.gather(1, bidx) + total)


def local_sdca_block_batched(w: torch.Tensor, alpha: torch.Tensor,
                             shards: dict, idxs_kh: torch.Tensor, lam: float,
                             n: int, mode: str = "cocoa", sigma: float = 1.0,
                             loss: str = "hinge", smoothing: float = 1.0,
                             block: int = 128, route: str = "split",
                             plain: bool = False,
                             pipeline: Optional[bool] = None):
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
      then the sparse apply.  No (K, B, d) tile.  On the hybrid layout
      (``X_hot``/``hot_cols`` in ``shards``) the slots are the cold
      residual, and each block adds the panel's terms as products in
      full float32: the margin base against w + sig_eff * Delta-w at the
      hot columns, the panel Gram, and coef . panel into a separate
      (K, n_hot) Delta-w_hot, added into Delta-w at the hot columns after
      the round (hot and cold columns are disjoint, so each sum splits
      exactly).

    ``pipeline`` (``--blockPipeline``; None: on when the round spans more
    than one block) gathers block b+1's row tile while block b's kernel
    runs, on the fused and split routes (:class:`_TilePipeline`), bit for
    bit the serial schedule; the ``sparse_gram`` route gathers no tile
    and ignores it, as in the JAX package.

    The row gathers, the alpha gathers and scatters and the (K, d) adds
    are plain tensor ops; every branch adds its alpha deltas once
    per block, in an order fixed by the block (:func:`_block_alpha_add`).
    ``plain`` calls the kernels' plain versions on every device (the
    solvers' rule for 2-byte dtypes, which the kernels refuse).  Returns
    (delta_alpha (K, n_shard), delta_w (K, d))."""
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
    hybrid = route == "sparse_gram" and "X_hot" in shards
    if route == "sparse_gram":
        row_len = shards.get("sp_row_len")
        if row_len is None:
            row_len = row_lengths(shards["sp_values"])
    if hybrid:
        hot_cols = shards["hot_cols"].long()                  # (K, n_hot)
        w_hot = w[hot_cols]
        dw_hot = torch.zeros_like(w_hot)
    if plain:
        gram_fn, chain_fn, apply_fn, fused_fn = (
            sparse_block_gram_plain, chain_block_batched_plain,
            sparse_block_apply_plain, fused_block_plain)
    else:
        gram_fn, chain_fn, apply_fn, fused_fn = (
            sparse_block_gram, chain_block_batched, sparse_block_apply,
            fused_block)
    ks = torch.arange(k, device=w.device)[:, None]
    tiles = None
    if route != "sparse_gram":
        if pipeline is None:
            pipeline = padded.shape[1] > block
        if pipeline:
            src = shards["X"] if "X" in shards else shards["sp_values"]
            tiles = _TilePipeline(shards, padded, block, d, src.dtype)
    for b, start in enumerate(range(0, padded.shape[1], block)):
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
            gram, mbase = gram_fn(w, dw, gidx, gvals, cnts, sig_eff, frozen)
            if hybrid:
                xh = gather_rows(shards["X_hot"], bidx)      # (K, B, n_hot)
                v_hot = w_hot if frozen else w_hot + sig_eff * dw_hot
                with fp32_matmul():
                    mbase = mbase + torch.matmul(xh, v_hot[:, :, None])[..., 0]
                    if not frozen:
                        # the full panel Gram: the chain reads i < j only
                        gram = gram + torch.matmul(xh, xh.transpose(1, 2))
            scal = torch.stack([mbase, yb, qb, a_vec.gather(1, bidx), zeros,
                                live], dim=1)
            delta, coefs = chain_fn(scal, gram, bidx32, **chain_kw)
            _block_alpha_add(a_vec, bidx, delta)
            apply_fn(dw, gidx, gvals, cnts, coefs)
            if hybrid:
                with fp32_matmul():
                    dw_hot = dw_hot + torch.matmul(coefs[:, None, :], xh)[:, 0]
            continue
        xb = dense_rows(shards, bidx, d) if tiles is None else tiles.tile(b)
        if route == "fused":
            v = w.expand(k, d).contiguous() if frozen else w + sig_eff * dw
            a0b = a_vec.gather(1, bidx)
            if tiles is not None:
                tiles.prefetch(b + 1)
            delta, dwu = fused_fn(xb, bidx32, yb, qb, a0b, live, v,
                                  **chain_kw)
            dw = dw + dwu
            _block_alpha_add(a_vec, bidx, delta)
            continue
        with fp32_matmul():
            if frozen:
                mbase, gram = torch.matmul(xb, w), None
            else:
                mbase = torch.matmul(xb, (w + sig_eff * dw)[:, :, None])[..., 0]
                gram = torch.matmul(xb, xb.transpose(1, 2))
        scal = torch.stack([mbase, yb, qb, a_vec.gather(1, bidx), zeros,
                            live], dim=1)
        if tiles is not None:
            tiles.prefetch(b + 1)
        delta, coefs = chain_fn(scal, gram, bidx32, **chain_kw)
        _block_alpha_add(a_vec, bidx, delta)
        with fp32_matmul():
            dw = dw + torch.matmul(coefs[:, None, :], xb)[:, 0]
    if hybrid:
        # panel padding lanes carry value 0 at column 0: they add 0
        dw.scatter_add_(1, hot_cols, dw_hot)
    return a_vec - alpha, dw
