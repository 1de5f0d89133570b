"""One sparse SDCA round for K padded-CSR shards: the CUDA kernels
``csrc/sparse_sdca.cu`` and their plain PyTorch version (counterpart of
cocoa_tpu/ops/pallas_sparse.py ``pallas_sparse_sdca_round``, the plain
and the hot-panel branch).

:func:`sparse_sdca_round` takes the tensor's device as the rule: on a CPU
tensor it runs :func:`sparse_sdca_round_plain`; on a CUDA tensor it
launches the kernel or raises.  The kernel reads each margin in-kernel
from w and dw_k; the plain version is the fast-math loop of
ops/local_sdca.py with the round's margins X.w computed up front.  The
two are equal in real arithmetic and sum in different orders.  Every
mode of ops/local_sdca.py runs through both, ``prox`` (ProxCoCoA+ on
padded-CSC column shards) with the ``lasso`` rule.

With ``hot_panel``/``hot_cols`` (the hybrid layout, ``--hotCols``) the
CSR streams hold the cold residual and each step also reads the sampled
row's hot-panel slice: on a CUDA tensor that is the kernel's hybrid
branch, counted in ``sparse_sdca_round.hybrid_launches``; the plain
layout's launches are counted in ``sparse_sdca_round.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cocoa_torch import kernels
from cocoa_torch.ops import losses
from cocoa_torch.ops.losses import LOSS_CODES
from cocoa_torch.ops.local_sdca import coef_divisor, local_sdca_fast, \
    mode_factors
from cocoa_torch.ops.rows import row_lengths, shard_margins

_FN = {torch.float32: "sparse_sdca_round_f32",
       torch.float64: "sparse_sdca_round_f64"}
_HYBRID_FN = {torch.float32: "sparse_sdca_hybrid_f32",
              torch.float64: "sparse_sdca_hybrid_f64"}


def check_dtype(dtype: torch.dtype) -> None:
    kernels.check_dtype(dtype, "the sparse SDCA kernel")


def sparse_sdca_round_plain(w, alpha, sp_indices, sp_values, labels,
                            sq_norms, idxs, lam, n, mode="plus", sigma=1.0,
                            loss="hinge", smoothing=1.0, hot_cols=None,
                            hot_panel=None):
    """The plain version: margins X.w once, then the fast-math loop over
    all K shards (padded slots are inert here), on hybrid rows when the
    hot panel is given.  Returns (dw (K, d), alpha_inner (K, n_shard))."""
    _check_hot(hot_cols, hot_panel)
    shards = {"sp_indices": sp_indices, "sp_values": sp_values,
              "labels": labels, "sq_norms": sq_norms}
    if hot_panel is not None:
        shards.update(X_hot=hot_panel, hot_cols=hot_cols.long())
    k, d = alpha.shape[0], w.shape[0]
    dw = torch.zeros(k, d, dtype=w.dtype, device=w.device)
    da, dw = local_sdca_fast(shard_margins(w, shards), alpha, shards, idxs,
                             lam, n, dw, mode=mode, sigma=sigma, loss=loss,
                             smoothing=smoothing)
    return dw, alpha + da


def sparse_sdca_round(w, alpha, sp_indices, sp_values, labels, sq_norms,
                      idxs, lam, n, mode="plus", sigma=1.0, loss="hinge",
                      smoothing=1.0, row_len=None, dw_in_smem=True,
                      hot_cols=None, hot_panel=None):
    """One sparse SDCA round.  ``w`` (d,), ``alpha`` (K, n_shard),
    ``sp_indices`` int32 / ``sp_values`` (K, n_shard, W), ``labels`` and
    ``sq_norms`` (K, n_shard), ``idxs`` int32 (K, H), ``row_len`` int32
    (K, n_shard) or None (computed here).  The hybrid layout adds
    ``hot_panel`` (K, n_shard, n_hot) and ``hot_cols`` int32 (K, n_hot);
    the CSR streams then hold the cold residual.  The kernel keeps each
    shard's dw (and the hybrid branch's Delta-w_hot) in shared memory
    where it fits, unless ``dw_in_smem`` is False.  Returns (dw (K, d)
    unreduced per-shard updates, alpha_inner (K, n_shard) the locally
    advanced alpha)."""
    check_dtype(w.dtype)
    losses.validate(loss, smoothing)
    _check_hot(hot_cols, hot_panel)
    if kernels.runs_plain(w.device):
        return sparse_sdca_round_plain(
            w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, lam, n,
            mode=mode, sigma=sigma, loss=loss, smoothing=smoothing,
            hot_cols=hot_cols, hot_panel=hot_panel)
    kernels.require_cuda(w, "sparse_sdca_round")
    if row_len is None:
        row_len = row_lengths(sp_values)
    args = (w, alpha, sp_indices, sp_values, labels, sq_norms, idxs,
            row_len, lam, n, mode, sigma, loss, smoothing, dw_in_smem)
    if hot_panel is not None:
        return _launch_hybrid(*args, hot_cols, hot_panel)
    return _launch(*args)


sparse_sdca_round.launches = 0
sparse_sdca_round.hybrid_launches = 0


def _check_hot(hot_cols, hot_panel) -> None:
    if (hot_cols is None) != (hot_panel is None):
        raise ValueError("hot_cols and hot_panel come together (the hybrid "
                         "layout) or not at all")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("sparse_sdca")
    kernels.declare(lib, _FN.values(), 9,
                    [ctypes.c_int] * 6 + [ctypes.c_double] * 5
                    + [ctypes.c_int, ctypes.c_int])
    kernels.declare(lib, _HYBRID_FN.values(), 12,
                    [ctypes.c_int] * 7 + [ctypes.c_double] * 5
                    + [ctypes.c_int, ctypes.c_int])
    return lib


def _launch(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, row_len,
            lam, n, mode, sigma, loss, smoothing, dw_in_smem):
    k, n_shard, width = sp_indices.shape
    d, h = w.shape[0], idxs.shape[1]
    dt, dev = w.dtype, w.device
    check = kernels.check_tensor
    check("w", w, dt, (d,), dev)
    check("alpha", alpha, dt, (k, n_shard), dev)
    check("sp_indices", sp_indices, torch.int32, (k, n_shard, width), dev)
    check("sp_values", sp_values, dt, (k, n_shard, width), dev)
    check("labels", labels, dt, (k, n_shard), dev)
    check("sq_norms", sq_norms, dt, (k, n_shard), dev)
    check("idxs", idxs, torch.int32, (k, h), dev)
    check("row_len", row_len, torch.int32, (k, n_shard), dev)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    lib = _library()
    alpha_out = alpha.clone()
    dw = torch.empty(k, d, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _FN[dt])(
            w.data_ptr(), alpha_out.data_ptr(), sp_indices.data_ptr(),
            sp_values.data_ptr(), labels.data_ptr(), sq_norms.data_ptr(),
            idxs.data_ptr(), row_len.data_ptr(), dw.data_ptr(),
            k, n_shard, width, d, h, LOSS_CODES[loss],
            float(lam * n), float(coef_divisor(mode, lam * n)),
            float(sig_eff), float(qii_factor), float(smoothing),
            int(mode == "frozen"), int(dw_in_smem), kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_sdca")
    sparse_sdca_round.launches += 1
    return dw, alpha_out


def _launch_hybrid(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs,
                   row_len, lam, n, mode, sigma, loss, smoothing, dw_in_smem,
                   hot_cols, hot_panel):
    k, n_shard, width = sp_indices.shape
    d, h, n_hot = w.shape[0], idxs.shape[1], hot_panel.shape[-1]
    dt, dev = w.dtype, w.device
    check = kernels.check_tensor
    check("w", w, dt, (d,), dev)
    check("alpha", alpha, dt, (k, n_shard), dev)
    check("sp_indices", sp_indices, torch.int32, (k, n_shard, width), dev)
    check("sp_values", sp_values, dt, (k, n_shard, width), dev)
    check("labels", labels, dt, (k, n_shard), dev)
    check("sq_norms", sq_norms, dt, (k, n_shard), dev)
    check("idxs", idxs, torch.int32, (k, h), dev)
    check("row_len", row_len, torch.int32, (k, n_shard), dev)
    check("hot_panel", hot_panel, dt, (k, n_shard, n_hot), dev)
    check("hot_cols", hot_cols, torch.int32, (k, n_hot), dev)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    lib = _library()
    alpha_out = alpha.clone()
    dw = torch.empty(k, d, dtype=dt, device=dev)
    # per shard: w at the hot columns, and Delta-w_hot where it does not
    # stay in shared memory
    scratch = torch.empty(k, 2, n_hot, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _HYBRID_FN[dt])(
            w.data_ptr(), alpha_out.data_ptr(), sp_indices.data_ptr(),
            sp_values.data_ptr(), labels.data_ptr(), sq_norms.data_ptr(),
            idxs.data_ptr(), row_len.data_ptr(), hot_panel.data_ptr(),
            hot_cols.data_ptr(), scratch.data_ptr(), dw.data_ptr(),
            k, n_shard, width, d, h, n_hot, LOSS_CODES[loss],
            float(lam * n), float(coef_divisor(mode, lam * n)),
            float(sig_eff), float(qii_factor), float(smoothing),
            int(mode == "frozen"), int(dw_in_smem), kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_sdca hybrid")
    sparse_sdca_round.hybrid_launches += 1
    return dw, alpha_out
