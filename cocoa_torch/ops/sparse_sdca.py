"""One sparse SDCA round for K padded-CSR shards: the CUDA kernel
``csrc/sparse_sdca.cu`` and its plain PyTorch version (counterpart of
cocoa_tpu/ops/pallas_sparse.py ``pallas_sparse_sdca_round``, plain
branch).

:func:`sparse_sdca_round` takes the tensor's device as the rule: on a CPU
tensor it runs :func:`sparse_sdca_round_plain`; on a CUDA tensor it
launches the kernel or raises.  The kernel reads each margin in-kernel
from w and dw_k; the plain version is the fast-math loop of
ops/local_sdca.py with the round's margins X.w computed up front.  The
two are equal in real arithmetic and sum in different orders.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cocoa_torch.ops import losses
from cocoa_torch.ops.local_sdca import coef_divisor, local_sdca_fast, \
    mode_factors
from cocoa_torch.ops.rows import shard_margins

_LOSS_CODES = {"hinge": 0, "smooth_hinge": 1, "logistic": 2}
_FN = {torch.float32: "sparse_sdca_round_f32",
       torch.float64: "sparse_sdca_round_f64"}


def check_dtype(dtype: torch.dtype) -> None:
    """2-byte dtypes are refused, as cocoa_tpu/ops/pallas_sdca.py
    ``check_dtype`` refuses them: a bf16 round cannot certify a small
    duality gap, and the kernel is built for float32 and float64."""
    if dtype not in _FN:
        raise ValueError(f"the sparse SDCA kernel takes float32 or float64, "
                         f"got {dtype}")


def row_lengths(sp_values: torch.Tensor) -> torch.Tensor:
    """(K, n_shard) int32: 1 + the last slot holding a nonzero value
    (interior explicit zeros count, trailing padding does not)."""
    w = sp_values.shape[-1]
    iota = torch.arange(1, w + 1, dtype=torch.int32, device=sp_values.device)
    return torch.where(sp_values != 0, iota, 0).amax(-1).to(torch.int32)


def sparse_sdca_round_plain(w, alpha, sp_indices, sp_values, labels,
                            sq_norms, idxs, lam, n, mode="plus", sigma=1.0,
                            loss="hinge", smoothing=1.0):
    """The plain version: margins X.w once, then the fast-math loop over
    all K shards (padded slots are inert here).  Returns (dw (K, d),
    alpha_inner (K, n_shard))."""
    shards = {"sp_indices": sp_indices, "sp_values": sp_values,
              "labels": labels, "sq_norms": sq_norms}
    k, d = alpha.shape[0], w.shape[0]
    dw = torch.zeros(k, d, dtype=w.dtype, device=w.device)
    da, dw = local_sdca_fast(shard_margins(w, shards), alpha, shards, idxs,
                             lam, n, dw, mode=mode, sigma=sigma, loss=loss,
                             smoothing=smoothing)
    return dw, alpha + da


def sparse_sdca_round(w, alpha, sp_indices, sp_values, labels, sq_norms,
                      idxs, lam, n, mode="plus", sigma=1.0, loss="hinge",
                      smoothing=1.0, row_len=None, dw_in_smem=True):
    """One sparse SDCA round.  ``w`` (d,), ``alpha`` (K, n_shard),
    ``sp_indices`` int32 / ``sp_values`` (K, n_shard, W), ``labels`` and
    ``sq_norms`` (K, n_shard), ``idxs`` int32 (K, H), ``row_len`` int32
    (K, n_shard) or None (computed here).  The kernel keeps each shard's
    dw in shared memory where it fits, unless ``dw_in_smem`` is False.
    Returns (dw (K, d) unreduced per-shard updates, alpha_inner
    (K, n_shard) the locally advanced alpha)."""
    check_dtype(w.dtype)
    losses.validate(loss, smoothing)
    if w.device.type == "cpu":
        return sparse_sdca_round_plain(
            w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, lam, n,
            mode=mode, sigma=sigma, loss=loss, smoothing=smoothing)
    if w.device.type != "cuda":
        raise ValueError(f"sparse_sdca_round runs on cuda or cpu tensors, "
                         f"got {w.device}")
    if row_len is None:
        row_len = row_lengths(sp_values)
    return _launch(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs,
                   row_len, lam, n, mode, sigma, loss, smoothing, dw_in_smem)


sparse_sdca_round.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    from cocoa_torch import kernels

    lib = kernels.load("sparse_sdca")
    for name in _FN.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_double] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, w on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, row_len,
            lam, n, mode, sigma, loss, smoothing, dw_in_smem):
    k, n_shard, width = sp_indices.shape
    d, h = w.shape[0], idxs.shape[1]
    dt, dev = w.dtype, w.device
    _check("w", w, dt, (d,), dev)
    _check("alpha", alpha, dt, (k, n_shard), dev)
    _check("sp_indices", sp_indices, torch.int32, (k, n_shard, width), dev)
    _check("sp_values", sp_values, dt, (k, n_shard, width), dev)
    _check("labels", labels, dt, (k, n_shard), dev)
    _check("sq_norms", sq_norms, dt, (k, n_shard), dev)
    _check("idxs", idxs, torch.int32, (k, h), dev)
    _check("row_len", row_len, torch.int32, (k, n_shard), dev)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    lib = _library()
    fn = getattr(lib, _FN[dt])
    alpha_out = alpha.clone()
    dw = torch.empty(k, d, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(w.data_ptr(), alpha_out.data_ptr(), sp_indices.data_ptr(),
                sp_values.data_ptr(), labels.data_ptr(), sq_norms.data_ptr(),
                idxs.data_ptr(), row_len.data_ptr(), dw.data_ptr(),
                k, n_shard, width, d, h, _LOSS_CODES[loss],
                float(lam * n), float(coef_divisor(mode, lam * n)),
                float(sig_eff), float(qii_factor), float(smoothing),
                int(mode == "frozen"), int(dw_in_smem), stream)
    if rc != 0:
        raise RuntimeError(f"sparse_sdca kernel launch failed: CUDA error "
                           f"{rc} ({lib.cuda_error_string(rc).decode()})")
    sparse_sdca_round.launches += 1
    return dw, alpha_out
