"""One dense SDCA round for K shards: the CUDA kernel ``csrc/dense_sdca.cu``
and its plain PyTorch version (counterpart of cocoa_tpu/ops/pallas_sdca.py
``pallas_sdca_round``).

:func:`dense_sdca_round` takes the tensor's device as the rule: on a CPU
tensor it runs :func:`dense_sdca_round_plain`; on a CUDA tensor it
launches the kernel or raises.  The kernel computes both dots of each
step (x.w0 and x.dw) in-kernel; the plain version takes the round's
margins X.w up front and runs the fast-math loop of ops/local_sdca.py.
The two are equal in real arithmetic and sum in different orders.  Every
mode of ops/local_sdca.py runs through both, ``prox`` with the ``lasso``
rule.
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

_FN = {torch.float32: "dense_sdca_round_f32",
       torch.float64: "dense_sdca_round_f64"}


def dense_sdca_round_plain(w, alpha, X, labels, sq_norms, idxs, lam, n,
                           mode="plus", sigma=1.0, loss="hinge",
                           smoothing=1.0):
    """The plain version: margins X.w once, then the fast-math loop over
    all K shards.  Returns (dw (K, d), alpha_inner (K, n_shard))."""
    shards = {"X": X, "labels": labels, "sq_norms": sq_norms}
    dw = torch.zeros(alpha.shape[0], w.shape[0], dtype=w.dtype,
                     device=w.device)
    da, dw = local_sdca_fast(X @ w, alpha, shards, idxs, lam, n, dw,
                             mode=mode, sigma=sigma, loss=loss,
                             smoothing=smoothing)
    return dw, alpha + da


def dense_sdca_round(w, alpha, X, labels, sq_norms, idxs, lam, n,
                     mode="plus", sigma=1.0, loss="hinge", smoothing=1.0,
                     state_in_smem=True):
    """One dense SDCA round.  ``w`` (d,), ``alpha`` (K, n_shard), ``X``
    (K, n_shard, d), ``labels`` and ``sq_norms`` (K, n_shard), ``idxs``
    int32 (K, H).  The kernel keeps w and each shard's dw in shared memory
    where both fit, unless ``state_in_smem`` is False.  Returns (dw (K, d)
    unreduced per-shard updates, alpha_inner (K, n_shard) the locally
    advanced alpha)."""
    kernels.check_dtype(w.dtype, "the dense SDCA kernel")
    losses.validate(loss, smoothing)
    if kernels.runs_plain(w.device):
        return dense_sdca_round_plain(w, alpha, X, labels, sq_norms, idxs,
                                      lam, n, mode=mode, sigma=sigma,
                                      loss=loss, smoothing=smoothing)
    kernels.require_cuda(w, "dense_sdca_round")
    return _launch(w, alpha, X, labels, sq_norms, idxs, lam, n, mode, sigma,
                   loss, smoothing, state_in_smem)


dense_sdca_round.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("dense_sdca")
    kernels.declare(lib, _FN.values(), 7,
                    [ctypes.c_int] * 5 + [ctypes.c_double] * 5
                    + [ctypes.c_int, ctypes.c_int])
    return lib


def _launch(w, alpha, X, labels, sq_norms, idxs, lam, n, mode, sigma, loss,
            smoothing, state_in_smem):
    k, n_shard, d = X.shape
    h = idxs.shape[1]
    dt, dev = w.dtype, w.device
    check = kernels.check_tensor
    check("w", w, dt, (d,), dev)
    check("alpha", alpha, dt, (k, n_shard), dev)
    check("X", X, dt, (k, n_shard, d), dev)
    check("labels", labels, dt, (k, n_shard), dev)
    check("sq_norms", sq_norms, dt, (k, n_shard), dev)
    check("idxs", idxs, torch.int32, (k, h), dev)
    sig_eff, qii_factor = mode_factors(mode, sigma)
    lib = _library()
    alpha_out = alpha.clone()
    dw = torch.empty(k, d, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _FN[dt])(
            w.data_ptr(), alpha_out.data_ptr(), X.data_ptr(),
            labels.data_ptr(), sq_norms.data_ptr(), idxs.data_ptr(),
            dw.data_ptr(), k, n_shard, d, h, LOSS_CODES[loss],
            float(lam * n), float(coef_divisor(mode, lam * n)),
            float(sig_eff), float(qii_factor), float(smoothing),
            int(mode == "frozen"), int(state_in_smem),
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "dense_sdca")
    dense_sdca_round.launches += 1
    return dw, alpha_out
