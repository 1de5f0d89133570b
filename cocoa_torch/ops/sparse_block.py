"""The sparse block round's Gram and Delta-w apply on padded-CSR rows: the
CUDA kernels ``csrc/sparse_block.cu`` and their plain PyTorch versions
(counterpart of cocoa_tpu/ops/pallas_sparse.py ``sparse_block_gram`` and
``sparse_block_apply``).

A block's rows arrive as ``gidx`` int32 / ``gvals`` (K, B, W) with
``cnts`` (K, B) int32 their lengths; -1 marks a masked step, which reads
nothing: zero Gram entries, a zero margin base, no update.  Row i is
expanded densely and row j's columns are picked from it, so a column
repeated within a row sums (the padded-CSR semantics of ops/rows.py).
The TPU kernels' lane-concatenated [w | dw] array and SMEM row segments
are TPU addressing; here w is (d,) and dw is (K, d).

Each wrapper takes the tensor's device as the rule: on a CPU tensor it
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cocoa_torch import kernels

_GRAM_FN = {torch.float32: "sparse_block_gram_f32",
            torch.float64: "sparse_block_gram_f64"}
_APPLY_FN = {torch.float32: "sparse_block_apply_f32",
             torch.float64: "sparse_block_apply_f64"}


def live_values(gvals, cnts):
    """The rows' values with every slot at or past the row's length (all
    of a masked row's) set to 0."""
    slot = torch.arange(gvals.shape[-1], device=gvals.device)
    return torch.where(slot < cnts[..., None], gvals, 0)


def sparse_block_gram_plain(w, dw, gidx, gvals, cnts, sig_eff, frozen):
    """The plain version, in the TPU kernel's shape: every row expanded
    densely, then row j's columns picked from row i's expansion."""
    k, b, width = gidx.shape
    vals = live_values(gvals, cnts)
    cols = gidx.long()
    coord = w[cols]
    if not frozen:
        coord = coord + sig_eff * dw.gather(1, cols.reshape(k, -1)) \
            .reshape(k, b, width)
    mb = (vals * coord).sum(-1)
    if frozen:
        return None, mb
    xrow = torch.zeros(k, b, w.shape[0], dtype=w.dtype, device=w.device) \
        .scatter_add_(2, cols, vals)
    picks = xrow.gather(2, cols.reshape(k, 1, b * width)
                        .expand(k, b, b * width)).reshape(k, b, b, width)
    g = (picks * vals[:, None]).sum(-1)          # g[k, i, j] = x_i . x_j
    return torch.tril(g.transpose(1, 2), diagonal=-1).contiguous(), mb


def sparse_block_gram(w, dw, gidx, gvals, cnts, sig_eff, frozen,
                      row_in_smem=True):
    """The block's Gram and margin base.  ``w`` (d,), ``dw`` (K, d) the
    Delta-w at the block's start.  Returns (gram, mb): gram (K, B, B) with
    row j holding x_i . x_j for i < j and zeros elsewhere (None in frozen
    mode), mb (K, B) = x_j . (w + sig_eff * dw_k) (x_j . w in frozen
    mode).  The kernel expands a row in shared memory where d fits,
    unless ``row_in_smem`` is False."""
    kernels.check_dtype(w.dtype, "the sparse block Gram kernel")
    if w.device.type == "cpu":
        return sparse_block_gram_plain(w, dw, gidx, gvals, cnts, sig_eff,
                                       frozen)
    kernels.require_cuda(w, "sparse_block_gram")
    k, b, width = gidx.shape
    d, dt, dev = w.shape[0], w.dtype, w.device
    _check_rows(gidx, gvals, cnts, dt, dev)
    kernels.check_tensor("w", w, dt, (d,), dev)
    kernels.check_tensor("dw", dw, dt, (k, d), dev)
    lib = _library()
    gram = None if frozen else torch.empty(k, b, b, dtype=dt, device=dev)
    mb = torch.empty(k, b, dtype=dt, device=dev)
    scratch = None
    if not frozen and (not row_in_smem
                       or d * dt.itemsize > lib.smem_optin_bytes()):
        scratch = _row_scratch(k, b, d, dt, dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _GRAM_FN[dt])(
            w.data_ptr(), dw.data_ptr(), gidx.data_ptr(), gvals.data_ptr(),
            cnts.data_ptr(), None if gram is None else gram.data_ptr(),
            mb.data_ptr(), None if scratch is None else scratch.data_ptr(),
            k, b, width, d, float(sig_eff), int(frozen),
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_block_gram")
    sparse_block_gram.launches += 1
    return gram, mb


sparse_block_gram.launches = 0
_SCRATCH: dict = {}


def _row_scratch(k, b, d, dt, dev) -> torch.Tensor:
    """The zeroed (K, B, d) buffer the Gram kernel expands rows into when
    d does not fit shared memory, one per shape and kept: the kernel
    zeroes the columns each row touched after use, so it stays zeroed."""
    key = (k, b, d, dt, dev)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(k, b, d, dtype=dt, device=dev)
    return _SCRATCH[key]


def sparse_block_apply_plain(dw, gidx, gvals, cnts, coefs):
    k = gidx.shape[0]
    upd = coefs[..., None] * live_values(gvals, cnts)
    return dw.scatter_add_(1, gidx.long().reshape(k, -1), upd.reshape(k, -1))


def sparse_block_apply(dw, gidx, gvals, cnts, coefs):
    """dw_k += sum_j coefs_kj * x_j over the block's nonzeros, in place;
    returns ``dw``.  The kernel adds row by row in order, so every column
    receives its adds in one fixed order and the result repeats bit for
    bit; the plain version's ``scatter_add_`` is ordered on the CPU only."""
    kernels.check_dtype(dw.dtype, "the sparse block apply kernel")
    if dw.device.type == "cpu":
        return sparse_block_apply_plain(dw, gidx, gvals, cnts, coefs)
    kernels.require_cuda(dw, "sparse_block_apply")
    k, b, width = gidx.shape
    d, dt, dev = dw.shape[1], dw.dtype, dw.device
    _check_rows(gidx, gvals, cnts, dt, dev)
    kernels.check_tensor("dw", dw, dt, (k, d), dev)
    kernels.check_tensor("coefs", coefs, dt, (k, b), dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = getattr(lib, _APPLY_FN[dt])(
            dw.data_ptr(), gidx.data_ptr(), gvals.data_ptr(), cnts.data_ptr(),
            coefs.data_ptr(), k, b, width, d, kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_block_apply")
    sparse_block_apply.launches += 1
    return dw


sparse_block_apply.launches = 0


def _check_rows(gidx, gvals, cnts, dt, dev):
    k, b, width = gidx.shape
    kernels.check_tensor("gidx", gidx, torch.int32, (k, b, width), dev)
    kernels.check_tensor("gvals", gvals, dt, (k, b, width), dev)
    kernels.check_tensor("cnts", cnts, torch.int32, (k, b), dev)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("sparse_block")
    kernels.declare(lib, _GRAM_FN.values(), 8,
                    [ctypes.c_int] * 4 + [ctypes.c_double, ctypes.c_int])
    kernels.declare(lib, _APPLY_FN.values(), 5, [ctypes.c_int] * 4)
    lib.smem_optin_bytes.restype = ctypes.c_int
    lib.smem_optin_bytes.argtypes = []
    return lib
