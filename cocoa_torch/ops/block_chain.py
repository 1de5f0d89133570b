"""The block-coordinate round's scalar chain and fused block: the CUDA
kernels ``csrc/block_chain.cu`` and their plain PyTorch versions
(counterpart of cocoa_tpu/ops/pallas_chain.py ``chain_block_batched`` and
``fused_block``).

One block holds B consecutive draws of every shard.  Step j's margin reads
cached pairwise dots instead of the running Delta-w::

    margin_j = m0_j + sig_eff * (mb_j + sum_{i<j} coef_i * G[j, i])

with G[j, i] = x_i . x_j, and repeated draws within the block read the
alpha that the earlier occurrence left.  ``gram`` is (K, B, B) with row j
of shard k contiguous; only its entries i < j are read, so a caller may
pass the full symmetric Gram or its strict triangle.

Each wrapper takes the tensor's device as the rule: on a CPU tensor it
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from cocoa_torch import kernels
from cocoa_torch.ops import losses
from cocoa_torch.ops.losses import LOSS_CODES

CHAIN_MAX_B = 1024           # 32 Gram entries per lane in the chain's warp
SMEM_OPTIN = 232_448         # H100: the 227 KB of shared memory a block may use
_TILE, _LD = 64, 33          # the fused kernel's Gram tile and padded row

_CHAIN_FN = {torch.float32: "chain_block_batched_f32",
             torch.float64: "chain_block_batched_f64"}
_FUSED_FN = {torch.float32: "fused_block_f32",
             torch.float64: "fused_block_f64"}


def fused_smem_bytes(b: int, itemsize: int) -> int:
    """Shared memory of one fused block (one shard): the (B, B) Gram,
    seven B-vectors, two 64 x 33 tiles of rows, the B indices."""
    return (b * b + 7 * b + 2 * _TILE * _LD) * itemsize + 4 * b


def fused_fits(b: int, itemsize: int) -> bool:
    return b <= CHAIN_MAX_B and fused_smem_bytes(b, itemsize) <= SMEM_OPTIN


@contextlib.contextmanager
def fp32_matmul():
    """Float32 matrix products in full float32 inside the block: TF32 off
    (``torch.backends.cuda.matmul.allow_tf32`` False, which is float32
    matmul precision "highest"), because TF32 keeps about three decimal
    digits and the gap certificate rests on w = (1/lam n) sum y alpha x
    staying tight.  The setting in force before is restored after."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def chain_block_batched_plain(scal, gram, idx, lam_n, coef_div, sig_eff,
                              frozen, loss, smoothing=1.0):
    """The plain version: the B steps as a Python loop over all K shards.
    Returns (delta (K, B), coef (K, B))."""
    k, _, b = scal.shape
    m0, y, qii, a0, mb, live = scal.unbind(1)
    delta = torch.zeros(k, b, dtype=scal.dtype, device=scal.device)
    coef = torch.zeros_like(delta)
    same = idx[:, :, None] == idx[:, None, :]       # same[k, i, j]
    lam_n_t = torch.tensor(lam_n, dtype=scal.dtype, device=scal.device)
    for j in range(b):
        a = a0[:, j] + (delta[:, :j] * same[:, :j, j]).sum(-1)
        margin = m0[:, j]
        if not frozen:
            margin = margin + sig_eff * (
                mb[:, j] + (coef[:, :j] * gram[:, j, :j]).sum(-1))
        new_a = losses.alpha_step(loss, a, y[:, j] * margin, qii[:, j],
                                  lam_n_t, smoothing=smoothing)
        delta[:, j] = (new_a - a) * live[:, j]
        coef[:, j] = y[:, j] * delta[:, j] / coef_div
    return delta, coef


def chain_block_batched(scal, gram, idx, lam_n, coef_div, sig_eff, frozen,
                        loss, smoothing=1.0):
    """One block's B-step recurrence for all K shards.  ``scal`` (K, 6, B)
    = [m0 | y | qii | alpha0 | mb | live]; ``gram`` (K, B, B) or None in
    frozen mode; ``idx`` (K, B) int32 the block's draws.  Returns
    (delta (K, B), coef (K, B)): alpha deltas for the caller's additive
    scatter and Delta-w coefficients."""
    kernels.check_dtype(scal.dtype, "the block chain kernel")
    losses.validate(loss, smoothing)
    if not frozen and gram is None:
        raise ValueError("chain_block_batched needs the Gram unless frozen")
    gram = None if frozen else gram
    if scal.device.type == "cpu":
        return chain_block_batched_plain(scal, gram, idx, lam_n, coef_div,
                                         sig_eff, frozen, loss, smoothing)
    kernels.require_cuda(scal, "chain_block_batched")
    k, _, b = scal.shape
    if b > CHAIN_MAX_B:
        raise ValueError(f"the chain kernel takes B <= {CHAIN_MAX_B}, got {b}")
    dt, dev = scal.dtype, scal.device
    check = kernels.check_tensor
    check("scal", scal, dt, (k, 6, b), dev)
    check("idx", idx, torch.int32, (k, b), dev)
    if gram is not None:
        check("gram", gram, dt, (k, b, b), dev)
    lib = _library()
    delta = torch.empty(k, b, dtype=dt, device=dev)
    coef = torch.empty_like(delta)
    with torch.cuda.device(dev):
        rc = getattr(lib, _CHAIN_FN[dt])(
            scal.data_ptr(), 0 if gram is None else gram.data_ptr(),
            idx.data_ptr(), delta.data_ptr(), coef.data_ptr(), k, b,
            LOSS_CODES[loss], float(lam_n), float(coef_div), float(sig_eff),
            float(smoothing), kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "chain_block_batched")
    chain_block_batched.launches += 1
    return delta, coef


chain_block_batched.launches = 0


def fused_block_plain(xb, idx, yb, qb, a0, live, v, lam_n, coef_div,
                      sig_eff, frozen, loss, smoothing=1.0):
    """The plain version: margins and Gram as batched matrix products in
    full float32, the chain's plain loop, then dwu = coef . xb."""
    with fp32_matmul():
        m0 = torch.matmul(xb, v[:, :, None])[..., 0]
        gram = None if frozen else torch.matmul(xb, xb.transpose(1, 2))
    scal = torch.stack([m0, yb, qb, a0, torch.zeros_like(m0), live], dim=1)
    delta, coef = chain_block_batched_plain(scal, gram, idx, lam_n, coef_div,
                                            sig_eff, frozen, loss, smoothing)
    with fp32_matmul():
        dwu = torch.matmul(coef[:, None, :], xb)[:, 0]
    return delta, dwu


def fused_block(xb, idx, yb, qb, a0, live, v, lam_n, coef_div, sig_eff,
                frozen, loss, smoothing=1.0):
    """One whole block: margins x_j . v_k, the K Gram matrices, the chain
    and the Delta-w increment.  ``xb`` (K, B, d) the gathered rows; ``idx``
    (K, B) int32; ``yb``, ``qb`` (qii), ``a0``, ``live`` (K, B); ``v``
    (K, d) = w + sig_eff * dw (w in frozen mode).  Returns (delta (K, B),
    dwu (K, d) = sum_j coef_j x_j)."""
    kernels.check_dtype(xb.dtype, "the fused block kernel")
    losses.validate(loss, smoothing)
    if xb.device.type == "cpu":
        return fused_block_plain(xb, idx, yb, qb, a0, live, v, lam_n,
                                 coef_div, sig_eff, frozen, loss, smoothing)
    kernels.require_cuda(xb, "fused_block")
    k, b, d = xb.shape
    dt, dev = xb.dtype, xb.device
    if not fused_fits(b, dt.itemsize):
        raise ValueError(f"fused_block at B={b} needs "
                         f"{fused_smem_bytes(b, dt.itemsize)} B of shared "
                         f"memory, over the {SMEM_OPTIN} B a block may use")
    check = kernels.check_tensor
    check("xb", xb, dt, (k, b, d), dev)
    check("idx", idx, torch.int32, (k, b), dev)
    for name, t in (("yb", yb), ("qb", qb), ("a0", a0), ("live", live)):
        check(name, t, dt, (k, b), dev)
    check("v", v, dt, (k, d), dev)
    lib = _library()
    delta = torch.empty(k, b, dtype=dt, device=dev)
    dwu = torch.empty(k, d, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _FUSED_FN[dt])(
            xb.data_ptr(), idx.data_ptr(), yb.data_ptr(), qb.data_ptr(),
            a0.data_ptr(), live.data_ptr(), v.data_ptr(), delta.data_ptr(),
            dwu.data_ptr(), k, b, d, LOSS_CODES[loss], float(lam_n),
            float(coef_div), float(sig_eff), float(smoothing), int(frozen),
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "fused_block")
    fused_block.launches += 1
    return delta, dwu


fused_block.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("block_chain")
    kernels.declare(lib, _CHAIN_FN.values(), 5,
                    [ctypes.c_int] * 3 + [ctypes.c_double] * 4)
    kernels.declare(lib, _FUSED_FN.values(), 9,
                    [ctypes.c_int] * 4 + [ctypes.c_double] * 4
                    + [ctypes.c_int])
    return lib
