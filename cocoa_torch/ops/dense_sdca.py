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

The kernel stages each sampled row in a ring of shared-memory slots
before its step, as the TPU kernel's row BlockSpecs buffer ``unroll`` rows
in VMEM; a row wider than a slot streams through the ring in chunks.
:func:`stage_plan` picks where w0 and dw_k live, the ring's depth and the
slot's width against the card's shared memory; the kernel refuses a plan
that does not fit and never picks another.
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

# the kernel's constants (csrc/dense_sdca.cu kThreads, kMaxStages, kReduce)
THREADS = 512
MAX_STAGES = 3
REDUCE_SLOTS = 2 * 2 * (THREADS // 32)
# the auto depth of a ring of chunks: wider chunks beat a deeper ring (on
# an H100 80GB HBM3 at the float64 demo row, chip_smoke.py dense_timing:
# 4096 columns x 2 slots and 8704 x 1 within 2 % of each other, 2560 x 3
# 10 % slower), and two slots keep one copy in flight while the other is
# read
CHUNK_STAGES = 2


def plan_bytes(d: int, itemsize: int, state_in_smem: bool, stages: int,
               chunk: int) -> int:
    """Shared memory of one block: the double-buffered partial dots, w0
    and dw_k when ``state_in_smem``, and ``stages`` slots of ``chunk``
    values."""
    return (REDUCE_SLOTS + (2 * d if state_in_smem else 0)
            + stages * chunk) * itemsize


def _check_stages(stages):
    if stages is None:
        return None
    if isinstance(stages, bool) or not isinstance(stages, int) \
            or not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stages must be an int in 1..{MAX_STAGES} or "
                         f"None (auto), got {stages!r}")
    return stages


def stage_plan(d: int, itemsize: int, smem_optin: int,
               state_in_smem: bool = True, stages=None):
    """(state_in_smem, stages, chunk) for rows of ``d`` values of
    ``itemsize`` bytes under ``smem_optin`` bytes of shared memory a block.

    ``stages`` None asks for as many whole-row slots as fit, up to
    MAX_STAGES, or CHUNK_STAGES slots of chunks where not one row fits;
    an int asks for exactly that many.  A slot holds the whole row (chunk
    = d) when the slots asked for fit, else the widest multiple of THREADS
    columns that does: the row then streams through the ring in chunks,
    read twice a step, and no width is refused.  The state (w0 and
    dw_k) stays in shared memory when ``state_in_smem`` and a slot of at
    least THREADS columns fits beside it, else it goes to global memory
    and the rows are still staged.  Raises ValueError only when not even
    that fits (an opt-in far below any CUDA card's)."""
    stages = _check_stages(stages)
    for in_smem in ((True, False) if state_in_smem else (False,)):
        room = smem_optin - plan_bytes(d, itemsize, in_smem, 0, 0)
        whole = max(0, room) // (d * itemsize)
        if stages is None and whole >= 1:
            return in_smem, min(MAX_STAGES, whole), d
        depth = stages or CHUNK_STAGES
        if whole >= depth:
            return in_smem, depth, d
        chunk = max(0, room) // (depth * itemsize) // THREADS * THREADS
        if chunk >= THREADS:
            return in_smem, depth, chunk
    raise ValueError(f"the dense SDCA kernel cannot stage rows of {d} x "
                     f"{itemsize} bytes in {smem_optin} bytes of shared "
                     f"memory")


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
                     state_in_smem=True, stages=None):
    """One dense SDCA round.  ``w`` (d,), ``alpha`` (K, n_shard), ``X``
    (K, n_shard, d), ``labels`` and ``sq_norms`` (K, n_shard), ``idxs``
    int32 (K, H).  The kernel stages each step's row in a ring of
    ``stages`` shared-memory slots (None: as deep as fits, at most
    MAX_STAGES), in chunks when the row is wider than a slot, and keeps w
    and each shard's dw in shared memory where they fit beside the ring,
    unless ``state_in_smem`` is False (:func:`stage_plan`).  The plain version takes no plan; ``stages`` is
    checked on every device.  Returns (dw (K, d) unreduced per-shard
    updates, alpha_inner (K, n_shard) the locally advanced alpha)."""
    kernels.check_dtype(w.dtype, "the dense SDCA kernel")
    losses.validate(loss, smoothing)
    stages = _check_stages(stages)
    if kernels.runs_plain(w.device):
        return dense_sdca_round_plain(w, alpha, X, labels, sq_norms, idxs,
                                      lam, n, mode=mode, sigma=sigma,
                                      loss=loss, smoothing=smoothing)
    kernels.require_cuda(w, "dense_sdca_round")
    plan = stage_plan(X.shape[-1], w.element_size(),
                      kernels.smem_optin(w.device), state_in_smem, stages)
    return _launch(w, alpha, X, labels, sq_norms, idxs, lam, n, mode, sigma,
                   loss, smoothing, plan)


kernels.count_launches(dense_sdca_round, "launches")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("dense_sdca")
    kernels.declare(lib, _FN.values(), 7,
                    [ctypes.c_int] * 5 + [ctypes.c_double] * 5
                    + [ctypes.c_int] * 4)
    return lib


def _launch(w, alpha, X, labels, sq_norms, idxs, lam, n, mode, sigma, loss,
            smoothing, plan):
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
    in_smem, stages, chunk = plan
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
            int(mode == "frozen"), int(in_smem), stages, chunk,
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "dense_sdca")
    dense_sdca_round.launches += 1
    return dw, alpha_out
