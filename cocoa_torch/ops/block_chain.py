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

The chain kernel is right-looking: each step pushes its coefficient into
the running margins of the rows still to come, and producer threads stage
the Gram's strict lower triangle in shared memory ahead of it, in units
of 32, 16 or 8 columns round a ring of slots.  :func:`chain_plan` picks
the ring's depth and the unit's width; the kernel refuses a plan it
cannot hold and never picks another.

The fused kernel runs each shard on a thread-block cluster whose blocks
split d: :func:`fused_plan` picks the cluster's size and the slice width,
and the kernel refuses a plan that breaks its rules and never picks
another.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from cocoa_torch import kernels
from cocoa_torch.ops import losses
from cocoa_torch.ops.losses import LOSS_CODES

CHAIN_MAX_B = 1024           # 32 rows per lane in the chain's warp
SMEM_OPTIN = 232_448         # H100: the 227 KB of shared memory a block may use
_TILE, _LD = 64, 33          # the fused kernel's Gram tile and padded row
# the fused kernel's step over d (kDk), the unit of a block's slice, and
# the largest cluster it takes (kMaxCluster; above 8 blocks non-portable)
SLICE_UNIT = 32
MAX_CLUSTER = 16
# the blocks of a shard's cluster under fused_plan's auto rule.  On the
# epsilon-like block (8 x 128 x 2000, float32; chip_smoke.py phase 5, an
# H100 80GB HBM3 at 700 W) C = 1, 2, 4, 8, 16 took 0.4696, 0.2841,
# 0.1828, 0.1339, 0.1268 ms: 16 is 5 % faster than 8, but it is a
# non-portable cluster size and at float64 the card holds 7 clusters of
# 16 at once, fewer than K, so 8 serves both dtypes without an occupancy
# query in the plan
AUTO_CLUSTER = 8

# the chain kernel's units of Gram columns, widest first (csrc/block_chain.cu
# chain_plan_ok), and the ring the auto plan asks for: every unit in its
# own slot, or at least this many slots of the widest unit that allows it
CHAIN_COLS = (32, 16, 8)
AUTO_CHAIN_STAGES = 4

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


def chain_slot_rows(b: int, cols: int, slot: int) -> int:
    """The rows of ring slot ``slot``: it holds units slot, slot + S, ...,
    and unit q covers rows 32 * floor(q * cols / 32) .. B-1."""
    return b - 32 * (slot * cols // 32)


def chain_smem_bytes(b: int, stages: int, cols: int, itemsize: int) -> int:
    """Shared memory of one chain block: two mbarriers a slot, the ring
    (each slot's rows at a stride of cols + 1 values), the six step
    scalars and the B coefficients and deltas."""
    rows = sum(chain_slot_rows(b, cols, s) for s in range(stages))
    return 16 * stages + ((cols + 1) * rows + 8 * b) * itemsize


def _check_stages(stages):
    if stages is None:
        return None
    if isinstance(stages, bool) or not isinstance(stages, int) \
            or stages < 1:
        raise ValueError(f"stages must be an int >= 1 or None (auto), got "
                         f"{stages!r}")
    return stages


@functools.lru_cache(maxsize=None, typed=True)
def chain_plan(b: int, itemsize: int, smem_optin: int, stages=None):
    """(stages, cols, smem_bytes): the chain kernel's ring of ``stages``
    slots, each holding a unit of ``cols`` Gram columns, and the block's
    shared memory, for B = ``b`` and ``itemsize``-byte values under
    ``smem_optin`` bytes.

    ``stages`` None takes the widest unit of CHAIN_COLS at which every
    unit has its own slot (the whole triangle, staged once) or at least
    AUTO_CHAIN_STAGES slots fit, as many slots as fit; failing that, the
    narrowest unit with as many slots as fit.  An int asks for exactly
    that many slots, in the widest unit that holds them.  Raises
    ValueError when no unit holds the slots asked for, or not even one."""
    stages = _check_stages(stages)
    if not 1 <= b <= CHAIN_MAX_B:
        raise ValueError(f"the chain kernel takes B in 1..{CHAIN_MAX_B}, "
                         f"got {b}")
    depth = {}
    for cols in CHAIN_COLS:
        units = _ceil(b, cols)
        fit = 0
        while fit < units and chain_smem_bytes(b, fit + 1, cols,
                                               itemsize) <= smem_optin:
            fit += 1
        depth[cols] = fit
        if stages is None and fit >= min(units, AUTO_CHAIN_STAGES):
            return fit, cols, chain_smem_bytes(b, fit, cols, itemsize)
        if stages is not None and stages <= fit:
            return stages, cols, chain_smem_bytes(b, stages, cols, itemsize)
    cols = CHAIN_COLS[-1]
    if stages is None and depth[cols] >= 1:
        return depth[cols], cols, chain_smem_bytes(b, depth[cols], cols,
                                                   itemsize)
    raise ValueError(f"the chain kernel cannot stage {stages or 'auto'} "
                     f"slots at B={b} ({itemsize}-byte values) in "
                     f"{smem_optin} bytes of shared memory")


def _check_cluster(cluster):
    if cluster is None:
        return None
    if isinstance(cluster, bool) or not isinstance(cluster, int) \
            or not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be an int in 1..{MAX_CLUSTER} or "
                         f"None (auto), got {cluster!r}")
    return cluster


def fused_plan(b: int, d: int, itemsize: int, cluster=None):
    """(cluster, width): the fused kernel's C blocks per shard, block r
    owning columns [r * width, min(d, (r + 1) * width)) of d.  The width
    is d for C = 1, else ceil(d / C) rounded up to SLICE_UNIT, so every
    slice but the last is a multiple of SLICE_UNIT columns.

    ``cluster`` None takes AUTO_CLUSTER blocks, fewer where d leaves a
    block without columns; an int asks for exactly that many, and a count
    that leaves a block without columns raises.  Every block holds the same
    shared memory as C = 1 (:func:`fused_smem_bytes`); a B whose working
    set does not fit raises."""
    cluster = _check_cluster(cluster)
    if not fused_fits(b, itemsize):
        raise ValueError(f"fused_block at B={b} needs "
                         f"{fused_smem_bytes(b, itemsize)} B of shared "
                         f"memory, over the {SMEM_OPTIN} B a block may use")
    c = cluster or AUTO_CLUSTER
    while True:
        width = d if c == 1 else _ceil(_ceil(d, c), SLICE_UNIT) * SLICE_UNIT
        used = _ceil(d, width)
        if used == c:
            return c, width
        if cluster is not None:
            raise ValueError(f"cluster={cluster} leaves a block without "
                             f"columns at d={d} (slices of {width})")
        c = used


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


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
    lam_n_t = torch.full((), lam_n, dtype=scal.dtype, device=scal.device)
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
                        loss, smoothing=1.0, stages=None):
    """One block's B-step recurrence for all K shards.  ``scal`` (K, 6, B)
    = [m0 | y | qii | alpha0 | mb | live]; ``gram`` (K, B, B) or None in
    frozen mode; ``idx`` (K, B) int32 the block's draws.  ``stages`` asks
    the kernel for that many ring slots (None: :func:`chain_plan`'s auto
    rule); the plain version takes no plan, and ``stages`` is checked on
    every device.  Returns (delta (K, B), coef (K, B)): alpha deltas for
    the caller's additive scatter and Delta-w coefficients."""
    kernels.check_dtype(scal.dtype, "the block chain kernel")
    losses.validate(loss, smoothing)
    stages = _check_stages(stages)
    if not frozen and gram is None:
        raise ValueError("chain_block_batched needs the Gram unless frozen")
    gram = None if frozen else gram
    if kernels.runs_plain(scal.device):
        return chain_block_batched_plain(scal, gram, idx, lam_n, coef_div,
                                         sig_eff, frozen, loss, smoothing)
    kernels.require_cuda(scal, "chain_block_batched")
    k, _, b = scal.shape
    dt, dev = scal.dtype, scal.device
    depth, cols, _ = chain_plan(b, dt.itemsize, kernels.smem_optin(dev),
                                stages)
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
            idx.data_ptr(), delta.data_ptr(), coef.data_ptr(), k, b, depth,
            cols, LOSS_CODES[loss], float(lam_n), float(coef_div),
            float(sig_eff), float(smoothing), kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "chain_block_batched")
    chain_block_batched.launches += 1
    return delta, coef


kernels.count_launches(chain_block_batched, "launches")


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
                frozen, loss, smoothing=1.0, cluster=None):
    """One whole block: margins x_j . v_k, the K Gram matrices, the chain
    and the Delta-w increment.  ``xb`` (K, B, d) the gathered rows; ``idx``
    (K, B) int32; ``yb``, ``qb`` (qii), ``a0``, ``live`` (K, B); ``v``
    (K, d) = w + sig_eff * dw (w in frozen mode).  ``cluster`` asks the
    kernel for that many blocks a shard (None: :func:`fused_plan`'s auto
    rule); the plain version takes no plan, and ``cluster`` is checked on
    every device.  Returns (delta (K, B), dwu (K, d) = sum_j coef_j x_j)."""
    kernels.check_dtype(xb.dtype, "the fused block kernel")
    losses.validate(loss, smoothing)
    cluster = _check_cluster(cluster)
    if kernels.runs_plain(xb.device):
        return fused_block_plain(xb, idx, yb, qb, a0, live, v, lam_n,
                                 coef_div, sig_eff, frozen, loss, smoothing)
    kernels.require_cuda(xb, "fused_block")
    k, b, d = xb.shape
    dt, dev = xb.dtype, xb.device
    c, width = fused_plan(b, d, dt.itemsize, cluster)
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
            dwu.data_ptr(), k, b, d, c, width, LOSS_CODES[loss],
            float(lam_n), float(coef_div), float(sig_eff), float(smoothing),
            int(frozen), kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "fused_block")
    fused_block.launches += 1
    return delta, dwu


kernels.count_launches(fused_block, "launches")


def fused_clusters(b: int, dtype, cluster: int, frozen: bool = False,
                   device="cuda") -> int:
    """How many clusters of ``cluster`` fused blocks at B = ``b`` the card
    of ``device`` holds at once (cudaOccupancyMaxActiveClusters): K
    clusters or more run in one wave."""
    kernels.check_dtype(dtype, "the fused block kernel")
    cluster = _check_cluster(cluster)
    lib = _library()
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = lib.fused_block_clusters(dtype.itemsize, b, cluster, int(frozen),
                                      ctypes.byref(out))
    kernels.raise_on_error(lib, rc, "fused_block_clusters")
    return out.value


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("block_chain")
    kernels.declare(lib, _CHAIN_FN.values(), 5,
                    [ctypes.c_int] * 5 + [ctypes.c_double] * 4)
    kernels.declare(lib, _FUSED_FN.values(), 9,
                    [ctypes.c_int] * 6 + [ctypes.c_double] * 4
                    + [ctypes.c_int])
    lib.fused_block_clusters.restype = ctypes.c_int
    lib.fused_block_clusters.argtypes = [ctypes.c_int] * 4 \
        + [ctypes.POINTER(ctypes.c_int)]
    return lib
