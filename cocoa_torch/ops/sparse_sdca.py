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

Producer warps stage each step's row (columns, values and w at those
columns) and scalars in a ring of shared-memory slots before its step, so
the chain reads only shared memory; a row longer than a slot has the rest
read from global memory in its step.  :func:`sparse_plan` picks where
dw_k lives, the ring's depth and the slot's width against the card's
shared memory, and whether the hybrid branch keeps its panel lanes in
registers; the kernel refuses a plan that does not fit and never picks
another.
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

# the kernel's constants (csrc/sparse_sdca.cu kMaxStages, kMinSlot,
# kPanelThreads, kHotRegs, kReduce)
MAX_STAGES = 7
MIN_SLOT = 32
PANEL_THREADS = 512
HOT_REGS = {4: 12, 8: 6}  # by itemsize
REDUCE_SLOTS = 2 * (PANEL_THREADS // 32 + 4)
# the auto ring: whole-row slots as deep as fit (up to MAX_STAGES) when at
# least this many fit, else MAX_STAGES slots narrower than the row
AUTO_MIN_STAGES = 4


def slot_bytes(slot: int, itemsize: int) -> int:
    """One ring slot: ``slot`` entries of (value, w at its column, int32
    column), and the step's y, |x|^2, alpha, draw, row length and the
    producer's mark of a column twice in a 32-entry chunk."""
    return slot * (2 * itemsize + 4) + 3 * itemsize + 12


def plan_bytes(d: int, n_hot: int, itemsize: int, dw_in_smem: bool,
               hot_in_regs: bool, stages: int, slot: int) -> int:
    """Shared memory of one block: the hybrid branch's double-buffered
    partials (n_hot > 0), dw_k (and dw_hot when the panel lanes are not in
    registers) when ``dw_in_smem``, and ``stages`` slots."""
    state = d + (n_hot if n_hot and not hot_in_regs else 0) \
        if dw_in_smem else 0
    return ((REDUCE_SLOTS if n_hot else 0) + state) * itemsize \
        + stages * slot_bytes(slot, itemsize)


def hot_fits_registers(n_hot: int, itemsize: int) -> bool:
    return 0 < n_hot and -(-n_hot // PANEL_THREADS) <= HOT_REGS[itemsize]


def _check_stages(stages):
    if stages is None:
        return None
    if isinstance(stages, bool) or not isinstance(stages, int) \
            or not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"stages must be an int in 1..{MAX_STAGES} or "
                         f"None (auto), got {stages!r}")
    return stages


def sparse_plan(width: int, d: int, itemsize: int, smem_optin: int,
                dw_in_smem: bool = True, stages=None, n_hot: int = 0):
    """(dw_in_smem, stages, slot, hot_in_regs) for rows of ``width``
    slots, ``d`` features, ``itemsize``-byte values and, for the hybrid
    branch, a panel of ``n_hot`` lanes, under ``smem_optin`` bytes of
    shared memory a block.

    ``stages`` None asks for whole-row slots as deep as fit, up to
    MAX_STAGES, when at least AUTO_MIN_STAGES fit, else for MAX_STAGES
    slots; an int asks for exactly that many.  A slot holds the whole row
    (slot = width) when the slots asked for fit, else the widest multiple
    of MIN_SLOT entries that does: a longer row's first ``slot`` entries
    are staged and the rest read in its step, so no width is refused.
    dw_k (with dw_hot when the panel lanes are not in registers) stays in
    shared memory when ``dw_in_smem`` and a ring of MIN_SLOT-wide slots
    fits beside it, else it goes to global memory.  The panel lanes are in
    registers when each of the PANEL_THREADS threads holds at most
    HOT_REGS[itemsize].  Raises ValueError when not even that ring fits."""
    stages = _check_stages(stages)
    regs = hot_fits_registers(n_hot, itemsize)
    for in_smem in ((True, False) if dw_in_smem else (False,)):
        room = max(0, smem_optin
                   - plan_bytes(d, n_hot, itemsize, in_smem, regs, 0, 0))
        whole = room // slot_bytes(width, itemsize)
        if stages is None and whole >= AUTO_MIN_STAGES:
            return in_smem, min(MAX_STAGES, whole), width, regs
        depth = stages or MAX_STAGES
        if whole >= depth:
            return in_smem, depth, width, regs
        slot = (room // depth - slot_bytes(0, itemsize)) \
            // (2 * itemsize + 4) // MIN_SLOT * MIN_SLOT
        if slot >= MIN_SLOT:
            return in_smem, depth, slot, regs
    raise ValueError(f"the sparse SDCA kernel cannot stage {stages or 'auto'}"
                     f" slots of rows {width} wide ({itemsize}-byte values, "
                     f"d={d}, n_hot={n_hot}) in {smem_optin} bytes of shared "
                     f"memory")


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
                      hot_cols=None, hot_panel=None, stages=None):
    """One sparse SDCA round.  ``w`` (d,), ``alpha`` (K, n_shard),
    ``sp_indices`` int32 / ``sp_values`` (K, n_shard, W), ``labels`` and
    ``sq_norms`` (K, n_shard), ``idxs`` int32 (K, H), ``row_len`` int32
    (K, n_shard) or None (computed here).  The hybrid layout adds
    ``hot_panel`` (K, n_shard, n_hot) and ``hot_cols`` int32 (K, n_hot);
    the CSR streams then hold the cold residual.  The kernel stages each
    step's row in a ring of ``stages`` shared-memory slots (None: the auto
    depth) and keeps each shard's dw (and the hybrid branch's
    Delta-w_hot) in shared memory where it fits beside the ring, unless
    ``dw_in_smem`` is False (:func:`sparse_plan`).  The plain version
    takes no plan; ``stages`` is checked on every device.  Returns (dw
    (K, d) unreduced per-shard updates, alpha_inner (K, n_shard) the
    locally advanced alpha)."""
    check_dtype(w.dtype)
    losses.validate(loss, smoothing)
    _check_hot(hot_cols, hot_panel)
    stages = _check_stages(stages)
    if kernels.runs_plain(w.device):
        return sparse_sdca_round_plain(
            w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, lam, n,
            mode=mode, sigma=sigma, loss=loss, smoothing=smoothing,
            hot_cols=hot_cols, hot_panel=hot_panel)
    kernels.require_cuda(w, "sparse_sdca_round")
    if row_len is None:
        row_len = row_lengths(sp_values)
    n_hot = 0 if hot_panel is None else hot_panel.shape[-1]
    plan = sparse_plan(sp_indices.shape[-1], w.shape[0], w.element_size(),
                       kernels.smem_optin(w.device), dw_in_smem, stages,
                       n_hot)
    args = (w, alpha, sp_indices, sp_values, labels, sq_norms, idxs,
            row_len, lam, n, mode, sigma, loss, smoothing, plan)
    if hot_panel is not None:
        return _launch_hybrid(*args, hot_cols, hot_panel)
    return _launch(*args)


kernels.count_launches(sparse_sdca_round, "launches", "hybrid_launches")


def _check_hot(hot_cols, hot_panel) -> None:
    if (hot_cols is None) != (hot_panel is None):
        raise ValueError("hot_cols and hot_panel come together (the hybrid "
                         "layout) or not at all")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("sparse_sdca")
    kernels.declare(lib, _FN.values(), 9,
                    [ctypes.c_int] * 6 + [ctypes.c_double] * 5
                    + [ctypes.c_int] * 4)
    kernels.declare(lib, _HYBRID_FN.values(), 12,
                    [ctypes.c_int] * 7 + [ctypes.c_double] * 5
                    + [ctypes.c_int] * 5)
    return lib


def _launch(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs, row_len,
            lam, n, mode, sigma, loss, smoothing, plan):
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
    in_smem, stages, slot, _ = plan
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
            int(mode == "frozen"), int(in_smem), stages, slot,
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_sdca")
    sparse_sdca_round.launches += 1
    return dw, alpha_out


def _launch_hybrid(w, alpha, sp_indices, sp_values, labels, sq_norms, idxs,
                   row_len, lam, n, mode, sigma, loss, smoothing, plan,
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
    in_smem, stages, slot, regs = plan
    lib = _library()
    alpha_out = alpha.clone()
    dw = torch.empty(k, d, dtype=dt, device=dev)
    # per shard: w at the hot columns, and Delta-w_hot where it does not
    # stay in shared memory, when the panel lanes are not in registers
    scratch = torch.empty(k, 2, 0 if regs else n_hot, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _HYBRID_FN[dt])(
            w.data_ptr(), alpha_out.data_ptr(), sp_indices.data_ptr(),
            sp_values.data_ptr(), labels.data_ptr(), sq_norms.data_ptr(),
            idxs.data_ptr(), row_len.data_ptr(), hot_panel.data_ptr(),
            hot_cols.data_ptr(), scratch.data_ptr(), dw.data_ptr(),
            k, n_shard, width, d, h, n_hot, LOSS_CODES[loss],
            float(lam * n), float(coef_divisor(mode, lam * n)),
            float(sig_eff), float(qii_factor), float(smoothing),
            int(mode == "frozen"), int(in_smem), stages, slot, int(regs),
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_sdca hybrid")
    sparse_sdca_round.hybrid_launches += 1
    return dw, alpha_out
