"""The sparse block round's Gram and Delta-w apply on padded-CSR rows: the
CUDA kernels ``csrc/sparse_block.cu`` and their plain PyTorch versions
(counterpart of cocoa_tpu/ops/pallas_sparse.py ``sparse_block_gram`` and
``sparse_block_apply``).

A block's rows arrive as ``gidx`` int32 / ``gvals`` (K, B, W) with
``cnts`` (K, B) int32 their lengths; -1 marks a masked step, which reads
nothing: zero Gram entries, a zero margin base, no update.  A column
repeated within a row sums (the padded-CSR semantics of ops/rows.py).
The TPU kernels' lane-concatenated [w | dw] array and SMEM row segments
are TPU addressing; here w is (d,) and dw is (K, d).

Each wrapper takes the tensor's device as the rule: on a CPU tensor it
runs the plain version; on a CUDA tensor it launches the kernel or raises.

The Gram kernel builds, for each row a block owns, a hash table of its
columns in shared memory, then streams the shard's later rows in chunks
and looks their columns up in the tables; a row whose table does not fit
goes into a smaller one in passes.  :func:`gram_plan` picks the blocks a
shard (the rows each owns), the table's size, the chunk and the entries a
pass against the card's shared memory, for rows of any width; the kernel
refuses a plan it cannot hold.

The apply kernel splits each shard's Delta-w over blocks that own an
interleaved slice of its columns each (every S-th column), in shared
memory; every block streams the shard's live entries in chunks, keeps
those of its slice, and folds each column's adds in (row, slot) order,
the order of the plain version on the CPU, so the two agree bit for bit.
:func:`apply_plan` picks the slices a shard (counting the blocks against
the card's SMs) and the chunk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from cocoa_torch import kernels

_GRAM_FN = {torch.float32: "sparse_block_gram_f32",
            torch.float64: "sparse_block_gram_f64"}
_APPLY_FN = {torch.float32: "sparse_block_apply_f32",
             torch.float64: "sparse_block_apply_f64"}

# the Gram kernel's constants (csrc/sparse_block.cu kWarps, kMaxTables):
# each of its warps double-buffers a chunk of a row; a block owns at most
# MAX_TABLES rows, each with a hash table of int32 keys beside values
GRAM_WARPS = 8
MAX_TABLES = 8
ROWS_PER_CTA = (8, 4, 2, 1)
# the entries of a chunk where whole rows do not fit beside the tables
CHUNK = 256
# the least table of a plan in passes (a pass then inserts 32 entries)
MIN_PASS_SLOTS = 64


# the apply kernel's chunk of staged entries, and the smaller ones it
# takes where a slice of the asked width would not fit beside the largest
APPLY_CHUNKS = (4096, 2048, 1024, 512, 256)
# its row ids are int16
APPLY_MAX_B = 32767
# its warps (csrc/sparse_block.cu kApplyThreads / 32)
APPLY_WARPS = 16


class GramPlan(NamedTuple):
    """The Gram kernel's plan: ``blocks`` a shard (block t owns rows t,
    t + blocks, ...), tables of ``slots`` entries, each warp's buffers of
    ``chunk`` entries of a row, at most ``cap`` entries of a row in a
    table at once (cap >= W: one pass), and a block's shared memory."""

    blocks: int
    slots: int
    chunk: int
    cap: int
    smem: int


def table_slots(width: int) -> int:
    """The default table size for rows of ``width`` slots: the least power
    of two of at least 2 * width (and 32)."""
    slots = 32
    while slots < 2 * width:
        slots *= 2
    return slots


def pass_cap(slots: int, width: int) -> int:
    """The entries of a row that one pass puts in a table of ``slots``:
    the whole row where it leaves an empty slot, else half the table,
    rounded down to whole chunks of 32."""
    if slots > width:
        return max(width, 1)
    return slots // 2 // 32 * 32


def gram_tables(b: int, blocks: int) -> int:
    """The tables (owned rows) of one block when a shard's B rows go
    round-robin over ``blocks`` blocks, rounded up to a power of two."""
    rows, tables = -(-b // blocks), 1
    while tables < rows:
        tables *= 2
    return tables


def gram_smem_bytes(tables: int, slots: int, chunk: int, b: int,
                    itemsize: int) -> int:
    """Shared memory of one Gram block: the tables (a slot holds the key
    beside its value, two values wide), each warp's two buffers of
    ``chunk`` entries (a value and an int32 column an entry) and the B row
    lengths."""
    return tables * slots * 2 * itemsize \
        + 2 * GRAM_WARPS * chunk * (itemsize + 4) + 4 * b


def _check_gram_plan(rows_per_cta, slots, width):
    if rows_per_cta is not None and (
            isinstance(rows_per_cta, bool)
            or not isinstance(rows_per_cta, int)
            or rows_per_cta not in ROWS_PER_CTA):
        raise ValueError(f"rows_per_cta must be one of {ROWS_PER_CTA} or "
                         f"None (auto), got {rows_per_cta!r}")
    if slots is not None and (
            isinstance(slots, bool) or not isinstance(slots, int)
            or slots < 1 or slots > 1 << 24 or slots & (slots - 1)
            or (slots <= width and slots < MIN_PASS_SLOTS)):
        raise ValueError(f"slots must be a power of two above the row "
                         f"width {width} or of at least {MIN_PASS_SLOTS} "
                         f"(in passes), or None (auto), got {slots!r}")


@functools.lru_cache(maxsize=None, typed=True)
def gram_plan(b: int, width: int, itemsize: int, smem_optin: int,
              rows_per_cta=None, slots=None) -> GramPlan:
    """The Gram kernel's plan (:class:`GramPlan`) for B = ``b`` rows of
    ``width`` slots and ``itemsize``-byte values under ``smem_optin``
    bytes, for every width.  The rows a block owns are the most of
    ROWS_PER_CTA that fit (``rows_per_cta`` asks for exactly that many),
    tried in this order:

    1. whole rows in the warps' buffers beside tables of ``slots`` (None:
       :func:`table_slots`), one pass (:func:`pass_cap`);
    2. the same tables beside buffers of CHUNK entries;
    3. only where ``slots`` is None: buffers of CHUNK entries beside the
       largest tables that fit, at least MIN_PASS_SLOTS, each pass putting
       half a table's entries of the row in it; one row a block unless
       ``rows_per_cta`` asks for more, since fewer, larger tables mean
       fewer passes and so fewer probes.

    ``slots`` an int asks for that size: a power of two above ``width``
    (one pass) or of at least MIN_PASS_SLOTS (passes where a row is
    wider).  Raises ValueError only when the plan asked for cannot fit
    (or B's row lengths alone overflow)."""
    _check_gram_plan(rows_per_cta, slots, width)
    rows_tried = (rows_per_cta,) if rows_per_cta else ROWS_PER_CTA
    table = slots or table_slots(width)
    chunks = (max(width, 1), min(max(width, 1), CHUNK))
    for chunk in dict.fromkeys(chunks):
        for rows in rows_tried:
            blocks = -(-b // rows)
            used = gram_smem_bytes(gram_tables(b, blocks), table, chunk, b,
                                   itemsize)
            if used <= smem_optin:
                return GramPlan(blocks, table, chunk,
                                pass_cap(table, width), used)
    if slots is None:
        rows = rows_per_cta or 1
        blocks = -(-b // rows)
        tables = gram_tables(b, blocks)
        while table > MIN_PASS_SLOTS:
            table //= 2
            used = gram_smem_bytes(tables, table, chunks[1], b, itemsize)
            if used <= smem_optin:
                # half the table a pass, as the default tables hold
                cap = min(max(width, 1), table // 2 // 32 * 32)
                return GramPlan(blocks, table, chunks[1], cap, used)
    raise ValueError(f"the sparse Gram kernel cannot hold "
                     f"{rows_per_cta or 'auto'} tables of "
                     f"{slots or 'auto'} slots beside rows {width} wide "
                     f"({itemsize}-byte values) in {smem_optin} bytes of "
                     f"shared memory")


class ApplyPlan(NamedTuple):
    """The apply kernel's plan: ``slices`` blocks a shard (a power of
    two), slice t owning the columns t, t + slices, ... of its Delta-w, at
    most ``cols`` of them; entries staged ``chunk`` at a time; and a
    block's shared memory."""

    slices: int
    cols: int
    chunk: int
    smem: int


def apply_smem_bytes(cols: int, chunk: int, b: int, itemsize: int) -> int:
    """Shared memory of one apply block: the dw slice, the B coefficients,
    two staging buffers and the compacted list of ``chunk`` values; the B
    + 1 row offsets, two staging buffers and the list of ``chunk`` int32
    columns, the warps' counts; two staging buffers of ``chunk`` int16
    row ids; a byte a slice column, set where an entry reached it."""
    return (cols + b + 3 * chunk) * itemsize \
        + (b + 1 + 3 * chunk + APPLY_WARPS) * 4 + 2 * chunk * 2 + cols


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _check_slices(slices):
    if slices is not None and (isinstance(slices, bool)
                               or not isinstance(slices, int) or slices < 1
                               or slices & (slices - 1)):
        raise ValueError(f"slices must be a power of two or None (auto), "
                         f"got {slices!r}")


@functools.lru_cache(maxsize=None, typed=True)
def apply_plan(k: int, b: int, width: int, d: int, itemsize: int,
               smem_optin: int, sms: int, slices=None) -> ApplyPlan:
    """The apply kernel's plan (:class:`ApplyPlan`) for K = ``k`` shards
    of B = ``b`` rows of ``width`` slots into a (K, ``d``) Delta-w of
    ``itemsize``-byte values, under ``smem_optin`` bytes of shared memory
    a block on a card of ``sms`` SMs.  Each of the K S blocks reads all of
    its shard's live entries and keeps those of its slice, so S fills the
    card once: the largest power of two up to ``sms // k`` (at least 1, at
    most d), with the largest chunk of APPLY_CHUNKS beside which a slice
    of ceil(d / S) columns fits; where none does, S doubles until one
    does.  ``slices`` asks for that many (a power of two; at most the
    largest power of two up to d).  The row width does not enter the plan:
    rows stream through the chunks at any width.  Raises ValueError only
    when the asked slices cannot fit, or B's rows alone cannot (B above
    APPLY_MAX_B, or the narrowest slices with the smallest chunk over
    ``smem_optin``)."""
    _check_slices(slices)
    if not 1 <= b <= APPLY_MAX_B or k < 1 or d < 1 or width < 0:
        raise ValueError(f"the sparse apply kernel takes 1 <= B <= "
                         f"{APPLY_MAX_B}, K >= 1 and d >= 1, got B={b}, "
                         f"K={k}, d={d}")
    most = _pow2_floor(d)
    count = min(slices or _pow2_floor(sms // k), most)
    while True:
        cols = -(-d // count)
        for chunk in APPLY_CHUNKS:
            used = apply_smem_bytes(cols, chunk, b, itemsize)
            if used <= smem_optin:
                return ApplyPlan(count, cols, chunk, used)
        if slices is not None or count == most:
            raise ValueError(
                f"the sparse apply kernel cannot hold a slice of d={d} in "
                f"{slices or 'auto'} slices beside {b} rows' staging "
                f"({itemsize}-byte values) in {smem_optin} bytes of shared "
                f"memory")
        count *= 2


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
                      rows_per_cta=None, slots=None):
    """The block's Gram and margin base.  ``w`` (d,), ``dw`` (K, d) the
    Delta-w at the block's start.  Returns (gram, mb): gram (K, B, B) with
    row j holding x_i . x_j for i < j and zeros elsewhere (None in frozen
    mode), mb (K, B) = x_j . (w + sig_eff * dw_k) (x_j . w in frozen
    mode).  ``rows_per_cta`` and ``slots`` ask the kernel for that plan
    (None: :func:`gram_plan`'s auto rule); the plain version takes no
    plan, and both are checked on every device."""
    kernels.check_dtype(w.dtype, "the sparse block Gram kernel")
    _check_gram_plan(rows_per_cta, slots, gidx.shape[-1])
    if kernels.runs_plain(w.device):
        return sparse_block_gram_plain(w, dw, gidx, gvals, cnts, sig_eff,
                                       frozen)
    kernels.require_cuda(w, "sparse_block_gram")
    k, b, width = gidx.shape
    d, dt, dev = w.shape[0], w.dtype, w.device
    _check_rows(gidx, gvals, cnts, dt, dev)
    kernels.check_tensor("w", w, dt, (d,), dev)
    kernels.check_tensor("dw", dw, dt, (k, d), dev)
    plan = gram_plan(b, width, dt.itemsize, kernels.smem_optin(dev),
                     rows_per_cta, slots)
    lib = _library()
    gram = None if frozen else torch.empty(k, b, b, dtype=dt, device=dev)
    mb = torch.empty(k, b, dtype=dt, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, _GRAM_FN[dt])(
            w.data_ptr(), dw.data_ptr(), gidx.data_ptr(), gvals.data_ptr(),
            cnts.data_ptr(), None if gram is None else gram.data_ptr(),
            mb.data_ptr(), k, b, width, d, plan.blocks, plan.slots,
            plan.chunk, plan.cap, float(sig_eff), int(frozen),
            kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_block_gram")
    sparse_block_gram.launches += 1
    return gram, mb


kernels.count_launches(sparse_block_gram, "launches")


def sparse_block_apply_plain(dw, gidx, gvals, cnts, coefs):
    """The plain version: one scatter_add_ of coef * v over every slot,
    the padding adding 0.  On the CPU it adds each column's terms in
    (row, slot) order, the kernel's order."""
    k = gidx.shape[0]
    upd = coefs[..., None] * live_values(gvals, cnts)
    return dw.scatter_add_(1, gidx.long().reshape(k, -1), upd.reshape(k, -1))


def sparse_block_apply(dw, gidx, gvals, cnts, coefs, slices=None):
    """dw_k += sum_j coefs_kj * x_j over the block's nonzeros, in place;
    returns ``dw``.  Each column receives its adds in (row, slot) order,
    a strict left fold from dw's value, so the kernel equals the plain
    version run on the CPU bit for bit.  ``slices`` asks the kernel for
    that many column slices a shard (None: :func:`apply_plan`'s auto
    rule); the plain version takes no plan, and ``slices`` is checked on
    every device."""
    kernels.check_dtype(dw.dtype, "the sparse block apply kernel")
    _check_slices(slices)
    if kernels.runs_plain(dw.device):
        return sparse_block_apply_plain(dw, gidx, gvals, cnts, coefs)
    kernels.require_cuda(dw, "sparse_block_apply")
    k, b, width = gidx.shape
    d, dt, dev = dw.shape[1], dw.dtype, dw.device
    _check_rows(gidx, gvals, cnts, dt, dev)
    kernels.check_tensor("dw", dw, dt, (k, d), dev)
    kernels.check_tensor("coefs", coefs, dt, (k, b), dev)
    plan = apply_plan(k, b, width, d, dt.itemsize, kernels.smem_optin(dev),
                      kernels.sm_count(dev), slices)
    lib = _library()
    with torch.cuda.device(dev):
        rc = getattr(lib, _APPLY_FN[dt])(
            dw.data_ptr(), gidx.data_ptr(), gvals.data_ptr(), cnts.data_ptr(),
            coefs.data_ptr(), k, b, width, d, plan.slices, plan.cols,
            plan.chunk, kernels.stream_ptr(dev))
    kernels.raise_on_error(lib, rc, "sparse_block_apply")
    sparse_block_apply.launches += 1
    return dw


kernels.count_launches(sparse_block_apply, "launches")


def _check_rows(gidx, gvals, cnts, dt, dev):
    k, b, width = gidx.shape
    kernels.check_tensor("gidx", gidx, torch.int32, (k, b, width), dev)
    kernels.check_tensor("gvals", gvals, dt, (k, b, width), dev)
    kernels.check_tensor("cnts", cnts, torch.int32, (k, b), dev)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kernels.load("sparse_block")
    kernels.declare(lib, _GRAM_FN.values(), 7,
                    [ctypes.c_int] * 8 + [ctypes.c_double, ctypes.c_int])
    kernels.declare(lib, _APPLY_FN.values(), 5, [ctypes.c_int] * 7)
    return lib
