"""Row access over the shard layouts (counterpart of cocoa_tpu/ops/rows.py,
dense, padded CSR and hybrid).

The JAX package reads one row of one shard per step and vmaps over the K
shards; here every accessor works on all K shards at once: a step picks
one row index per shard, ``idx`` of shape (K,), and the d-vectors it
touches are (K, d).  Padded CSR slots carry index 0 / value 0, so they
add exactly 0 to every dot and axpy.

On the hybrid layout (``--hotCols``, data/hybrid.py) a row also carries
its dense hot-panel slice, and the dot and axpy add the panel term at the
``hot_cols`` column ids.  Hot and cold columns are disjoint, so the
panel's scatter never meets the residual's; the panel's padding lanes
(column 0, value 0) add exactly 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Row(NamedTuple):
    """One row per shard, in whichever layout the shards use."""

    dense: Optional[torch.Tensor] = None   # (K, d)
    idx: Optional[torch.Tensor] = None     # (K, W) int64
    val: Optional[torch.Tensor] = None     # (K, W)
    hot: Optional[torch.Tensor] = None     # hybrid: (K, n_hot) panel values
    hot_cols: Optional[torch.Tensor] = None  # hybrid: (K, n_hot) int64


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (K, B) of each shard of ``t`` (K, n, m): (K, B, m).
    A gather, where ``t[ks, idx]`` would take PyTorch's general indexing
    path, which is slow on the CPU for a wide panel."""
    return t.gather(1, idx[:, :, None].expand(-1, -1, t.shape[-1]))


def get_row(shards: dict, idx: torch.Tensor) -> Row:
    """Row ``idx[k]`` of shard k for every k; ``idx`` is (K,) int64."""
    ks = torch.arange(idx.shape[0], device=idx.device)
    if "X" in shards:
        return Row(dense=shards["X"][ks, idx])
    hot = hot_cols = None
    if "X_hot" in shards:
        hot = gather_rows(shards["X_hot"], idx[:, None])[:, 0]
        hot_cols = shards["hot_cols"].long()
    return Row(idx=shards["sp_indices"][ks, idx].long(),
               val=shards["sp_values"][ks, idx], hot=hot, hot_cols=hot_cols)


def row_dot(row: Row, vec: torch.Tensor) -> torch.Tensor:
    """x_k . vec_k for every shard: (K,)."""
    if row.dense is not None:
        return (row.dense * vec).sum(-1)
    out = (vec.gather(1, row.idx) * row.val).sum(-1)
    if row.hot is not None:
        out = out + (vec.gather(1, row.hot_cols) * row.hot).sum(-1)
    return out


def row_axpy(row: Row, coef: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """vec_k += coef_k * x_k, in place (``vec`` is loop-local state)."""
    if row.dense is not None:
        return vec.add_(coef[:, None] * row.dense)
    # torchlint: allow=scatter-order -- a row's columns are distinct; its
    # padded slots add an exact 0 at column 0
    vec.scatter_add_(1, row.idx, coef[:, None] * row.val)
    if row.hot is not None:
        # torchlint: allow=scatter-order -- distinct hot columns
        vec.scatter_add_(1, row.hot_cols, coef[:, None] * row.hot)
    return vec


def row_lengths(sp_values: torch.Tensor) -> torch.Tensor:
    """(K, n_shard) int32: 1 + the last slot holding a nonzero value
    (interior explicit zeros count, trailing padding does not)."""
    w = sp_values.shape[-1]
    iota = torch.arange(1, w + 1, dtype=torch.int32, device=sp_values.device)
    return torch.where(sp_values != 0, iota, 0).amax(-1).to(torch.int32)


def shard_margins(w: torch.Tensor, shards: dict) -> torch.Tensor:
    """x_i . w for every row of every shard: (K, n_shard); on the hybrid
    layout the residual's gather-sum plus the panel's product with w at
    the hot columns."""
    if "X" in shards:
        return shards["X"] @ w
    m = (w[shards["sp_indices"].long()] * shards["sp_values"]).sum(-1)
    if "X_hot" in shards:
        w_hot = w[shards["hot_cols"].long()]              # (K, n_hot)
        m = m + torch.matmul(shards["X_hot"], w_hot[:, :, None])[..., 0]
    return m


def gather_dequant(w: torch.Tensor, idx: torch.Tensor,
                   form: str = "f32") -> torch.Tensor:
    """``w[idx]`` that understands the packed serving forms
    (serving/quantize.py; counterpart of cocoa_tpu/ops/rows.py
    ``gather_dequant``).  ``idx`` is int64.  The JAX package tells the
    forms apart by the model's dtype (uint32 bf16, int32 int8); here both
    packed forms are int32, so the form is named.

    - ``f32``: a plain gather, the same operation :func:`shard_margins`
      runs.
    - ``bf16``, two lanes a 32-bit word: word ``idx >> 1``, lane ``idx &
      1`` shifted down and masked (``>>`` on int32 is arithmetic), then
      shifted into the high half, whose bits viewed as float32 are the
      bf16 value exactly (the shift wraps; the bits are right).
    - ``int8``, four lanes a word: word ``idx >> 2``, lane ``idx & 3``
      shifted down, masked and sign-extended; the caller applies the
      model's scale once to the reduced margins.

    Padded query slots (index 0, value 0) read lane 0 and multiply it by
    0."""
    if form == "bf16":
        word = w[idx >> 1]
        lane = (word >> ((idx & 1) << 4).to(torch.int32)) & 0xFFFF
        return (lane << 16).view(torch.float32)
    if form == "int8":
        word = w[idx >> 2]
        lane = (word >> ((idx & 3) << 3).to(torch.int32)) & 0xFF
        return (lane - ((lane & 0x80) << 1)).to(torch.float32)
    return w[idx]


def serve_margins(w: torch.Tensor, shard: dict, scale=None,
                  form: str = "f32") -> torch.Tensor:
    """The serving twin of :func:`shard_margins` (counterpart of
    cocoa_tpu/ops/rows.py ``serve_margins``, plain torch as the JAX
    package leaves it to XLA): the margins of one padded batch, ``shard``
    holding ``sp_indices`` and ``sp_values`` of shape (bucket, max_nnz)
    and, on the hybrid layout, the panel ``X_hot`` (bucket, n_hot) and its
    ``hot_cols`` (n_hot,); every read of the model goes through
    :func:`gather_dequant`.  The batch is taken as one shard of
    :func:`shard_margins`' (K, n, ...) layout, so with an f32 model and
    no ``scale`` this runs the very operations of :func:`shard_margins` on
    that shard, and its margins are the same bit for bit.

    ``scale`` (int8's per-model scale) multiplies the reduced margins
    once; the panel term gathers the same quantized model, so both parts
    share it.

    A 2-D ``w`` (T, d) is a catalogue of T tenant models, and the shard
    carries a per-row ``tenant`` (bucket,): row r scores against
    ``w[tenant[r]]`` through one flat gather at ``tenant * d + idx``, the
    same values a single-model server gathers from that row of ``w``,
    reduced in the same order, so each tenant's margins are those of a
    server of that tenant alone, bit for bit.  Padded slots (tenant 0,
    index 0, value 0) add 0."""
    idx = shard["sp_indices"].long()
    if w.dim() == 2:
        idx = shard["tenant"].long()[:, None] * w.shape[1] + idx
        w = w.reshape(-1)
    m = (gather_dequant(w, idx[None], form) * shard["sp_values"][None]).sum(-1)
    if "X_hot" in shard:
        w_hot = gather_dequant(w, shard["hot_cols"].long()[None], form)
        m = m + torch.matmul(shard["X_hot"][None], w_hot[:, :, None])[..., 0]
    m = m[0]
    if scale is not None:
        m = m * float(scale)
    return m


def nonzero_slots(shards: dict):
    """The padded CSR slots that hold a nonzero, flattened once: (row over
    all K shards, column, value) of each, for :func:`shards_axpy`, which
    then scatters only these.  Each padding slot would add 0 at column 0:
    on the card an atomic add to one address per slot, ~9.6 M of them on
    rcv1-like shards.  None on the dense layout.  It reads the values'
    pattern on the host, so it is made once, outside any capture."""
    if "X" in shards:
        return None
    vals = shards["sp_values"].reshape(-1)
    pos = torch.nonzero(vals != 0).squeeze(1)
    return (pos // shards["sp_values"].shape[-1],
            shards["sp_indices"].reshape(-1)[pos].long(), vals[pos])


def _scatter_add(vec: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """``vec`` with ``vals`` added at ``cols``, each column's terms in slot
    order, as a new tensor: ``index_put`` with ``accumulate`` on the card
    (a sort, where ``index_add`` races atomics) and ``index_add`` on the
    CPU (a serial loop, where ``index_put`` with ``accumulate`` splits
    large scatters over threads that race)."""
    if vec.device.type == "cuda":
        # torchlint: allow=scatter-order -- the ordered fold: on the card
        # index_put with accumulate sorts the indices and sums each run in
        # slot order (deterministic)
        return vec.index_put((cols,), vals, accumulate=True)
    # torchlint: allow=scatter-order -- the CPU's index_add is a serial loop
    return vec.index_add(0, cols, vals)


def shards_axpy(coefs: torch.Tensor, shards: dict,
                vec: torch.Tensor, slots=None) -> torch.Tensor:
    """vec + sum over every row of every shard of coefs[k, i] * x_{k,i}: the
    transpose of :func:`shard_margins` (counterpart of
    cocoa_tpu/ops/rows.py ``shards_axpy``, plain torch as the JAX package
    leaves it to XLA).  The accelerated loop's secant jump advances w by
    it.  Padded slots add exactly 0; on the hybrid layout the panel
    scatters per shard at ``hot_cols`` (K, n_hot), disjoint from the
    residual's columns.  ``slots`` (:func:`nonzero_slots`) leaves the
    padding slots out of the scatter, the same sum.  The scatters
    accumulate each column's terms in slot order on every device
    (:func:`_scatter_add`), so a run is bit-reproducible.  Returns a new
    tensor."""
    if "X" in shards:
        return vec + torch.einsum("kn,knd->d", coefs, shards["X"])
    if slots is not None:
        rows, cols, vals = slots
        out = _scatter_add(vec, cols, coefs.reshape(-1)[rows] * vals)
    else:
        out = _scatter_add(vec, shards["sp_indices"].reshape(-1).long(),
                           (coefs[..., None]
                            * shards["sp_values"]).reshape(-1))
    if "X_hot" in shards:
        out = _scatter_add(out, shards["hot_cols"].reshape(-1).long(),
                           torch.einsum("kn,knh->kh", coefs,
                                        shards["X_hot"]).reshape(-1))
    return out


def eval_margins(w: torch.Tensor, shards: dict) -> torch.Tensor:
    """The evaluation's margins (counterpart of cocoa_tpu/ops/rows.py
    ``eval_margins``): one product with the dense eval twin ``X_eval``
    where the shards carry one (``--evalDense``), else
    :func:`shard_margins`.  Only the evals read the twin: training calls
    :func:`shard_margins`, so the trained (w, alpha) are the same bit for
    bit with and without it."""
    if "X_eval" in shards:
        return shards["X_eval"] @ w
    return shard_margins(w, shards)
