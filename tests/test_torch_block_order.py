"""The block round's alpha update in an order fixed by the block
(ops/local_sdca.py ``_block_alpha_add``), on the CPU.

The round adds each block's (K, B) alpha deltas into alpha once; a row
drawn twice or more in one block (reference draws sample with
replacement) gets several.  ``scatter_add_`` added them with atomics on
the card, in no fixed order, so two runs could differ in float32 bits;
the update now sums each row's deltas through a (K, B, B) index-equality
mask, one reduction of fixed shape, and writes alpha + total to every
slot of the row.  These tests hold the update to that sum, rows drawn
once to alpha + delta as ``scatter_add_`` gave them, and the rounds that
use it to themselves across calls and pipeline schedules on reference
draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.synth import synth_dense, synth_sparse  # noqa: E402
from cocoa_torch.ops import local_sdca as ls  # noqa: E402
from cocoa_torch.solvers.base import IndexSampler  # noqa: E402


def _block(dtype):
    """K=3 shards of 10 rows, a block of B=8 slots that draws row 4 of
    shard 0 three times and rows 1 and 7 of shard 2 twice each, with
    deltas of mixed magnitude, so the order of the adds shows in the
    float32 bits."""
    rng = np.random.default_rng(5)
    bidx = torch.tensor([[4, 0, 4, 2, 4, 9, 1, 3],
                         [0, 1, 2, 3, 4, 5, 6, 7],
                         [1, 7, 1, 7, 2, 0, 5, 9]])
    delta = torch.tensor(rng.standard_normal((3, 8))
                         * 10.0 ** rng.integers(-8, 1, (3, 8)), dtype=dtype)
    a = torch.tensor(rng.random((3, 10)), dtype=dtype)
    return a, bidx, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_alpha_add_sums_each_rows_deltas(dtype):
    a, bidx, delta = _block(dtype)
    got = a.clone()
    ls._block_alpha_add(got, bidx, delta)
    again = a.clone()
    ls._block_alpha_add(again, bidx, delta)
    assert torch.equal(again, got)
    old = a.clone().scatter_add_(1, bidx, delta)
    for k in range(3):
        for row in range(10):
            slots = [j for j in range(8) if bidx[k, j] == row]
            d = [delta[k, j] for j in slots]
            if not slots:
                assert got[k, row] == a[k, row]
            elif len(slots) == 1:
                assert got[k, row] == old[k, row] == a[k, row] + d[0]
            elif len(slots) == 2:
                assert got[k, row] == a[k, row] + (d[0] + d[1])
            else:
                # a fixed association of the three deltas, added once
                assert len(slots) == 3
                sums = {float(a[k, row] + x) for x in (
                    (d[0] + d[1]) + d[2], d[0] + (d[1] + d[2]),
                    (d[0] + d[2]) + d[1])}
                assert float(got[k, row]) in sums
    want = a.to(torch.float64).scatter_add_(1, bidx,
                                            delta.to(torch.float64))
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    assert torch.allclose(got.to(torch.float64), want, rtol=0, atol=tol)


def _reference_idxs(counts, h, t=3):
    return IndexSampler("reference", 0, h, counts).chunk_indices(t, 1)[0]


def _has_repeats(idxs, block):
    for k in range(idxs.shape[0]):
        for s in range(0, idxs.shape[1], block):
            blk = idxs[k, s:s + block]
            if blk.unique().numel() < blk.numel():
                return True
    return False


@pytest.mark.parametrize("route", ["fused", "split"])
def test_pipelined_equals_serial_on_reference_draws(route):
    ds = shard_dataset(synth_dense(240, 24, seed=3), k=3, layout="dense",
                       device="cpu")
    idxs = _reference_idxs(ds.counts, 60)
    assert _has_repeats(idxs, 16)
    w = torch.randn(24, generator=torch.Generator().manual_seed(1)) * 0.1
    alpha = torch.rand(3, ds.n_shard,
                       generator=torch.Generator().manual_seed(2)) \
        * ds.mask
    kw = dict(mode="plus", sigma=3.0, block=16, route=route)
    outs = [ls.local_sdca_block_batched(w, alpha, ds.shard_arrays(), idxs,
                                        1e-2, ds.n, pipeline=p, **kw)
            for p in (False, True, True, False)]
    for out in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(out, outs[0]))


def test_sparse_block_round_is_stable_on_reference_draws():
    ds = shard_dataset(synth_sparse(300, 500, nnz_mean=12, seed=4), k=3,
                       layout="sparse", device="cpu")
    idxs = _reference_idxs(ds.counts, 64)
    assert _has_repeats(idxs, 32)
    w = torch.zeros(500)
    alpha = torch.zeros(3, ds.n_shard)
    kw = dict(mode="plus", sigma=3.0, block=32, route="sparse_gram")
    shards = ds.shard_arrays()
    first = ls.local_sdca_block_batched(w, alpha, shards, idxs, 1e-3, ds.n,
                                        **kw)
    second = ls.local_sdca_block_batched(w, alpha, shards, idxs, 1e-3,
                                         ds.n, **kw)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    # a repeated row's alpha is its deltas added in slot order: the block
    # round against the sequential fast loop, in float64, to rounding
    ds64 = shard_dataset(synth_sparse(300, 500, nnz_mean=12, seed=4), k=3,
                         layout="sparse", dtype=torch.float64, device="cpu")
    da, dw = ls.local_sdca_block_batched(
        torch.zeros(500, dtype=torch.float64),
        torch.zeros(3, ds64.n_shard, dtype=torch.float64),
        ds64.shard_arrays(), idxs, 1e-3, ds64.n, **kw)
    m0 = torch.zeros(3, ds64.n_shard, dtype=torch.float64)
    da_s, dw_s = ls.local_sdca_fast(
        m0, torch.zeros(3, ds64.n_shard, dtype=torch.float64),
        ds64.shard_arrays(), idxs, 1e-3, ds64.n,
        torch.zeros(3, 500, dtype=torch.float64), mode="plus", sigma=3.0)
    assert torch.allclose(da, da_s, rtol=0, atol=1e-12)
    assert torch.allclose(dw, dw_s, rtol=0, atol=1e-12)
