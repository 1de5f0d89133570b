"""ProxCoCoA+ through the block round (``--objective=lasso --blockSize``)
in the port against the JAX package, float64 on the CPU:
``run_prox_cocoa(block_size=B)`` against JAX's on both column layouts at
l2 0 and 0.3 and B = 4 and 8, with a case whose blocks draw a coordinate
twice (x and r to atol 1e-9, the round records to rtol 1e-9, as
tests/test_torch_prox.py holds the sequential path); the port's block
round against its own sequential prox round (rtol 1e-9); the block
kernels' plain versions in mode prox with the lasso rule against the JAX
Pallas kernels in interpret mode (1e-12); and both CLIs with
``--objective=lasso --blockSize``."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.ops import pallas_chain, pallas_sparse  # noqa: E402
from cocoa_tpu.solvers import run_prox_cocoa as jax_run_prox  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.ops import block_chain, local_sdca, sparse_block  # noqa: E402
from cocoa_torch.ops.rows import row_lengths  # noqa: E402
from cocoa_torch.solvers import base  # noqa: E402
from cocoa_torch.solvers import cocoa as cocoa_mod  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402
from test_torch_block import _dyadic_block, _eq_t, _pallas_fused, \
    _port_args, _t, _wd  # noqa: E402
from test_torch_prox import _problem, _unpadded  # noqa: E402

K = 4
TOL, ATOL, RTOL = 1e-12, 1e-9, 1e-9
F64 = torch.float64
L2S = (0.0, 0.3)
LASSO_ARGV = [f"--trainFile={SMALL_TRAIN}",
              f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
              "--numRounds=10", "--debugIter=5", "--localIterFrac=0.1",
              "--lambda=.1", "--objective=lasso", "--dtype=float64",
              "--math=fast"]
_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|Total Objective Value|"
    r"Duality Gap): (\S+)$", re.M)


def _runs(layout, l2, block, h=8, rounds=12):
    """The same problem and draws through JAX's and the port's
    run_prox_cocoa at ``block`` (and the port's sequential round)."""
    A, b, data_j, data_t = _problem(seed=2)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    kw = dict(n=A.shape[1], num_rounds=rounds, local_iters=h, lam=lam,
              smoothing=l2, loss="lasso")
    dbg = dict(debug_iter=4, seed=3)
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout=layout)
    ref = jax_run_prox(ds_j, b_j, JaxParams(**kw), JaxDebug(**dbg),
                       quiet=True, math="fast", block_size=block)
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                            layout=layout)
    mine = run_prox_cocoa(ds, b_t, Params(**kw), DebugParams(**dbg),
                          quiet=True, math="fast", block_size=block)
    seq = run_prox_cocoa(ds, b_t, Params(**kw), DebugParams(**dbg),
                         quiet=True, math="fast")
    return A, b, ds, ds_j, mine, ref, seq


def _same_run(A, ds, ds_j, mine, ref):
    x, r, traj = mine
    x_j, r_j, traj_j = ref
    assert [t.round for t in traj.records] == \
        [t.round for t in traj_j.records]
    for a, c in zip(traj.records, traj_j.records):
        np.testing.assert_allclose([a.primal, a.gap], [c.primal, c.gap],
                                   rtol=RTOL)
        assert a.gap >= 0.0 and a.test_error is None
    np.testing.assert_allclose(_unpadded(x.numpy(), ds.counts),
                               _unpadded(np.asarray(x_j), ds_j.counts),
                               rtol=0, atol=ATOL)
    n = A.shape[0]
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j)[:n], rtol=0,
                               atol=ATOL)


def _repeats_in_blocks(ds, h, block, rounds, seed=3):
    """Whether any block of any round draws a coordinate twice."""
    sampler = base.IndexSampler("reference", seed, h, ds.counts)
    for t in range(1, rounds + 1):
        idx = sampler.round_indices(t).numpy()
        for start in range(0, h, block):
            blk = idx[:, start:start + block]
            if any(len(set(row)) < len(row) for row in blk):
                return True
    return False


@pytest.mark.parametrize("block", [4, 8])
@pytest.mark.parametrize("l2", L2S)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_block_prox_matches_jax(layout, l2, block):
    """run_prox_cocoa(block_size=B) against JAX's on the same columns and
    draws: fused (dense) or sparse-Gram (padded CSC) in the port, JAX's
    block path in its CPU form."""
    A, _, ds, ds_j, mine, ref, _ = _runs(layout, l2, block)
    assert cocoa_mod.block_route(layout, block, F64) == \
        ("fused" if layout == "dense" else "sparse_gram")
    _same_run(A, ds, ds_j, mine, ref)


@pytest.mark.parametrize("l2", L2S)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_block_prox_draws_a_coordinate_twice(layout, l2):
    """H = 24 draws from about 7 coordinates a shard, with replacement:
    blocks of 8 draw coordinates twice, and the chain reads the earlier
    occurrence's coordinate."""
    A, _, ds, ds_j, mine, ref, seq = _runs(layout, l2, 8, h=24, rounds=8)
    assert _repeats_in_blocks(ds, 24, 8, 8)
    _same_run(A, ds, ds_j, mine, ref)
    _same_run(A, ds, ds, mine, seq)


@pytest.mark.parametrize("l2", L2S)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_block_prox_matches_sequential(layout, l2):
    """The port's block round against its own sequential prox round: the
    same draws and the same math, regrouped."""
    A, _, ds, _, mine, _, seq = _runs(layout, l2, 4)
    for a, c in zip(mine[2].records, seq[2].records):
        np.testing.assert_allclose([a.primal, a.gap], [c.primal, c.gap],
                                   rtol=RTOL)
    _same_run(A, ds, ds, mine, seq)


@pytest.mark.parametrize("route", local_sdca.BLOCK_ROUTES)
def test_block_round_routes_in_prox_mode(route):
    """One round of local_sdca_block_batched in mode prox on every branch
    (the split branch on dense columns too) against the sequential prox
    round on the same draws: coordinate deltas and Delta-r."""
    layout = "sparse" if route == "sparse_gram" else "dense"
    A, b, _, data_t = _problem(seed=6)
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                            layout=layout)
    shards = ds.shard_arrays()
    rng = np.random.default_rng(7)
    r = torch.as_tensor(A @ (rng.normal(size=A.shape[1]) * 0.5) - b)
    x = torch.as_tensor(rng.normal(size=(K, ds.n_shard))) * shards["mask"]
    idxs = base.IndexSampler("reference", 5, 30, ds.counts).round_indices(1)
    for l2 in L2S:
        kw = dict(mode="prox", sigma=float(K), loss="lasso", smoothing=l2)
        got = local_sdca.local_sdca_block_batched(
            r, x, shards, idxs, 0.2, 1, block=8, route=route, **kw)
        want = local_sdca.local_sdca(r, x, shards, idxs, 0.2, 1, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=TOL)


# --------------------------------------------------------------------------
# the block kernels' plain versions in mode prox with the lasso rule
# --------------------------------------------------------------------------

LAM = 0.3      # the L1 weight: lam_n with n = 1
SIGMA = 4.0    # sigma' = K * gamma
B = 128


def _prox_chain_inputs(seed, k=3, pool=20, n=12, live_n=100):
    """A block of B draws of coordinates from a pool of 20 columns a
    shard (repeats certain), column 3 of shard 0 all zeros and drawn
    repeatedly (qii = 0), labels 1, unbounded coordinates, steps past
    ``live_n`` masked.  Returns scal (K, 6, B), the full Gram and idx."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, pool, n))
    X[0, 3] = 0.0
    idx = rng.integers(0, pool, size=(k, B))
    idx[0, :6] = [3, 5, 3, 3, 7, 5]
    ks = np.arange(k)[:, None]
    xb = X[ks, idx]
    a0 = rng.normal(0.0, 1.0, (k, pool))[ks, idx]
    r = rng.normal(size=n) * 0.5
    dr = rng.normal(size=(k, n)) * 0.05
    scal = np.stack([xb @ r, np.ones((k, B)), (xb * xb).sum(-1) * SIGMA, a0,
                     np.einsum("kbn,kn->kb", xb, dr),
                     np.broadcast_to((np.arange(B) < live_n) * 1.0, (k, B))],
                    axis=1)
    return scal, np.einsum("kjn,kin->kji", xb, xb), idx


def _lasso_kw(l2):
    return dict(lam_n=LAM, coef_div=1.0, sig_eff=SIGMA, frozen=False,
                loss="lasso", smoothing=l2)


@pytest.mark.parametrize("l2", L2S)
def test_chain_lasso_matches_pallas(l2):
    """B3's plain version with the lasso rule (soft-threshold, the
    elastic-net shrink, a zero column left as it is, repeated draws)
    against JAX's chain kernel in interpret mode."""
    scal, gram, idx = _prox_chain_inputs(1)
    gq = np.concatenate([gram.transpose(1, 0, 2), _eq_t(idx)], axis=1)
    kw = _lasso_kw(l2)
    delta_j, coef_j = pallas_chain.chain_block_batched(
        jnp.asarray(scal), jnp.asarray(gq), interpret=True, **kw)
    delta, coef = block_chain.chain_block_batched(
        _t(scal), _t(gram), _t(idx, torch.int32), **kw)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(coef.numpy(), np.asarray(coef_j), rtol=0,
                               atol=TOL)
    # the coefficient is the raw coordinate delta; the zero column at step
    # 0 keeps its coordinate under the lasso, and moves only by the shrink
    np.testing.assert_array_equal(coef.numpy(), delta.numpy())
    assert (float(delta[0, 0]) == 0.0) == (l2 == 0.0)
    assert float(delta.abs().max()) > 0.0
    assert bool((delta[:, 100:] == 0).all())              # masked steps


@pytest.mark.parametrize("l2", L2S)
def test_fused_lasso_matches_pallas(l2):
    """B4's plain version with the lasso rule against JAX's fused kernel
    in interpret mode, on dyadic columns (its float32 products exact):
    labels 1, unbounded coordinates, a zero column, repeats."""
    xb, idx, _, qb, a0, live, v = _dyadic_block(4, SIGMA)
    a0 = np.round(a0 * 8 - 3) / 8                      # signs either way
    block = (xb, idx, np.ones_like(qb), qb, a0, live, v)
    kw = _lasso_kw(l2)
    delta_j, dwu_j = _pallas_fused(block, **kw)
    delta, dwu = block_chain.fused_block(*_port_args(block), **kw)
    np.testing.assert_allclose(delta.numpy(), delta_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(dwu.numpy(), dwu_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        dwu.numpy(), np.einsum("kb,kbn->kn", delta.numpy(), xb), rtol=0,
        atol=TOL)
    assert float(delta.abs().max()) > 0.0


def _column_block(seed=6):
    """One block of B draws of a sparse design's padded-CSC columns (each
    "row" a column of A over the n examples) with the state of a prox
    round: r (n,) and a Delta-r (K, n); steps past 100 masked.  The slot
    axis is padded to a multiple of 32, as JAX's block round pads it for
    its kernels' trip counts (cocoa_tpu/ops/local_sdca.py)."""
    A, b, _, data_t = _problem(seed=seed, n=60, d=40, density=0.4)
    ds, _ = shard_columns(data_t, K, dtype=F64, device="cpu",
                          layout="sparse")
    idxs = base.IndexSampler("reference", seed, B, ds.counts) \
        .round_indices(1).long()
    ks = torch.arange(K)[:, None]
    live = torch.arange(B) < 100
    cnts = torch.where(live, row_lengths(ds.sp_values).gather(1, idxs), -1)
    rng = np.random.default_rng(seed)
    n, width = ds.num_features, ds.sp_indices.shape[-1]
    pad = ((0, 0), (0, 0), (0, -width % 32))
    assert width % 32 and pad[2][1]
    return (np.pad(ds.sp_indices[ks, idxs].numpy(), pad),
            np.pad(ds.sp_values[ks, idxs].numpy(), pad),
            cnts.to(torch.int32).numpy(), rng.normal(size=n) * 0.3,
            rng.normal(size=(K, n)) * 0.1, rng.normal(size=(K, B)) * 0.2)


def test_sparse_gram_on_columns_matches_pallas():
    """B5's plain version on padded-CSC columns (mode prox reads like
    plus: sig_eff = sigma') against JAX's kernel in interpret mode."""
    gidx, gval, cnts, r, dr, _ = _column_block()
    gram_j, mb_j = pallas_sparse.sparse_block_gram(
        _wd(r, dr), jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(cnts),
        sig_eff=SIGMA, frozen=False, interpret=True)
    gram, mb = sparse_block.sparse_block_gram(
        _t(r), _t(dr), _t(gidx, torch.int32), _t(gval),
        _t(cnts, torch.int32), SIGMA, False)
    np.testing.assert_allclose(mb.numpy(), np.asarray(mb_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(gram.numpy(),
                               np.asarray(gram_j).transpose(1, 0, 2),
                               rtol=0, atol=TOL)
    assert float(gram.abs().max()) > 0.0


def test_sparse_apply_on_columns_matches_pallas():
    """B6's plain version scattering into Delta-r (length n) against
    JAX's kernel in interpret mode."""
    gidx, gval, cnts, r, dr, coefs = _column_block(7)
    coefs[:, 100:] = 0.0
    wd = pallas_sparse.sparse_block_apply(
        _wd(r, dr), jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(cnts),
        jnp.asarray(coefs), interpret=True)
    dr_j = np.asarray(pallas_sparse.wd_delta(wd, dr.shape[1]))
    out = sparse_block.sparse_block_apply(
        _t(dr), _t(gidx, torch.int32), _t(gval), _t(cnts, torch.int32),
        _t(coefs))
    np.testing.assert_allclose(out.numpy(), dr_j, rtol=0, atol=TOL)


# --------------------------------------------------------------------------
# the two CLIs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block", ["4", "auto"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_cli_lasso_block_matches_jax(layout, block, capsys):
    """--objective=lasso --blockSize through both CLIs on the demo's
    columns: the same round and summary numbers, and with auto the same
    resolution line (the sequential path at float64, in both)."""
    argv = LASSO_ARGV + [f"--layout={layout}", f"--blockSize={block}"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 0
    ref_out = capsys.readouterr().out
    rc, results = cli.run(argv + ["--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and [r.algorithm for r in results] == ["ProxCoCoA+"]
    assert "Running ProxCoCoA+ on 9947 data examples, distributed over 4 " \
        "workers" in out
    auto = [ln for ln in out.splitlines() if ln.startswith("blockSize=auto")]
    assert auto == [ln for ln in ref_out.splitlines()
                    if ln.startswith("blockSize=auto")]
    assert auto == ([f"blockSize=auto: using the sequential path for the "
                     f"{layout} layout"] if block == "auto" else [])
    mine, ref = _LINE.findall(out), _LINE.findall(ref_out)
    assert [k for k, _ in mine] == [k for k, _ in ref]
    assert len(mine) == 2 * 2 + 2
    np.testing.assert_allclose([float(v) for _, v in mine],
                               [float(v) for _, v in ref], rtol=RTOL)
    gaps = [r.gap for r in results[0].trajectory.records]
    assert all(g >= 0 for g in gaps) and gaps[-1] < gaps[0]
