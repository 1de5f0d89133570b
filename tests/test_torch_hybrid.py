"""The hybrid hot/cold layout (``--hotCols``) in the port against the JAX
package, float64 on the CPU: the resolver and the slabs (exactly equal),
the shards, the margins, the sparse SDCA round's plain version on hybrid
rows (every mode x loss, and against the JAX kernel's hot-panel branch in
interpret mode), the block round's sparse-Gram branch with the panel
terms, DistGD's subgradient and local SGD, both CLIs with ``--hotCols``,
and the CLI's refusals with the JAX CLI's messages."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.data import hybrid as jax_hybrid  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse as jax_synth_sparse  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_block_batched as jax_batched  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_fast as jax_fast  # noqa: E402
from cocoa_tpu.ops.local_sgd import local_sgd as jax_local_sgd  # noqa: E402
from cocoa_tpu.ops.pallas_sparse import pallas_sparse_sdca_round  # noqa: E402
from cocoa_tpu.ops.rows import eval_margins as jax_eval_margins  # noqa: E402
from cocoa_tpu.ops.rows import shard_margins as jax_margins  # noqa: E402
from cocoa_tpu.ops.subgradient import subgradient_pass as jax_subgrad  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.data import hybrid, shard_dataset  # noqa: E402
from cocoa_torch.data.synth import synth_sparse  # noqa: E402
from cocoa_torch.ops import local_sdca as ls  # noqa: E402
from cocoa_torch.ops import sparse_sdca  # noqa: E402
from cocoa_torch.ops.local_sgd import local_sgd  # noqa: E402
from cocoa_torch.ops.rows import eval_margins, shard_margins  # noqa: E402
from cocoa_torch.ops.subgradient import subgradient_pass  # noqa: E402

K, N_HOT, LAM, H = 4, 256, 0.01, 37
TOL = 1e-12   # float64: the two packages sum in different orders
RTOL = 1e-9   # the CLIs' round records
CASES = [(mode, sigma, loss, 1.0)
         for mode, sigma in (("cocoa", 1.0), ("plus", 4.0), ("frozen", 1.0))
         for loss in ("hinge", "smooth_hinge", "logistic")] \
    + [("prox", 4.0, "lasso", 0.0), ("prox", 4.0, "lasso", 0.3)]
DEMO_ARGV = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
             f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
             "--numRounds=10", "--localIterFrac=0.1", "--lambda=.001",
             "--debugIter=5", "--dtype=float64"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)
_HOT_LINE = re.compile(r"^hotCols=.*$", re.M)


@pytest.fixture(scope="module")
def zipf():
    """(the port's data, the JAX package's data): the same rcv1-like Zipf
    columns from one seed, at CI size."""
    return (synth_sparse(300, 800, nnz_mean=20, seed=3),
            jax_synth_sparse(300, 800, nnz_mean=20, seed=3))


def _port_ds(ds_j):
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    return interop.dataset_from_numpy(arrays, "sparse", ds_j.n,
                                      ds_j.num_features, device="cpu")


def _setup(data_j, k=K, n_hot=N_HOT, h=H, seed=4):
    """The JAX package's hybrid shards in both packages, with the same w,
    alpha and draws (every third draw repeats the one before it)."""
    ds_j = jax_shard(data_j, k=k, layout="sparse", dtype=jnp.float64,
                     hot_cols=n_hot)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=ds_j.num_features) * 0.1
    alpha = np.clip(rng.normal(size=(k, ds_j.n_shard)) * 0.3 + 0.3, 0, 1) \
        * np.asarray(ds_j.mask)
    idxs = sample_indices_per_shard(6, range(1, 2), h, ds_j.counts)[:, 0]
    idxs[:, 1::3] = idxs[:, 0::3][:, :idxs[:, 1::3].shape[1]]
    return ds_j, _port_ds(ds_j), w, alpha, np.ascontiguousarray(idxs)


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol)


# --------------------------------------------------------------------------
# the resolver and the layout
# --------------------------------------------------------------------------


def test_helpers_match_jax(zipf):
    data, data_j = zipf
    counts = hybrid.column_counts(data)
    np.testing.assert_array_equal(counts, jax_hybrid.column_counts(data_j))
    for n in (0, 1, 127, 128, 129, 300, 800, 5000):
        assert hybrid.pad_panel(n) == jax_hybrid.pad_panel(n)
        ids = hybrid.hottest_columns(counts, n)
        ids_j = jax_hybrid.hottest_columns(counts, n)
        assert ids.dtype == ids_j.dtype
        np.testing.assert_array_equal(ids, ids_j)
        np.testing.assert_array_equal(hybrid.hot_rank(800, ids),
                                      jax_hybrid.hot_rank(800, ids_j))
        assert hybrid.split_stats(data, ids) == \
            jax_hybrid.split_stats(data_j, ids_j)
    assert hybrid.panel_bytes(256, 4, 80, 8) == \
        jax_hybrid.panel_bytes(256, 4, 80, 8)
    for spec in (None, " Auto ", "OFF", 128, "0"):
        assert hybrid.normalize_spec(spec) == jax_hybrid.normalize_spec(spec)


@pytest.mark.parametrize("spec,budget", [
    ("auto", None), ("off", None), ("0", None), (None, None), ("100", None),
    ("256", None), ("5000", None), ("auto", 4 * 80 * 128 * 8),
    ("auto", 1024)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_resolve_matches_jax(zipf, spec, budget, dtype):
    """The width and the split record, exactly; a budget of one block of
    128 lanes clamps ``auto`` down, 1 KB turns it off."""
    data, data_j = zipf
    got = hybrid.resolve_hot_cols(spec, data, K, getattr(torch, dtype),
                                  budget=budget)
    want = jax_hybrid.resolve_hot_cols(spec, data_j, K,
                                       getattr(jnp, dtype), budget=budget)
    assert got == want
    counts = hybrid.column_counts(data)
    assert hybrid.resolve_hot_width(spec, counts, data.n, K, np.float64,
                                    budget=budget) == \
        jax_hybrid.resolve_hot_width(spec, counts, data_j.n, K, np.float64,
                                     budget=budget)


@pytest.mark.parametrize("spec,budget", [("256", 1024), ("garbage", None),
                                         ("-5", None)])
def test_resolve_refusals_match_jax(zipf, spec, budget):
    """An explicit width over the budget, and bad specs: the same error."""
    data, data_j = zipf
    with pytest.raises(ValueError) as mine:
        hybrid.resolve_hot_cols(spec, data, K, torch.float32, budget=budget)
    with pytest.raises(ValueError) as ref:
        jax_hybrid.resolve_hot_cols(spec, data_j, K, jnp.float32,
                                    budget=budget)
    assert str(mine.value) == str(ref.value)


def test_split_slab_matches_jax(zipf):
    data, data_j = zipf
    ids = hybrid.hottest_columns(hybrid.column_counts(data), N_HOT)
    rank = hybrid.hot_rank(800, ids)
    width = hybrid.split_stats(data, ids)["residual_max_nnz"]
    for lo, hi in ((0, 75), (75, 150), (290, 300)):
        got = hybrid.split_slab(data, lo, hi, 80, rank, N_HOT, width,
                                np.float64)
        want = jax_hybrid.split_slab(data_j, lo, hi, 80, rank, N_HOT, width,
                                     np.float64)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hot_cols", [100, N_HOT, 5000])
def test_shards_match_jax(zipf, hot_cols):
    """``shard_dataset(hot_cols=)`` against the JAX package's on the real
    rows: the same panel (lanes past the real hot count at column 0), the
    same residual at the same width."""
    data, data_j = zipf
    ds = shard_dataset(data, K, layout="sparse", dtype=torch.float64,
                       device="cpu", hot_cols=hot_cols)
    ds_j = jax_shard(data_j, k=K, layout="sparse", dtype=jnp.float64,
                     hot_cols=hot_cols)
    assert ds.n_hot == ds_j.n_hot == hybrid.pad_panel(min(hot_cols, 800))
    assert ds.sp_indices.shape[-1] == ds_j.sp_indices.shape[-1]
    m = ds.n_shard
    mine, ref = ds.shard_arrays(), ds_j.shard_arrays()
    assert set(mine) == set(ref)
    for f, v in ref.items():
        v = np.asarray(v)
        got = mine[f].numpy()
        if f == "hot_cols":
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, v)
        else:
            np.testing.assert_array_equal(got, v[:, :m])
            assert not v[:, m:].any()  # the JAX rows past the port's pad


def test_hot_cols_refuses_dense_layout(zipf):
    data, data_j = zipf
    with pytest.raises(ValueError) as mine:
        shard_dataset(data, K, layout="dense", device="cpu", hot_cols=128)
    with pytest.raises(ValueError) as ref:
        jax_shard(data_j, k=K, layout="dense", hot_cols=128)
    assert str(mine.value) == str(ref.value)


def test_margins_match_jax(zipf):
    ds_j, ds_t, w, _, _ = _setup(zipf[1])
    for port_fn, jax_fn in ((shard_margins, jax_margins),
                            (eval_margins, jax_eval_margins)):
        want = jax.vmap(lambda sh: jax_fn(jnp.asarray(w), sh))(
            ds_j.shard_arrays())
        _close([port_fn(torch.as_tensor(w), ds_t.shard_arrays())], [want])


# --------------------------------------------------------------------------
# the sequential round (B1's hot-panel branch, plain version)
# --------------------------------------------------------------------------


def _port_round(ds_t, w, alpha, idxs, mode, sigma, loss, s, n):
    launches = sparse_sdca.sparse_sdca_round.hybrid_launches
    out = sparse_sdca.sparse_sdca_round(
        torch.as_tensor(w), torch.as_tensor(alpha), ds_t.sp_indices,
        ds_t.sp_values, ds_t.labels, ds_t.sq_norms,
        torch.as_tensor(idxs, dtype=torch.int32), LAM, n, mode=mode,
        sigma=sigma, loss=loss, smoothing=s, hot_cols=ds_t.hot_cols,
        hot_panel=ds_t.X_hot)
    # a CPU tensor runs the plain version, not the kernel
    assert sparse_sdca.sparse_sdca_round.hybrid_launches == launches
    return out


@pytest.mark.parametrize("mode,sigma,loss,s", CASES)
def test_round_matches_jax_fast(zipf, mode, sigma, loss, s):
    """The hybrid round (its plain version on CPU tensors) against JAX
    ``local_sdca_fast`` over the same hybrid rows, per shard."""
    ds_j, ds_t, w, alpha, idxs = _setup(zipf[1])
    if mode == "prox":
        alpha = alpha - 0.3  # unbounded coordinates
    d, n = ds_j.num_features, ds_j.n

    def one(a, sh, ix):
        return jax_fast(jax_margins(jnp.asarray(w), sh), a, sh, ix, LAM, n,
                        jnp.zeros(d), mode=mode, sigma=sigma, loss=loss,
                        smoothing=s)

    da_j, dw_j = jax.vmap(one)(jnp.asarray(alpha), ds_j.shard_arrays(),
                               jnp.asarray(idxs))
    dw, a_inner = _port_round(ds_t, w, alpha, idxs, mode, sigma, loss, s, n)
    _close([dw, a_inner - torch.as_tensor(alpha)], [dw_j, da_j])


def test_round_matches_jax_kernel(zipf):
    """One tiny case against the JAX kernel's hot-panel branch in
    interpret mode (K=2, H=8, with repeats)."""
    ds_j, ds_t, w, alpha, idxs = _setup(zipf[1], k=2, n_hot=128, h=8)
    sa = ds_j.shard_arrays()
    dw_j, a_j = pallas_sparse_sdca_round(
        jnp.asarray(w), jnp.asarray(alpha), sa["sp_indices"],
        sa["sp_values"], sa["labels"], sa["sq_norms"], jnp.asarray(idxs),
        LAM, ds_j.n, mode="plus", sigma=2.0, interpret=True,
        hot_cols=sa["hot_cols"], hot_panel=sa["X_hot"])
    _close(_port_round(ds_t, w, alpha, idxs, "plus", 2.0, "hinge", 1.0,
                       ds_j.n), [dw_j, a_j])


def test_round_equals_unsplit(zipf):
    """The hybrid round equals the round on the unsplit rows of the same
    data (the split permutes each row's sums)."""
    data = zipf[0]
    plain = shard_dataset(data, K, layout="sparse", dtype=torch.float64,
                          device="cpu")
    hyb = shard_dataset(data, K, layout="sparse", dtype=torch.float64,
                        device="cpu", hot_cols=N_HOT)
    _, _, w, alpha, idxs = _setup(zipf[1])
    alpha = alpha[:, :plain.n_shard]
    args = (torch.as_tensor(w), torch.as_tensor(alpha))
    kw = dict(mode="plus", sigma=4.0)
    ix = torch.as_tensor(idxs, dtype=torch.int32)
    want = sparse_sdca.sparse_sdca_round(
        *args, plain.sp_indices, plain.sp_values, plain.labels,
        plain.sq_norms, ix, LAM, data.n, **kw)
    got = sparse_sdca.sparse_sdca_round(
        *args, hyb.sp_indices, hyb.sp_values, hyb.labels, hyb.sq_norms, ix,
        LAM, data.n, hot_cols=hyb.hot_cols, hot_panel=hyb.X_hot, **kw)
    _close(got, want)


def test_round_refuses_half_a_panel(zipf):
    ds_j, ds_t, w, alpha, idxs = _setup(zipf[1])
    with pytest.raises(ValueError, match="together"):
        sparse_sdca.sparse_sdca_round(
            torch.as_tensor(w), torch.as_tensor(alpha), ds_t.sp_indices,
            ds_t.sp_values, ds_t.labels, ds_t.sq_norms,
            torch.as_tensor(idxs, dtype=torch.int32), LAM, ds_j.n,
            hot_panel=ds_t.X_hot)


# --------------------------------------------------------------------------
# the block round's hybrid branch, the exact loop and the baselines
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode,sigma", [("plus", 4.0), ("frozen", 1.0)])
def test_block_sparse_gram_matches_jax(zipf, mode, sigma):
    """``route="sparse_gram"`` on hybrid shards against JAX's
    ``sparse_gram=True`` hybrid branch (its kernels in interpret mode):
    H=150, two blocks of 128 with a masked tail."""
    ds_j, ds_t, w, alpha, idxs = _setup(zipf[1], k=2, n_hot=128, h=150)
    want = jax_batched(jnp.asarray(w), jnp.asarray(alpha),
                       ds_j.shard_arrays(), jnp.asarray(idxs), LAM, ds_j.n,
                       mode=mode, sigma=sigma, block=128, interpret=True,
                       sparse_gram=True)
    got = ls.local_sdca_block_batched(
        torch.as_tensor(w), torch.as_tensor(alpha), ds_t.shard_arrays(),
        torch.as_tensor(idxs), LAM, ds_j.n, mode=mode, sigma=sigma,
        block=128, route="sparse_gram")
    _close(got, want)


@pytest.mark.parametrize("mode,sigma", [("cocoa", 1.0), ("plus", 4.0)])
def test_exact_and_portable_block_on_hybrid_rows(zipf, mode, sigma):
    """The exact loop and the portable block form (``dense_rows`` with the
    panel) on hybrid rows against the JAX package's exact loop."""
    from cocoa_tpu.ops.local_sdca import local_sdca as jax_exact

    ds_j, ds_t, w, alpha, idxs = _setup(zipf[1])
    want = jax.vmap(lambda a, sh, ix: jax_exact(
        jnp.asarray(w), a, sh, ix, LAM, ds_j.n, mode=mode, sigma=sigma))(
        jnp.asarray(alpha), ds_j.shard_arrays(), jnp.asarray(idxs))
    sa = ds_t.shard_arrays()
    w_t, a_t, ix = map(torch.as_tensor, (w, alpha, idxs))
    _close(ls.local_sdca(w_t, a_t, sa, ix, LAM, ds_j.n, mode=mode,
                         sigma=sigma), want)
    if mode == "plus":
        _close(ls.local_sdca_block(
            shard_margins(w_t, sa), a_t, sa, ix, LAM, ds_j.n,
            torch.zeros(K, w.shape[0], dtype=torch.float64), mode=mode,
            sigma=sigma, block=16), want)


def test_subgradient_matches_jax(zipf):
    ds_j, ds_t, w, _, _ = _setup(zipf[1])
    want = jax.vmap(lambda sh: jax_subgrad(jnp.asarray(w), sh, LAM))(
        ds_j.shard_arrays())
    _close([subgradient_pass(torch.as_tensor(w), ds_t.shard_arrays(), LAM)],
           [want])


@pytest.mark.parametrize("local", [True, False])
def test_local_sgd_matches_jax(zipf, local):
    ds_j, ds_t, w, _, idxs = _setup(zipf[1])
    want = jax.vmap(lambda sh, ix: jax_local_sgd(
        jnp.asarray(w), sh, ix, LAM, 40, local))(
        ds_j.shard_arrays(), jnp.asarray(idxs))
    got = local_sgd(torch.as_tensor(w), ds_t.shard_arrays(),
                    torch.as_tensor(idxs), LAM, 40, local)
    _close([got], [want])


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _numbers(out):
    return [float(v) for _, v in _NUMBER_LINE.findall(out)]


@pytest.mark.parametrize("spec", ["auto", "300"])
@pytest.mark.parametrize("math", ["exact", "fast"])
def test_cli_matches_jax(math, spec, capsys):
    """Both CLIs with ``--hotCols`` on the demo: the same resolution line
    and the same round and summary numbers."""
    argv = DEMO_ARGV + [f"--math={math}", f"--hotCols={spec}"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 0
    ref = capsys.readouterr().out
    rc, results = cli.run(argv + ["--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and [r.algorithm for r in results] == ["CoCoA+", "CoCoA"]
    assert _HOT_LINE.findall(out) == _HOT_LINE.findall(ref)
    assert len(_HOT_LINE.findall(out)) == 1
    mine, want = _numbers(out), _numbers(ref)
    assert len(mine) == len(want) == 2 * 3 * 3
    np.testing.assert_allclose(mine, want, rtol=RTOL)


def test_cli_hot_cols_off_is_the_plain_layout(capsys):
    """``--hotCols=off`` gives bit for bit the run without the flag."""
    base = DEMO_ARGV + ["--math=fast", "--device=cpu"]
    rc, plain = cli.run(base)
    rc_off, off = cli.run(base + ["--hotCols=off"])
    assert rc == rc_off == 0
    assert "hotCols=" not in capsys.readouterr().out
    for a, b in zip(plain, off):
        assert torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha)
        assert [(r.primal, r.gap, r.test_error) for r in a.trajectory.records] \
            == [(r.primal, r.gap, r.test_error) for r in b.trajectory.records]


@pytest.mark.parametrize("extra", [
    ["--layout=dense", "--hotCols=auto"],
    ["--objective=lasso", "--hotCols=auto"],
    ["--hotCols=garbage"],
    ["--hotCols=-3"],
    ["--hotCols=9000"]])
def test_cli_refusals_match_jax(extra, capsys, monkeypatch):
    """Each refusal exits 2 with the JAX CLI's message; the budget is cut
    to 1 MiB in both packages, so 9000 columns are over it."""
    monkeypatch.setattr(jax_hybrid, "HOT_PANEL_HBM_BUDGET", 1 << 20)
    monkeypatch.setattr(hybrid, "HOT_PANEL_HBM_BUDGET", 1 << 20)
    argv = [f"--trainFile={SMALL_TRAIN}",
            f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
            "--numRounds=2", "--dtype=float64"] + extra
    assert jax_cli.main(argv + ["--mesh=1"]) == 2
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    rc, _ = cli.run(argv + ["--device=cpu"])
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert rc == 2 and ref.startswith("error: ") and err == ref
