"""ProxCoCoA+ in the port against the JAX package, float64 on the CPU: the
column shards' unpadded contents, ``run_prox_cocoa`` on both math modes,
both column layouts and l2 in {0, 0.3} (atol 1e-9, as tests/test_prox.py
holds the JAX paths to each other), ``lasso_metrics`` (rtol 1e-9), and
``--objective=lasso`` through both CLIs (rtol 1e-9) with the JAX CLI's
refusals."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.libsvm import LibsvmData as JaxLibsvm  # noqa: E402
from cocoa_tpu.solvers import run_prox_cocoa as jax_run_prox  # noqa: E402
from cocoa_tpu.solvers.prox_cocoa import lasso_metrics as jax_metrics  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import lasso_metrics, \
    run_prox_cocoa  # noqa: E402

K = 4
RTOL = 1e-9
F64 = torch.float64
LASSO_ARGV = [f"--trainFile={SMALL_TRAIN}",
              f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
              "--numRounds=10", "--debugIter=5", "--localIterFrac=0.1",
              "--lambda=.1", "--objective=lasso", "--dtype=float64"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|Total Objective Value|"
    r"Duality Gap): (\S+)$", re.M)


def _problem(seed=0, n=48, d=26, density=1.0):
    """A Gaussian design with a planted sparse x*, as both packages'
    LibsvmData; ``density`` < 1 keeps that share of the entries (CSR
    without the zeros).  Returns (A, b, jax data, port data)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)) / np.sqrt(n)
    if density < 1.0:
        A *= rng.random((n, d)) < density
        A[0, :] = 0.5  # every column has a nonzero
    x_true = np.zeros(d)
    x_true[rng.choice(d, 5, replace=False)] = 3 * rng.normal(size=5)
    b = A @ x_true + 0.01 * rng.normal(size=n)
    rows, cols = np.nonzero(A)
    fields = dict(labels=b, indptr=np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int64),
        indices=cols.astype(np.int32), values=A[rows, cols], num_features=d)
    return A, b, JaxLibsvm(**fields), LibsvmData(**fields)


def _unpadded(x, counts):
    return np.concatenate([np.asarray(x[s])[:c] for s, c in enumerate(counts)])


@pytest.mark.parametrize("layout,density", [("dense", 1.0), ("sparse", 1.0),
                                            ("auto", 0.05)])
def test_shard_columns_matches_jax(layout, density):
    A, b, data_j, data_t = _problem(seed=1, n=120, density=density)
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout=layout)
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu", layout=layout)
    assert ds.layout == ds_j.layout
    assert ds.layout == ("sparse" if layout == "auto" else layout)
    assert (ds.n, ds.num_features) == (A.shape[1], A.shape[0])
    np.testing.assert_array_equal(ds.counts, ds_j.counts)
    n = A.shape[0]
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j)[:n])
    for f in ("labels", "mask", "sq_norms"):
        mine, ref = getattr(ds, f).numpy(), np.asarray(getattr(ds_j, f))
        for s, c in enumerate(ds.counts):
            np.testing.assert_array_equal(mine[s, :c], ref[s, :c])
            assert not mine[s, c:].any()  # padded columns are inert
    if ds.layout == "dense":
        X, X_j = ds.X.numpy(), np.asarray(ds_j.X)
        for s, c in enumerate(ds.counts):
            np.testing.assert_array_equal(X[s, :c], X_j[s, :c, :n])
        np.testing.assert_array_equal(_unpadded(X, ds.counts), A.T)
    else:
        for f in ("sp_indices", "sp_values"):
            mine, ref = getattr(ds, f).numpy(), np.asarray(getattr(ds_j, f))
            assert mine.shape[-1] == ref.shape[-1]  # the widest column
            for s, c in enumerate(ds.counts):
                np.testing.assert_array_equal(mine[s, :c], ref[s, :c])


def test_shard_columns_refuses_degenerate_csc():
    _, _, data_j, data_t = _problem(seed=8)
    with pytest.raises(ValueError):
        jax_columns(data_j, K, layout="sparse", max_col_nnz=2)
    with pytest.raises(ValueError, match="max_col_nnz=2"):
        shard_columns(data_t, K, device="cpu", layout="sparse", max_col_nnz=2)
    # auto picks a viable layout instead of refusing, in both packages
    _, _, data_j, data_t = _problem(seed=8, n=120, density=0.05)
    ds_j, _ = jax_columns(data_j, K, layout="auto", max_col_nnz=2)
    ds, _ = shard_columns(data_t, K, device="cpu", layout="auto",
                          max_col_nnz=2)
    assert ds.layout == ds_j.layout == "dense"


@pytest.mark.parametrize("l2", [0.0, 0.3])
@pytest.mark.parametrize("math,layout", [("exact", "dense"),
                                         ("fast", "dense"),
                                         ("exact", "sparse"),
                                         ("fast", "sparse")])
def test_run_prox_matches_jax(math, layout, l2):
    A, b, data_j, data_t = _problem(seed=2)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    kw = dict(n=A.shape[1], num_rounds=12, local_iters=8, lam=lam,
              smoothing=l2, loss="lasso")
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout=layout)
    x_j, r_j, traj_j = jax_run_prox(ds_j, b_j, JaxParams(**kw),
                                    JaxDebug(debug_iter=4, seed=3),
                                    quiet=True, math=math)
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                            layout=layout)
    x, r, traj = run_prox_cocoa(ds, b_t, Params(**kw),
                                DebugParams(debug_iter=4, seed=3),
                                quiet=True, math=math)
    assert traj.algorithm == traj_j.algorithm == "ProxCoCoA+"
    assert [t.round for t in traj.records] == \
        [t.round for t in traj_j.records] == [4, 8, 12]
    for a, c in zip(traj.records, traj_j.records):
        np.testing.assert_allclose([a.primal, a.gap], [c.primal, c.gap],
                                   rtol=RTOL)
        assert a.gap >= 0.0 and a.test_error is None
    np.testing.assert_allclose(_unpadded(x.numpy(), ds.counts),
                               _unpadded(x_j, ds_j.counts), rtol=0, atol=1e-9)
    n = A.shape[0]
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j)[:n], rtol=0,
                               atol=1e-9)
    # the residual is A x - b for the coordinates it carries
    np.testing.assert_allclose(r.numpy(),
                               A @ _unpadded(x.numpy(), ds.counts) - b,
                               atol=1e-10)


@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_lasso_metrics_matches_jax(l2):
    A, b, data_j, data_t = _problem(seed=4)
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout="dense")
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                            layout="dense")
    rng = np.random.default_rng(5)
    x_flat = rng.normal(size=A.shape[1]) * (rng.random(A.shape[1]) < 0.5)
    r = A @ x_flat - b
    x = np.zeros((K, ds.n_shard))
    x_j = np.zeros((K, ds_j.n_shard))
    lo = 0
    for s, c in enumerate(ds.counts):
        x[s, :c] = x_j[s, :c] = x_flat[lo:lo + c]
        lo += c
    r_j = np.zeros(ds_j.num_features)
    r_j[:len(r)] = r
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    ref = np.asarray(jax_metrics(jnp.asarray(r_j), jnp.asarray(x_j),
                                 ds_j.shard_arrays(), b_j, lam, l2))
    mine = lasso_metrics(torch.as_tensor(r), torch.as_tensor(x),
                         ds.shard_arrays(), b_t, lam, l2).numpy()
    np.testing.assert_allclose(mine[:2], ref[:2], rtol=RTOL)
    assert np.isnan(mine[2]) and mine[1] >= 0.0


@pytest.mark.parametrize("extra", [["--math=fast", "--l2=0.1"],
                                   ["--math=fast", "--layout=dense"]])
def test_cli_lasso_matches_jax(extra, capsys):
    """--objective=lasso through both CLIs on the demo: the sparse column
    layout (auto) runs the sparse round in prox mode, --layout=dense the
    dense one; the same round and summary numbers."""
    assert jax_cli.main(LASSO_ARGV + extra + ["--mesh=1"]) == 0
    ref = _NUMBER_LINE.findall(capsys.readouterr().out)
    rc, results = cli.run(LASSO_ARGV + extra + ["--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and [r.algorithm for r in results] == ["ProxCoCoA+"]
    assert "Running ProxCoCoA+ on 9947 data examples, distributed over 4 " \
        "workers" in out
    mine = _NUMBER_LINE.findall(out)
    assert [k for k, _ in mine] == [k for k, _ in ref]
    assert len(mine) == 2 * 2 + 2
    np.testing.assert_allclose([float(v) for _, v in mine],
                               [float(v) for _, v in ref], rtol=RTOL)
    gaps = [r.gap for r in results[0].trajectory.records]
    assert all(g >= 0 for g in gaps) and gaps[-1] < gaps[0]


@pytest.mark.parametrize("change", [[f"--testFile={SMALL_TEST}"],
                                    ["--l2=-0.5"], ["--l2=abc"],
                                    ["--objective=ridge"]])
def test_cli_lasso_refusals_match_jax(change, capsys):
    argv = LASSO_ARGV + change
    assert jax_cli.main(argv + ["--mesh=1"]) == 2
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(argv + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert err.strip() == ref and ref.startswith("error: --")
    assert "Running" not in out

