"""The rest of the reference's algorithm menu in the port against the JAX
package, float64 on the CPU: mini-batch CD (sequential on both math modes
and the block round), mini-batch and local SGD, and DistGD -- their
weights, duals and every debugIter trajectory record -- and the two CLIs
with ``--justCoCoA=false`` (all six algorithms, rtol 1e-9)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers import run_dist_gd as jax_dist_gd  # noqa: E402
from cocoa_tpu.solvers import run_minibatch_cd as jax_mbcd  # noqa: E402
from cocoa_tpu.solvers import run_sgd as jax_sgd  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402

RTOL = 1e-9  # float64; the packages sum in different orders
ATOL = 1e-12
MENU = ["CoCoA+", "CoCoA", "Mini-batch CD", "Mini-batch SGD", "Local SGD",
        "Dist SGD"]
DEMO_ARGV = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
             f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
             "--numRounds=10", "--debugIter=5", "--localIterFrac=0.1",
             "--lambda=.001", "--dtype=float64", "--justCoCoA=false"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


def _datasets(tiny_data, layout):
    def port(ds_j):
        arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
        return interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                          ds_j.num_features, device="cpu")
    ds_j = jax_shard(tiny_data, k=4, layout=layout, dtype=jnp.float64)
    test_j = jax_shard(tiny_data, k=3, layout=layout, dtype=jnp.float64)
    return ds_j, test_j, port(ds_j), port(test_j)


def _params(tiny_data, **kw):
    base = dict(n=tiny_data.n, num_rounds=8, local_iters=20, lam=0.01,
                beta=0.7)
    base.update(kw)
    return JaxParams(**base), Params(**base)


def _same_trajectory(traj, traj_j, primal_only):
    assert traj.algorithm == traj_j.algorithm
    assert [r.round for r in traj.records] == \
        [r.round for r in traj_j.records] == [4, 8]
    for a, b in zip(traj.records, traj_j.records):
        np.testing.assert_allclose([a.primal, a.test_error],
                                   [b.primal, b.test_error], rtol=RTOL)
        if primal_only:
            assert a.gap is None and b.gap is None
        else:
            np.testing.assert_allclose(a.gap, b.gap, rtol=RTOL)


@pytest.mark.parametrize("math,block,layout", [
    ("exact", 0, "dense"), ("fast", 0, "dense"), ("fast", 0, "sparse"),
    ("fast", 8, "dense"), ("fast", 8, "sparse")])
def test_minibatch_cd_matches_jax(tiny_data, math, block, layout):
    ds_j, test_j, ds, test = _datasets(tiny_data, layout)
    p_j, p = _params(tiny_data)
    w_j, a_j, traj_j = jax_mbcd(ds_j, p_j, JaxDebug(debug_iter=4, seed=2),
                                test_ds=test_j, quiet=True, math=math,
                                block_size=block)
    w, a, traj = run_minibatch_cd(ds, p, DebugParams(debug_iter=4, seed=2),
                                  test_ds=test, quiet=True, math=math,
                                  block_size=block)
    _same_trajectory(traj, traj_j, primal_only=False)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0, atol=ATOL)
    gaps = [r.gap for r in traj.records]
    assert all(g >= 0 for g in gaps) and gaps[-1] < gaps[0]


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("local", [True, False])
def test_sgd_matches_jax(tiny_data, local, layout):
    ds_j, test_j, ds, test = _datasets(tiny_data, layout)
    p_j, p = _params(tiny_data)
    w_j, traj_j = jax_sgd(ds_j, p_j, JaxDebug(debug_iter=4, seed=2),
                          local=local, test_ds=test_j, rng="jax", quiet=True)
    w, traj = run_sgd(ds, p, DebugParams(debug_iter=4, seed=2), local=local,
                      test_ds=test, rng="jax", quiet=True)
    _same_trajectory(traj, traj_j, primal_only=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_dist_gd_matches_jax(tiny_data, layout):
    ds_j, test_j, ds, test = _datasets(tiny_data, layout)
    p_j, p = _params(tiny_data)
    w_j, traj_j = jax_dist_gd(ds_j, p_j, JaxDebug(debug_iter=4, seed=2),
                              test_ds=test_j, quiet=True)
    w, traj = run_dist_gd(ds, p, DebugParams(debug_iter=4, seed=2),
                          test_ds=test, quiet=True)
    _same_trajectory(traj, traj_j, primal_only=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=ATOL)
    primals = [r.primal for r in traj.records]
    assert primals[-1] < primals[0]


@pytest.mark.parametrize("math", ["exact", "fast"])
def test_cli_menu_matches_jax(math, capsys):
    """--justCoCoA=false on the demo: both CLIs run the six algorithms in
    the same order and print the same round and summary numbers."""
    assert jax_cli.main(DEMO_ARGV + [f"--math={math}", "--mesh=1"]) == 0
    ref = _NUMBER_LINE.findall(capsys.readouterr().out)
    rc, results = cli.run(DEMO_ARGV + [f"--math={math}", "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and [r.algorithm for r in results] == MENU
    assert "Running SGD (with local updates = True) on 2000 data examples, " \
        "distributed over 4 workers" in out
    assert "Running DistGD on 2000 data examples" in out
    mine = _NUMBER_LINE.findall(out)
    assert [k for k, _ in mine] == [k for k, _ in ref]
    # two evals and a summary: 3 numbers each for the SDCA family, 2 for
    # the primal-only baselines
    assert len(mine) == 3 * 3 * 3 + 3 * 3 * 2
    np.testing.assert_allclose([float(v) for _, v in mine],
                               [float(v) for _, v in ref], rtol=RTOL)
    assert all(r.alpha is None for r in results[3:])
