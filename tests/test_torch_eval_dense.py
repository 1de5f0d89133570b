"""``--evalDense``: the sparse layout's dense eval twin ``X_eval``, float64
on the CPU, mirroring tests/test_eval_dense.py.  The twin sits beside the
sparse arrays and changes none of them; the evals read it and agree with
the sparse evals and with JAX's twin evals within 1e-12; training never
reads it, so the trained state is the same bit for bit with and without
it, on the chunked and the device loop; the dense layout refuses it;
``eval_dense_fits`` decides as JAX's does where rounding the rows up to
16 changes the answer; and the CLI's ``evalDense=auto:`` line is the JAX
CLI's, fallback text included."""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.data import sharding as jax_sharding  # noqa: E402
from cocoa_tpu.evals import objectives as jax_obj  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import sharding  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.evals import objectives  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402

K, LAM, TOL = 4, 0.01, 1e-12
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
        "--numRounds=4", "--localIterFrac=0.1", "--lambda=.001",
        "--debugIter=2", "--math=fast", "--dtype=float64"]


def _port(data):
    return LibsvmData(labels=data.labels, indptr=data.indptr,
                      indices=data.indices, values=data.values,
                      num_features=data.num_features)


def _pair(data, **kw):
    mk = dict(k=K, layout="sparse", dtype=torch.float64, device="cpu", **kw)
    return (sharding.shard_dataset(_port(data), **mk),
            sharding.shard_dataset(_port(data), eval_dense=True, **mk))


@pytest.mark.parametrize("hot", [0, 8])
def test_twin_only_in_eval_arrays(tiny_data, hot):
    """The twin is the rows dense, JAX's twin on the real rows, and the
    sparse (or hybrid) training arrays are untouched."""
    plain, twin = _pair(tiny_data, hot_cols=hot)
    assert "X_eval" not in plain.shard_arrays()
    sa = twin.shard_arrays()
    assert sa["X_eval"].shape == (K, twin.n_shard, twin.num_features)
    for name, t in plain.shard_arrays().items():
        assert torch.equal(sa[name], t), name
    ref = jax_sharding.shard_dataset(tiny_data, k=K, layout="sparse",
                                     dtype=jnp.float64, eval_dense=True)
    np.testing.assert_array_equal(
        sa["X_eval"].numpy(),
        np.asarray(ref.shard_arrays()["X_eval"])[:, :twin.n_shard])


def test_eval_values_match_sparse_eval_and_jax(tiny_data):
    plain, twin = _pair(tiny_data)
    ref = jax_sharding.shard_dataset(tiny_data, k=K, layout="sparse",
                                     dtype=jnp.float64, eval_dense=True)
    rng = np.random.default_rng(5)
    w = rng.normal(size=tiny_data.num_features)
    alpha = rng.random((K, plain.n_shard)) * plain.mask.numpy()
    alpha_j = np.zeros((K, ref.n_shard))
    alpha_j[:, :plain.n_shard] = alpha
    w_t, a_t = torch.as_tensor(w), torch.as_tensor(alpha)
    for ds in (plain, twin):
        got = objectives.evaluate(ds, w_t, a_t, LAM, test_ds=ds)
        want = (jax_obj.primal_objective(ref, jnp.asarray(w), LAM),
                jax_obj.duality_gap(ref, jnp.asarray(w), jnp.asarray(alpha_j),
                                    LAM),
                jax_obj.classification_error(ref, jnp.asarray(w)))
        np.testing.assert_allclose(got, np.asarray(want, np.float64),
                                   rtol=TOL, atol=TOL)
        assert objectives.primal_objective(ds, w_t, LAM) == pytest.approx(
            float(want[0]), rel=TOL, abs=TOL)
        assert objectives.classification_error(ds, w_t) == float(want[2])


@pytest.mark.parametrize("device_loop", [False, True])
@pytest.mark.parametrize("math", ["exact", "fast"])
def test_training_state_bit_identical(tiny_data, math, device_loop):
    """Training never reads the twin: the trained (w, alpha) are the same
    bit for bit; the evals agree within float tolerance."""
    plain, twin = _pair(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=5, local_iters=8, lam=LAM)
    d = DebugParams(debug_iter=1, seed=0)
    kw = dict(plus=True, quiet=True, math=math, device_loop=device_loop)
    w_p, a_p, traj_p = run_cocoa(plain, p, d, test_ds=plain, **kw)
    w_t, a_t, traj_t = run_cocoa(twin, p, d, test_ds=twin, **kw)
    assert torch.equal(w_t, w_p) and torch.equal(a_t, a_p)
    assert len(traj_t.records) == len(traj_p.records) == 5
    for rp, rt in zip(traj_p.records, traj_t.records):
        np.testing.assert_allclose([rt.primal, rt.gap, rt.test_error],
                                   [rp.primal, rp.gap, rp.test_error],
                                   rtol=TOL, atol=TOL)


def test_distgd_training_bit_identical(tiny_data):
    plain, twin = _pair(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=3, local_iters=1, lam=LAM)
    d = DebugParams(debug_iter=3, seed=0)
    w_p, _ = run_dist_gd(plain, p, d, quiet=True)
    w_t, _ = run_dist_gd(twin, p, d, quiet=True)
    assert torch.equal(w_t, w_p)


def test_eval_dense_refused_off_the_sparse_layout(tiny_data):
    with pytest.raises(ValueError, match="sparse") as got:
        sharding.shard_dataset(_port(tiny_data), k=K, layout="dense",
                               eval_dense=True, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_sharding.shard_dataset(tiny_data, k=K, layout="dense",
                                   eval_dense=True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,d,k,budget", [
    (100, 10, 4, 4500),    # 25 rows a shard: 4000 B unrounded, 5120 rounded
    (100, 10, 4, 5120),    # exactly the rounded size
    (100, 10, 4, 5119),
    (2000, 9947, 4, sharding.EVAL_DENSE_HBM_BUDGET),   # the demo
    (20242, 47236, 8, sharding.EVAL_DENSE_HBM_BUDGET),  # rcv1-like
    (129, 7, 8, 17 * 7 * 8 * 4),  # 17 rows a shard: 17 unrounded, 32
])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_eval_dense_fits_matches_jax(n, d, k, budget, dt):
    got = sharding.eval_dense_fits(n, d, k, getattr(torch, dt), budget)
    assert got == jax_sharding.eval_dense_fits(n, d, k, getattr(jnp, dt),
                                               budget)
    assert sharding.EVAL_DENSE_HBM_BUDGET == \
        jax_sharding.EVAL_DENSE_HBM_BUDGET


def _auto_line(text):
    return [ln for ln in text.splitlines() if ln.startswith("evalDense=")]


@pytest.mark.parametrize("fits", [True, False])
@pytest.mark.parametrize("hot", [[], ["--hotCols=auto"]])
def test_cli_auto_line_matches_jax(capsys, fits, hot):
    """The ``evalDense=auto:`` line word for word, the twin's and both
    fallbacks' (the budget's answer forced for the second)."""
    argv = DEMO[:4] + ["--numRounds=2", "--debugIter=2", "--lambda=.001",
                       "--localIterFrac=0.1", "--justCoCoA=true",
                       "--evalDense=auto"] + hot
    with mock.patch.object(jax_sharding, "eval_dense_fits",
                           lambda *a, **kw: fits), \
            mock.patch.object(cli, "eval_dense_fits",
                              lambda *a, **kw: fits):
        assert jax_cli.main(argv + ["--mesh=1"]) == 0
        want = _auto_line(capsys.readouterr().out)
        assert cli.main(argv + ["--device=cpu"]) == 0
        got = _auto_line(capsys.readouterr().out)
    assert len(want) == 1 and got == want


def test_cli_twin_prints_the_sparse_evals(capsys):
    """``--evalDense`` through the CLI: the same rounds, every number
    within 1e-12 of the run without the twin (training bit for bit, the
    evals another product), and a non-sparse layout refused with JAX's
    message."""
    def numbers(text):
        return [float(ln.split(": ")[1]) for ln in text.splitlines()
                if ln.startswith(("primal", "test error", " Total",
                                  " Duality", " Test"))]
    runs = []
    for flag in ([], ["--evalDense"], ["--evalDense=true"]):
        code, res = cli.run(DEMO + ["--device=cpu"] + flag)
        assert code == 0
        runs.append((numbers(capsys.readouterr().out), res))
    for nums, res in runs[1:]:
        np.testing.assert_allclose(nums, runs[0][0], rtol=TOL, atol=TOL)
        for r, r0 in zip(res, runs[0][1]):
            assert torch.equal(r.w, r0.w) and torch.equal(r.alpha, r0.alpha)
    assert cli.main(DEMO + ["--device=cpu", "--evalDense",
                            "--layout=dense"]) == 2
    assert capsys.readouterr().err.strip() == (
        "error: eval_dense only applies to the sparse layout (the dense "
        "layout's eval is already a matvec)")
