"""DistGD's subgradient pass made order-stable (ops/subgradient.py), float64
on the CPU: the sparse pass adds each column's terms in slot order, bit
for bit as a serial loop over the slots does, with the nonzero-slot
list made by the pass or by its caller; the pass equals JAX's on the dense, sparse and hybrid
layouts within 1e-12; and two ``run_dist_gd`` runs are equal bit for bit
on the sparse and hybrid layouts, chunked and on the device loop, and
equal to JAX's DistGD within 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.ops.subgradient import subgradient_pass as jax_pass  # noqa: E402
from cocoa_tpu.solvers import run_dist_gd as jax_dist_gd  # noqa: E402
from cocoa_torch import interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.ops.rows import nonzero_slots  # noqa: E402
from cocoa_torch.ops.subgradient import subgradient_pass  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402

K, LAM, TOL = 4, 0.01, 1e-12
LAYOUTS = [("dense", 0), ("sparse", 0), ("sparse", 8)]


def _pair(data, layout, hot):
    ds_j = jax_shard(data, k=K, layout=layout, dtype=jnp.float64,
                     hot_cols=hot)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    return ds_j, interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                            ds_j.num_features, device="cpu")


def _w(d, seed=3):
    return np.random.default_rng(seed).normal(size=d) * 0.3


@pytest.mark.parametrize("layout,hot", LAYOUTS)
def test_pass_matches_jax(tiny_data, layout, hot):
    ds_j, ds_t = _pair(tiny_data, layout, hot)
    w = _w(ds_t.num_features)
    want = jax.vmap(lambda sh: jax_pass(jnp.asarray(w), sh, LAM))(
        ds_j.shard_arrays())
    sa = ds_t.shard_arrays()
    for slots in (None, nonzero_slots(sa)):
        got = subgradient_pass(torch.as_tensor(w), sa, LAM, slots=slots)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_sparse_scatter_in_slot_order(tiny_data):
    """The residual's X^T.coef as a serial loop over the slots in order
    (``np.add.at``, the padding slots' zeros included), bit for bit, with
    the nonzero-slot list made by the pass or by its caller."""
    _, ds_t = _pair(tiny_data, "sparse", 0)
    sa = ds_t.shard_arrays()
    d = ds_t.num_features
    w = torch.as_tensor(_w(d))
    ref = np.zeros(K * d)
    y = sa["labels"].numpy()
    z = y * (np.take(w.numpy(), sa["sp_indices"].numpy())
             * sa["sp_values"].numpy()).sum(-1)
    coef = y * np.where(z < 1.0, 1.0, 0.0)
    np.add.at(ref, (sa["sp_indices"].numpy()
                    + d * np.arange(K)[:, None, None]).reshape(-1),
              (sa["sp_values"].numpy() * coef[..., None]).reshape(-1))
    ref = ref.reshape(K, d) - LAM * w.numpy()
    for slots in (None, nonzero_slots(sa)):
        got = subgradient_pass(w, sa, LAM, slots=slots)
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("device_loop", [False, True])
@pytest.mark.parametrize("hot", [0, 8])
def test_run_dist_gd_bit_stable_and_matches_jax(tiny_data, hot,
                                                device_loop):
    ds_j, ds_t = _pair(tiny_data, "sparse", hot)
    p = Params(n=tiny_data.n, num_rounds=6, local_iters=1, lam=LAM)
    d = DebugParams(debug_iter=2, seed=0)
    runs = [run_dist_gd(ds_t, p, d, quiet=True, device_loop=device_loop)
            for _ in range(2)]
    (w0, t0), (w1, t1) = runs
    assert torch.equal(w0, w1)
    assert [(r.round, r.primal) for r in t0.records] == \
        [(r.round, r.primal) for r in t1.records]
    w_j, traj_j = jax_dist_gd(ds_j, JaxParams(n=tiny_data.n, num_rounds=6,
                                              local_iters=1, lam=LAM),
                              JaxDebug(debug_iter=2, seed=0), quiet=True)
    np.testing.assert_allclose(w0.numpy(), np.asarray(w_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose([r.primal for r in t0.records],
                               [r.primal for r in traj_j.records], rtol=TOL)
