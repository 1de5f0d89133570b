"""The port's inner loop against the JAX package, float64 on the CPU:
``alpha_step``, ``local_sdca`` / ``local_sdca_fast`` and the sparse SDCA
round's plain version, to 1e-12; plus the kernel wrapper's refusals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oracle  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca as jax_local_sdca  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_fast as jax_local_sdca_fast  # noqa: E402
from cocoa_tpu.ops import losses as jax_losses  # noqa: E402
from cocoa_tpu.ops.rows import shard_margins as jax_margins  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import interop  # noqa: E402
from cocoa_torch.ops import losses, sparse_sdca  # noqa: E402
from cocoa_torch.ops.local_sdca import local_sdca, local_sdca_fast  # noqa: E402
from cocoa_torch.ops.rows import shard_margins  # noqa: E402
from cocoa_torch.solvers.cocoa import fast_round_route  # noqa: E402

K, H, LAM = 4, 30, 0.01
MODES = [("cocoa", 1.0), ("plus", 4.0), ("frozen", 1.0)]
LOSSES = ["hinge", "smooth_hinge", "logistic"]
TOL = 1e-12  # float64: the two packages sum in different orders


def _setup(tiny_data, layout, seed=4):
    """The same shards, w, alpha and draws (with repeats) in both
    packages."""
    ds_j = jax_shard(tiny_data, k=K, layout=layout, dtype=jnp.float64)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    ds_t = interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                      ds_j.num_features, device="cpu")
    rng = np.random.default_rng(seed)
    w = rng.normal(size=ds_j.num_features) * 0.1
    alpha = np.clip(rng.normal(size=(K, ds_j.n_shard)) * 0.3 + 0.3, 0, 1) \
        * arrays["mask"]
    idxs = sample_indices_per_shard(6, range(1, 2), H, ds_j.counts)[:, 0, :]
    idxs[:, 1::3] = idxs[:, 0::3][:, :idxs[:, 1::3].shape[1]]
    w_t, alpha_t = interop.state_from_numpy(w, alpha, device="cpu")
    return ds_j, ds_t, w, alpha, idxs, w_t, alpha_t


def _jax_per_shard(fn, ds_j, alpha, idxs):
    """vmap a per-shard JAX local solver over the K shards."""
    return jax.vmap(fn)(jnp.asarray(alpha), ds_j.shard_arrays(),
                        jnp.asarray(idxs))


@pytest.mark.parametrize("loss", LOSSES)
def test_alpha_step_matches_jax(loss):
    rng = np.random.default_rng(1)
    n = 4000
    a = np.clip(rng.normal(0.5, 0.6, n), 0, 1)
    a[:50] = 0.0
    a[50:100] = 1.0
    z = rng.normal(0.8, 1.5, n)
    qii = np.abs(rng.normal(1.0, 1.0, n))
    qii[:10] = 0.0
    for lam_n, s in ((0.96, 1.0), (2.0, 0.3)):
        mine = losses.alpha_step(loss, *map(torch.as_tensor, (a, z, qii)),
                                 torch.tensor(lam_n, dtype=torch.float64),
                                 smoothing=s)
        ref = jax_losses.alpha_step(loss, *map(jnp.asarray, (a, z, qii)),
                                    lam_n, smoothing=s)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("loss", LOSSES)
def test_primal_dual_terms_match_jax(loss):
    rng = np.random.default_rng(2)
    z = rng.normal(0.5, 2.0, 500)
    a = np.clip(rng.normal(0.5, 0.5, 500), 0, 1)
    np.testing.assert_allclose(
        losses.primal(loss, torch.as_tensor(z), 0.7).numpy(),
        np.asarray(jax_losses.primal(loss, jnp.asarray(z), 0.7)), atol=TOL)
    np.testing.assert_allclose(
        losses.dual_term(loss, torch.as_tensor(a), 0.7).numpy(),
        np.asarray(jax_losses.dual_term(loss, jnp.asarray(a), 0.7)),
        atol=TOL)


@pytest.mark.parametrize("mode,sigma", MODES)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_local_sdca_matches_jax(tiny_data, mode, sigma, layout):
    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, layout)
    da_j, dw_j = _jax_per_shard(
        lambda a, sh, ix: jax_local_sdca(
            jnp.asarray(w), a, sh, ix, LAM, ds_j.n, mode=mode, sigma=sigma),
        ds_j, alpha, idxs)
    da, dw = local_sdca(w_t, alpha_t, ds_t.shard_arrays(),
                        torch.as_tensor(idxs), LAM, ds_j.n, mode=mode,
                        sigma=sigma)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_j), atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=TOL)


@pytest.mark.parametrize("mode,sigma", MODES)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_local_sdca_fast_matches_jax(tiny_data, mode, sigma, layout):
    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, layout)
    d = ds_j.num_features

    def jax_fast(a, sh, ix):
        return jax_local_sdca_fast(
            jax_margins(jnp.asarray(w), sh), a, sh, ix, LAM, ds_j.n,
            jnp.zeros(d, jnp.float64), mode=mode, sigma=sigma)

    da_j, dw_j = _jax_per_shard(jax_fast, ds_j, alpha, idxs)
    sa = ds_t.shard_arrays()
    da, dw = local_sdca_fast(shard_margins(w_t, sa), alpha_t, sa,
                             torch.as_tensor(idxs), LAM, ds_j.n,
                             torch.zeros(K, d, dtype=torch.float64),
                             mode=mode, sigma=sigma)
    np.testing.assert_allclose(da.numpy(), np.asarray(da_j), atol=TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=TOL)


@pytest.mark.parametrize("plus", [True, False])
def test_local_sdca_matches_oracle(tiny_data, plus):
    """The exact loop against the literal NumPy transcription of the
    reference's localSDCA (hinge)."""
    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, "dense")
    sigma = float(K) if plus else 1.0
    da, dw = local_sdca(w_t, alpha_t, ds_t.shard_arrays(),
                        torch.as_tensor(idxs), LAM, ds_j.n,
                        mode="plus" if plus else "cocoa", sigma=sigma)
    X = np.asarray(ds_j.X)
    y = np.asarray(ds_j.labels)
    for s in range(K):
        da_o, dw_o = oracle.local_sdca(X[s], y[s], w, alpha[s], idxs[s],
                                       LAM, ds_j.n, plus, sigma)
        np.testing.assert_allclose(da[s].numpy(), da_o, atol=TOL)
        np.testing.assert_allclose(dw[s].numpy(), dw_o, atol=TOL)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("mode,sigma", MODES)
def test_sparse_round_matches_jax(tiny_data, mode, sigma, loss):
    """The port's sparse round (the kernel's plain version on CPU tensors)
    against JAX ``local_sdca_fast`` on every shard."""
    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, "sparse")
    d = ds_j.num_features

    def jax_fast(a, sh, ix):
        return jax_local_sdca_fast(
            jax_margins(jnp.asarray(w), sh), a, sh, ix, LAM, ds_j.n,
            jnp.zeros(d, jnp.float64), mode=mode, sigma=sigma, loss=loss)

    da_j, dw_j = _jax_per_shard(jax_fast, ds_j, alpha, idxs)
    launches = sparse_sdca.sparse_sdca_round.launches
    dw, a_inner = sparse_sdca.sparse_sdca_round(
        w_t, alpha_t, ds_t.sp_indices, ds_t.sp_values, ds_t.labels,
        ds_t.sq_norms, torch.as_tensor(idxs), LAM, ds_j.n, mode=mode,
        sigma=sigma, loss=loss)
    assert sparse_sdca.sparse_sdca_round.launches == launches  # plain: no launch
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), atol=TOL)
    np.testing.assert_allclose((a_inner - alpha_t).numpy(),
                               np.asarray(da_j), atol=TOL)


def test_sparse_round_matches_pallas_interpret(tiny_data):
    """The TPU kernel itself, run in interpret mode, against the port's
    sparse round (CoCoA+, hinge)."""
    from cocoa_tpu.ops.pallas_sparse import pallas_sparse_sdca_round

    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, "sparse")
    dw_p, a_p = pallas_sparse_sdca_round(
        jnp.asarray(w), jnp.asarray(alpha), ds_j.sp_indices, ds_j.sp_values,
        ds_j.labels, ds_j.sq_norms, jnp.asarray(idxs), LAM, ds_j.n,
        mode="plus", sigma=4.0, interpret=True)
    dw, a_inner = sparse_sdca.sparse_sdca_round(
        w_t, alpha_t, ds_t.sp_indices, ds_t.sp_values, ds_t.labels,
        ds_t.sq_norms, torch.as_tensor(idxs), LAM, ds_j.n, mode="plus",
        sigma=4.0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_p), atol=TOL)
    np.testing.assert_allclose(a_inner.numpy(), np.asarray(a_p), atol=TOL)


def test_row_lengths_stop_at_the_last_nonzero():
    v = torch.tensor([[[0.5, 0.0, 0.3, 0.0, 0.0], [0.0] * 5,
                       [0.9, 0.0, 0.0, 0.0, 0.0]]])
    assert sparse_sdca.row_lengths(v).tolist() == [[3, 0, 1]]


def test_wrapper_refuses_bf16_and_other_devices(tiny_data):
    ds_j, ds_t, w, alpha, idxs, w_t, alpha_t = _setup(tiny_data, "sparse")
    args = (ds_t.sp_indices, ds_t.sp_values, ds_t.labels, ds_t.sq_norms,
            torch.as_tensor(idxs), LAM, ds_j.n)
    with pytest.raises(ValueError, match="float32 or float64"):
        sparse_sdca.sparse_sdca_round(w_t.bfloat16(), alpha_t.bfloat16(),
                                      *args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sparse_sdca.sparse_sdca_round(w_t.to("meta"), alpha_t.to("meta"),
                                      *args)


def test_fast_route():
    """The --math=fast dispatch: the kernel for CUDA tensors on either
    layout, the plain version for CPU tensors and for bf16 on every
    device (the dtype alone decides, as the JAX auto-select keeps 2-byte
    dtypes off its kernels), and a refusal for an unknown layout."""
    assert fast_round_route("sparse", "cuda", torch.float32) == "kernel"
    assert fast_round_route("sparse", "cuda:0", torch.float64) == "kernel"
    assert fast_round_route("sparse", "cpu", torch.float32) == "plain"
    assert fast_round_route("dense", "cpu", torch.float64) == "plain"
    assert fast_round_route("dense", "cuda", torch.float32) == "kernel"
    with pytest.raises(ValueError, match="layout"):
        fast_round_route("hybrid", "cuda", torch.float32)
    for layout, dev in (("sparse", "cuda"), ("dense", "cpu")):
        assert fast_round_route(layout, dev, torch.bfloat16) == "plain"
