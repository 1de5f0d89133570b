"""The block-coordinate kernels' plain versions against the JAX Pallas
kernels in interpret mode, float64 on the CPU: the chain (B3), the fused
block (B4), the sparse Gram (B5) and the sparse apply (B6), with repeated
draws, a zero-norm row, masked tail steps and crafted CSR rows (a real
column 0 followed by padding, column 0 inside a row, a repeated column);
plus the wrappers' refusals and the TF32 pin."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.ops import pallas_chain, pallas_sparse  # noqa: E402
from cocoa_torch.ops import block_chain, sparse_block  # noqa: E402

TOL = 1e-12  # float64: the two packages sum in different orders
B = 128
LOSSES = [("hinge", 1.0), ("smooth_hinge", 0.5), ("logistic", 1.0)]
MODES = [("cocoa", 1.0, 1.0), ("plus", 4.0, 4.0), ("frozen", 0.0, 1.0)]
LAM_N = 0.96


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _eq_t(idx):
    """The JAX kernels' j-leading equality rows: eq[j, k, i] =
    (idx[k, i] == idx[k, j])."""
    return (idx.T[:, :, None] == idx[None, :, :]).astype(np.float64)


def _chain_inputs(seed, qf, k=3, pool=20, d=12, live_n=100):
    """A block of B draws from a pool of 20 rows per shard (so repeats are
    certain), row 3 of shard 0 all zeros and drawn repeatedly, steps past
    ``live_n`` masked.  Returns scal (K, 6, B), the full Gram (K, B, B)
    with row j holding x_i . x_j, and idx (K, B)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, pool, d))
    X[0, 3] = 0.0
    idx = rng.integers(0, pool, size=(k, B))
    idx[0, :6] = [3, 5, 3, 3, 7, 5]
    ks = np.arange(k)[:, None]
    xb = X[ks, idx]
    y = np.where(rng.random((k, pool)) > 0.5, 1.0, -1.0)[ks, idx]
    a0 = np.clip(rng.normal(0.4, 0.3, (k, pool)), 0, 1)[ks, idx]
    w = rng.normal(size=d) * 0.2
    dw = rng.normal(size=(k, d)) * 0.05
    scal = np.stack([xb @ w, y, (xb * xb).sum(-1) * qf, a0,
                     np.einsum("kbd,kd->kb", xb, dw),
                     np.broadcast_to((np.arange(B) < live_n) * 1.0, (k, B))],
                    axis=1)
    return scal, np.einsum("kjd,kid->kji", xb, xb), idx


@pytest.mark.parametrize("loss,smoothing", LOSSES)
@pytest.mark.parametrize("mode,sig_eff,qf", MODES)
def test_chain_matches_pallas(mode, sig_eff, qf, loss, smoothing):
    frozen = mode == "frozen"
    scal, gram, idx = _chain_inputs(1, qf)
    gq = _eq_t(idx) if frozen else np.concatenate(
        [gram.transpose(1, 0, 2), _eq_t(idx)], axis=1)
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=sig_eff, frozen=frozen,
              loss=loss, smoothing=smoothing)
    delta_j, coef_j = pallas_chain.chain_block_batched(
        jnp.asarray(scal), jnp.asarray(gq), interpret=True, **kw)
    launches = block_chain.chain_block_batched.launches
    delta, coef = block_chain.chain_block_batched(
        _t(scal), None if frozen else _t(gram), _t(idx, torch.int32), **kw)
    assert block_chain.chain_block_batched.launches == launches  # plain
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(coef.numpy(), np.asarray(coef_j), rtol=0,
                               atol=TOL)
    if loss == "hinge" and not frozen:
        # qii == 0 (the zero row, drawn first at step 0) gives alpha' = 1
        assert float(scal[0, 3, 0] + delta[0, 0]) == 1.0


def test_chain_reads_only_the_strict_triangle():
    """The full symmetric Gram (split branch) and its strict triangle
    (sparse branch) give the same chain, bit for bit."""
    scal, gram, idx = _chain_inputs(2, 4.0)
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=4.0, frozen=False,
              loss="hinge")
    full = block_chain.chain_block_batched(_t(scal), _t(gram),
                                           _t(idx, torch.int32), **kw)
    tri = block_chain.chain_block_batched(
        _t(scal), torch.tril(_t(gram), diagonal=-1), _t(idx, torch.int32),
        **kw)
    for a, b in zip(full, tri):
        assert torch.equal(a, b)


def _dyadic(rng, shape, scale):
    """Normal draws rounded to multiples of 1/scale."""
    return np.round(rng.normal(size=shape) * scale) / scale


@pytest.mark.parametrize("tile", ["dense", "densified_sparse"])
@pytest.mark.parametrize("mode,sig_eff,qf", MODES)
def test_fused_block_matches_pallas(mode, sig_eff, qf, tile):
    """The JAX fused kernel accumulates its products with
    ``preferred_element_type=float32`` even at float64, so the inputs are
    dyadic (rows in 1/8, v in 1/64, d=16): its margins and Gram are then
    exact, and delta is held to 1e-12.  Its dwu carries float32 rounding:
    the port's is held to it at 1e-6 and to the exact coef . xb at 1e-12."""
    frozen = mode == "frozen"
    rng = np.random.default_rng(3)
    k, d, pool = 2, 16, 24
    X = _dyadic(rng, (k, pool, d), 8)
    if tile == "densified_sparse":
        X *= rng.random((k, pool, d)) < 0.3
    X[1, 0] = 0.0                                   # a zero-norm row
    idx = rng.integers(0, pool, size=(k, B))
    idx[1, :4] = 0
    ks = np.arange(k)[:, None]
    xb = X[ks, idx]
    yb = np.where(rng.random((k, pool)) > 0.5, 1.0, -1.0)[ks, idx]
    qb = (xb * xb).sum(-1) * qf
    a0 = np.clip(rng.normal(0.4, 0.3, (k, pool)), 0, 1)[ks, idx]
    live = np.broadcast_to((np.arange(B) < 90) * 1.0, (k, B))
    v = _dyadic(rng, (k, d), 64) * 0.5
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=sig_eff, frozen=frozen,
              loss="hinge", smoothing=1.0)
    delta_j, dwu_j = pallas_chain.fused_block(
        *map(jnp.asarray, (xb, idx.astype(np.float64), yb, qb, a0, live, v)),
        interpret=True, **kw)
    delta, dwu = block_chain.fused_block(
        _t(xb), _t(idx, torch.int32), *map(_t, (yb, qb, a0, live, v)), **kw)
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(dwu.numpy(), np.asarray(dwu_j), rtol=1e-6,
                               atol=1e-9)
    coef = yb * delta.numpy() / LAM_N
    np.testing.assert_allclose(dwu.numpy(),
                               np.einsum("kb,kbd->kd", coef, xb), rtol=0,
                               atol=TOL)


def _crafted_rows(seed, k=2, d=30, width=8, live_n=100):
    """A block of CSR rows (K, B, width) with cnts the rows' lengths and -1
    on masked steps.  Shard 0's rows 0-3 are crafted: a real column 0
    followed by padding, column 0 inside a row, a repeated column, and an
    empty row; shard 1's last live rows repeat earlier ones."""
    rng = np.random.default_rng(seed)
    gidx = np.zeros((k, B, width), np.int32)
    gval = np.zeros((k, B, width))
    cnts = np.zeros((k, B), np.int32)
    for kk in range(k):
        for j in range(B):
            nnz = int(rng.integers(1, width + 1))
            gidx[kk, j, :nnz] = np.sort(rng.choice(d, nnz, replace=False))
            gval[kk, j, :nnz] = rng.normal(size=nnz)
            cnts[kk, j] = nnz
    crafted = ([(0, 0.9)], [(3, 0.2), (0, 0.5), (11, 0.1)],
               [(7, 0.3), (7, 0.2), (2, 0.6)], [])
    for j, slots in enumerate(crafted):
        gidx[0, j] = 0
        gval[0, j] = 0.0
        for t, (f, v) in enumerate(slots):
            gidx[0, j, t], gval[0, j, t] = f, v
        cnts[0, j] = len(slots)
    gidx[1, 90:95], gval[1, 90:95], cnts[1, 90:95] = \
        gidx[1, :5], gval[1, :5], cnts[1, :5]
    cnts[:, live_n:] = -1
    w = rng.normal(size=d) * 0.3
    dw = rng.normal(size=(k, d)) * 0.1
    coefs = rng.normal(size=(k, B)) * (np.arange(B) < live_n)
    return gidx, gval, cnts, w, dw, coefs


def _wd(w, dw):
    """The JAX kernels' lane-concatenated [w | dw] array."""
    k, d = dw.shape
    wd = pallas_sparse.wd_stack(jnp.asarray(w), k)
    pad = wd.shape[1] * 128 - d
    return wd.at[:, :, 128:].set(
        jnp.pad(jnp.asarray(dw), ((0, 0), (0, pad))).reshape(k, -1, 128))


@pytest.mark.parametrize("sig_eff,frozen", [(4.0, False), (1.0, True)])
def test_sparse_block_gram_matches_pallas(sig_eff, frozen):
    gidx, gval, cnts, w, dw, _ = _crafted_rows(5)
    gram_j, mb_j = pallas_sparse.sparse_block_gram(
        _wd(w, dw), jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(cnts),
        sig_eff=sig_eff, frozen=frozen, interpret=True)
    launches = sparse_block.sparse_block_gram.launches
    gram, mb = sparse_block.sparse_block_gram(
        _t(w), _t(dw), _t(gidx, torch.int32), _t(gval),
        _t(cnts, torch.int32), sig_eff, frozen)
    assert sparse_block.sparse_block_gram.launches == launches
    np.testing.assert_allclose(mb.numpy(), np.asarray(mb_j), rtol=0, atol=TOL)
    assert float(mb[:, 100:].abs().max()) == 0.0     # masked steps
    if frozen:
        assert gram is None and gram_j is None
        return
    # compare the strict triangle (row j, columns i < j) and nothing else
    np.testing.assert_allclose(gram.numpy(),
                               np.asarray(gram_j).transpose(1, 0, 2),
                               rtol=0, atol=TOL)
    g = gram.numpy()
    assert np.all(np.triu(g[0]) == 0)
    # column 0 inside row 1 meets the real column 0 of row 0; the
    # repeated column 7 of row 2 sums (0.3 + 0.2)
    assert g[0, 1, 0] == pytest.approx(0.9 * 0.5, abs=TOL)


def test_sparse_block_apply_matches_pallas():
    gidx, gval, cnts, w, dw, coefs = _crafted_rows(6)
    wd = pallas_sparse.sparse_block_apply(
        _wd(w, dw), jnp.asarray(gidx), jnp.asarray(gval), jnp.asarray(cnts),
        jnp.asarray(coefs), interpret=True)
    dw_j = np.asarray(pallas_sparse.wd_delta(wd, dw.shape[1]))
    launches = sparse_block.sparse_block_apply.launches
    out = _t(dw)
    res = sparse_block.sparse_block_apply(
        out, _t(gidx, torch.int32), _t(gval), _t(cnts, torch.int32),
        _t(coefs))
    assert res is out  # in place
    assert sparse_block.sparse_block_apply.launches == launches
    np.testing.assert_allclose(out.numpy(), dw_j, rtol=0, atol=TOL)


def test_wrappers_refuse_bf16_and_other_devices():
    scal, gram, idx = _chain_inputs(1, 1.0)
    kw = dict(lam_n=1.0, coef_div=1.0, sig_eff=1.0, frozen=False,
              loss="hinge")
    with pytest.raises(ValueError, match="float32 or float64"):
        block_chain.chain_block_batched(_t(scal, torch.bfloat16),
                                        _t(gram, torch.bfloat16),
                                        _t(idx, torch.int32), **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        block_chain.chain_block_batched(_t(scal).to("meta"),
                                        _t(gram).to("meta"),
                                        _t(idx, torch.int32), **kw)
    with pytest.raises(ValueError, match="needs the Gram"):
        block_chain.chain_block_batched(_t(scal), None, _t(idx, torch.int32),
                                        **kw)
    gidx, gval, cnts, w, dw, coefs = _crafted_rows(5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sparse_block.sparse_block_gram(
            _t(w).to("meta"), _t(dw).to("meta"), _t(gidx, torch.int32),
            _t(gval), _t(cnts, torch.int32), 1.0, False)
    with pytest.raises(ValueError, match="float32 or float64"):
        sparse_block.sparse_block_apply(
            _t(dw, torch.float16), _t(gidx, torch.int32), _t(gval),
            _t(cnts, torch.int32), _t(coefs))


def test_fused_fit_rule():
    """The fused kernel's (B, B) Gram lives in shared memory: B=128 fits in
    float32 and float64, B=256 in float32 does not (227 KB a block)."""
    assert block_chain.fused_smem_bytes(128, 4) == 86528
    assert block_chain.fused_fits(128, 4) and block_chain.fused_fits(128, 8)
    assert not block_chain.fused_fits(256, 4)


def test_fp32_matmul_turns_tf32_off_and_restores(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with block_chain.fp32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is True
