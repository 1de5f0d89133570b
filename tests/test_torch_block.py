"""The block-coordinate kernels' plain versions against the JAX Pallas
kernels in interpret mode, float64 on the CPU: the chain (B3), the fused
block (B4), the sparse Gram (B5) and the sparse apply (B6), with repeated
draws, a zero-norm row, masked tail steps and crafted CSR rows (a real
column 0 followed by padding, column 0 inside a row, a repeated column);
plus the wrappers' refusals and the TF32 pin."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.ops import pallas_chain, pallas_sparse  # noqa: E402
from cocoa_torch import interop, kernels  # noqa: E402
from cocoa_torch.ops import block_chain, local_sdca, sparse_block  # noqa: E402

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


def _dyadic_block(seed, qf, d=16, sparse=False, k=2, pool=24):
    """A fused block of B draws from a pool of 24 dyadic rows per shard
    (rows in 1/8, v in 1/64: their products are exact in float32), row 0
    of shard 1 all zeros and drawn first, steps past 90 masked.  Returns
    (xb, idx, yb, qb, a0, live, v) as numpy arrays."""
    rng = np.random.default_rng(seed)
    X = _dyadic(rng, (k, pool, d), 8)
    if sparse:
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
    return xb, idx, yb, qb, a0, live, v


def _pallas_fused(block, **kw):
    xb, idx, yb, qb, a0, live, v = block
    delta, dwu = pallas_chain.fused_block(
        *map(jnp.asarray, (xb, idx.astype(np.float64), yb, qb, a0, live, v)),
        interpret=True, **kw)
    return np.asarray(delta), np.asarray(dwu)


def _port_args(block):
    xb, idx, yb, qb, a0, live, v = block
    return (_t(xb), _t(idx, torch.int32), *map(_t, (yb, qb, a0, live, v)))


@pytest.mark.parametrize("tile", ["dense", "densified_sparse"])
@pytest.mark.parametrize("mode,sig_eff,qf", MODES)
def test_fused_block_matches_pallas(mode, sig_eff, qf, tile):
    """The JAX fused kernel accumulates its products with
    ``preferred_element_type=float32`` even at float64, so the inputs are
    dyadic (rows in 1/8, v in 1/64, d=16): its margins and Gram are then
    exact, and delta is held to 1e-12.  Its dwu carries float32 rounding:
    the port's is held to it at 1e-6 and to the exact coef . xb at 1e-12."""
    frozen = mode == "frozen"
    block = _dyadic_block(3, qf, sparse=tile == "densified_sparse")
    xb, yb = block[0], block[2]
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=sig_eff, frozen=frozen,
              loss="hinge", smoothing=1.0)
    delta_j, dwu_j = _pallas_fused(block, **kw)
    delta, dwu = block_chain.fused_block(*_port_args(block), **kw)
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


# the fused kernel's plan (csrc/block_chain.cu): B x d at the block
# configurations' shapes, B not a multiple of the 64-row tile, d no slice
# width divides, and d narrower than one slice unit
PLAN_SHAPES = [(128, 2000), (128, 1000), (100, 2000), (128, 9947),
               (128, 200), (128, 16), (128, 33), (64, 2000), (150, 100)]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("b,d", PLAN_SHAPES)
def test_fused_plan_slices_cover_d(b, d, itemsize):
    """Every plan, auto or asked, splits d into C non-empty contiguous
    slices that end at d, each a multiple of SLICE_UNIT columns but the
    last, with C <= MAX_CLUSTER and every block's shared memory within the
    opt-in; an asked C is kept or refused, never changed; the auto C is
    AUTO_CLUSTER, or fewer where AUTO_CLUSTER would leave a block without
    columns."""
    unit = block_chain.SLICE_UNIT
    for asked in (None, *range(1, block_chain.MAX_CLUSTER + 1)):
        try:
            c, width = block_chain.fused_plan(b, d, itemsize, asked)
        except ValueError as err:
            assert asked is not None and "without columns" in str(err)
            w = -(-(-(-d // asked)) // unit) * unit
            assert (asked - 1) * w >= d
            continue
        assert 1 <= c <= block_chain.MAX_CLUSTER
        assert asked is None or c == asked
        edges = [min(d, r * width) for r in range(c + 1)]
        assert edges[0] == 0 and edges[-1] == d
        assert all(lo < hi for lo, hi in zip(edges, edges[1:]))
        assert c == 1 and width == d or width % unit == 0
        assert block_chain.fused_smem_bytes(b, itemsize) \
            <= block_chain.SMEM_OPTIN
        if asked is None and c != block_chain.AUTO_CLUSTER:
            assert c < block_chain.AUTO_CLUSTER
            with pytest.raises(ValueError, match="without columns"):
                block_chain.fused_plan(b, d, itemsize,
                                       block_chain.AUTO_CLUSTER)


def test_fused_plan_at_main_shapes_and_refusals():
    plan = block_chain.fused_plan
    # the epsilon-like block: 8 blocks of 256 columns, the last 208
    assert plan(128, 2000, 4) == (8, 256)
    assert plan(128, 2000, 8) == (8, 256)
    assert plan(128, 1000, 4) == (8, 128)
    assert plan(128, 2000, 4, 1) == (1, 2000)
    assert plan(128, 2000, 4, 16) == (16, 128)
    # the auto C drops to what d allows
    assert plan(128, 16, 8) == (1, 16)
    assert plan(128, 100, 8) == (4, 32)
    with pytest.raises(ValueError, match="without columns"):
        plan(128, 16, 8, 2)
    with pytest.raises(ValueError, match="shared memory"):
        plan(256, 2000, 4)
    for bad in (0, 17, -1, 2.0, True):
        with pytest.raises(ValueError, match="cluster must be an int"):
            plan(128, 2000, 4, bad)


def test_fused_plan_matches_the_kernel():
    """The plan's constants and rules are the kernel's, read from the
    source: the slice unit, the cluster limit, the plan check, and three
    cluster barriers (partials, sums, coefficients)."""
    src = kernels.SOURCES["block_chain"].read_text()
    assert f"kDk = {block_chain.SLICE_UNIT};" in src
    assert f"kMaxCluster = {block_chain.MAX_CLUSTER};" in src
    assert "if (cluster > 1 && sw % kDk != 0) return false;" in src
    assert ("return (long long)(cluster - 1) * sw < d && "
            "(long long)cluster * sw >= d;") in src
    assert src.count("cluster.sync();") == 3
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src


def _split_k(xb, idx, yb, qb, a0, live, v, plan, lam_n, coef_div, sig_eff,
             frozen, loss, smoothing=1.0):
    """The fused kernel's walk over a cluster (csrc/block_chain.cu): block
    r takes columns [r * width, min(d, (r + 1) * width)) and computes the
    partial margins x_j . v and the partial Gram there; the C partials are
    summed in rank order 0..C-1; the leader's chain runs on the sums; each
    block writes dwu = sum_j coef_j x_j over its own slice."""
    c, width = plan
    d = xb.shape[-1]
    cuts = [slice(r * width, min(d, (r + 1) * width)) for r in range(c)]
    assert cuts[-1].stop == d and all(s.start < s.stop for s in cuts)
    m0 = gram = None
    for s in cuts:
        pm = torch.matmul(xb[..., s], v[:, s, None])[..., 0]
        pg = torch.matmul(xb[..., s], xb[..., s].transpose(1, 2))
        m0 = pm if m0 is None else m0 + pm
        gram = pg if gram is None else gram + pg
    scal = torch.stack([m0, yb, qb, a0, torch.zeros_like(m0), live], dim=1)
    delta, coef = block_chain.chain_block_batched_plain(
        scal, None if frozen else gram, idx, lam_n, coef_div, sig_eff,
        frozen, loss, smoothing)
    dwu = torch.cat([torch.matmul(coef[:, None, :], xb[..., s])[:, 0]
                     for s in cuts], dim=-1)
    return delta, dwu


CLUSTER_D = 200        # divided by no width of a plan with C > 1
CLUSTERS = [1, 2, 3, 4, 7, None]


@functools.lru_cache(maxsize=None)
def _pallas_cluster_case(seed, mode, sig_eff, qf):
    kw = dict(lam_n=LAM_N, coef_div=LAM_N, sig_eff=sig_eff,
              frozen=mode == "frozen", loss="hinge", smoothing=1.0)
    block = _dyadic_block(seed, qf, d=CLUSTER_D)
    return block, kw, _pallas_fused(block, **kw)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("mode,sig_eff,qf", MODES)
@pytest.mark.parametrize("seed", [4, 5])
def test_cluster_split_k_matches_plain_and_pallas(seed, mode, sig_eff, qf,
                                                  cluster):
    """The cluster's split-K walk at C = 1, 2, 3, 4, 7 and the auto plan
    (d = 200: the last slice is short at every C > 1), on dyadic rows with
    repeated draws, a zero-norm row and a masked tail: its partial margins
    and Grams sum to the exact ones, so delta equals the plain version's
    bit for bit and JAX's fused kernel (interpret mode) within 1e-12; dwu
    within 1e-12 of the plain version and within JAX's float32 rounding
    (1e-6 of its largest entry)."""
    block, kw, (delta_j, dwu_j) = _pallas_cluster_case(seed, mode, sig_eff,
                                                       qf)
    plan = block_chain.fused_plan(B, CLUSTER_D, 8, cluster)
    assert cluster is None or plan[0] == cluster
    args = _port_args(block)
    delta, dwu = _split_k(*args, plan, **kw)
    want = block_chain.fused_block(*args, cluster=cluster, **kw)
    assert torch.equal(delta, want[0])
    np.testing.assert_allclose(dwu.numpy(), want[1].numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(delta.numpy(), delta_j, rtol=0, atol=TOL)
    # JAX's dwu sums 128 products in float32: its rounding, on dwu's scale
    np.testing.assert_allclose(dwu.numpy(), dwu_j, rtol=0,
                               atol=1e-6 * np.abs(dwu_j).max())


@pytest.mark.parametrize("cluster", [0, 17, 2.0, True])
def test_cluster_refused_and_ignored_on_the_cpu_route(cluster):
    """On the CPU the plan does not exist: a valid cluster size gives the
    plain version's result with no launch; an invalid one is refused on
    every device."""
    block, kw, _ = _pallas_cluster_case(4, "plus", 4.0, 4.0)
    args = _port_args(block)
    launches = block_chain.fused_block.launches
    want = block_chain.fused_block(*args, **kw)
    for c in (1, 4, 16):
        got = block_chain.fused_block(*args, cluster=c, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert block_chain.fused_block.launches == launches
    with pytest.raises(ValueError, match="cluster must be an int"):
        block_chain.fused_block(*args, cluster=cluster, **kw)


# the JAX checks of its fused kernel (tests/test_block.py), mirrored with
# the port's fused route running the cluster's split-K walk: float32, on
# rows of 100 columns (C = 2 splits them 64 + 36, C = 4 32 x 3 + 4)
MIRROR_K, MIRROR_D = 2, 100


@functools.lru_cache(maxsize=None)
def _mirror_shards(layout):
    from cocoa_tpu.data.sharding import shard_dataset as jax_shard
    from cocoa_tpu.data.synth import synth_dense as jax_synth_dense

    data = jax_synth_dense(640, MIRROR_D, seed=3)
    ds_j = jax_shard(data, k=MIRROR_K, layout=layout, dtype=jnp.float32)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    ds_t = interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                      ds_j.num_features, device="cpu")
    return ds_j, ds_t


def _mirror_state(ds_j, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=ds_j.num_features) * 0.1).astype(np.float32)
    alpha = np.clip(rng.normal(size=(MIRROR_K, ds_j.n_shard)) * 0.3 + 0.3,
                    0, 1).astype(np.float32)
    return w, alpha


def _split_route(monkeypatch, cluster):
    """The port's fused route with its kernel's walk over ``cluster``
    blocks a shard in place of the kernel; returns the list of the walks'
    plans, one a block."""
    plans = []

    def fused(xb, idx, yb, qb, a0, live, v, lam_n, coef_div, sig_eff,
              frozen, loss, smoothing=1.0):
        k, b, d = xb.shape
        plan = block_chain.fused_plan(b, d, xb.element_size(), cluster)
        assert plan[0] == cluster
        plans.append(plan)
        return _split_k(xb, idx, yb, qb, a0, live, v, plan, lam_n, coef_div,
                        sig_eff, frozen, loss, smoothing)

    monkeypatch.setattr(local_sdca, "fused_block", fused)
    return plans


def _port_fused_round(ds_t, w, alpha, idxs, **kw):
    return local_sdca.local_sdca_block_batched(
        torch.as_tensor(w), torch.as_tensor(alpha), ds_t.shard_arrays(),
        torch.as_tensor(np.asarray(idxs)), 0.01, ds_t.n, block=B,
        route="fused", **kw)


def _jax_sequential(ds_j, w, alpha, idxs, **kw):
    """JAX's sequential fast path, shard by shard (its fused kernel's
    reference in tests/test_block.py)."""
    from cocoa_tpu.ops.local_sdca import local_sdca_fast
    from cocoa_tpu.ops.rows import shard_margins

    sa = ds_j.shard_arrays()
    out = []
    for s in range(MIRROR_K):
        shard = {kk: v[s] for kk, v in sa.items()}
        out.append(local_sdca_fast(
            shard_margins(jnp.asarray(w), shard), jnp.asarray(alpha[s]),
            shard, jnp.asarray(idxs[s]), 0.01, ds_j.n,
            jnp.zeros(ds_j.num_features, jnp.float32), **kw))
    return [np.stack([np.asarray(o[i]) for o in out]) for i in (0, 1)]


def _close32(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("cluster", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("mode,sigma", [("cocoa", 1.0), ("plus", 4.0),
                                        ("frozen", 1.0)])
def test_cluster_fused_route_matches_sequential(monkeypatch, mode, sigma,
                                                layout, cluster):
    """tests/test_block.py:407 mirrored: the fused route in float32, every
    mode, both layouts, here with the Gram, margins and apply split over
    the cluster, matches JAX's sequential fast path (H = 37) to float32
    tolerance."""
    from cocoa_tpu.utils.prng import sample_indices_per_shard

    ds_j, ds_t = _mirror_shards(layout)
    w, alpha = _mirror_state(ds_j, 5)
    idxs = sample_indices_per_shard(7, range(1, 2), 37, ds_j.counts)[:, 0, :]
    plans = _split_route(monkeypatch, cluster)
    kw = dict(mode=mode, sigma=sigma)
    _close32(_port_fused_round(ds_t, w, alpha, idxs, **kw),
             _jax_sequential(ds_j, w, alpha, idxs, **kw))
    assert len(plans) == 1


@pytest.mark.parametrize("loss,smoothing", [("smooth_hinge", 0.5),
                                            ("logistic", 1.0)])
def test_cluster_fused_route_generic_losses(monkeypatch, loss, smoothing):
    """tests/test_block.py:450 mirrored: the chain's non-hinge branches
    behind the cluster's reduction."""
    from cocoa_tpu.utils.prng import sample_indices_per_shard

    ds_j, ds_t = _mirror_shards("dense")
    w, alpha = _mirror_state(ds_j, 9)
    idxs = sample_indices_per_shard(3, range(1, 2), 37, ds_j.counts)[:, 0, :]
    plans = _split_route(monkeypatch, 4)
    kw = dict(mode="plus", sigma=4.0, loss=loss, smoothing=smoothing)
    _close32(_port_fused_round(ds_t, w, alpha, idxs, **kw),
             _jax_sequential(ds_j, w, alpha, idxs, **kw))
    assert plans == [(4, 32)]


@pytest.mark.parametrize("h", [20, 200])
@pytest.mark.parametrize("mode,sigma", [("cocoa", 1.0), ("plus", 4.0),
                                        ("frozen", 1.0)])
def test_cluster_fused_route_distinct_draws(monkeypatch, mode, sigma, h):
    """tests/test_block.py:491 mirrored: pairwise-distinct draws in one
    block with a masked tail (H = 20) and across two blocks (H = 200), the
    cluster's walk against JAX's fused kernel (interpret mode) with its
    distinct licence, to float32 tolerance."""
    from cocoa_tpu.ops.local_sdca import local_sdca_block_batched
    from cocoa_tpu.ops.pallas_chain import fused_fits

    ds_j, ds_t = _mirror_shards("dense")
    assert fused_fits(MIRROR_K, B, MIRROR_D, 4, ds_j.n_shard)
    w, alpha = _mirror_state(ds_j, 11)
    rng = np.random.default_rng(11)
    idxs = np.stack([rng.permutation(int(c))[:h]
                     for c in ds_j.counts]).astype(np.int32)
    want = local_sdca_block_batched(
        jnp.asarray(w), jnp.asarray(alpha), ds_j.shard_arrays(),
        jnp.asarray(idxs), 0.01, ds_j.n, mode=mode, sigma=sigma, block=B,
        interpret=True, distinct=True)
    plans = _split_route(monkeypatch, 4)
    _close32(_port_fused_round(ds_t, w, alpha, idxs, mode=mode, sigma=sigma),
             [np.asarray(x) for x in want])
    assert len(plans) == -(-h // B)


def test_fp32_matmul_turns_tf32_off_and_restores(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with block_chain.fp32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is True
