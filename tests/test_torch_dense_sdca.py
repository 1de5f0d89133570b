"""The port's dense SDCA round (Queue B2) against the JAX package, float64
on the CPU: the kernel's plain version against the TPU kernel itself
(``pallas_sdca_round`` in interpret mode) in every mode x loss, prox x
lasso included, with repeated draws, to 1e-12; the lasso rule against
the JAX ``alpha_step``; the --math=fast route; the wrapper's refusals."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.libsvm import LibsvmData as JaxLibsvm  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.ops import losses as jax_losses  # noqa: E402
from cocoa_tpu.ops.pallas_sdca import pallas_sdca_round  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import kernels  # noqa: E402
from cocoa_torch.ops import dense_sdca, losses  # noqa: E402
from cocoa_torch.solvers.cocoa import fast_round_route  # noqa: E402

K, H, LAM = 4, 14, 0.01
TOL = 1e-12  # float64: the kernel sums each dot in another order
CASES = [(mode, sigma, loss, 1.0)
         for mode, sigma in (("cocoa", 1.0), ("plus", 4.0), ("frozen", 1.0))
         for loss in ("hinge", "smooth_hinge", "logistic")] + \
        [("prox", 4.0, "lasso", l2) for l2 in (0.0, 0.3)]


def _draws(counts, seed, repeats):
    """Reference-mode draws; every third step redraws the row of the step
    before it, or with ``repeats`` the whole round cycles over two rows
    per shard (a row drawn again and again)."""
    idxs = sample_indices_per_shard(seed, range(1, 2), H, counts)[:, 0, :]
    if repeats:
        idxs = idxs[:, [0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0]]
    else:
        idxs[:, 1::3] = idxs[:, 0::3][:, :idxs[:, 1::3].shape[1]]
    return np.ascontiguousarray(idxs)


def _inputs(tiny_data, mode, repeats=False, seed=5):
    """Dense shards of the same numbers for both packages: the tiny
    classification data for the dual modes, the column shards of a small
    lasso design for ``prox`` (n = 1 there, so lam*n is the L1 weight).
    Returns (numpy arrays, n)."""
    rng = np.random.default_rng(seed)
    if mode == "prox":
        n_rows, d = 40, 26
        A = rng.normal(size=(n_rows, d)) / np.sqrt(n_rows)
        A[:, 3] = 0.0  # a zero column: the s = 0 no-op
        data = JaxLibsvm(labels=rng.normal(size=n_rows),
                         indptr=np.arange(0, (n_rows + 1) * d, d),
                         indices=np.tile(np.arange(d, dtype=np.int32),
                                         n_rows),
                         values=A.reshape(-1), num_features=d)
        ds, _ = jax_columns(data, K, dtype=jnp.float64, layout="dense")
        alpha = rng.normal(size=(K, ds.n_shard))
        n = 1
    else:
        ds = jax_shard(tiny_data, k=K, layout="dense", dtype=jnp.float64)
        alpha = np.clip(rng.normal(size=(K, ds.n_shard)) * 0.3 + 0.3, 0, 1)
        n = ds.n
    arrays = {f: np.array(v) for f, v in ds.shard_arrays().items()}
    arrays["alpha"] = alpha * arrays["mask"]
    arrays["w"] = rng.normal(size=ds.num_features) * 0.3
    arrays["idxs"] = _draws(ds.counts, seed, repeats)
    return arrays, n


def _both(arrays, n, mode, sigma, loss, l2):
    names = ("w", "alpha", "X", "labels", "sq_norms", "idxs")
    kw = dict(mode=mode, sigma=sigma, loss=loss, smoothing=l2)
    dw_j, a_j = pallas_sdca_round(*(jnp.asarray(arrays[f]) for f in names),
                                  LAM, n, interpret=True, **kw)
    launches = dense_sdca.dense_sdca_round.launches
    dw, a = dense_sdca.dense_sdca_round(
        *(torch.as_tensor(arrays[f]) for f in names), LAM, n, **kw)
    assert dense_sdca.dense_sdca_round.launches == launches  # plain: no launch
    return (dw.numpy(), a.numpy()), (np.asarray(dw_j), np.asarray(a_j))


@pytest.mark.parametrize("mode,sigma,loss,l2", CASES)
def test_dense_round_matches_pallas_interpret(tiny_data, mode, sigma, loss,
                                              l2):
    arrays, n = _inputs(tiny_data, mode)
    (dw, a), (dw_j, a_j) = _both(arrays, n, mode, sigma, loss, l2)
    np.testing.assert_allclose(dw, dw_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(a, a_j, rtol=0, atol=TOL)
    assert np.abs(a - arrays["alpha"]).max() > 1e-3  # the round moved


@pytest.mark.parametrize("mode,sigma,loss,l2", [("plus", 4.0, "hinge", 1.0),
                                                ("prox", 4.0, "lasso", 0.0)])
def test_dense_round_repeated_draws(tiny_data, mode, sigma, loss, l2):
    """Two rows per shard drawn again and again: each draw must read the
    alpha the last draw of its row wrote."""
    arrays, n = _inputs(tiny_data, mode, repeats=True, seed=8)
    (dw, a), (dw_j, a_j) = _both(arrays, n, mode, sigma, loss, l2)
    np.testing.assert_allclose(dw, dw_j, rtol=0, atol=TOL)
    np.testing.assert_allclose(a, a_j, rtol=0, atol=TOL)


@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_lasso_rule_matches_jax(l2):
    """The soft-threshold step, exactly, including the qii = 0 no-op at
    s = 0 and coordinates thresholded to zero."""
    rng = np.random.default_rng(3)
    a = rng.normal(0.0, 1.0, 3000)
    z = rng.normal(0.0, 2.0, 3000)
    qii = np.abs(rng.normal(1.0, 1.0, 3000))
    qii[:20] = 0.0
    z[20:40] = qii[20:40] * a[20:40]  # u = 0
    lam = 0.7
    mine = losses.alpha_step("lasso", *map(torch.as_tensor, (a, z, qii)),
                             torch.tensor(lam, dtype=torch.float64),
                             smoothing=l2)
    ref = jax_losses.alpha_step("lasso", *map(jnp.asarray, (a, z, qii)),
                                lam, smoothing=l2)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    if l2 == 0.0:
        np.testing.assert_array_equal(mine.numpy()[:20], a[:20])
    assert (mine.numpy() == 0.0).sum() > 100


def test_grad_factor_matches_jax():
    z = np.random.default_rng(4).normal(0.5, 3.0, 2000)
    z[:5] = 1.0
    for loss in losses.LOSSES:
        np.testing.assert_allclose(
            losses.grad_factor(loss, torch.as_tensor(z), 0.7).numpy(),
            np.asarray(jax_losses.grad_factor(loss, jnp.asarray(z), 0.7)),
            rtol=0, atol=TOL)


def test_lasso_validation():
    assert losses.validate("lasso", 0.0) == "lasso"
    with pytest.raises(ValueError, match="elastic-net"):
        losses.validate("lasso", -0.1)
    with pytest.raises(ValueError, match="lasso"):
        losses.validate("hinge_squared")
    assert losses.LOSS_CODES["lasso"] == 3
    header = (kernels.SOURCES["dense_sdca"].parent / "sdca_common.cuh")
    assert "kLasso = 3" in header.read_text()


def test_fast_route_dense_cuda_is_the_kernel():
    """--math=fast on the dense layout runs the dense kernel on CUDA,
    judged from the route function alone (no card needed)."""
    assert fast_round_route("dense", "cuda", torch.float32) == "kernel"
    assert fast_round_route("dense", "cuda:0", torch.float64) == "kernel"
    assert fast_round_route("dense", "cpu", torch.float32) == "plain"
    assert "dense_sdca" in kernels.SOURCES
    assert kernels.library_path("dense_sdca").name.startswith("dense_sdca_")


def test_wrapper_refuses_bf16_and_other_devices(tiny_data):
    arrays, n = _inputs(tiny_data, "plus")
    t = {f: torch.as_tensor(v) for f, v in arrays.items()}
    rest = (t["X"], t["labels"], t["sq_norms"], t["idxs"], LAM, n)
    with pytest.raises(ValueError, match="float32 or float64"):
        dense_sdca.dense_sdca_round(t["w"].bfloat16(), t["alpha"].bfloat16(),
                                    *rest)
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_sdca.dense_sdca_round(t["w"].to("meta"), t["alpha"].to("meta"),
                                    *rest)
    with pytest.raises(ValueError, match="mode"):
        dense_sdca.dense_sdca_round(t["w"], t["alpha"], *rest, mode="dual")


OPTIN = 232448  # an H100's opt-in shared memory per block
THREADS = dense_sdca.THREADS
# (d, itemsize): the plan with the state asked into shared memory, and
# with it kept in global memory (epsilon-like, lasso design, demo dense,
# and a tall lasso design whose columns are 100000 values long)
PLANS = [(2000, 4, (True, 3, 2000), (False, 3, 2000)),
         (2000, 8, (True, 3, 2000), (False, 3, 2000)),
         (8192, 4, (True, 3, 8192), (False, 3, 8192)),
         (8192, 8, (True, 1, 8192), (False, 3, 8192)),
         (9947, 4, (True, 3, 9947), (False, 3, 9947)),
         (9947, 8, (True, 2, 4096), (False, 2, 9947)),
         (100000, 4, (False, 2, 28672), (False, 2, 28672)),
         (100000, 8, (False, 2, 14336), (False, 2, 14336))]


@pytest.mark.parametrize("d,itemsize,in_smem,in_global", PLANS)
def test_stage_plan_at_main_shapes(d, itemsize, in_smem, in_global):
    """Every plan fits the opt-in and keeps at least one slot of the
    whole row or of a multiple of THREADS columns; the float64 demo state
    keeps its shared memory beside a ring of chunks; a row wider than a
    slot is streamed, never refused; state_in_smem=False still stages."""
    for asked, want in ((True, in_smem), (False, in_global)):
        plan = dense_sdca.stage_plan(d, itemsize, OPTIN, asked)
        assert plan == want
        in_sm, stages, chunk = plan
        assert stages >= 1
        assert chunk == d or (chunk % THREADS == 0 and THREADS <= chunk < d)
        assert dense_sdca.plan_bytes(d, itemsize, *plan) <= OPTIN
        # the deepest whole-row ring that fits, or the widest chunk
        if chunk == d:
            assert stages == dense_sdca.MAX_STAGES or dense_sdca.plan_bytes(
                d, itemsize, in_sm, stages + 1, d) > OPTIN
        else:
            assert dense_sdca.plan_bytes(d, itemsize, in_sm, stages,
                                         chunk + THREADS) > OPTIN


def test_stage_plan_explicit_stages_and_refusals():
    plan = dense_sdca.stage_plan
    assert plan(2000, 4, OPTIN, stages=1) == (True, 1, 2000)
    assert plan(2000, 4, OPTIN, False, stages=3) == (False, 3, 2000)
    # beside the float64 demo state: one slot of 17 x 512 columns
    assert plan(9947, 8, OPTIN, stages=1) == (True, 1, 8704)
    # three slots beside the float64 lasso state are chunks; two whole
    # rows fit once the state is in global memory
    assert plan(8192, 8, OPTIN, stages=3) == (True, 3, 4096)
    assert plan(8192, 8, OPTIN, False, stages=2) == (False, 2, 8192)
    # epsilon's 400000 samples as the rows of lasso column shards
    assert plan(400000, 4, OPTIN) == (False, 2, 28672)
    with pytest.raises(ValueError, match="cannot stage rows"):
        plan(2000, 4, 4096)
    for bad in (0, 4, -1, 2.0, True):
        with pytest.raises(ValueError, match="stages"):
            plan(2000, 4, OPTIN, stages=bad)


def test_plan_bytes_match_the_kernel():
    """The plan's byte count is the kernel's: the same constants and the
    same sum, read from the source; one barrier in the kernel."""
    src = kernels.SOURCES["dense_sdca"].read_text()
    assert f"kThreads = {THREADS};" in src
    assert f"kMaxStages = {dense_sdca.MAX_STAGES};" in src
    assert "kReduce = 2 * 2 * kWarps;" in src
    assert dense_sdca.REDUCE_SLOTS == 2 * 2 * THREADS // 32
    assert ("return (kReduce + (state_in_smem ? 2 * (size_t)d : 0) +\n"
            "          (size_t)stages * chunk) * itemsize;") in src
    assert dense_sdca.plan_bytes(9947, 4, True, 3, 9947) == (64 + 5 * 9947) * 4
    assert dense_sdca.plan_bytes(9947, 8, False, 2, 512) == (64 + 1024) * 8
    assert src.count("__syncthreads()") == 1


def _walk(d, h, stages, chunk, land_early):
    """The kernel's walk of its ring (csrc/dense_sdca.cu), one thread's
    view: the prologue's fills, then per step the dots' reads and the
    axpy's, each read after ``wait_group stages-1`` and each slot refilled
    after its last read.  A copy group lands at its commit
    (``land_early``) or at the last moment its wait allows.  Returns what
    each read found, as (step, first column) of the element, beside what
    it should find."""
    n_chunks = -(-d // chunk)
    per_step = 1 if n_chunks == 1 else 2 * n_chunks
    ahead = stages if n_chunks == 1 else 1
    slots, groups, landed = [None] * stages, [], [0]
    cur = {"step": 0, "j": 0}

    def fill(slot, step):
        f_step, j = cur["step"], cur["j"]
        # the prologue reads the row of f_step; a refill picks this
        # step's row or the one ``ahead`` steps on
        assert step is None or f_step >= h or f_step in (step, step + ahead)
        base = (j if j < n_chunks else j - n_chunks) * chunk
        groups.append((slot, (f_step, base) if f_step < h else None))
        if land_early:
            land(len(groups))
        cur["j"] = j + 1
        if cur["j"] == per_step:
            cur["step"], cur["j"] = f_step + 1, 0

    def land(upto):
        for slot, content in groups[landed[0]:upto]:
            if content is not None:
                slots[slot] = content
        landed[0] = max(landed[0], upto)

    def wait():
        land(len(groups) - (stages - 1))

    found, slot = [], 0
    for s in range(stages):
        fill(s, None)
    for step in range(h):
        for axpy in (False, True):
            for base in range(0, d, chunk):
                if not axpy or n_chunks > 1:
                    wait()
                found.append((slots[slot], (step, base)))
                if axpy or n_chunks > 1:
                    fill(slot, step)
                    slot = (slot + 1) % stages
    return found


@pytest.mark.parametrize("d,h,stages,chunk", [
    (2000, 14, 3, 2000), (2000, 2, 3, 2000), (2000, 13, 2, 2000),
    (9947, 14, 2, 4096), (9947, 5, 1, 8704), (100000, 7, 3, 18944),
    (1030, 3, 3, 512)])
def test_ring_walk_reads_each_element_once_landed(d, h, stages, chunk):
    """Every read of the ring finds the element it wants, whether a copy
    lands at once or as late as ``wait_group stages-1`` allows: H < S, H
    not a multiple of S, whole rows, chunked rows and a short last
    chunk."""
    for land_early in (True, False):
        found = _walk(d, h, stages, chunk, land_early)
        n_chunks = -(-d // chunk)
        assert len(found) == h * 2 * n_chunks
        for got, want in found:
            assert got == want


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stages_ignored_by_the_plain_version(tiny_data, stages):
    """On the CPU the plan does not exist: any valid depth gives the plain
    version's result, with no launch."""
    arrays, n = _inputs(tiny_data, "plus")
    t = [torch.as_tensor(arrays[f])
         for f in ("w", "alpha", "X", "labels", "sq_norms", "idxs")]
    launches = dense_sdca.dense_sdca_round.launches
    want = dense_sdca.dense_sdca_round(*t, LAM, n, sigma=4.0)
    got = dense_sdca.dense_sdca_round(*t, LAM, n, sigma=4.0, stages=stages,
                                      state_in_smem=False)
    assert dense_sdca.dense_sdca_round.launches == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stages", [0, -2, 4, 1.5, False])
def test_stages_refused_on_the_cpu_route(tiny_data, stages):
    arrays, n = _inputs(tiny_data, "plus")
    t = [torch.as_tensor(arrays[f])
         for f in ("w", "alpha", "X", "labels", "sq_norms", "idxs")]
    with pytest.raises(ValueError, match="stages must be an int"):
        dense_sdca.dense_sdca_round(*t, LAM, n, stages=stages)
