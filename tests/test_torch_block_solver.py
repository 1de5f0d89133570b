"""The block-coordinate round (``--blockSize``) end to end against the JAX
package, float64 on the CPU: every branch of ``local_sdca_block_batched``
(fused, split, sparse-Gram) against JAX's and against the port's portable ``local_sdca_block``; ``run_cocoa``
and both CLIs with ``--blockSize``; the routing rules at the three
configurations' shapes; the TF32 pin; the synthetic dense data."""

import re
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data import synth as jax_synth  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_block as jax_block  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_block_batched as jax_batched  # noqa: E402
from cocoa_tpu.ops.rows import shard_margins as jax_margins  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.synth import synth_dense, synth_dense_sharded  # noqa: E402
from cocoa_torch.ops import local_sdca as ls  # noqa: E402
from cocoa_torch.ops.rows import shard_margins  # noqa: E402
from cocoa_torch.solvers import cocoa as cocoa_mod  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402

K, LAM, TOL, RTOL = 4, 0.01, 1e-12, 1e-9
MODES = [("cocoa", 1.0), ("plus", 4.0), ("frozen", 1.0)]
DEMO_ARGV = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
             f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
             "--numRounds=10", "--localIterFrac=0.1", "--lambda=.001",
             "--debugIter=5", "--math=fast"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


def _port_ds(ds_j, layout):
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    return interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                      ds_j.num_features, device="cpu")


def _setup(data, layout, h=200, k=K, seed=4, idxs=None):
    """The same shards, w, alpha and draws in both packages.  H=200 is two
    blocks of 128 with a masked tail; every third draw repeats the one
    before it."""
    ds_j = jax_shard(data, k=k, layout=layout, dtype=jnp.float64)
    ds_t = _port_ds(ds_j, layout)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=ds_j.num_features) * 0.1
    alpha = np.clip(rng.normal(size=(k, ds_j.n_shard)) * 0.3 + 0.3, 0, 1) \
        * np.asarray(ds_j.mask)
    if idxs is None:
        idxs = sample_indices_per_shard(6, range(1, 2), h, ds_j.counts)[:, 0]
        idxs[:, 1::3] = idxs[:, 0::3][:, :idxs[:, 1::3].shape[1]]
    return ds_j, ds_t, w, alpha, np.ascontiguousarray(idxs)


def _port_block(ds_t, w, alpha, idxs, mode, sigma, route, **kw):
    return ls.local_sdca_block_batched(
        torch.as_tensor(w), torch.as_tensor(alpha), ds_t.shard_arrays(),
        torch.as_tensor(idxs), LAM, ds_t.n, mode=mode, sigma=sigma,
        block=128, route=route, **kw)


def _port_portable(ds_t, w, alpha, idxs, mode, sigma, block=128):
    sa = ds_t.shard_arrays()
    w_t = torch.as_tensor(w)
    return ls.local_sdca_block(
        shard_margins(w_t, sa), torch.as_tensor(alpha), sa,
        torch.as_tensor(idxs), LAM, ds_t.n,
        torch.zeros(ds_t.k, w.shape[0], dtype=torch.float64), mode=mode,
        sigma=sigma, block=block)


def _close(got, want, tol=TOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("mode,sigma", MODES)
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_portable_block_matches_jax(tiny_data, mode, sigma, layout):
    """The port's ``local_sdca_block`` against JAX's, per shard (B=37: a
    masked tail and repeats inside blocks)."""
    ds_j, ds_t, w, alpha, idxs = _setup(tiny_data, layout, h=100)
    d = ds_j.num_features

    def one(a, sh, ix):
        return jax_block(jax_margins(jnp.asarray(w), sh), a, sh, ix, LAM,
                         ds_j.n, jnp.zeros(d), mode=mode, sigma=sigma,
                         block=37)

    want = jax.vmap(one)(jnp.asarray(alpha), ds_j.shard_arrays(),
                         jnp.asarray(idxs))
    _close(_port_portable(ds_t, w, alpha, idxs, mode, sigma, block=37), want)


@pytest.mark.parametrize("mode,sigma", MODES)
@pytest.mark.parametrize("route,layout", [("fused", "dense"),
                                          ("split", "sparse"),
                                          ("sparse_gram", "sparse")])
def test_block_batched_matches_jax(tiny_data, route, layout, mode, sigma):
    """Each branch against JAX ``local_sdca_block_batched`` with its Pallas
    kernels in interpret mode (float64 takes JAX's split branch, the same
    math as the fused one; ``sparse_gram=True`` its sparse branch), and
    against the portable form."""
    ds_j, ds_t, w, alpha, idxs = _setup(tiny_data, layout)
    got = _port_block(ds_t, w, alpha, idxs, mode, sigma, route)
    want = jax_batched(jnp.asarray(w), jnp.asarray(alpha),
                       ds_j.shard_arrays(), jnp.asarray(idxs), LAM, ds_j.n,
                       mode=mode, sigma=sigma, block=128, interpret=True,
                       sparse_gram=route == "sparse_gram")
    _close(got, want)
    _close(got, _port_portable(ds_t, w, alpha, idxs, mode, sigma))


@pytest.mark.parametrize("route,layout", [("fused", "sparse"),
                                          ("split", "dense"),
                                          ("sparse_gram", "sparse")])
def test_block_batched_duplicate_heavy(tiny_data, route, layout):
    """The first 64 draws of every shard are one row and the rest cycle
    over three: the equality terms carry the recurrence."""
    idxs = np.tile(np.array([[0] * 64 + [1, 2, 5] * 45]), (K, 1))[:, :199]
    ds_j, ds_t, w, alpha, idxs = _setup(tiny_data, layout, idxs=idxs)
    _close(_port_block(ds_t, w, alpha, idxs, "plus", 4.0, route),
           _port_portable(ds_t, w, alpha, idxs, "plus", 4.0))


@pytest.mark.parametrize("mode,sigma", MODES)
def test_fused_distinct_is_bit_identical(mode, sigma):
    """Pairwise-distinct draws (two blocks): JAX's distinct licence (one
    alpha scatter per round) equals its per-block scatter bit for bit, so
    the port keeps only the per-block scatter, which matches both."""
    data = jax_synth.synth_dense(640, 32, seed=3)
    rng = np.random.default_rng(11)
    idxs = np.stack([rng.permutation(320)[:200] for _ in range(2)])
    ds_j, ds_t, w, alpha, idxs = _setup(data, "dense", k=2, idxs=idxs)

    def jax_fused(distinct):
        return jax_batched(
            jnp.asarray(w), jnp.asarray(alpha), ds_j.shard_arrays(),
            jnp.asarray(idxs), LAM, ds_j.n, mode=mode, sigma=sigma,
            block=128, interpret=True, distinct=distinct)

    distinct, per_block = jax_fused(True), jax_fused(False)
    for a, b in zip(distinct, per_block):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _close(_port_block(ds_t, w, alpha, idxs, mode, sigma, "fused"), distinct)


def test_split_matmuls_run_without_tf32(tiny_data, monkeypatch):
    """TF32 on for the process: every matrix product of the split branch
    still runs with TF32 off."""
    ds_j, ds_t, w, alpha, idxs = _setup(tiny_data, "dense")
    seen = []
    real = torch.matmul

    def spy(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*args, **kw)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch, "matmul", spy)
    _port_block(ds_t, w, alpha, idxs, "plus", 4.0, "split")
    assert len(seen) == 2 * 3  # two blocks: margins, Gram, the dw product
    assert set(seen) == {False}
    assert torch.backends.cuda.matmul.allow_tf32 is True


def _runs(tiny_data, layout, plus, rng, h, block=128):
    ds_j = jax_shard(tiny_data, k=K, layout=layout, dtype=jnp.float64)
    test_j = jax_shard(tiny_data, k=3, layout=layout, dtype=jnp.float64)
    kw = dict(n=tiny_data.n, num_rounds=8, local_iters=h, lam=LAM)
    mine = run_cocoa(_port_ds(ds_j, layout), Params(**kw),
                     DebugParams(debug_iter=4, seed=3), plus=plus,
                     test_ds=_port_ds(test_j, layout), rng=rng, math="fast",
                     quiet=True, block_size=block)
    ref = jax_run_cocoa(ds_j, JaxParams(**kw), JaxDebug(debug_iter=4, seed=3),
                        plus=plus, test_ds=test_j, rng=rng, math="fast",
                        quiet=True, block_size=block)
    return mine, ref


@pytest.mark.parametrize("plus", [True, False])
@pytest.mark.parametrize("layout,rng,h", [("sparse", "reference", 150),
                                          ("dense", "jax", 150),
                                          ("dense", "permuted", 24)])
def test_run_cocoa_block_matches_jax(tiny_data, layout, rng, h, plus):
    """``run_cocoa(math="fast", block_size=128)`` against the JAX package
    (which runs its portable block form on the CPU): sparse takes the
    sparse-Gram branch, dense the fused one; permuted draws with
    counts % H == 0 are the case where JAX takes its distinct licence."""
    (w_t, a_t, traj_t), (w_j, a_j, traj_j) = _runs(tiny_data, layout, plus,
                                                   rng, h)
    assert [r.round for r in traj_t.records] == [4, 8]
    for a, b in zip(traj_t.records, traj_j.records):
        np.testing.assert_allclose([a.primal, a.gap, a.test_error],
                                   [b.primal, b.gap, b.test_error],
                                   rtol=RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-12)


def test_run_cocoa_block_routes_and_licence(tiny_data, monkeypatch):
    """The branch each layout takes, whatever the sampling: permuted draws
    with counts % H == 0 (JAX's distinct licence) take the same branch
    with the same per-block alpha scatter."""
    seen = []
    real = cocoa_mod.local_sdca_block_batched

    def spy(*args, **kw):
        assert "distinct" not in kw
        seen.append((kw["route"], kw["block"]))
        return real(*args, **kw)

    monkeypatch.setattr(cocoa_mod, "local_sdca_block_batched", spy)
    for layout, rng, h, want in (("sparse", "permuted", 24,
                                  ("sparse_gram", 128)),
                                 ("dense", "permuted", 7, ("fused", 128)),
                                 ("dense", "reference", 24, ("fused", 128))):
        seen.clear()
        ds_j = jax_shard(tiny_data, k=K, layout=layout, dtype=jnp.float64)
        run_cocoa(_port_ds(ds_j, layout),
                  Params(n=tiny_data.n, num_rounds=2, local_iters=h, lam=LAM),
                  DebugParams(debug_iter=2), plus=True, rng=rng, math="fast",
                  quiet=True, block_size=128)
        assert seen == [want, want]
    with pytest.raises(ValueError, match="math='fast'"):
        run_cocoa(_port_ds(ds_j, "dense"),
                  Params(n=tiny_data.n, local_iters=8), DebugParams(),
                  plus=True, math="exact", quiet=True, block_size=8)


def _stub(layout):
    return SimpleNamespace(layout=layout)


def test_block_route_at_the_three_configurations():
    """demo (K=4, d=9947, sparse) and rcv1-like (K=8, d=47236, sparse) ->
    128 on the sparse-Gram branch; epsilon-like (K=8, d=2000, dense) ->
    128 fused, 256 split; float64 -> 0 (sequential)."""
    f32 = torch.float32
    for layout in ("sparse", "dense"):
        assert cocoa_mod.auto_block_size(_stub(layout), f32) == 128
        assert cocoa_mod.auto_block_size(_stub(layout), torch.float64) == 0
    route = cocoa_mod.block_route
    assert route("sparse", 128, f32) == "sparse_gram"
    assert route("dense", 128, f32) == "fused"
    assert route("dense", 256, f32) == "split"
    assert route("dense", 128, torch.float64) == "fused"
    assert route("dense", 512, f32) == "split"
    assert route("sparse", 512, f32) == "sparse_gram"
    assert cocoa_mod.AUTO_BLOCK == 128
    with pytest.raises(ValueError, match="float32 or float64"):
        route("sparse", 128, torch.bfloat16)
    with pytest.raises(ValueError, match="1..1024"):
        route("dense", 2048, f32)


@pytest.mark.parametrize("block", ["128", "auto"])
def test_cli_block_size_matches_jax(block, capsys):
    """The demo through both CLIs with --blockSize, float64 (``auto`` is
    the sequential path at float64 in both packages)."""
    argv = DEMO_ARGV + ["--dtype=float64", f"--blockSize={block}"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 0
    ref = _NUMBER_LINE.findall(capsys.readouterr().out)
    assert cli.main(argv + ["--device=cpu"]) == 0
    out = capsys.readouterr().out
    mine = _NUMBER_LINE.findall(out)
    if block == "auto":
        assert "blockSize=auto: using the sequential path for the sparse " \
            "layout" in out
    assert [k for k, _ in mine] == [k for k, _ in ref]
    assert len(mine) == 2 * (2 * 3 + 3)
    np.testing.assert_allclose([float(v) for _, v in mine],
                               [float(v) for _, v in ref], rtol=RTOL)


def test_cli_block_size_auto_float32(capsys, monkeypatch):
    seen = []
    real = cocoa_mod.local_sdca_block_batched

    def spy(*args, **kw):
        seen.append((kw["block"], kw["route"]))
        return real(*args, **kw)

    monkeypatch.setattr(cocoa_mod, "local_sdca_block_batched", spy)
    argv = [a for a in DEMO_ARGV if not a.startswith("--numRounds")]
    assert cli.main(argv + ["--numRounds=5", "--debugIter=5",
                            "--blockSize=auto", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "blockSize=auto: using 128 for the sparse layout" in out
    assert set(seen) == {(128, "sparse_gram")} and len(seen) == 10


@pytest.mark.parametrize("flags", [["--blockSize=abc", "--math=fast"],
                                   ["--blockSize=-1", "--math=fast"],
                                   ["--blockSize=8", "--math=exact"],
                                   ["--blockSize=auto", "--math=exact"]])
def test_cli_block_size_refusals_match_jax(flags, capsys):
    base = [a for a in DEMO_ARGV if not a.startswith("--math")]
    assert jax_cli.main(base + flags + ["--mesh=1"]) == 2
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        assert cli.main(base + flags + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert ref.startswith("error: --blockSize")
    assert err.strip() == ref
    assert "Running" not in out


def test_cli_block_pipeline_stays_unported(capsys):
    assert cli.main(DEMO_ARGV + ["--device=cpu", "--blockSize=128",
                                 "--blockPipeline=on"]) == 2
    assert "--blockPipeline is not yet ported" in capsys.readouterr().err


def test_synth_dense_matches_jax():
    mine, ref = synth_dense(50, 7, seed=2), jax_synth.synth_dense(50, 7,
                                                                  seed=2)
    for f in ("labels", "indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))


def test_synth_dense_sharded():
    """Deterministic in its seed, unit rows, labels +-1, padded rows zero
    with mask 0, and a different seed gives other draws."""
    kw = dict(seed=5, dtype=torch.float64, device="cpu")
    a = synth_dense_sharded(103, 9, 4, **kw)
    b = synth_dense_sharded(103, 9, 4, **kw)
    c = synth_dense_sharded(103, 9, 4, seed=6, dtype=torch.float64,
                            device="cpu")
    assert torch.equal(a.X, b.X) and torch.equal(a.labels, b.labels)
    assert not torch.equal(a.X, c.X)
    assert a.X.shape == (4, 26, 9) and a.counts.tolist() == [26, 26, 26, 25]
    np.testing.assert_allclose(a.sq_norms[:, :25].numpy(), 1.0, atol=1e-12)
    assert float(a.X[3, 25].abs().max()) == 0.0
    assert a.mask[3, 25] == 0 and a.labels[3, 25] == 0
    assert set(a.labels[:, :25].flatten().tolist()) == {-1.0, 1.0}
