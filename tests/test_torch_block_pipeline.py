"""``--blockPipeline``: the block round's row tiles gathered one block
ahead (ops/local_sdca.py ``_TilePipeline``), float64 on the CPU.  The
pipelined schedule equals the serial one bit for bit on the fused and
split routes, through ``local_sdca_block_batched``, ``run_cocoa`` (both
loops), ``run_prox_cocoa`` and the CLI, duplicate-heavy draws included;
it equals JAX's ``local_sdca_block_batched(pipeline=True)`` (its kernels
in interpret mode) within 1e-12; the sparse-Gram route ignores the flag;
and the CLI refuses bad values with the JAX CLI's messages."""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.ops.local_sdca import local_sdca_block_batched as jax_batched  # noqa: E402
from cocoa_tpu.utils.prng import sample_indices_per_shard  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.synth import synth_lasso_columns  # noqa: E402
from cocoa_torch.ops import local_sdca as ls  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402

K, LAM, TOL = 4, 0.01, 1e-12
MODES = [("cocoa", 1.0), ("plus", 4.0), ("frozen", 1.0)]
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
        "--numRounds=6", "--localIterFrac=0.1", "--lambda=.001",
        "--debugIter=2", "--math=fast"]


def _setup(data, layout, h=200, seed=4, idxs=None):
    """The same shards, w, alpha and draws in both packages; H=200 is two
    blocks of 128 with a masked tail, every third draw repeating the one
    before it."""
    ds_j = jax_shard(data, k=K, layout=layout, dtype=jnp.float64)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    ds_t = interop.dataset_from_numpy(arrays, layout, ds_j.n,
                                      ds_j.num_features, device="cpu")
    rng = np.random.default_rng(seed)
    w = rng.normal(size=ds_j.num_features) * 0.1
    alpha = np.clip(rng.normal(size=(K, ds_j.n_shard)) * 0.3 + 0.3, 0, 1) \
        * np.asarray(ds_j.mask)
    if idxs is None:
        idxs = sample_indices_per_shard(6, range(1, 2), h, ds_j.counts)[:, 0]
        idxs[:, 1::3] = idxs[:, 0::3][:, :idxs[:, 1::3].shape[1]]
    return ds_j, ds_t, w, alpha, np.ascontiguousarray(idxs)


def _block(ds_t, w, alpha, idxs, mode, sigma, route, pipeline, block=128):
    return ls.local_sdca_block_batched(
        torch.as_tensor(w), torch.as_tensor(alpha), ds_t.shard_arrays(),
        torch.as_tensor(idxs), LAM, ds_t.n, mode=mode, sigma=sigma,
        block=block, route=route, pipeline=pipeline)


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,sigma", MODES)
@pytest.mark.parametrize("route,layout", [("fused", "dense"),
                                          ("split", "dense"),
                                          ("fused", "sparse")])
def test_pipelined_equals_serial_and_jax(tiny_data, route, layout, mode,
                                         sigma):
    """On and auto against off bit for bit (two blocks: the only case in
    which the schedules differ), and against JAX's pipelined round."""
    ds_j, ds_t, w, alpha, idxs = _setup(tiny_data, layout)
    serial = _block(ds_t, w, alpha, idxs, mode, sigma, route, False)
    _equal(_block(ds_t, w, alpha, idxs, mode, sigma, route, True), serial)
    _equal(_block(ds_t, w, alpha, idxs, mode, sigma, route, None), serial)
    want = jax_batched(jnp.asarray(w), jnp.asarray(alpha),
                       ds_j.shard_arrays(), jnp.asarray(idxs), LAM, ds_j.n,
                       mode=mode, sigma=sigma, block=128, interpret=True,
                       pipeline=True, sparse_gram=False)
    for a, b in zip(serial, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("route", ["fused", "split"])
def test_pipelined_duplicate_heavy_many_blocks(tiny_data, route):
    """Seven blocks of 32 whose draws are one row, then a cycle of three:
    each buffer is gathered into three or four times."""
    idxs = np.tile(np.array([[0] * 64 + [1, 2, 5] * 53]), (K, 1))[:, :215]
    _, ds_t, w, alpha, idxs = _setup(tiny_data, "dense", idxs=idxs)
    serial = _block(ds_t, w, alpha, idxs, "plus", 4.0, route, False, 32)
    _equal(_block(ds_t, w, alpha, idxs, "plus", 4.0, route, True, 32),
           serial)


@pytest.mark.parametrize("route,kernel,pos", [("fused", "fused_block", 1),
                                               ("split", "chain_block_batched",
                                                2)])
def test_pipeline_gathers_one_block_ahead(tiny_data, route, kernel, pos):
    """The pipelined order: block b+1's tile is gathered just before block
    b's kernel (the fused kernel, or the chain after the split route's
    products), into two buffers made once; the serial order gathers each
    block's rows just before its own work into a new tensor."""
    _, ds_t, w, alpha, idxs = _setup(tiny_data, "dense", h=96)
    events = []
    real_rows, real_kernel = ls.dense_rows, getattr(ls, kernel)

    def rows(shards, bidx, d, out=None):
        events.append(("gather", int(bidx[0, 0]), out is not None))
        return real_rows(shards, bidx, d, out=out)

    def spy(*args, **kw):
        events.append(("kernel", int(args[pos][0, 0]), None))
        return real_kernel(*args, **kw)

    with mock.patch.object(ls, "dense_rows", rows), \
            mock.patch.object(ls, kernel, spy):
        _block(ds_t, w, alpha, idxs, "plus", 4.0, route, True, 32)
        piped, events[:] = list(events), []
        _block(ds_t, w, alpha, idxs, "plus", 4.0, route, False, 32)
    first = [int(idxs[0, s]) for s in (0, 32, 64)]
    assert [e[:2] for e in piped] == [
        ("gather", first[0]), ("gather", first[1]), ("kernel", first[0]),
        ("gather", first[2]), ("kernel", first[1]), ("kernel", first[2])]
    assert all(e[2] for e in piped if e[0] == "gather")
    assert [e[:2] for e in events] == [
        (kind, first[b]) for b in range(3) for kind in ("gather", "kernel")]
    assert not any(e[2] for e in events if e[0] == "gather")


def test_sparse_gram_route_ignores_the_flag(tiny_data):
    """The sparse-Gram route gathers no tile: the flag changes nothing,
    and no pipeline is made."""
    _, ds_t, w, alpha, idxs = _setup(tiny_data, "sparse")
    serial = _block(ds_t, w, alpha, idxs, "plus", 4.0, "sparse_gram", False)
    with mock.patch.object(ls, "_TilePipeline",
                           side_effect=AssertionError("pipelined")):
        for flag in (True, None):
            _equal(_block(ds_t, w, alpha, idxs, "plus", 4.0, "sparse_gram",
                          flag), serial)


@pytest.mark.parametrize("device_loop", [False, True])
def test_run_cocoa_pipelined_equals_serial(tiny_data, device_loop):
    """Through the solver: CoCoA+, 40 steps in blocks of 16, on both
    loops."""
    _, ds_t, _, _, _ = _setup(tiny_data, "dense")
    p = Params(n=ds_t.n, num_rounds=6, local_iters=40, lam=LAM)
    d = DebugParams(debug_iter=2, seed=0)
    outs = [run_cocoa(ds_t, p, d, plus=True, quiet=True, math="fast",
                      block_size=16, block_pipeline=flag,
                      device_loop=device_loop) for flag in (False, True)]
    (w0, a0, t0), (w1, a1, t1) = outs
    assert torch.equal(w0, w1) and torch.equal(a0, a1)
    assert [(r.round, r.primal, r.gap) for r in t0.records] == \
        [(r.round, r.primal, r.gap) for r in t1.records]


def test_prox_cocoa_pipelined_equals_serial():
    """ProxCoCoA+'s dense column shards through the fused route."""
    ds, b, lam_max = synth_lasso_columns(64, 96, 4, seed=1,
                                         dtype=torch.float64, device="cpu")
    p = Params(n=ds.n, num_rounds=4, local_iters=20, lam=0.3 * lam_max,
               loss="lasso", smoothing=0.0)
    d = DebugParams(debug_iter=2, seed=0)
    (x0, r0, t0), (x1, r1, t1) = [
        run_prox_cocoa(ds, b, p, d, quiet=True, block_size=8,
                       block_pipeline=flag) for flag in (False, True)]
    assert torch.equal(x0, x1) and torch.equal(r0, r1)
    assert [r.gap for r in t0.records] == [r.gap for r in t1.records]


def test_cli_pipeline_on_off_auto_print_the_same(capsys):
    """The demo's dense layout at B=16 (H=50: four blocks a round): the
    three settings print the same lines, past the flag echo."""
    base = [a for a in DEMO if not a.startswith("--numRounds")] + [
        "--numRounds=2", "--device=cpu", "--layout=dense",
        "--dtype=float64", "--blockSize=16"]
    outs = []
    for flag in ("on", "off", "auto"):
        assert cli.main(base + [f"--blockPipeline={flag}"]) == 0
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("block_pipeline: ")])
    assert outs[0] == outs[1] == outs[2]
    assert any(ln.startswith("primal-dual gap") for ln in outs[0])


@pytest.mark.parametrize("flags", [["--blockSize=8", "--blockPipeline=x"],
                                   ["--blockPipeline=on"],
                                   ["--blockSize=0", "--blockPipeline=off"]])
def test_cli_pipeline_refusals_match_jax(flags, capsys):
    assert jax_cli.main(DEMO + flags + ["--mesh=1"]) == 2
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    assert cli.main(DEMO + flags + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert ref.startswith("error: --blockPipeline")
    assert err.strip() == ref
    assert "Running" not in out


def test_cli_pipeline_auto_needs_no_block_size(capsys):
    argv = [a for a in DEMO if not a.startswith("--numRounds")]
    assert cli.main(argv + ["--numRounds=2", "--device=cpu",
                            "--blockPipeline=auto"]) == 0
    assert "CoCoA has finished running" in capsys.readouterr().out
