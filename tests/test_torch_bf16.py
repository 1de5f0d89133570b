"""bfloat16 through the port's --math=fast routes, and the end-of-run
summary, against the JAX CLI on the CPU.

The JAX auto-select keeps 2-byte dtypes off its kernels and runs them all
the same (cocoa_tpu/solvers/cocoa.py ``itemsize == 4``); the port's
routes send them to the kernels' plain versions on every device, while
the CUDA kernels themselves keep refusing them.  The summary is computed
as the JAX CLI's ``finish`` computes it: each device sum combined on the
host in float64."""

import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import cli, kernels  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import load_libsvm, shard_dataset  # noqa: E402
from cocoa_torch.ops import block_chain as bc  # noqa: E402
from cocoa_torch.ops import dense_sdca, sparse_block, sparse_sdca  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402

DEMO = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
        "--numSplits=4", "--numRounds=20", "--localIterFrac=0.1"]
BF16_FAST = ["--dtype=bfloat16", "--math=fast"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)
# one bfloat16 ulp is at most 2^-7 of a value (8 significant bits)
BF16_ULP = 2.0 ** -7


def _both(argv):
    """(JAX CLI stdout, port CLI stdout) of one command, each exiting 0."""
    outs = []
    for main, extra in ((jax_cli.main, ["--mesh=1"]),
                        (cli.main, ["--device=cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue())
    return outs


def _numbers(out):
    return _NUMBER_LINE.findall(out)


# the four commands that refused bf16: sequential, in blocks of 8, with
# --blockSize=auto (0 at bf16: the sequential path, as in JAX) and the
# lasso; every round line and the summary agree exactly at 20 rounds
FAST_COMMANDS = {
    "sequential": ["--lambda=.001"],
    "block 8": ["--lambda=.001", "--blockSize=8"],
    "block auto": ["--lambda=.001", "--blockSize=auto"],
    "lasso": ["--objective=lasso", "--lambda=.1"],
}


@pytest.mark.parametrize("name", list(FAST_COMMANDS))
def test_bf16_fast_commands_match_jax(name):
    ref, out = _both(DEMO + BF16_FAST + FAST_COMMANDS[name])
    assert _numbers(out) == _numbers(ref)
    assert len(_numbers(out)) == (2 * 3 if name == "lasso" else 2 * 2 * 3)
    if name == "block auto":
        assert "blockSize=auto: using the sequential path" in out


# where the port and JAX round in other places (the SGD baselines, the
# block round's plain Gram against JAX's densified tile, the lasso's
# later evals), a printed number may differ by one bf16 ulp: each number
# is held to 2^-7 of the primal objective printed with it (the gap and
# the test error are read against the eval's primal)
ULP_COMMANDS = {
    "menu": ["--lambda=.001", "--justCoCoA=false"],
    "menu block 8": ["--lambda=.001", "--justCoCoA=false", "--blockSize=8"],
    "lasso 50 rounds": ["--objective=lasso", "--lambda=.1", "--numRounds=50",
                        "--debugIter=5"],
    "block 8 with test errors": ["--lambda=.001", f"--testFile={SMALL_TEST}",
                                 "--debugIter=5", "--blockSize=8"],
}


@pytest.mark.parametrize("name", list(ULP_COMMANDS))
def test_bf16_runs_within_one_ulp_of_jax(name):
    ref, out = _both(DEMO + BF16_FAST + ULP_COMMANDS[name])
    mine, theirs = _numbers(out), _numbers(ref)
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    scale = None
    for (key, a), (_, b) in zip(mine, theirs):
        a, b = float(a), float(b)
        if key in ("primal objective", "Total Objective Value"):
            scale = abs(b)
        assert abs(a - b) <= BF16_ULP * scale, (key, a, b)


def test_bf16_summary_is_jax_finish():
    """The bf16 demo's summary: each device sum rounded to bf16 (its
    products summed unrounded, as XLA on the CPU fuses them), combined on
    the host in float64, not the round line's bf16 primal and gap."""
    ref, out = _both(DEMO + ["--lambda=.001", "--dtype=bfloat16"])
    for line in ("Total Objective Value: 0.2475",
                 "Duality Gap: 0.09900000000000003",
                 "Total Objective Value: 0.2515", "Duality Gap: 0.125"):
        assert line in ref and line in out
    assert "primal objective: 0.248046875" in out
    assert _numbers(out) == _numbers(ref)


def test_float32_test_error_is_jax_finish():
    """The float32 demo's test error: the count of wrong rows over n on
    the host, not the round line's float32 quotient."""
    argv = DEMO + ["--numRounds=100", "--lambda=.001", "--dtype=float32",
                   f"--testFile={SMALL_TEST}"]
    ref, out = _both(argv)
    assert "test error: 0.02500000037252903" in out
    for got in (ref, out):
        assert re.findall(r"Test Error: (\S+)", got) == ["0.025", "0.025"]


@pytest.mark.parametrize("block", [0, 8])
def test_bf16_route_is_plain_on_every_device(monkeypatch, tiny_data, block):
    """With every kernel wrapper barred, as on a CUDA tensor that the
    kernels do not take, a bf16 run goes through the plain versions: the
    dtype decides the route before any launch."""
    def barred(*args, **kw):
        raise AssertionError("a kernel wrapper was called at bf16")

    monkeypatch.setattr(kernels, "runs_plain", lambda device: False)
    from cocoa_torch.ops import local_sdca
    from cocoa_torch.solvers import cocoa as cocoa_mod
    for mod, names in ((cocoa_mod, ("sparse_sdca_round", "dense_sdca_round")),
                       (local_sdca, ("sparse_block_gram", "sparse_block_apply",
                                     "chain_block_batched", "fused_block"))):
        for name in names:
            monkeypatch.setattr(mod, name, barred)
    ds = shard_dataset(tiny_data, k=4, layout="sparse",
                       dtype=torch.bfloat16, device="cpu")
    params = Params(n=tiny_data.n, num_rounds=4, local_iters=10, lam=0.01)
    w, alpha, traj = run_cocoa(ds, params, DebugParams(debug_iter=2, seed=3),
                               plus=True, math="fast", block_size=block,
                               quiet=True)
    assert w.dtype == torch.bfloat16 and torch.isfinite(w.float()).all()
    assert [r.round for r in traj.records] == [2, 4]


def test_kernels_refuse_bf16():
    """Called directly, every CUDA kernel's wrapper still refuses bf16, on
    any device, before its plain route."""
    bf = torch.bfloat16
    k, b, width, d, n = 2, 4, 3, 7, 5
    gidx = torch.zeros(k, b, width, dtype=torch.int32)
    gvals = torch.zeros(k, b, width, dtype=bf)
    cnts = torch.full((k, b), width, dtype=torch.int32)
    idx = torch.zeros(k, b, dtype=torch.int32)
    w, dw, coefs = (torch.zeros(d, dtype=bf), torch.zeros(k, d, dtype=bf),
                    torch.zeros(k, b, dtype=bf))
    alpha, lab = torch.zeros(k, n, dtype=bf), torch.ones(k, n, dtype=bf)
    calls = [
        lambda: sparse_sdca.sparse_sdca_round(
            w, alpha, torch.zeros(k, n, width, dtype=torch.int32),
            torch.zeros(k, n, width, dtype=bf), lab, lab, idx, 0.1, n),
        lambda: dense_sdca.dense_sdca_round(
            w, alpha, torch.zeros(k, n, d, dtype=bf), lab, lab, idx, 0.1, n),
        lambda: sparse_block.sparse_block_gram(w, dw, gidx, gvals, cnts, 1.0,
                                               False),
        lambda: sparse_block.sparse_block_apply(dw, gidx, gvals, cnts, coefs),
        lambda: bc.chain_block_batched(torch.zeros(k, 6, b, dtype=bf),
                                       torch.zeros(k, b, b, dtype=bf), idx,
                                       1.0, 1.0, 1.0, False, "hinge"),
        lambda: bc.fused_block(torch.zeros(k, b, d, dtype=bf), idx, coefs,
                               coefs, coefs, coefs, dw, 1.0, 1.0, 1.0, False,
                               "hinge"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="float32 or float64"):
            call()
    assert not kernels.takes_dtype(bf) and not kernels.takes_dtype(
        torch.float16)
    assert all(kernels.takes_dtype(t) for t in kernels.DTYPES)


def test_summary_parts_match_the_fused_eval_in_float64(tiny_data):
    """In float64 the host-combined summary equals the fused eval to
    rounding: the same sums, fetched apart."""
    from cocoa_torch.evals import objectives
    ds = shard_dataset(tiny_data, k=3, layout="sparse", dtype=torch.float64,
                       device="cpu")
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.normal(size=ds.num_features) * 0.1)
    alpha = torch.as_tensor(rng.uniform(size=(ds.k, ds.n_shard))) \
        * ds.shard_arrays()["mask"]
    primal, gap, err = objectives.evaluate(ds, w, alpha, 0.01, test_ds=ds)
    p = objectives.primal_objective(ds, w, 0.01)
    np.testing.assert_allclose(p, primal, rtol=1e-12)
    np.testing.assert_allclose(p - objectives.dual_objective(ds, w, alpha,
                                                             0.01),
                               gap, rtol=1e-12)
    assert objectives.classification_error(ds, w) == pytest.approx(err,
                                                                   abs=1e-15)
