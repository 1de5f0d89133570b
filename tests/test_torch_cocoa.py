"""The port's slice end to end against the JAX package: ``run_cocoa`` and
the CLI, float64 on the CPU, both math modes, CoCoA+ and CoCoA -- primal,
gap and test error at every debugIter equal to rtol 1e-9.  Plus the
port's guards: no JAX import, no quiet CPU fallback, unported flags
refused."""

import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9  # float64; the packages sum in different orders
DEMO_ARGV = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
             f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
             "--numRounds=20", "--localIterFrac=0.1", "--lambda=.001",
             "--dtype=float64"]
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


@pytest.mark.parametrize("math", ["exact", "fast"])
@pytest.mark.parametrize("plus", [True, False])
@pytest.mark.parametrize("layout,rng", [("sparse", "reference"),
                                        ("dense", "jax")])
def test_run_cocoa_matches_jax(tiny_data, math, plus, layout, rng):
    ds_j, test_j, ds_t, test_t = _datasets(tiny_data, layout)
    kw = dict(n=tiny_data.n, num_rounds=12, local_iters=20, lam=0.01)
    w_j, a_j, traj_j = jax_run_cocoa(
        ds_j, JaxParams(**kw), JaxDebug(debug_iter=4, seed=3), plus=plus,
        test_ds=test_j, rng=rng, math=math, quiet=True)
    w_t, a_t, traj_t = run_cocoa(
        ds_t, Params(**kw), DebugParams(debug_iter=4, seed=3), plus=plus,
        test_ds=test_t, rng=rng, math=math, quiet=True)
    assert [r.round for r in traj_t.records] == \
        [r.round for r in traj_j.records] == [4, 8, 12]
    for a, b in zip(traj_t.records, traj_j.records):
        np.testing.assert_allclose([a.primal, a.gap, a.test_error],
                                   [b.primal, b.gap, b.test_error],
                                   rtol=RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("math", ["exact", "fast"])
def test_cli_matches_jax_on_demo(math, capsys):
    """The demo command through both CLIs prints the same round and summary
    numbers (CoCoA+ then CoCoA)."""
    assert jax_cli.main(DEMO_ARGV + [f"--math={math}", "--mesh=1"]) == 0
    ref = _NUMBER_LINE.findall(capsys.readouterr().out)
    assert cli.main(DEMO_ARGV + [f"--math={math}", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    mine = _NUMBER_LINE.findall(out)
    assert "Running CoCoA+ on 2000 data examples, distributed over 4 " \
        "workers" in out
    assert [k for k, _ in mine] == [k for k, _ in ref]
    assert len(mine) == 2 * (2 * 3 + 3)  # two evals and a summary, twice
    np.testing.assert_allclose([float(v) for _, v in mine],
                               [float(v) for _, v in ref], rtol=RTOL)


def test_cli_without_cuda_refuses_to_run(capsys):
    """No --device=cpu and no CUDA: exit 2 with ``error:``, nothing run."""
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        assert cli.main(DEMO_ARGV) == 2
    out, err = capsys.readouterr()
    assert err.startswith("error:") and "--device=cpu" in err
    assert "Running" not in out


def test_library_without_cuda_refuses_to_run(tiny_data):
    """The library's entry points default to CUDA too: without it and
    without device="cpu" they raise instead of building CPU tensors."""
    ds_j = jax_shard(tiny_data, k=4, layout="sparse", dtype=jnp.float64)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    data = LibsvmData(labels=tiny_data.labels, indptr=tiny_data.indptr,
                      indices=tiny_data.indices, values=tiny_data.values,
                      num_features=tiny_data.num_features)
    calls = [
        lambda: shard_dataset(data, 4),
        lambda: interop.dataset_from_numpy(arrays, "sparse", ds_j.n,
                                           ds_j.num_features),
        lambda: interop.state_from_numpy(np.zeros(3), np.zeros((4, 2))),
    ]
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert shard_dataset(data, 4, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("flag", [
    "--ingest=stream", "--ingestCache=c", "--staleRounds=1",
    "--elastic=2", "--overlapComm=on", "--stallTimeout=60",
    "--fleetLanes=2", "--statusPort=0", "--fleet=f.jsonl", "--serve=7000",
    "--fp=2"])
def test_cli_unported_flags_exit_2(flag, capsys):
    name = flag.lstrip("-").split("=")[0]
    # the ingest flags are ported: refused beside the lasso, with the JAX
    # CLI's exit code and message
    extra = ["--objective=lasso"] if name in cli._INGEST_FLAGS else []
    assert cli.main(DEMO_ARGV + ["--device=cpu", flag] + extra) == 2
    out, err = capsys.readouterr()
    if (name in cli._SERVE_FLAGS or name in cli._FLEET_FLAGS
            or name in cli._INGEST_FLAGS):
        # the serving and fleet flags are ported: refused beside these
        # training flags with the JAX CLI's exit code and message
        assert jax_cli.main(DEMO_ARGV + [flag] + extra) == 2
        assert err == capsys.readouterr().err and err.startswith("error: ")
    else:
        assert f"error: --{name} is not yet ported to cocoa_torch " \
            f"(ROADMAP Queue A)" in err
    assert "Running" not in out


@pytest.mark.parametrize("change,needle", [
    ("--trainFile=missing.dat", "missing.dat"),
    ("--numFeatures=100", "numFeatures"),
    ("--numSplits=3000", "every shard needs at least one example"),
    ("--dtype=float16", "--dtype"),
    ("--math=approx", "--math"),
])
def test_cli_bad_input_exits_2(change, needle, capsys):
    key = change.split("=")[0]
    argv = [a for a in DEMO_ARGV if not a.startswith(key + "=")]
    assert cli.main(argv + ["--device=cpu", change]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and needle in err


def test_port_imports_no_jax():
    """Every cocoa_torch module, chip_smoke.py, time_dense_sdca.py,
    time_fused_block.py, time_sparse_sdca.py, time_block_round.py and
    probe_ingest_memory.py import without pulling in jax or cocoa_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cocoa_torch\n"
        "for m in pkgutil.walk_packages(cocoa_torch.__path__, "
        "'cocoa_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, time_dense_sdca, time_fused_block, "
        "time_sparse_sdca, time_block_round, probe_ingest_memory\n"
        "assert {'cocoa_torch.parallel.distributed', "
        "'cocoa_torch.parallel.mesh'} <= set(sys.modules)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cocoa_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
