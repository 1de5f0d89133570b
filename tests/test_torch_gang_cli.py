"""The gang through the CLI: two ``python -m cocoa_torch.cli`` ranks with
``--master``, ``--processId`` and ``--numProcesses`` on the CPU (gloo)
against the JAX CLI's ``--mesh=2`` and ``--mesh=1`` runs on the demo, the
printed numbers at rtol 1e-9; checkpoints written by a gang resumed by
one port process and by the JAX CLI, and a JAX checkpoint resumed by a
gang, each to 1e-12 of the uninterrupted run; the refusals with the JAX
CLI's messages; and the gang's telemetry (``<events>.p1``, the
manifest's process count)."""

import json
import os
import re
import shutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_gang_cli  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import checkpoint, cli  # noqa: E402
from cocoa_torch.parallel.mesh import Mesh  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402

RTOL = 1e-9
ATOL = 1e-12
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
        "--numRounds=20", "--localIterFrac=0.1", "--lambda=.001",
        "--dtype=float64", "--debugIter=10"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


def _numbers(text):
    return _NUMBER_LINE.findall(text)


def _same_numbers(got, want):
    assert [k for k, _ in got] == [k for k, _ in want] and got
    np.testing.assert_allclose([float(v) for _, v in got],
                               [float(v) for _, v in want], rtol=RTOL)


def gang(argvs, timeout=240):
    """Run one port CLI a rank, ``argvs[r]`` rank r's flags (the gang's
    own are added); returns [(rc, stdout, stderr)], every child killed on
    any failure."""
    return torch_gang_cli.gang(argvs, timeout)


@pytest.fixture(scope="module")
def demo_gang(tmp_path_factory):
    """The demo on a 2-rank gang with --events, --metrics and an explicit
    --mesh=2 (the gang's size)."""
    tmp = tmp_path_factory.mktemp("gang_cli")
    ev, prom = str(tmp / "ev.jsonl"), str(tmp / "m.prom")
    flags = DEMO + [f"--events={ev}", f"--metrics={prom}", "--mesh=2"]
    return gang([flags, flags]), ev, prom


@pytest.mark.parametrize("mesh", ["2", "1"])
def test_two_ranks_print_the_jax_mesh_run(demo_gang, mesh, capsys):
    (r0, r1), _, _ = demo_gang
    for rc, out, err in (r0, r1):
        assert rc == 0, err[-2000:]
        assert "Running CoCoA+ on 2000 data examples, distributed over 4 " \
            "workers" in out
    assert "gang: rank 0 of 2 on cpu, device group gloo" in r0[1]
    assert "gang: rank 1 of 2 on cpu, device group gloo" in r1[1]
    # both ranks print the same lines, bit for bit
    assert _numbers(r0[1]) == _numbers(r1[1])
    assert jax_cli.main(DEMO + [f"--mesh={mesh}"]) == 0
    ref = _numbers(capsys.readouterr().out)
    assert len(ref) == 2 * (2 * 3 + 3)
    _same_numbers(_numbers(r0[1]), ref)


def test_gang_telemetry_streams(demo_gang):
    """Rank 0 writes ``<events>``, rank 1 ``<events>.p1``, both
    schema-valid with a process count of 2; only rank 0 keeps the metrics
    textfile."""
    _, ev, prom = demo_gang
    for rank, path in ((0, ev), (1, ev + ".p1")):
        assert schema.check_file(path) == [], path
        with open(path) as f:
            starts = [json.loads(ln) for ln in f
                      if '"run_start"' in ln]
        man = starts[0]["manifest"]
        assert man["process_count"] == 2
        assert man["process_index"] == rank
        assert man["device_group"] == "gloo"
    assert os.path.exists(prom) and not os.path.exists(prom + ".p1")
    assert not os.path.exists(ev + ".p2")


def _arrays(directory, algorithm, round_t):
    path = os.path.join(directory, f"{algorithm}-r{round_t:06d}.npz")
    meta, arrays = checkpoint.load_full(path)
    assert meta["round"] == round_t
    return arrays


def _close_state(got, want):
    for name in ("w", "alpha"):
        a, b = np.asarray(got[name]), np.asarray(want[name])
        n = tuple(slice(0, s) for s in a.shape)
        np.testing.assert_allclose(a, b[n], rtol=0, atol=ATOL)
        rest = b.copy()
        rest[n] = 0
        assert not np.any(rest), name


def test_checkpoints_both_ways(tmp_path, capsys):
    """A gang's file resumes in one port process and in the JAX CLI, and a
    JAX file resumes in a gang, each to 1e-12 of the uninterrupted run's
    round-20 state; the gang's two ranks write the same file, bit for
    bit."""
    ck = ["--chkptIter=10"]
    half = [a for a in DEMO if not a.startswith("--numRounds")] \
        + ["--numRounds=10"]
    d = {name: str(tmp_path / name)
         for name in ("full", "jfull", "g0", "g1", "jax", "gjax", "jres")}
    # uninterrupted: the port and JAX, 20 rounds
    assert cli.main(DEMO + ck + [f"--chkptDir={d['full']}",
                                 "--device=cpu"]) == 0
    assert jax_cli.main(DEMO + ck + [f"--chkptDir={d['jfull']}",
                                     "--mesh=1"]) == 0
    # a gang writes round 10, each rank into its own directory
    res = gang([half + ck + [f"--chkptDir={d['g0']}"],
                half + ck + [f"--chkptDir={d['g1']}"]])
    assert all(rc == 0 for rc, _, _ in res), res[0][2][-2000:]
    for alg in ("CoCoA+", "CoCoA"):
        a0, a1 = _arrays(d["g0"], alg, 10), _arrays(d["g1"], alg, 10)
        for name in ("w", "alpha"):
            assert a0[name].tobytes() == a1[name].tobytes()
        assert a0["alpha"].shape[0] == 4
    shutil.copytree(d["g0"], d["jres"])
    # the gang's file resumed by one port process and by the JAX CLI
    assert cli.main(DEMO + ck + [f"--chkptDir={d['g0']}", "--resume",
                                 "--device=cpu"]) == 0
    assert "resuming CoCoA+ from round 10" in capsys.readouterr().out
    assert jax_cli.main(DEMO + ck + [f"--chkptDir={d['jres']}", "--resume",
                                     "--mesh=1"]) == 0
    capsys.readouterr()
    # JAX's round-10 file resumed by a gang
    assert jax_cli.main(half + ck + [f"--chkptDir={d['jax']}",
                                     "--mesh=1"]) == 0
    capsys.readouterr()
    shutil.copytree(d["jax"], d["gjax"])
    res = gang([DEMO + ck + [f"--chkptDir={d['jax']}", "--resume"],
                DEMO + ck + [f"--chkptDir={d['gjax']}", "--resume"]])
    assert all(rc == 0 for rc, _, _ in res), res[0][2][-2000:]
    assert "resuming CoCoA from round 10" in res[1][1]
    for alg in ("CoCoA+", "CoCoA"):
        full = _arrays(d["full"], alg, 20)
        _close_state(_arrays(d["g0"], alg, 20), full)
        _close_state(_arrays(d["jax"], alg, 20), full)
        _close_state(full, _arrays(d["jfull"], alg, 20))
        _close_state(full, _arrays(d["jres"], alg, 20))


def _err_lines(capsys):
    return [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("error:")]


@pytest.mark.parametrize("flags", [
    ["--master=spark://host"],
    ["--master=127.0.0.1:1", "--processId=x", "--numProcesses=2"],
    ["--master=127.0.0.1:1", "--processId=0", "--numProcesses=y"],
    ["--mesh=two"],
])
def test_refusals_match_jax(flags, capsys):
    assert jax_cli.main(DEMO + flags) == 2
    want = _err_lines(capsys)
    assert cli.main(DEMO + flags + ["--device=cpu"]) == 2
    assert _err_lines(capsys) == want and len(want) == 1


@pytest.mark.parametrize("mesh", ["3", "2"])
def test_mesh_refusal_names_the_port_devices(mesh, capsys):
    """``--mesh`` that does not divide K (without ``--master``: this
    host's one CPU device), or that is not the gang's size (a
    ``--master`` gang of one rank, its rendezvous stubbed), exits 2 with
    the JAX CLI's sentence and the port's device count."""
    argv = DEMO + [f"--mesh={mesh}"]
    if mesh == "3":
        assert jax_cli.main(argv) == 2
        want = _err_lines(capsys)[0].replace("(have 8)", "(have 1)")
    else:
        want = ("error: --mesh=2 (x fp=1) needs a divisor of numSplits=4 "
                "and mesh x fp devices (have 1); use --mesh=1 for the "
                "single-chip path")
        argv += ["--master=127.0.0.1:1", "--processId=0",
                 "--numProcesses=1"]
    with mock.patch.object(cli.distributed, "maybe_initialize",
                           return_value=True):
        assert cli.main(argv + ["--device=cpu"]) == 2
    assert _err_lines(capsys) == [want]


def test_serve_refuses_the_gang_flags_as_jax(capsys):
    for flag in ("--master=127.0.0.1:1", "--mesh=1", "--processId=0",
                 "--numProcesses=2"):
        argv = ["--serve", flag, "--chkptDir=/nonexistent",
                f"--numFeatures={DEMO_NUM_FEATURES}"]
        assert jax_cli.main(argv) == 2
        want = _err_lines(capsys)
        assert cli.main(argv + ["--device=cpu"]) == 2
        assert _err_lines(capsys) == want and len(want) == 1


def test_device_loop_refused_on_a_gloo_card_gang(capsys):
    """Two ranks on one card exchange over gloo, which a CUDA graph cannot
    capture: --deviceLoop exits 2 saying why (the mesh is stubbed, as
    this machine has no card)."""
    fake = Mesh(0, 2, torch.device("cuda", 0), "gloo")
    with mock.patch.object(cli.distributed, "maybe_initialize",
                           return_value=True), \
            mock.patch.object(cli, "make_mesh", return_value=fake):
        assert cli.main(DEMO + ["--deviceLoop", "--device=cpu",
                                "--master=127.0.0.1:1", "--processId=0",
                                "--numProcesses=2"]) == 2
    err = _err_lines(capsys)
    assert len(err) == 1 and "gloo" in err[0] and "--deviceLoop" in err[0]
    assert "cannot be captured" in err[0]
