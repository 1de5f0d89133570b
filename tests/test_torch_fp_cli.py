"""``--fp`` through the CLI: the demo on a gloo gang of 2 dp positions x
2 fp slices (four ranks of tests/torch_fp_cli_worker.py, one launch for
the module, each job a ``cli.run``) against the JAX CLI's (2, 2) fp mesh
on the conftest's virtual CPU devices, every printed number at rtol
1e-9: the reference menu, the split block round, a checkpointed run, the
gang resuming its own checkpoints and the JAX CLI's, and one port process
resuming the gang's.  A K = 2 gang without fp prints the same numbers as
the K = 2 x F = 2 gang (its sums are not counted F times).  Then every
refusal that involves ``--fp``, with the JAX CLI's words and exit 2
(tests/test_chaos.py:370-375 for ``--elastic``)."""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import cli  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "torch_fp_cli_worker.py")
RTOL = 1e-9
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=2",
        "--numRounds=20", "--localIterFrac=0.1", "--lambda=.001",
        "--dtype=float64", "--debugIter=10"]
FP = ["--fp=2"]
# the menu checkpoints at round 15; a resume from it runs rounds 16-20
CKPT = ["--chkptIter=15"]
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


def _numbers(text):
    return _NUMBER_LINE.findall(text)


def _same_numbers(got, want):
    assert [k for k, _ in got] == [k for k, _ in want] and got
    np.testing.assert_allclose([float(v) for _, v in got],
                               [float(v) for _, v in want], rtol=RTOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax(argv, capsys):
    rc = jax_cli.main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI's references (in this process) and the gang's jobs
    (one launch of four ranks): {tag: [(rc, out, err) per rank]}."""
    tmp = tmp_path_factory.mktemp("fp_cli")
    ck, jck = str(tmp / "ck"), str(tmp / "jck")
    # the JAX CLI's fp menu, checkpointing at round 15
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(DEMO + FP + ["--justCoCoA=false",
                                         f"--chkptDir={jck}"] + CKPT) == 0
    ref = out.getvalue()
    jobs = [dict(tag="menu", world=4,
                 argv=DEMO + FP + ["--justCoCoA=false", "--mesh=2",
                                   f"--chkptDir={ck}"] + CKPT),
            dict(tag="dp", world=2, argv=DEMO),
            dict(tag="block", world=4,
                 argv=DEMO + FP + ["--math=fast", "--blockSize=16"]),
            dict(tag="resume", world=4,
                 argv=DEMO + FP + [f"--chkptDir={ck}", "--resume"]),
            dict(tag="jax resume", world=4,
                 argv=DEMO + FP + [f"--chkptDir={jck}", "--resume"]),
            dict(tag="mesh=1", world=2, argv=DEMO + FP + ["--mesh=1"])]
    for job in jobs:
        job["port"] = _free_port()
    spec = str(tmp / "jobs.json")
    with open(spec, "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), spec,
                               str(tmp)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in range(4)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    gang = {job["tag"]: [(ranks[r][job["tag"]]["rc"],
                          ranks[r][job["tag"]]["out"],
                          ranks[r][job["tag"]]["err"])
                         for r in range(job["world"])] for job in jobs}
    return gang, ref, ck


def _ranks_ok(results):
    for rc, out, err in results:
        assert rc == 0, err[-2000:]
    # every rank prints the same numbers, bit for bit
    first = _numbers(results[0][1])
    assert all(_numbers(out) == first for _, out, _ in results[1:])
    return results[0][1]


def test_demo_menu_prints_the_jax_fp_run(runs):
    gang, ref, _ = runs
    out = _ranks_ok(gang["menu"])
    for r, (_, text, _) in enumerate(gang["menu"]):
        assert (f"gang: rank {r} of 4 on cpu, device group gloo, dp "
                f"position {r // 2} of 2, fp slice {r % 2} of 2; chunks "
                f"eager (the CPU)") in text
    # six algorithms: CoCoA+, CoCoA and mini-batch CD print primal, gap
    # and test error at two evals and in the summary, the SGDs and
    # DistGD primal and test error
    assert len(_numbers(ref)) == 3 * 9 + 3 * 6
    _same_numbers(_numbers(out), _numbers(ref))


def test_fp_gang_prints_the_dp_gang_numbers(runs):
    """K = 2 x F = 2 prints what the K = 2 gang without fp prints: the
    dw and eval sums run over the dp group only."""
    gang, _, _ = runs
    fp_out = _ranks_ok(gang["menu"])
    dp_out = _ranks_ok(gang["dp"])
    assert "fp slice" not in dp_out
    dp = _numbers(dp_out)
    assert len(dp) == 2 * 9
    _same_numbers(_numbers(fp_out)[:len(dp)], dp)


def test_block_round_prints_the_jax_fp_run(runs, capsys):
    gang, _, _ = runs
    out = _ranks_ok(gang["block"])
    rc, ref, _ = _jax(DEMO + FP + ["--math=fast", "--blockSize=16"], capsys)
    assert rc == 0
    _same_numbers(_numbers(out), _numbers(ref))


def test_checkpoints_and_resume_both_ways(runs, capsys):
    """The menu's round-15 checkpoints hold the whole w (9952 columns,
    the pad zero) and alpha; the gang resumes its own and the JAX CLI's
    fp ones, and one port process without fp resumes the gang's (w cut
    back to 9947 columns), each printing the JAX run's round-20 eval and
    summary."""
    gang, ref, ck = runs
    files = sorted(f for f in os.listdir(ck) if f.startswith("CoCoA")
                   and f.endswith(".npz"))
    assert files == ["CoCoA+-r000015.npz", "CoCoA-r000015.npz"]
    with np.load(os.path.join(ck, files[0])) as f:
        assert f["w"].shape == (9952,)
        np.testing.assert_array_equal(f["w"][DEMO_NUM_FEATURES:], 0.0)
        assert f["alpha"].shape[0] == 2
    # CoCoA+ and CoCoA print 9 numbers each (two evals, the summary); a
    # run resumed at round 15 prints round 20's eval and the summary
    ref = _numbers(ref)
    tail = ref[3:9] + ref[12:18]
    for tag in ("resume", "jax resume"):
        out = _ranks_ok(gang[tag])
        assert "resuming CoCoA+ from round 15" in out
        _same_numbers(_numbers(out), tail)
    rc = cli.main(DEMO + [f"--chkptDir={ck}", "--resume", "--device=cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "resuming CoCoA from round 15" in out
    _same_numbers(_numbers(out), tail)


def test_mesh_1_beside_fp_is_refused_in_a_gang(runs, capsys):
    gang, _, _ = runs
    rc_j, _, err_j = _jax(DEMO + FP + ["--mesh=1"], capsys)
    assert rc_j == 2 and "incompatible with the --mesh=1" in err_j
    for rc, out, err in gang["mesh=1"]:
        assert rc == 2 and err == err_j and "Running" not in out


# --- the refusals, in one process ----------------------------------------

# each flag set with the JAX CLI's words; the port, without --master,
# counts the JAX CLI's devices (8 virtual CPUs) as its host's, so that
# both CLIs resolve the same mesh at the same point of their checks
REFUSALS = [
    (["--fp=x"], "must be an integer"),
    (["--fp=0"], "must be >= 1"),
    (["--fp=2", "--objective=lasso"], "--fp does not apply"),
    (["--fp=2", "--ingestCache=CACHE"], "feature-parallel"),
    (["--fp=2", "--ingest=stream"], "feature-parallel"),
    (["--fp=2", "--layout=sparse"], "layout='dense'"),
    (["--fp=2", "--mesh=3"], "needs a divisor of numSplits"),
    (["--fp=2", "--numSplits=4", "--mesh=2"], "requires a 4x2-device mesh"),
]


@pytest.mark.parametrize("extra,needle", REFUSALS,
                         ids=[" ".join(e) for e, _ in REFUSALS])
def test_fp_refusals_match_the_jax_cli(extra, needle, tmp_path, capsys,
                                      monkeypatch):
    extra = [a.replace("CACHE", str(tmp_path / "cache")) for a in extra]
    argv = DEMO + extra
    rc_j, out_j, err_j = _jax(argv, capsys)
    assert rc_j == 2 and needle in err_j and "Running" not in out_j
    monkeypatch.setattr(cli, "_local_devices", lambda device: 8)
    rc = cli.main(argv + ["--device=cpu"])
    out, err = capsys.readouterr()
    assert rc == 2 and "Running" not in out
    assert err == err_j


def test_fp_without_a_gang_names_the_mesh_it_needs(capsys):
    """One process has one device: ``--fp=2`` asks for a 2 x 2 gang."""
    assert cli.main(DEMO + FP + ["--device=cpu"]) == 2
    assert capsys.readouterr().err == (
        "error: --fp=2 requires a 2x2-device mesh (numSplits x fp; shard "
        "multiplexing is dp-only; have 1 devices)\n")


def test_elastic_beside_fp(monkeypatch, capsys):
    """tests/test_chaos.py:370-375 on the port: an fp gang cannot shrink
    (explicit ask refused), the default keeps same-size restarts with the
    JAX CLI's note; a port worker being one rank, N must be K x F."""
    base = DEMO + ["--chkptDir=ck"]
    calls = {}

    def spy(argv, n, **kw):
        calls.update(kw, n=n)
        return 0

    for target in ("cocoa_tpu.elastic.supervise",
                   "cocoa_torch.elastic.supervise"):
        monkeypatch.setattr(target, spy)
    assert cli.main(base + ["--elastic=4,shrink", "--fp=2",
                            "--device=cpu"]) == 2
    err = capsys.readouterr().err
    assert "feature-parallel" in err
    assert jax_cli.main(base + ["--elastic=4,shrink", "--fp=2"]) == 2
    assert capsys.readouterr().err == err
    assert cli.main(base + ["--elastic=4", "--fp=2", "--device=cpu"]) == 0
    assert calls["shrink"] == "off" and calls["n"] == 4
    err = capsys.readouterr().err
    assert "same-size restarts" in err
    calls.clear()
    assert jax_cli.main(base + ["--elastic=4", "--fp=2"]) == 0
    assert calls["shrink"] == "off"
    assert capsys.readouterr().err == err
    calls.clear()
    assert cli.main(base + ["--elastic=2", "--fp=2", "--device=cpu"]) == 2
    assert capsys.readouterr().err == (
        "error: --elastic=2 with --fp=2: a port worker is one rank, so the "
        "gang needs numSplits x fp = 4 workers\n") and not calls
