"""Which fault an argv with two faults names: the port makes its checks
in the JAX CLI's order, so both CLIs print the same line and exit 2, though
the JAX CLI makes some of its checks only after it has loaded the training
file (the lasso's ``--testFile``, ``--l2``, the guard, ``--blockSize``)
and the port makes them all before.  Without ``--master`` the port
resolves ``--mesh`` and ``--fp`` at the JAX CLI's point, over the JAX
CLI's device count (8 virtual CPUs, given to the port as its host's); a
``--master`` gang's geometry is the exception, checked as it joins
(ROADMAP, "Which error a bad argv names")."""

import io
from contextlib import redirect_stderr, redirect_stdout

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import cli  # noqa: E402

DEMO = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
        "--numSplits=4", "--numRounds=20", "--localIterFrac=0.1",
        "--lambda=.001"]
LASSO_HOT = ["--objective=lasso", "--hotCols=auto"]

# (the flags beside the demo's, the words of the line both CLIs print)
PAIRS = {
    # the ladder before the lasso's test file (JAX: after its load)
    "accel-testFile": ([f"--testFile={SMALL_TEST}", "--objective=lasso",
                        "--accel=on"], "--accel=on requires --gapTarget"),
    # the ladder before the lasso's hot columns
    "sigma-hotCols": (["--sigma=auto", *LASSO_HOT],
                      "--sigma=auto requires --gapTarget"),
    "anneal-hotCols": (["--sigma=1", "--sigmaSchedule=anneal", *LASSO_HOT],
                       "--sigmaSchedule=anneal requires --gapTarget"),
    # the ladder before --blockSize (JAX: after its load)
    "sigma-blockSize": (["--sigma=auto", "--blockSize=x"],
                        "--sigma=auto requires --gapTarget"),
    # the lasso's hot columns before the guard (JAX: before its load)
    "hotCols-guard": (["--divergenceGuard=bogus", *LASSO_HOT],
                      "--hotCols does not apply"),
    # the guard before the lasso's test file (both after JAX's load)
    "guard-testFile": ([f"--testFile={SMALL_TEST}", "--objective=lasso",
                        "--divergenceGuard=bogus"],
                       "--divergenceGuard must be"),
    # the gang's rank flags before the objective (JAX: as it joins)
    "processId-objective": (["--master=127.0.0.1:1", "--processId=x",
                             "--numProcesses=2", "--objective=bogus"],
                            "--processId/--numProcesses must be integers"),
    # --resume before --blockSize (both after JAX's load)
    "resume-blockSize": (["--resume", "--blockSize=x"],
                         "--resume requires --chkptDir"),
    # --blockSize before the lasso's --l2
    "blockSize-l2": (["--objective=lasso", "--l2=-1", "--blockSize=-2",
                      "--math=fast"], "--blockSize must be >= 0"),
    # the mesh before the objective's checks (no --master: the host's)
    "mesh-hotCols": (["--mesh=3", *LASSO_HOT],
                     "--mesh=3 (x fp=1) needs a divisor of numSplits=4"),
}


def _run(main, argv):
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        rc = main(argv)
    return rc, [ln for ln in se.getvalue().splitlines()
                if ln.startswith("error:")]


@pytest.mark.parametrize("name", list(PAIRS))
def test_two_faults_name_the_jax_fault(name, monkeypatch):
    flags, words = PAIRS[name]
    monkeypatch.setattr(cli, "_local_devices", lambda device: 8)
    rc_j, err_j = _run(jax_cli.main, DEMO + flags)
    rc_p, err_p = _run(cli.main, DEMO + flags + ["--device=cpu"])
    assert rc_j == rc_p == 2
    assert len(err_j) == 1 and words in err_j[0]
    assert err_p == err_j
