"""The chunked round loop (``--scanChunk``) and where its tables are made
(``--sampling``) through both CLIs, float64 on the CPU, mirroring
tests/test_solvers.py::test_scan_chunk_equals_per_round,
tests/test_device_paths.py and
tests/test_device_sampling.py::test_solver_trajectory_device_vs_host_sampling.

Each command runs on a small synthetic set (96 rows, 24 features, K=4,
12 rounds, 24 for ``--accel``, an eval every 4) through the port at
every ``--scanChunk`` in {1, 3, default} x ``--sampling`` in {host,
device, auto}, and through the JAX CLI at one of those nine settings, a
different one for each command (the JAX package's own tests hold its
output to be the same at every setting).  The commands: CoCoA+ and CoCoA, the ``--justCoCoA=false`` menu
(SGD with its eta(t), DistGD, mini-batch CD) with ``--blockSize=auto``
(the sequential path at float64), the block round at ``--blockSize=4``,
``--objective=lasso``, and one ladder run each of ``--sigma=auto``,
``--accel=on`` and ``--warmStart``.

Tolerances (the driver ladder's): each line of the JAX CLI's output,
the flag echo left out, with equal text, stop rounds and sigma'; primal
objectives and test errors to relative 1e-12, gaps to 1e-12 of the primal
printed before them.  Among themselves the port's nine settings print the
same lines character for character, and those lines hash to what the
port's CLI printed before rounds ran in captured chunks (the commit
before ``--scanChunk`` and ``--sampling`` were ported, which built every
chunk's tables on the host)."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_gap_target import _ECHO, assert_same_console  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import cli  # noqa: E402

CHUNKS = ("1", "3", None)
SAMPLINGS = ("host", "device", "auto")
SETTINGS = [(c, s) for c in CHUNKS for s in SAMPLINGS]
COMMON = ["--numSplits=4", "--numRounds=12", "--debugIter=4",
          "--localIterFrac=0.25", "--lambda=.01", "--dtype=float64",
          "--seed=3"]
# name -> (flags, with the test file, the JAX setting's index in SETTINGS)
COMMANDS = {
    "cocoa": ([], True, 0),
    "menu": (["--justCoCoA=false", "--math=fast", "--blockSize=auto",
              "--rng=permuted"], True, 4),
    "block": (["--math=fast", "--blockSize=4", "--rng=jax"], True, 8),
    "lasso": (["--objective=lasso", "--lambda=.1", "--math=fast"], False, 2),
    "sigma": (["--sigma=auto", "--gapTarget=1e-9", "--math=fast"], True, 6),
    "accel": (["--accel=on", "--gapTarget=1e-9", "--math=fast",
               "--rng=permuted", "--numRounds=24"], True, 3),
    "warm": (["--warmStart=0.5,4", "--gapTarget=1e-9"], True, 7),
}
# the sha256 of each command's lines (:func:`console`) as the port's CLI
# printed them before chunks were captured, with --device=cpu
BEFORE = {
    "cocoa":
        "b10067d5865d7c68801df626c0ea8e99041ccb9295d70f552e60d839eee2f115",
    "menu":
        "f79b0baef0051fea7c074fee7228a0fcc3a18b52b0de92611803501e83e4a52b",
    "block":
        "b8642f37af1263307183bf073880cccc03a77e2bfe1bb5427a8d3931657f44ab",
    "lasso":
        "9a81ec972b863afc6be36e959b3ae42d9df37089aff333852b9afbc03723b148",
    "sigma":
        "c4e1af06883912c64be6cde6e7ec0c51038e7b2781972c9c310b77964664c6c5",
    "accel":
        "3dd565b76ea430c4d2d75b2ac9cca920cf8ecc8922b301ca25b63519a1687b1e",
    "warm":
        "da4bb97cace8973f3bec16db8f2de41f98ffeae0e50e536b172a1c880bc4c725",
}


def write_train(path):
    """96 rows of 24 features, about 40 % nonzero, labels from a planted
    w, in LIBSVM text (17 significant digits, so both parsers read the
    same doubles)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(96, 24)) * (rng.random((96, 24)) < 0.4)
    y = np.where(X @ rng.normal(size=24) > 0, 1, -1)
    lines = []
    for row, label in zip(X, y):
        nz = np.nonzero(row)[0]
        lines.append(" ".join([f"{label:+d}"] + [f"{j + 1}:{row[j]:.17g}"
                                                 for j in nz]))
    path.write_text("\n".join(lines) + "\n")


def argv_of(name, train):
    flags, with_test, _ = COMMANDS[name]
    files = [f"--trainFile={train}", "--numFeatures=24"]
    if with_test:
        files.append(f"--testFile={train}")
    return files + COMMON + flags


def setting_flags(chunk, sampling):
    return ([f"--scanChunk={chunk}"] if chunk else []) + \
        [f"--sampling={sampling}"]


def console(out):
    """The lines the two CLIs share: the flag echo left out."""
    return [ln for ln in out.splitlines() if not _ECHO.match(ln)
            or ln.startswith(("primal", "test error"))]


def digest(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    path = tmp_path_factory.mktemp("scan_chunk") / "train.dat"
    write_train(path)
    return path


@pytest.mark.parametrize("name", list(COMMANDS))
def test_cli_settings_match_jax_and_each_other(name, train, capsys):
    argv = argv_of(name, train)
    chunk, sampling = SETTINGS[COMMANDS[name][2]]
    assert jax_cli.main(argv + setting_flags(chunk, sampling)
                        + ["--mesh=1"]) == 0
    ref = capsys.readouterr().out
    outs = {}
    for setting in SETTINGS:
        assert cli.main(argv + setting_flags(*setting)
                        + ["--device=cpu"]) == 0
        outs[setting] = capsys.readouterr().out
    first = console(outs[SETTINGS[0]])
    assert "Iteration: 12" in first
    for setting, out in outs.items():
        assert console(out) == first, setting
    assert_same_console(ref, outs[SETTINGS[0]])
    assert digest(first) == BEFORE[name]


def test_scan_chunk_must_be_an_integer(train, capsys):
    """Both CLIs' message for a --scanChunk that is not an integer."""
    argv = argv_of("cocoa", train) + ["--scanChunk=3.5"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 2
    err_j = capsys.readouterr().err
    assert cli.main(argv + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert err.strip() == err_j.strip() == \
        "error: --scanChunk must be an integer, got '3.5'"
    assert "Running" not in out


def test_sampling_errors_match_jax(train, capsys):
    """--sampling=device where the JAX rule says device tables are not
    exact (a seed at the int32 edge), and a setting that is not one."""
    for extra, needle in ((["--sampling=device", "--seed=2147483640"],
                           "device sampling is not exact"),
                          (["--sampling=bogus"], "sampling must be")):
        argv = argv_of("cocoa", train) + extra + ["--device=cpu"]
        assert cli.main(argv) == 2
        err = capsys.readouterr().err
        assert err.startswith("error: ") and needle in err
        with pytest.raises(ValueError, match=needle):
            jax_cli.main(argv_of("cocoa", train) + extra + ["--mesh=1"])
        capsys.readouterr()
