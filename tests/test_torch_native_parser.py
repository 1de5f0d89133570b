"""The port's native LIBSVM parser (cocoa_torch/data/native_loader.py,
built from native/libsvm_parser.cpp into cocoa_torch/_build/) against the
port's Python parser and the JAX package's parsers, bit for bit: the demo
file, the malformed-tail and byte-level cases and the byte-range tilings
of tests/test_libsvm.py; two builds at once leave one good library; no
compiler falls back to the Python parser with a warning; the CLI parses
through it; and ``python -m cocoa_torch`` runs the demo."""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu.data import libsvm as jax_libsvm  # noqa: E402
from cocoa_tpu.data import native_loader as jax_native  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.data import libsvm, native_loader  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("labels", "indptr", "indices", "values")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.fixture(scope="module")
def native():
    if not native_loader.available():
        pytest.fail("the native parser did not build (a C++ compiler is "
                    "expected here)")
    return native_loader


def test_demo_equals_python_and_jax(native):
    nat = native.parse_file(SMALL_TRAIN, DEMO_NUM_FEATURES)
    _same(nat, libsvm.load_libsvm_python(SMALL_TRAIN, DEMO_NUM_FEATURES))
    _same(nat, jax_libsvm.load_libsvm_python(SMALL_TRAIN, DEMO_NUM_FEATURES))
    if jax_native.available():
        _same(nat, jax_native.parse_file(SMALL_TRAIN, DEMO_NUM_FEATURES))
    _same(libsvm.load_libsvm(SMALL_TRAIN, DEMO_NUM_FEATURES), nat)
    assert native_loader.library_path().parent == REPO / "cocoa_torch" / \
        "_build"
    assert native_loader.library_path().exists()


# tests/test_libsvm.py ``test_native_parser_malformed_whitespace_tails``'s
# files: (bytes, num_features)
MALFORMED = {
    "space after colon": (b"1 3: \n-1 1:7.0\n", 10),
    "vertical tab": (b"1 \v\n-1 1:7.0\n", 10),
    "parity": (b"1 1:1.0 3: 5.0\n-1 1:2.0 2:3.0x 4:9\n1 1:4.0 2:5:6 4:9\n"
               b"-1 3.5:1.0\n1 2 3\n-1 1:7.0\n", 10),
    "grammar": (b"1 1:0x10 2:3.0\n1 1:nan(0) 2:3.0\n1 1:inf 2:3.0\n"
                b"1 \xd9\xa1:2.0\n1 1:1_0.5 2:3.0\n1 1:2.0\xc2\xa03:4.0\n"
                b"0x1 1:5.0\n-1 1:7.0\n", 10),
    "bytes": (b"1 1:2.0\r2:3.0\n1 1:4.0 \xff 2:6.0\n"
              b"1 4294967301:2.0 2:8.0\n1 0:9.0 2:8.0\n"
              b"-1 2147483648:5.0\n", 2**31),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_tails_equal_python(native, tmp_path, name):
    text, d = MALFORMED[name]
    path = tmp_path / "m.svm"
    path.write_bytes(text)
    nat = native.parse_file(str(path), d)
    _same(nat, libsvm.load_libsvm_python(str(path), d))
    _same(nat, jax_libsvm.load_libsvm_python(str(path), d))


def test_page_sized_file_with_malformed_last_line(native, tmp_path):
    import mmap

    head, tail = b"+1 1:1.0\n", b"1 2: \n"
    path = tmp_path / "page.svm"
    path.write_bytes(head + b"\n" * (2 * mmap.PAGESIZE - len(head)
                                     - len(tail)) + tail)
    nat = native.parse_file(str(path), 10)
    _same(nat, libsvm.load_libsvm_python(str(path), 10))
    np.testing.assert_array_equal(nat.indptr, [0, 1, 1])


RANGE_FIXTURE = (b"1 1:1.0 2:2.5\n\n-1 3: \n1 1:4.0\r2:3.0\n\r\n"
                 b"-1 2:3.0x 4:9\n1 5:6.25")


def _tiled(parse, path, d, splits):
    bounds = [0, *splits, os.path.getsize(path)]
    parts = [parse(path, d, lo, hi) for lo, hi in zip(bounds, bounds[1:])]
    nnz = np.concatenate([np.diff(p.indptr) for p, _ in parts])
    return (np.concatenate([p.labels for p, _ in parts]),
            np.concatenate([[0], np.cumsum(nnz)]),
            np.concatenate([p.indices for p, _ in parts]),
            np.concatenate([p.values for p, _ in parts]),
            np.concatenate([o for _, o in parts]))


def _parsers():
    return {"python": libsvm.load_libsvm_python_range,
            "native": lambda p, d, lo, hi: native_loader.parse_range(
                p, lo, hi, d),
            "load_libsvm_range": libsvm.load_libsvm_range}


def test_range_tiles_to_whole_every_split(native, tmp_path):
    """Every split point of the fixture, on every parser: the two ranges
    give the whole file's rows and offsets; native and Python agree on
    each range."""
    path = str(tmp_path / "range.svm")
    Path(path).write_bytes(RANGE_FIXTURE)
    size = len(RANGE_FIXTURE)
    for name, parse in _parsers().items():
        whole, woff = parse(path, 10, 0, size)
        np.testing.assert_array_equal(whole.labels, [1, -1, 1, -1, 1])
        for cut in range(size + 1):
            got = _tiled(parse, path, 10, [cut])
            for a, b in zip(got, (*[getattr(whole, f) for f in FIELDS],
                                  woff)):
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {cut}")
    for cut in range(size + 1):
        for lo, hi in ((0, cut), (cut, size)):
            py, py_off = libsvm.load_libsvm_python_range(path, 10, lo, hi)
            nat, nat_off = native.parse_range(path, lo, hi, 10)
            _same(nat, py)
            np.testing.assert_array_equal(nat_off, py_off)


def test_three_way_tiling_of_the_demo(native):
    size = os.path.getsize(SMALL_TRAIN)
    whole = libsvm.load_libsvm_python(SMALL_TRAIN, 2**31)
    for name, parse in _parsers().items():
        for splits in ([size // 3, 2 * size // 3], [1, size - 1],
                       [997, 998, size // 2 + 13]):
            got = _tiled(parse, SMALL_TRAIN, 2**31, splits)
            for f, a in zip(FIELDS, got):
                np.testing.assert_array_equal(a, getattr(whole, f),
                                              err_msg=name)


def test_two_builds_at_once_leave_one_good_library(native, tmp_path):
    code = ("import sys; from cocoa_torch.data import native_loader as n; "
            "print(n.build(sys.argv[1]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    lib = native_loader.library_path(tmp_path)
    assert outs == [str(lib)] * 2
    assert sorted(os.listdir(tmp_path)) == [lib.name]
    bound = native_loader._bind(lib)
    with mock.patch.object(native_loader, "_load", lambda: bound):
        _same(native_loader.parse_file(SMALL_TEST, DEMO_NUM_FEATURES),
              libsvm.load_libsvm_python(SMALL_TEST, DEMO_NUM_FEATURES))


def test_no_compiler_falls_back_with_a_warning(tmp_path):
    native_loader._load.cache_clear()
    try:
        with mock.patch.object(native_loader, "BUILD_DIR", tmp_path), \
                mock.patch.object(native_loader, "_compiler",
                                  lambda: None):
            with pytest.warns(RuntimeWarning, match="Python parser"):
                assert not native_loader.available()
            got = libsvm.load_libsvm(SMALL_TRAIN, DEMO_NUM_FEATURES)
    finally:
        native_loader._load.cache_clear()
    _same(got, libsvm.load_libsvm_python(SMALL_TRAIN, DEMO_NUM_FEATURES))
    assert os.listdir(tmp_path) == []


def test_validation_and_missing_file(native, tmp_path):
    path = tmp_path / "wide.svm"
    path.write_bytes(b"1 5:1.0\n")
    with pytest.raises(ValueError, match="exceeds num_features=4"):
        libsvm.load_libsvm(str(path), 4)
    with pytest.raises(OSError):
        libsvm.load_libsvm(str(tmp_path / "missing.svm"), 4)


def test_cli_parses_through_the_native_parser(native, capsys):
    argv = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
            f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
            "--numRounds=2", "--localIterFrac=0.1", "--lambda=.001",
            "--debugIter=2", "--device=cpu"]
    with mock.patch.object(native_loader, "parse_file",
                           wraps=native_loader.parse_file) as spy:
        assert cli.main(argv) == 0
    assert [c.args[0] for c in spy.call_args_list] == [SMALL_TRAIN,
                                                        SMALL_TEST]
    assert "CoCoA has finished running" in capsys.readouterr().out


def test_python_m_cocoa_torch_runs_the_demo():
    res = subprocess.run(
        [sys.executable, "-m", "cocoa_torch", f"--trainFile={SMALL_TRAIN}",
         f"--testFile={SMALL_TEST}", f"--numFeatures={DEMO_NUM_FEATURES}",
         "--numSplits=4", "--numRounds=2", "--localIterFrac=0.1",
         "--lambda=.001", "--debugIter=2", "--device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "CoCoA+ has finished running" in res.stdout
    assert "CoCoA has finished running" in res.stdout
