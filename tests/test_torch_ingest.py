"""Streaming sharded ingest (cocoa_torch/data/ingest.py) against the JAX
package's (cocoa_tpu/data/ingest.py) on the same files.

The index of pass 1 equals JAX's and the whole parse's at any window; a
streamed build equals the port's whole-file ``shard_dataset`` bit for bit
(``torch.equal``, dtypes included) and JAX's streamed build on the rows
they share (JAX rounds each shard up to 16 rows, the port does not), on
the dense, sparse, hybrid and eval-twin layouts at K = 2 and 4, float32,
float64 and bfloat16 (its 16-bit patterns); a bfloat16 build is the
float64 build through torch's cast; the stats-based resolution equals the
data-based one; the mode rule and its messages are JAX's.  Gangs of 2
and 4 gloo processes (tests/torch_ingest_worker.py) stream only their own
shards, equal bit for bit to ``shard_dataset(..., part=...)``, their rows
tiling n.  The CLI with ``--ingest`` prints the JAX CLI's lines to 1e-12
relative, in one process and as a 2-rank gang, and its refusals carry
JAX's message and exit code 2."""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.data import hybrid as jax_hybrid  # noqa: E402
from cocoa_tpu.data import ingest as jax_ingest  # noqa: E402
from cocoa_tpu.data import sharding as jax_sharding  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.data import hybrid, ingest, load_libsvm  # noqa: E402
from cocoa_torch.data import sharding  # noqa: E402
from cocoa_torch.parallel.mesh import Mesh  # noqa: E402

D = DEMO_NUM_FEATURES
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_ingest_worker.py")
RTOL = 1e-12
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# layout, hot columns, eval twin
LAYOUTS = {"dense": ("dense", 0, False), "sparse": ("sparse", 0, False),
           "hybrid": ("sparse", 128, False), "twin": ("sparse", 0, True),
           "hybrid+twin": ("sparse", 256, True)}
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={D}", "--numSplits=4", "--numRounds=20",
        "--localIterFrac=0.1", "--lambda=.001", "--dtype=float64",
        "--debugIter=10"]
_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


@pytest.fixture(scope="module")
def demo():
    return load_libsvm(SMALL_TRAIN, D)


def assert_equal(a, b):
    """Two port datasets equal bit for bit, field by field."""
    assert (a.layout, a.n, a.num_features, a.k) == \
        (b.layout, b.n, b.num_features, b.k)
    np.testing.assert_array_equal(a.counts, b.counts)
    fa, fb = a.shard_arrays(), b.shard_arrays()
    assert fa.keys() == fb.keys()
    for f in fa:
        assert fa[f].dtype == fb[f].dtype and fa[f].shape == fb[f].shape, f
        assert torch.equal(fa[f], fb[f]), f


def assert_jax_rows(ds, ds_j):
    """The port's shards equal JAX's where they overlap; what JAX holds
    past the port's shapes (rows rounded up to 16, dense columns to 8) is
    its zero padding.  bfloat16 fields are held as their 16-bit
    patterns."""
    fa, fj = ds.shard_arrays(), ds_j.shard_arrays()
    assert fa.keys() == fj.keys()
    for f, t in fa.items():
        j = np.asarray(fj[f])
        if t.dtype == torch.bfloat16:
            assert j.dtype == jnp.bfloat16, f
            a, j = t.view(torch.int16).numpy(), j.view(np.int16)
        else:
            a = t.numpy()
        assert a.dtype == j.dtype and a.ndim == j.ndim, f
        common = tuple(slice(0, s) for s in a.shape)
        np.testing.assert_array_equal(a, j[common], err_msg=f)
        rest = j.copy()
        rest[common] = 0
        assert not rest.any(), f


@pytest.mark.parametrize("window", [ingest.PASS1_WINDOW, 10_000, 777])
def test_build_index_matches_whole_parse_and_jax(demo, window):
    """Pass 1's index is the whole parse's and JAX's at any window (the
    window bounds memory, it means nothing)."""
    index = ingest.build_index(SMALL_TRAIN, D, window=window)
    ref = jax_ingest.build_index(SMALL_TRAIN, D)
    assert index.n == demo.n == ref.n
    assert index.total_nnz == int(demo.indptr[-1])
    np.testing.assert_array_equal(index.row_nnz, np.diff(demo.indptr))
    np.testing.assert_array_equal(index.hist,
                                  np.bincount(demo.indices, minlength=D))
    for f in ("row_off", "row_nnz", "hist"):
        np.testing.assert_array_equal(getattr(index, f), getattr(ref, f))
    assert index.row_off[-1] == os.path.getsize(SMALL_TRAIN)
    assert (np.diff(index.row_off) > 0).all()
    assert index.scan_bytes == os.path.getsize(SMALL_TRAIN)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stream_equals_whole_and_jax(demo, layout, k, dtype):
    lay, hot, twin = LAYOUTS[layout]
    dt, dt_j = DTYPES[dtype]
    ds, info = ingest.stream_shard_dataset(
        SMALL_TRAIN, D, k, layout=lay, dtype=dt, device="cpu",
        hot_cols=hot, eval_dense=twin)
    whole = sharding.shard_dataset(demo, k, layout=lay, dtype=dt,
                                   device="cpu", hot_cols=hot,
                                   eval_dense=twin)
    assert_equal(ds, whole)
    ds_j, info_j = jax_ingest.stream_shard_dataset(
        SMALL_TRAIN, D, k, layout=lay, dtype=dt_j, hot_cols=hot,
        eval_dense=twin)
    assert_jax_rows(ds, ds_j)
    # one process parses every row once, as JAX's does
    assert (info.rows, info.nnz, info.bytes_read, info.residual_max_nnz) \
        == (info_j.rows, info_j.nnz, info_j.bytes_read,
            info_j.residual_max_nnz)
    assert info.bytes_read == os.path.getsize(SMALL_TRAIN)
    assert info.cache_status == "off"


@pytest.mark.parametrize("layout", ["dense", "sparse", "hybrid", "twin"])
def test_bfloat16_is_the_float64_build_cast(tmp_path, layout):
    """A bfloat16 build is the float64 build (``sq_norms`` the float64
    sum) put through torch's one float64 -> bfloat16 cast, as the whole
    build cast it before the per-shard builder: the whole and the
    streamed builds, and JAX's streamed build on the rows they share.
    The values carry all 17 digits, and half of them lie 2^-30 past a
    bfloat16 midpoint (1 + 2^-8, scaled): torch's cast, ml_dtypes' and
    XLA's all pass through float32 there and land on the tie's even
    neighbour, so a builder that rounded otherwise would move bits."""
    rng = np.random.default_rng(7)
    n, d = 48, 24
    path = str(tmp_path / "ties.svm")
    with open(path, "w") as f:
        for i in range(n):
            cols = np.sort(rng.choice(d, size=int(rng.integers(1, 9)),
                                      replace=False))
            ties = (rng.choice([-1.0, 1.0], cols.size)
                    * (1 + 2.0 ** -8 + 2.0 ** -30)
                    * 2.0 ** rng.integers(-3, 4, cols.size).astype(float))
            vals = np.where(rng.random(cols.size) < 0.5, ties,
                            rng.standard_normal(cols.size))
            f.write(f"{1 if i % 2 else -1} " + " ".join(
                f"{c + 1}:{v:.17g}" for c, v in zip(cols, vals)) + "\n")
    lay, hot, twin = {"dense": ("dense", 0, False),
                      "sparse": ("sparse", 0, False),
                      "hybrid": ("sparse", 8, False),
                      "twin": ("sparse", 0, True)}[layout]
    data = load_libsvm(path, d)
    kw = dict(layout=lay, device="cpu", hot_cols=hot, eval_dense=twin)
    wide = sharding.shard_dataset(data, 2, dtype=torch.float64, **kw)
    whole = sharding.shard_dataset(data, 2, dtype=torch.bfloat16, **kw)
    ds, _ = ingest.stream_shard_dataset(path, d, 2, dtype=torch.bfloat16,
                                        **kw)
    assert_equal(ds, whole)
    fw, fb = wide.shard_arrays(), whole.shard_arrays()
    assert fw.keys() == fb.keys()
    for f, t in fw.items():
        if t.is_floating_point():
            assert fb[f].dtype == torch.bfloat16, f
            assert torch.equal(fb[f].view(torch.int16),
                               t.to(torch.bfloat16).view(torch.int16)), f
        else:
            assert torch.equal(fb[f], t), f
    ds_j, _ = jax_ingest.stream_shard_dataset(
        path, d, 2, layout=lay, dtype=jnp.bfloat16, hot_cols=hot,
        eval_dense=twin)
    assert_jax_rows(ds, ds_j)


@pytest.mark.parametrize("spec", ["auto", "128", "64", "off"])
def test_stats_resolution_matches_data_resolution(demo, spec):
    """The layout, the hot width and the split's record from the index's
    counts equal the whole parse's, and JAX's."""
    index = ingest.build_index(SMALL_TRAIN, D)
    for layout in ("auto", "dense", "sparse"):
        got = sharding.resolve_layout_stats(index.n, D, index.total_nnz,
                                            layout)
        assert got == sharding.resolve_layout(demo, layout)
        assert got == jax_sharding.resolve_layout_stats(
            index.n, D, index.total_nnz, layout)
    k = 4
    width, split = hybrid.resolve_hot_cols(spec, demo, k, torch.float32)
    assert hybrid.resolve_hot_width(spec, index.hist, index.n, k,
                                    torch.float32) == width
    resid = (hybrid.residual_max_nnz(demo, hybrid.hot_rank(
        D, hybrid.hottest_columns(index.hist, width))) if width
        else int(index.row_nnz.max()))
    record = hybrid.stats_from_counts(spec, index.hist, width, resid,
                                      index.n, k, torch.float32)
    assert record == split
    assert record == jax_hybrid.stats_from_counts(
        spec, index.hist, width, resid, index.n, k, jnp.float32)
    if width:
        np.testing.assert_array_equal(
            hybrid.hottest_columns(index.hist, width),
            hybrid.hottest_columns(hybrid.column_counts(demo), width))


# (spec, objective, cached) -> the mode, as JAX's resolves it in one
# process (JAX's rule keys the gang on the process count: one here)
MODES = [(spec, obj, cached) for spec in (None, "auto", "whole", "stream",
                                          " Stream ")
         for obj in ("svm", "lasso") for cached in (False, True)]


@pytest.mark.parametrize("spec,objective,cached", MODES)
def test_resolve_ingest_mode_table(spec, objective, cached):
    def both(fn, *args):
        try:
            return fn(*args, objective=objective, cached=cached)
        except ValueError as e:
            return ("error", str(e))

    got = both(ingest.resolve_ingest_mode, spec, None)
    assert got == both(jax_ingest.resolve_ingest_mode, spec, None)
    # on a gang of 2 auto streams the SVM rows, as JAX's on 2 processes
    gang = Mesh(0, 2, torch.device("cpu"), "gloo")
    want = ("stream" if (spec or "auto").strip().lower() == "auto"
            and objective == "svm" else got)
    assert both(ingest.resolve_ingest_mode, spec, gang) == want
    alone = Mesh(0, 1, torch.device("cpu"), "gloo")
    assert both(ingest.resolve_ingest_mode, spec, alone) == got


def test_resolve_ingest_mode_rejects_a_bad_value():
    for fn in (ingest.resolve_ingest_mode, jax_ingest.resolve_ingest_mode):
        with pytest.raises(ValueError,
                           match="--ingest must be stream\\|whole\\|auto, "
                                 "got 'shard'"):
            fn("shard", None)


def test_stream_detects_file_change_and_bad_twin(tmp_path):
    """A file rewritten between the two passes fails with JAX's message,
    never a build on skewed rows; the twin needs the sparse layout."""
    path = tmp_path / "mut.svm"
    path.write_text("1 1:1.0\n-1 2:2.0\n1 3:3.0\n-1 1:4.0\n")
    index = ingest.build_index(str(path), 10)
    index_j = jax_ingest.build_index(str(path), 10)
    path.write_text("1 1:1.0 2:2.0 3:3.0 4:4.0\n" * 4)
    msgs = []
    for fn, idx, kw in ((ingest.stream_shard_dataset, index,
                         dict(dtype=torch.float32, device="cpu")),
                        (jax_ingest.stream_shard_dataset, index_j,
                         dict(dtype=jnp.float32))):
        with pytest.raises(ValueError, match="changed during ingest") as e:
            fn(str(path), 10, 2, layout="sparse", index=idx, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="eval_dense"):
        ingest.stream_shard_dataset(SMALL_TRAIN, D, 2, layout="dense",
                                    device="cpu", eval_dense=True)


# --- gangs of processes ------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(world, cases, tmp_path, path=SMALL_TRAIN, timeout=180):
    """The worker on ``world`` ranks; returns {case name: [rank results]}
    (every child killed on any failure)."""
    spec = tmp_path / f"cases{world}.json"
    spec.write_text(json.dumps(cases))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port), path,
         str(D), str(spec)], cwd=REPO, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("RESULT "):
                r = json.loads(ln[7:])
                res.setdefault(r["name"], []).append(r)
    return res


GANG_CASES = [
    dict(name="dense f64 K=4", k=4, layout="dense"),
    dict(name="sparse f32 K=4", k=4, layout="sparse", dtype="float32"),
    dict(name="hybrid f64 K=4", k=4, layout="sparse", hot=128),
    dict(name="hybrid+twin f32 K=8", k=8, layout="sparse", hot=256,
         eval_dense=True, dtype="float32"),
    dict(name="twin bf16 K=4", k=4, layout="sparse", eval_dense=True,
         dtype="bfloat16"),
]


@pytest.mark.parametrize("world", [2, 4])
def test_gang_streams_its_own_shards(tmp_path, demo, world):
    """Each rank streams only its shards' bytes; its dataset is
    ``shard_dataset(..., part=(rank, world))`` bit for bit; every rank
    assembles the same index and residual width, the whole file's; the
    ranks' rows tile n."""
    res = run_gang(world, GANG_CASES, tmp_path)
    size = os.path.getsize(SMALL_TRAIN)
    for case in GANG_CASES:
        ranks = res[case["name"]]
        assert len(ranks) == world
        for r in ranks:
            assert "error" not in r, r
            assert r["equal"], r
            assert r["bytes_read"] < size and r["scan_bytes"] < size
        assert sum(r["rows"] for r in ranks) == demo.n
        assert sum(r["nnz"] for r in ranks) == int(demo.indptr[-1])
        assert sum(r["scan_bytes"] for r in ranks) == size
        assert len({r["index"] for r in ranks}) == 1
        assert len({(r["resid"], r["width"]) for r in ranks}) == 1
        if case.get("hot"):
            whole = sharding.shard_dataset(demo, case["k"], layout="sparse",
                                           dtype=torch.float32,
                                           device="cpu", hot_cols=case["hot"])
            assert ranks[0]["width"] == whole.sp_indices.shape[-1]


# --- the CLI ---------------------------------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, [ln for ln in err.splitlines() if ln.startswith("error")]


def _same_lines(got, want):
    g, w = _LINE.findall(got), _LINE.findall(want)
    assert [k for k, _ in g] == [k for k, _ in w] and g
    np.testing.assert_allclose([float(v) for _, v in g],
                               [float(v) for _, v in w], rtol=RTOL)


def _announced(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("hotCols=", "evalDense="))]


@pytest.mark.parametrize("flags", [
    ["--ingest=stream"],
    ["--ingest=stream", "--hotCols=auto", "--evalDense=auto"],
])
def test_cli_stream_prints_the_jax_lines(flags, capsys):
    rc_j, out_j, _ = _run(jax_cli.main, DEMO + flags, capsys)
    rc, out, err = _run(cli.main, DEMO + flags + ["--device=cpu"], capsys)
    assert rc == rc_j == 0, err
    _same_lines(out, out_j)
    assert _announced(out) == _announced(out_j)


def _events(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


TIMED = {"parse_seconds", "peak_rss_bytes", "seconds_saved", "seq", "ts",
         "bytes_mapped"}


def _ingest_records(path):
    """run_start's ingest record, then every ingest and ingest_cache
    event, without their timed fields (and the mapped bytes, which
    count each package's own padding)."""
    out = []
    for ev in _events(path):
        rec = (ev["manifest"]["ingest"] if ev["event"] == "run_start"
               else ev if ev["event"] in ("ingest", "ingest_cache")
               else None)
        if rec is not None:
            out.append({k: v for k, v in rec.items()
                        if k not in TIMED and k != "pid"})
    return out


def _metric(path, name):
    with open(path) as f:
        for ln in f:
            if ln.startswith(name + " "):
                return float(ln.split()[1])
    return None


@pytest.mark.parametrize("flags", [
    [],
    ["--ingest=whole", "--hotCols=128"],
])
def test_cli_cache_cold_then_warm_records_match_jax(tmp_path, flags,
                                                   capsys):
    """A cold then a warm run with ``--ingestCache``: the same lines and
    the same ingest records as the JAX CLI's (modes, bytes, rows, cache
    outcomes), the same ``cocoa_ingest_bytes`` and
    ``cocoa_ingest_cache_hits_total``; the warm runs read no byte."""
    recs, lines = {}, {}
    for who, main, extra in (("jax", jax_cli.main, []),
                             ("port", cli.main, ["--device=cpu"])):
        for run in ("cold", "warm"):
            ev = tmp_path / f"{who}-{run}.jsonl"
            prom = tmp_path / f"{who}-{run}.prom"
            argv = DEMO + flags + [f"--ingestCache={tmp_path / who}",
                                   f"--events={ev}", f"--metrics={prom}"]
            rc, out, err = _run(main, argv + extra, capsys)
            assert rc == 0, err
            recs[who, run] = _ingest_records(ev)
            lines[who, run] = out
            recs[who, run].append(
                {m: _metric(prom, m) for m in (
                    "cocoa_ingest_bytes", "cocoa_ingest_cache_hits_total")})
    for run in ("cold", "warm"):
        assert recs["port", run] == recs["jax", run], run
        _same_lines(lines["port", run], lines["jax", run])
        assert _announced(lines["port", run]) == \
            _announced(lines["jax", run])
    warm = [r for r in recs["port", "warm"] if r.get("event") == "ingest"]
    assert len(warm) == 2 and all(r["bytes_read"] == 0 and r["cache"] ==
                                  "hit" for r in warm)
    assert recs["port", "warm"][-1]["cocoa_ingest_cache_hits_total"] == 8


def _err_lines(capsys):
    return [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("error:")]


REFUSALS = {
    "bogus mode": ["--ingest=bogus"],
    "stream lasso": ["--ingest=stream", "--objective=lasso"],
    "cache lasso": ["--ingestCache=CACHE", "--objective=lasso"],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_refusals_match_jax(name, tmp_path, capsys):
    flags = [f.replace("CACHE", str(tmp_path / "c"))
             for f in REFUSALS[name]]
    base = [a for a in DEMO if not a.startswith("--testFile")] \
        if "--objective=lasso" in flags else DEMO
    assert jax_cli.main(base + flags) == 2
    want = _err_lines(capsys)
    assert cli.main(base + flags + ["--device=cpu"]) == 2
    assert _err_lines(capsys) == want and len(want) == 1
    assert not os.path.exists(tmp_path / "c")


def test_cli_cache_refused_beside_fleet_and_serve(tmp_path, capsys):
    from cocoa_torch.data.fleet import synth_fleet_specs, \
        write_fleet_manifest

    manifest = tmp_path / "f.jsonl"
    write_fleet_manifest(str(manifest), synth_fleet_specs(
        2, n=64, d=16, gap_target=1e-2))
    for argv in ([f"--fleet={manifest}", "--numSplits=2", "--numRounds=10",
                  "--debugIter=5", f"--ingestCache={tmp_path}"],
                 ["--serve=0", f"--chkptDir={tmp_path}", "--numFeatures=8",
                  f"--ingestCache={tmp_path}"]):
        assert jax_cli.main(argv) == 2
        want = _err_lines(capsys)
        assert cli.main(argv + ["--device=cpu"]) == 2
        got = _err_lines(capsys)
        assert got == want and len(want) == 1
        assert "--ingestCache does not combine with" in got[0]


def gang_cli(argvs, timeout=240):
    """One port CLI a rank (``argvs[r]`` rank r's flags)."""
    port, world = _free_port(), len(argvs)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", *argv, "--device=cpu",
         f"--master=127.0.0.1:{port}", f"--processId={r}",
         f"--numProcesses={world}"], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r, argv in enumerate(argvs)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_cli_gang_streams_and_prints_the_jax_lines(tmp_path, capsys):
    """Two ranks with ``--ingest=stream --hotCols=auto`` and a cache: each
    prints the JAX CLI's lines; each rank parsed under 0.6 of the file
    beside its half of the index scan; the
    ranks' rows tile n; a second gang on the same cache reads no byte."""
    flags = DEMO + ["--ingest=stream", "--hotCols=auto",
                    f"--ingestCache={tmp_path / 'c'}"]
    assert jax_cli.main(DEMO + ["--hotCols=auto"]) == 0
    want = capsys.readouterr().out
    size = os.path.getsize(SMALL_TRAIN)
    for run in ("cold", "warm"):
        evs = [str(tmp_path / f"{run}.jsonl")] * 2
        res = gang_cli([flags + [f"--events={evs[0]}"]] * 2)
        for rc, out, err in res:
            assert rc == 0, err[-2000:]
            _same_lines(out, want)
            assert _announced(out) == _announced(want)
        assert _LINE.findall(res[0][1]) == _LINE.findall(res[1][1])
        train = [[e for e in _events(p) if e["event"] == "ingest"][0]
                 for p in (evs[0], evs[0] + ".p1")]
        assert sum(r["rows"] for r in train) == (2000 if run == "cold"
                                                 else 0)
        for rank, r in enumerate(train):
            assert r["mode"] == "stream" and r["processes"] == 2
            if run == "cold":
                # pass 1 scans the rank's half, pass 2 its shards' bytes
                scan = (rank + 1) * size // 2 - rank * size // 2
                assert 0 < r["bytes_read"] - scan < 0.6 * size
                assert r["cache"] == "miss"
            else:
                assert r["bytes_read"] == 0 and r["cache"] == "hit"
