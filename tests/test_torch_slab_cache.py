"""The slab cache (cocoa_torch/data/slab_cache.py) and its readers in
cocoa_torch/data/ingest.py, the counterparts of the JAX package's.

A warm build equals the cold one and the uncached control bit for bit
(``torch.equal``) at float32, float64 and bfloat16, parsing no byte; the
whole-file build publishes and a build from the artifacts alone equals
it; a rewrite of the file, or a new inode under a forged mtime, misses;
a torn artifact falls back to a cold parse with one typed
``ingest_cache_corrupt`` event; the artifacts serve another gang size;
the hybrid resolution from cached counts equals the fresh one; a
parallel cold parse, a publish that fails and a field set that drifts
behave as JAX's; two processes racing publish one artifact a shard; and
the index artifact is read across the two packages both ways while
neither reads the other's slabs."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TRAIN  # noqa: E402
from cocoa_tpu.data import ingest as jax_ingest  # noqa: E402
from cocoa_tpu.data import slab_cache as jax_slab_cache  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import hybrid, ingest, load_libsvm  # noqa: E402
from cocoa_torch.data import sharding, slab_cache  # noqa: E402
from cocoa_torch.data.slab_cache import SlabCache  # noqa: E402
from cocoa_torch.solvers import run_cocoa  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402

D = DEMO_NUM_FEATURES
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def demo():
    return load_libsvm(SMALL_TRAIN, D)


def assert_equal(a, b):
    assert (a.layout, a.n, a.num_features, a.k, a.shard_lo) == \
        (b.layout, b.n, b.num_features, b.k, b.shard_lo)
    np.testing.assert_array_equal(a.counts, b.counts)
    fa, fb = a.shard_arrays(), b.shard_arrays()
    assert fa.keys() == fb.keys()
    for f in fa:
        assert fa[f].dtype == fb[f].dtype and fa[f].shape == fb[f].shape, f
        assert torch.equal(fa[f], fb[f]), f


def stream(root=None, k=4, **kw):
    kw = dict(dict(layout="sparse", dtype=torch.float32, device="cpu"),
              **kw)
    cache = SlabCache(root) if isinstance(root, str) else root
    return ingest.stream_shard_dataset(SMALL_TRAIN, D, k, cache=cache,
                                       **kw)


def truncate_newest_artifact(root, keep_bytes=64):
    """Tear the newest ``.npy`` of a slab artifact under ``root`` down to
    ``keep_bytes`` (a torn write); returns its path."""
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".npy") and "slab-" in d]
    newest = max(paths, key=lambda p: (os.path.getmtime(p), p))
    with open(newest, "r+b") as f:
        f.truncate(keep_bytes)
    return newest


@pytest.mark.parametrize("layout,hot,twin", [
    ("sparse", 0, False), ("dense", 0, False), ("sparse", 128, True)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_warm_equals_cold_with_zero_bytes(tmp_path, demo, dtype, layout,
                                          hot, twin):
    """Cold publishes, warm loads: no byte scanned or parsed, every shard
    bit for bit the uncached whole-file build's (bfloat16 through its
    16-bit patterns)."""
    dt, root = DTYPES[dtype], str(tmp_path / "c")
    kw = dict(layout=layout, dtype=dt, hot_cols=hot, eval_dense=twin)
    cold, info_cold = stream(root, **kw)
    assert info_cold.cache_status == "miss"
    assert info_cold.bytes_read == os.path.getsize(SMALL_TRAIN)
    warm_cache = SlabCache(root)   # a fresh instance: only disk persists
    index = ingest.build_index(SMALL_TRAIN, D, cache=warm_cache)
    assert index.scan_bytes == 0 and index.scan_seconds == 0.0
    warm, info = stream(warm_cache, index=index, **kw)
    assert info.cache_status == "hit"
    assert info.bytes_read == 0 and info.rows == 0
    assert info.shards_cached == info.shards_total == 4
    assert info.cache_bytes_mapped > 0 and info.seconds_saved > 0.0
    assert info.residual_max_nnz == info_cold.residual_max_nnz
    ctrl = sharding.shard_dataset(demo, 4, device="cpu", **kw)
    assert_equal(ctrl, cold)
    assert_equal(ctrl, warm)
    fresh = ingest.build_index(SMALL_TRAIN, D)
    for f in ("row_off", "row_nnz", "hist"):
        np.testing.assert_array_equal(getattr(index, f), getattr(fresh, f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_path_populates_and_warm_loads(tmp_path, demo, dtype):
    """``shard_dataset(cache=handle)`` publishes every shard; the
    zero-parse loader builds the same dataset from the artifacts."""
    dt = DTYPES[dtype]
    handle = SlabCache(str(tmp_path / "c")).for_file(SMALL_TRAIN, D)
    ctrl = sharding.shard_dataset(demo, 4, layout="sparse", dtype=dt,
                                  device="cpu", hot_cols=128, cache=handle)
    handle.store_index(hist=np.bincount(demo.indices, minlength=D),
                       n=demo.n, total_nnz=int(demo.indptr[-1]),
                       max_row_nnz=demo.max_nnz)
    h2 = SlabCache(str(tmp_path / "c")).for_file(SMALL_TRAIN, D)
    stats = h2.load_index()
    assert stats is not None and not stats.has_rows and stats.n == demo.n
    got = ingest.load_cached_dataset(h2, stats, 4, layout="sparse",
                                     dtype=dt, device="cpu", hot_cols=128)
    assert got is not None
    warm, info = got
    assert info.cache_status == "hit" and info.bytes_read == 0
    assert_equal(ctrl, warm)
    # a shape the cache never saw is a miss, not a wrong dataset
    assert ingest.load_cached_dataset(h2, stats, 2, layout="sparse",
                                      dtype=dt, device="cpu",
                                      hot_cols=128) is None


def test_key_invalidates_on_rewrite_and_inode_change(tmp_path):
    path = tmp_path / "mut.svm"
    path.write_text("1 1:1.0\n-1 2:2.0\n1 3:3.0\n-1 1:4.0\n")
    root = str(tmp_path / "c")

    def build():
        return ingest.stream_shard_dataset(
            str(path), 10, 2, layout="sparse", device="cpu",
            cache=SlabCache(root))

    assert build()[1].cache_status == "miss"
    assert build()[1].cache_status == "hit"
    path.write_text("1 1:9.0 2:9.0\n-1 2:2.0\n1 3:3.0\n-1 1:4.0\n")
    ds, info = build()
    assert info.cache_status == "miss"
    assert float(ds.sp_values.max()) == 9.0
    # the same size and a forged mtime, renamed into place: a new inode
    st = os.stat(path)
    new = tmp_path / "mut.svm.new"
    new.write_text("1 1:8.0 2:8.0\n-1 2:2.0\n1 3:3.0\n-1 1:4.0\n")
    os.replace(new, path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    st2 = os.stat(path)
    assert (st2.st_size, st2.st_mtime_ns) == (st.st_size, st.st_mtime_ns)
    ds, info = build()
    assert info.cache_status == "miss"
    assert float(ds.sp_values.max()) == 8.0


@pytest.mark.parametrize("keep", [64, 200])
def test_torn_artifact_falls_back_cold_with_typed_event(tmp_path, keep):
    """A torn slab (its header cut, or its data) fails inside the load,
    fires one ``ingest_cache_corrupt`` event, is evicted and parsed
    again; the dataset is the same, and the next run a full hit."""
    root = str(tmp_path / "c")
    ref, _ = stream(root)
    truncate_newest_artifact(root, keep)
    corrupt = []
    cache = SlabCache(root, on_corrupt=lambda **kw: corrupt.append(kw))
    ds, info = stream(cache)
    assert info.cache_status == "partial"
    assert (info.shards_cached, info.shards_total) == (3, 4)
    assert len(corrupt) == 1 and cache.corrupt_total == 1
    assert corrupt[0]["artifact"].startswith("slab-")
    assert corrupt[0]["path"] == SMALL_TRAIN
    assert_equal(ref, ds)
    assert stream(root)[1].cache_status == "hit"


def test_torn_artifact_through_the_cli_emits_the_event(tmp_path, capsys):
    """The CLI hooks the cache to the bus: a torn slab is the schema's
    ``ingest_cache_corrupt`` event, the run goes on, its ``ingest_cache``
    record says partial."""
    import json

    argv = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={D}",
            "--numSplits=4", "--numRounds=2", "--localIterFrac=0.1",
            "--lambda=.001", "--debugIter=1", "--quiet", "--device=cpu",
            f"--ingestCache={tmp_path / 'c'}"]
    assert cli.main(argv) == 0
    truncate_newest_artifact(str(tmp_path / "c"))
    ev = tmp_path / "ev.jsonl"
    assert cli.main(argv + [f"--events={ev}"]) == 0
    capsys.readouterr()
    assert schema.check_file(str(ev)) == []
    recs = [json.loads(ln) for ln in ev.read_text().splitlines()]
    torn = [r for r in recs if r["event"] == "ingest_cache_corrupt"]
    assert len(torn) == 1 and torn[0]["artifact"].startswith("slab-")
    cache = [r for r in recs if r["event"] == "ingest_cache"]
    assert [c["status"] for c in cache] == ["partial"]
    assert (cache[0]["shards_cached"], cache[0]["shards_total"]) == (3, 4)


@pytest.mark.parametrize("part", [(0, 2), (1, 2), (3, 4)])
def test_warm_read_across_a_gang_size_change(tmp_path, part):
    """Artifacts published by one process serve a rank of another gang
    size warm: the key is the shard, not the gang."""
    root = str(tmp_path / "c")
    stream(root)
    warm, info = stream(root, part=part)
    assert info.cache_status == "hit" and info.bytes_read == 0
    assert info.shards_total == 4 // part[1]
    fresh, _ = stream(part=part)
    assert_equal(fresh, warm)


def test_cached_hybrid_resolution_equals_fresh(tmp_path, demo):
    """``--hotCols=auto`` from the cached histogram equals the fresh
    resolution, the cached residual width the measured one, and the warm
    hybrid dataset with its twin the fresh build."""
    k, dt = 2, torch.float32
    hot, _ = hybrid.resolve_hot_cols("auto", demo, k, dt)
    root = str(tmp_path / "c")
    _, icold = stream(root, k=k, hot_cols=hot, eval_dense=True)
    cache = SlabCache(root)
    handle = cache.for_file(SMALL_TRAIN, D)
    stats = handle.load_index()
    assert hybrid.resolve_hot_width("auto", stats.hist, stats.n, k,
                                    dt) == hot
    assert handle.load_hybrid_meta(hot) == icold.residual_max_nnz
    warm, info = stream(cache, k=k, hot_cols=hot, eval_dense=True)
    assert info.cache_status == "hit" and info.bytes_read == 0
    ctrl = sharding.shard_dataset(demo, k, layout="sparse", dtype=dt,
                                  device="cpu", hot_cols=hot,
                                  eval_dense=True)
    assert_equal(ctrl, warm)


def test_warm_trajectory_bit_for_bit(tmp_path, demo):
    root = str(tmp_path / "c")
    stream(root, dtype=torch.float64)
    warm, info = stream(root, dtype=torch.float64)
    assert info.cache_status == "hit"
    ctrl = sharding.shard_dataset(demo, 4, layout="sparse",
                                  dtype=torch.float64, device="cpu")
    params = Params(n=demo.n, num_rounds=5, local_iters=10, lam=0.01)

    def train(ds):
        w, alpha, traj = run_cocoa(ds, params, DebugParams(debug_iter=1,
                                                           seed=0),
                                   plus=True, quiet=True)
        return w, alpha, torch.tensor([r.gap for r in traj.records])

    for got, want in zip(train(warm), train(ctrl)):
        assert torch.equal(got, want)


def test_parallel_cold_parse_bit_for_bit(monkeypatch, demo):
    """The pass-2 thread pool moves no byte: shards come back in order."""
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    from cocoa_torch.data import native_loader

    assert ingest._pass2_workers(8) == (4 if native_loader.available()
                                        else 1)
    ds, info = stream(k=8)
    assert info.bytes_read == os.path.getsize(SMALL_TRAIN)
    assert_equal(sharding.shard_dataset(demo, 8, layout="sparse",
                                        device="cpu"), ds)


def test_publish_failure_degrades_to_uncached(tmp_path, monkeypatch, demo):
    def boom(*a, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(slab_cache.np, "save", boom)
    cache = SlabCache(str(tmp_path / "c"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ds, info = stream(cache)
    assert info.cache_status == "miss" and cache.store_failures > 0
    assert sum("continuing uncached" in str(w.message) for w in caught) == 1
    assert_equal(sharding.shard_dataset(demo, 4, layout="sparse",
                                        device="cpu"), ds)
    assert not any(".tmp." in e for e in os.listdir(tmp_path / "c"))


def test_store_rejects_field_drift(tmp_path):
    handle = SlabCache(str(tmp_path / "c")).for_file(SMALL_TRAIN, D)
    view = handle.view(layout="sparse", k=2, n_shard=16, width=4, n_hot=0,
                       d=D, dtype=torch.float32, eval_dense=False)
    with pytest.raises(ValueError, match="LAYOUT_VERSION"):
        view.store(0, {"labels": np.zeros(16)})


_RACE = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
from cocoa_torch.data import SlabCache, stream_shard_dataset
ds, info = stream_shard_dataset(sys.argv[1], 9947, 4, layout="sparse",
                                device="cpu", cache=SlabCache(sys.argv[2]))
np.savez(sys.argv[3], **{f: v.numpy() for f, v in ds.shard_arrays().items()})
print("RACE_DONE", flush=True)
"""


def test_two_processes_race_one_winner(tmp_path, demo):
    """Two processes build the same artifacts at once: both datasets are
    the control's, one artifact a shard remains, no temporary is left,
    and a third build is a full hit."""
    root = str(tmp_path / "c")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACE, SMALL_TRAIN, root,
         str(tmp_path / f"out{i}.npz"), REPO], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0 and "RACE_DONE" in out, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ctrl = sharding.shard_dataset(demo, 4, layout="sparse", device="cpu")
    for i in range(2):
        got = dict(np.load(tmp_path / f"out{i}.npz"))
        assert got.keys() == ctrl.shard_arrays().keys()
        for f, v in ctrl.shard_arrays().items():
            np.testing.assert_array_equal(got[f], v.numpy(), err_msg=f)
    entries = os.listdir(root)
    assert not any(".tmp." in e for e in entries)
    assert sum(e.startswith("slab-") for e in entries) == 4
    _, info = stream(root)
    assert info.cache_status == "hit" and info.bytes_read == 0


def test_index_read_across_packages_both_ways(tmp_path):
    """The index artifact holds facts of the file alone: each package
    warm-loads the one the other stored (no scan), equal to a fresh
    scan."""
    fresh = ingest.build_index(SMALL_TRAIN, D)
    port_root, jax_root = str(tmp_path / "p"), str(tmp_path / "j")
    ingest.build_index(SMALL_TRAIN, D, cache=SlabCache(port_root))
    jax_ingest.build_index(SMALL_TRAIN, D,
                           cache=jax_slab_cache.SlabCache(jax_root))
    got_j = jax_ingest.build_index(SMALL_TRAIN, D,
                                   cache=jax_slab_cache.SlabCache(port_root))
    got_p = ingest.build_index(SMALL_TRAIN, D, cache=SlabCache(jax_root))
    for got in (got_j, got_p):
        assert got.scan_bytes == 0
        for f in ("row_off", "row_nnz", "hist"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(fresh, f))
    assert sorted(os.listdir(port_root)) == sorted(os.listdir(jax_root))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_slabs_never_read_across_packages(tmp_path, demo, first):
    """Each package's slabs are its own: after the other package filled
    the cache (its index included), a build finds the index but no slab,
    parses every shard, and equals its own control; the two packages'
    slab artifacts never share a name."""
    root = str(tmp_path / "c")

    def port_build():
        return stream(root, layout="sparse", dtype=torch.float32)

    def jax_build():
        return jax_ingest.stream_shard_dataset(
            SMALL_TRAIN, D, 4, layout="sparse", dtype=jnp.float32,
            cache=jax_slab_cache.SlabCache(root))

    builds = [jax_build, port_build] if first == "jax" \
        else [port_build, jax_build]
    builds[0]()
    before = {e for e in os.listdir(root) if e.startswith("slab-")}
    ds, info = builds[1]()
    assert info.cache_status == "miss" and info.shards_cached == 0
    assert info.bytes_read == os.path.getsize(SMALL_TRAIN)
    after = {e for e in os.listdir(root) if e.startswith("slab-")}
    assert len(before) == 4 and len(after - before) == 4
    if first == "jax":
        assert_equal(sharding.shard_dataset(demo, 4, layout="sparse",
                                            device="cpu"), ds)


def test_gang_votes_before_every_cache_shortcut(tmp_path, demo):
    """Per-rank cache directories, rank 0's warm and rank 1's empty: the
    index and the hybrid meta are voted, so both ranks scan and measure
    (neither waits on a collective the other skipped), finish, and equal
    the whole build; once rank 1's directory is filled too, both load
    with no byte read."""
    from test_torch_ingest import run_gang

    warm, cold = str(tmp_path / "r0"), str(tmp_path / "r1")
    case = dict(k=4, layout="sparse", hot=128, dtype="float32",
                caches=[warm, cold])
    stream(warm, hot_cols=128)
    res = run_gang(2, [dict(case, name="split"), dict(case, name="both")],
                   tmp_path)
    for r in res["split"]:
        assert "error" not in r, r
        assert r["equal"] and r["scan_bytes"] > 0 and r["rows"] > 0
        assert r["status"] == "miss"
    assert sum(r["rows"] for r in res["split"]) == demo.n
    for r in res["both"]:
        assert r["equal"] and r["status"] == "hit"
        assert r["scan_bytes"] == r["bytes_read"] == r["rows"] == 0
