"""Feature-parallel gangs on the CPU (``--fp``): the port's gloo gang of
2 dp positions x 2 fp slices, four processes of
tests/torch_fp_worker.py, each rank holding its column block of w and of
its shards' rows, against the JAX package's (K, 2) fp mesh on the
conftest's virtual CPU devices, in float64.

The bar is JAX's own (tests/test_feature_sharding.py): w, alpha and the
duality gap within 1e-9 for CoCoA+ and CoCoA in exact and fast math, the
scan chunk, mini-batch CD, DistGD and both SGDs, the odd-d padding (w's
pad columns exactly 0), and the split block round against JAX's
XLA-chain fp run.  K = 4 puts two shards on a dp position, K = 2 one.
The gang is launched once for the module, every case in one worker run;
each case then checks its own results: the F peers of a dp position
hold alpha bit for bit, and the fp sums and dp all-reduces are counted.

Also here: the mesh's geometry and groups in process, ``pad_features``,
the column-block builds (``shard_dataset(cols=)``,
``synth_dense_sharded(mesh=)``, tests/test_synth.py:118), the fp
refusals of the builders, and the fleet's partition rules
(tests/test_fleet.py's last two tests)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.ingest import resolve_ingest_mode as jax_mode  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.evals import objectives as jax_objectives  # noqa: E402
from cocoa_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from cocoa_tpu.parallel import mesh as jax_mesh_lib  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.solvers import run_minibatch_cd as jax_cd  # noqa: E402
from cocoa_tpu.solvers import run_sgd as jax_sgd  # noqa: E402
from cocoa_tpu.solvers.dist_gd import run_dist_gd as jax_dist_gd  # noqa: E402

from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.data.ingest import resolve_ingest_mode  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.data.synth import synth_dense_sharded, \
    synth_sparse  # noqa: E402
from cocoa_torch.parallel import mesh as mesh_lib  # noqa: E402
from cocoa_torch.parallel.mesh import Mesh  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "torch_fp_worker.py")
FP = 2
WORLD = 4          # 2 dp positions x 2 fp slices
ATOL = 1e-9        # tests/test_feature_sharding.py's bar

_BASE = dict(k=4, rounds=10, h=16, debug_iter=5)
CASES = [dict(_BASE, **c) for c in (
    dict(name="cocoa+ exact", solver="cocoa", plus=True, math="exact"),
    dict(name="cocoa exact", solver="cocoa", plus=False, math="exact"),
    dict(name="cocoa+ fast", solver="cocoa", plus=True, math="fast"),
    dict(name="cocoa fast", solver="cocoa", plus=False, math="fast"),
    dict(name="cocoa+ exact K=2", solver="cocoa", k=2),
    dict(name="odd d", solver="cocoa", data="odd"),
    dict(name="scan chunk", solver="cocoa", scan_chunk=5),
    dict(name="mini-batch cd", solver="cd"),
    dict(name="dist gd", solver="dist_gd"),
    dict(name="sgd local", solver="sgd", local=True),
    dict(name="sgd mini-batch", solver="sgd", local=False),
    dict(name="block split", solver="cocoa", math="fast", block=8),
    dict(name="block split cocoa K=2", solver="cocoa", plus=False,
         math="fast", block=8, k=2),
    dict(name="device loop", solver="cocoa", math="fast", device_loop=True),
    # the JAX package's accelerated loop does not run on its fp mesh (a
    # ShardingTypeError in the secant jump's contraction over dp): held
    # against its run on one device, which its fp runs equal at 1e-9
    dict(name="accel", solver="cocoa", math="fast", rounds=40,
         gap_target=1e-9, accel="on", jax_mesh=False),
)]


def _odd(data) -> LibsvmData:
    """``data`` without its last feature: d = 23, not a multiple of F
    (tests/test_feature_sharding.py ``test_fp_pads_odd_feature_dim``)."""
    d_odd = data.num_features - 1
    keep = data.indices < d_odd
    nnz = np.cumsum([np.sum(keep[data.indptr[i]:data.indptr[i + 1]])
                     for i in range(data.n)])
    return LibsvmData(labels=np.asarray(data.labels),
                      indptr=np.concatenate([[0], nnz]).astype(np.int64),
                      indices=np.asarray(data.indices)[keep],
                      values=np.asarray(data.values)[keep],
                      num_features=d_odd)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_gang(datasets: dict, tmp) -> list:
    """Every case in one launch of the 2 x 2 gang; each rank's npz."""
    path = os.path.join(tmp, "data.npz")
    np.savez(path, **{f"{name}/{field}": np.asarray(getattr(d, field))
                      for name, d in datasets.items()
                      for field in ("labels", "indptr", "indices", "values",
                                    "num_features")})
    spec = os.path.join(tmp, "cases.json")
    with open(spec, "w") as f:
        json.dump(CASES, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(FP), str(port),
         path, spec, tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for r in range(WORLD)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r in range(WORLD):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as f:
            out.append({key: f[key] for key in f.files})
    return out


def _jax_run(data, case):
    """The JAX package's run of ``case`` on its (K, 2) fp mesh (on one
    device where ``jax_mesh`` is False): (ds, w, alpha or None,
    records)."""
    mesh = jax_make_mesh(case["k"], fp=FP) if case.get("jax_mesh", True) \
        else None
    ds = jax_shard(data, k=case["k"], layout="dense", dtype=jnp.float64,
                   mesh=mesh)
    params = JaxParams(n=data.n, num_rounds=case["rounds"],
                       local_iters=case["h"], lam=0.01)
    debug = JaxDebug(debug_iter=case["debug_iter"], seed=11)
    kw = dict(mesh=mesh, quiet=True)
    if case.get("scan_chunk"):
        kw["scan_chunk"] = case["scan_chunk"]
    if case.get("device_loop"):
        kw["device_loop"] = True
    solver = case["solver"]
    if solver == "cocoa":
        w, alpha, traj = jax_cocoa(
            ds, params, debug, plus=case.get("plus", True),
            math=case.get("math", "exact"), block_size=case.get("block", 0),
            gap_target=case.get("gap_target"), accel=case.get("accel"),
            **kw)
    elif solver == "cd":
        w, alpha, traj = jax_cd(ds, params, debug, **kw)
    elif solver == "sgd":
        (w, traj), alpha = jax_sgd(ds, params, debug, local=case["local"],
                                   **kw), None
    else:
        (w, traj), alpha = jax_dist_gd(ds, params, debug, **kw), None
    return ds, params, w, alpha, traj


@pytest.fixture(scope="module")
def gang(tiny_data, tmp_path_factory):
    datasets = {"tiny": tiny_data, "odd": _odd(tiny_data)}
    ranks = _run_gang(datasets, str(tmp_path_factory.mktemp("fp")))
    return datasets, ranks


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_fp_gang_matches_jax_fp_mesh(gang, case):
    datasets, ranks = gang
    name = case["name"]
    data = datasets[case.get("data", "tiny")]
    assert f"{name}/error" not in ranks[0], str(ranks[0][f"{name}/error"])
    ds, params, w, alpha, traj = _jax_run(data, case)
    d = data.num_features
    d_pad = jax_mesh_lib.pad_features(d, jax_make_mesh(case["k"], fp=FP))
    mine = ranks[0][f"{name}/w"]
    assert mine.shape == (d_pad,) == np.asarray(w).shape
    # every rank gathers the same whole w; the pad columns stay exactly 0
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{name}/w"], mine)
    np.testing.assert_array_equal(mine[d:], 0.0)
    np.testing.assert_allclose(mine, np.asarray(w), atol=ATOL, rtol=0)
    recs = ranks[0][f"{name}/records"]
    want = [(r.round, r.primal) for r in traj.records]
    assert [int(x) for x in recs[:, 0]] == [t for t, _ in want]
    np.testing.assert_allclose(recs[:, 1], [p for _, p in want], rtol=1e-9)
    calls_dp, calls_fp = ranks[0][f"{name}/calls"]
    if case.get("accel"):
        # the secant jumps add their own sums
        assert calls_fp > calls_dp > case["rounds"]
        calls_dp = calls_fp = None
    evals = case["rounds"] // case["debug_iter"]
    # one dp all-reduce a round and one an eval; the fp sums of a round:
    # one a step (exact and fast math, CD, SGD), one a block (the block
    # round), one a round (DistGD's margins and |dw|), plus one an eval
    steps = {"dist_gd": 2}.get(case["solver"], case["h"])
    if case.get("block"):
        steps = -(-case["h"] // case["block"])
    fast = case.get("math") == "fast" and not case.get("block")
    if calls_dp is not None:
        assert calls_dp == case["rounds"] + evals
        assert calls_fp == case["rounds"] * (steps + fast) + evals
    if alpha is None:
        assert f"{name}/alpha" not in ranks[0]
        return
    a_j = np.asarray(alpha)
    a_p = ranks[0][f"{name}/alpha"]
    n_shard = a_p.shape[1]
    np.testing.assert_array_equal(a_j[:, n_shard:], 0.0)
    np.testing.assert_allclose(a_p, a_j[:, :n_shard], atol=ATOL, rtol=0)
    # the F peers of each dp position hold alpha bit for bit
    for p in range(WORLD // FP):
        peers = [ranks[p * FP + f][f"{name}/alpha_local"] for f in range(FP)]
        for other in peers[1:]:
            np.testing.assert_array_equal(other, peers[0])
    gap = jax_objectives.duality_gap(ds, w, alpha, params.lam)
    assert float(ranks[0][f"{name}/gap"]) >= -1e-9
    np.testing.assert_allclose(float(ranks[0][f"{name}/gap"]), gap,
                               atol=ATOL)


# --- in process: the mesh, the padding, the column blocks ---------------


def _fake_mesh(rank, size=8, fp=FP):
    return Mesh(rank, size, torch.device("cpu"), "gloo", fp=fp)


def test_mesh_geometry_and_padding_rule():
    """rank r sits at dp position r // F and fp slice r % F; the (dp,)
    mesh of F = 1 is unchanged; ``pad_features`` is JAX's lcm(F, 8)
    rule at every F and d."""
    for r in range(8):
        m = _fake_mesh(r)
        assert (m.dp_rank, m.fp_rank, m.dp_size, m.fp) == (r // 2, r % 2,
                                                            4, 2)
        assert mesh_lib.local_part(m) == (r // 2, 4)
        assert mesh_lib.feature_part(m) == (r % 2, 2)
        assert mesh_lib.has_fp(m)
        assert f"dp position {r // 2} of 4, fp slice {r % 2} of 2" in \
            m.describe()
    plain = Mesh(1, 2, torch.device("cpu"), "gloo")
    assert (plain.dp_rank, plain.dp_size, plain.fp_rank) == (1, 2, 0)
    assert not mesh_lib.has_fp(plain) and not mesh_lib.has_fp(None)
    assert mesh_lib.feature_part(plain) is None
    assert plain.describe() == "rank 1 of 2 on cpu, device group gloo"
    for fp in (1, 2, 4, 8):
        jm = jax_make_mesh(8 // fp, fp=fp)
        for d in (1, 7, 8, 23, 24, 30, 9947):
            want = jax_mesh_lib.pad_features(d, jm)
            assert mesh_lib.pad_features(d, _fake_mesh(0, 8, fp)) == want
            assert mesh_lib.padded_width(d, fp) == want
    assert [mesh_lib.padded_width(30, fp) for fp in (3, 6, 16)] == \
        [48, 48, 32]
    with pytest.raises(ValueError, match="no fp axis"):
        Mesh(0, 3, torch.device("cpu"), "gloo", fp=2)


def test_make_mesh_needs_k_times_f_ranks(monkeypatch):
    """The world must be k x F ranks, with JAX's words."""
    from cocoa_torch.parallel import distributed

    monkeypatch.setattr(distributed, "initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    with pytest.raises(ValueError) as mine:
        mesh_lib.make_mesh(4, "cpu", fp=2)
    assert str(mine.value) == "mesh (4 dp x 2 fp) needs 8 devices, have 4"


@pytest.mark.parametrize("k", [2, 4])
def test_column_blocks_tile_the_padded_rows(tiny_data, k):
    """Each rank of a 4 x 2 grid builds rows [lo, hi) of the solo build
    and its column block of d_pad = 24; the blocks put side by side are
    the JAX fp build's X (pad columns zero), and every rank's sq_norms
    are the whole rows'."""
    odd = _odd(tiny_data)
    jm = jax_make_mesh(k, fp=FP)
    want = jax_shard(odd, k=k, layout="dense", dtype=jnp.float64, mesh=jm)
    solo = shard_dataset(odd, k, layout="dense", dtype=torch.float64,
                         device="cpu")
    dp = k
    rows = []
    for p in range(dp):
        blocks = []
        for f in range(FP):
            ds = shard_dataset(odd, k, layout="auto", dtype=torch.float64,
                               device="cpu", part=(p, dp), cols=(f, FP))
            assert ds.layout == "dense" and ds.num_features == 24
            assert (ds.col_lo, ds.col_hi, ds.w_len) == (12 * f, 12 * f + 12,
                                                        12)
            assert torch.equal(ds.sq_norms, solo.sq_norms[p:p + 1])
            blocks.append(ds.X)
        rows.append(torch.cat(blocks, -1))
    X = torch.cat(rows).numpy()
    assert want.num_features == X.shape[-1] == 24
    n_shard = X.shape[1]
    np.testing.assert_array_equal(X, np.asarray(want.X)[:, :n_shard])
    np.testing.assert_array_equal(X[..., 23:], 0.0)


def test_fp_builders_refuse_sparse_layouts(tiny_data):
    """JAX's fp refusals: the sparse row layout, the sparse column
    shards, the streamed ingest; ``auto`` resolves to dense even for
    sparse data (tests/test_feature_sharding.py
    ``test_sparse_layout_rejected``)."""
    jm = jax_make_mesh(4, fp=FP)
    with pytest.raises(ValueError) as ref:
        jax_shard(tiny_data, k=4, layout="sparse", dtype=jnp.float64,
                  mesh=jm)
    with pytest.raises(ValueError) as mine:
        shard_dataset(tiny_data, 4, layout="sparse", device="cpu",
                      cols=(0, FP))
    assert str(mine.value) == str(ref.value)
    sparse = synth_sparse(64, 512, nnz_mean=10, seed=0)
    assert sparse.indptr[-1] / (64 * 512) < 0.10
    assert shard_dataset(sparse, 4, layout="auto", device="cpu",
                         cols=(1, FP)).layout == "dense"
    with pytest.raises(ValueError, match="cannot combine with an fp mesh"):
        shard_columns(tiny_data, 4, device="cpu", layout="sparse", fp=True)
    assert shard_columns(sparse, 4, device="cpu", fp=True)[0].layout == \
        "dense"
    with pytest.raises(ValueError) as ref:
        jax_mode("stream", jm)
    with pytest.raises(ValueError) as mine:
        resolve_ingest_mode("stream", _fake_mesh(0))
    assert str(mine.value) == str(ref.value)
    assert resolve_ingest_mode(None, _fake_mesh(0), cached=True) == \
        jax_mode(None, jm, cached=True) == "whole"


def test_synth_dense_sharded_fp_mesh():
    """tests/test_synth.py:118 on the port: d = 30 pads to 32 on an fp
    axis of 2, each rank holds a (1, n_shard, 16) block of its shard, and
    the blocks are the solo build's rows (pad columns zero)."""
    solo = synth_dense_sharded(50, 30, 4, seed=1, device="cpu")
    grid = [[synth_dense_sharded(50, 30, 4, seed=1, device="cpu",
                                 mesh=_fake_mesh(p * FP + f))
             for f in range(FP)] for p in range(4)]
    for row in grid:
        for ds in row:
            assert ds.num_features == 32
            assert tuple(ds.X.shape) == (1, ds.n_shard, 16)
    X = torch.cat([torch.cat([ds.X for ds in row], -1) for row in grid])
    assert torch.equal(X[..., :30], solo.X)
    assert bool((X[..., 30:] == 0).all())
    assert torch.equal(torch.cat([row[1].labels for row in grid]),
                       solo.labels)


# --- the fleet's tenant axis (tests/test_fleet.py's last two tests) ------


def test_match_partition_rules_first_match_wins_and_rejects_unmatched():
    P = mesh_lib.PartitionSpec
    tree = {"w": np.zeros(2), "alpha": np.zeros(2), "sched": np.zeros(2)}
    specs = mesh_lib.match_partition_rules(
        ((r"alpha", P("tenant", None)), (r".*", P("tenant"))), tree)
    assert specs["alpha"] == P("tenant", None)
    assert specs["w"] == P("tenant") and specs["sched"] == P("tenant")
    with pytest.raises(ValueError, match="no partition rule") as mine:
        mesh_lib.match_partition_rules(((r"alpha", P("tenant")),), tree)
    from jax.sharding import PartitionSpec as JP

    with pytest.raises(ValueError) as ref:
        jax_mesh_lib.match_partition_rules(((r"alpha", JP("tenant")),),
                                           tree)
    assert str(mine.value) == str(ref.value)


def test_fleet_shardings_cover_the_whole_state_and_data_surface():
    from cocoa_torch.data.fleet import build_fleet, synth_fleet_specs

    fleet = build_fleet(synth_fleet_specs(2, n=64, d=16), k=2,
                        local_iter_frac=0.25, device="cpu")
    mesh = mesh_lib.make_fleet_mesh(1)   # the degenerate single-card mesh
    tree = {"data": fleet.shard_arrays(),
            "state": {"w": np.zeros((2, 16)),
                      "alpha": np.zeros((2, 2, fleet.n_shard))}}
    sh = mesh_lib.fleet_shardings(mesh, tree)
    leaves = mesh_lib.tree_leaves(sh)
    assert len(leaves) == len(mesh_lib.tree_leaves(tree))
    assert all(mesh_lib.TENANT_AXIS in s.spec for s in leaves)
    # one rank holds every tenant; two ranks one each
    assert all(s.index == slice(0, 2) for s in leaves)
    half = mesh_lib.fleet_shardings(mesh_lib.TenantMesh(2, 1), tree)
    w = np.arange(32.0).reshape(2, 16)
    np.testing.assert_array_equal(half["state"]["w"].apply(w), w[1:])
    with pytest.raises(ValueError, match="fleet mesh needs 2 devices"):
        mesh_lib.make_fleet_mesh(2)
