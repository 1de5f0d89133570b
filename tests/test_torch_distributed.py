"""The gang's pieces in one process, against the JAX package: parse_master,
the multiplexing rules and their messages, the rank-local shard builds
(pure functions of (rank, world size)), the rank-sliced draw tables, the
backend rule, and the all-reduce census on a world-size-1 gloo group --
one all-reduce a round and one an eval for every solver family, whatever
the chunk length (the port's form of tests/test_comm_contract.py)."""

import dataclasses
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from cocoa_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from cocoa_tpu.parallel.distributed import \
    parse_master as jax_parse_master  # noqa: E402
from cocoa_tpu.parallel.fanout import \
    shards_per_device as jax_shards_per_device  # noqa: E402
from cocoa_tpu.parallel.mesh import \
    dp_local_shards as jax_dp_local_shards  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.data.synth import synth_sparse  # noqa: E402
from cocoa_torch.parallel import distributed  # noqa: E402
from cocoa_torch.parallel.fanout import all_reduce_max, all_reduce_sum, \
    shards_per_device  # noqa: E402
from cocoa_torch.parallel.mesh import Mesh, dp_local_shards, \
    make_mesh  # noqa: E402
from cocoa_torch.solvers import base, run_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402
from cocoa_torch.utils import prng  # noqa: E402

F64 = torch.float64


@pytest.mark.parametrize("master", [
    None, "", "local", "local[4]", "local[*]", "host0:8476",
    "spark://host0:7077", "grpc://10.0.0.1:1234", "jax://h:1",
    "justahost", "  host1:99  "])
def test_parse_master_matches_jax(master):
    assert distributed.parse_master(master) == jax_parse_master(master)


@pytest.mark.parametrize("master", ["spark://host0", "grpc://h", "jax://x"])
def test_parse_master_errors_match_jax(master):
    with pytest.raises(ValueError) as mine:
        distributed.parse_master(master)
    with pytest.raises(ValueError) as ref:
        jax_parse_master(master)
    assert str(mine.value) == str(ref.value)


def _cpu_mesh(size, rank=0):
    return Mesh(rank, size, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("d,k", [(2, 4), (4, 4), (2, 8), (4, 6), (2, 3)])
def test_multiplexing_rules_match_jax(d, k):
    """shards_per_device and dp_local_shards: the same m and shard ranges,
    and the same message where D does not divide K."""
    jm = jax_make_mesh(d)
    for fn, jfn in ((shards_per_device, jax_shards_per_device),
                    (dp_local_shards, jax_dp_local_shards)):
        try:
            want = jfn(jm, k)
        except ValueError as e:
            with pytest.raises(ValueError) as mine:
                fn(_cpu_mesh(d), k)
            assert str(mine.value) == str(e)
            continue
        if fn is shards_per_device:
            assert fn(_cpu_mesh(d), k) == want
        else:
            # JAX's one process holds every position; rank r holds one
            assert [fn(_cpu_mesh(d, r), k)[0][1:] for r in range(d)] == \
                [entry[1:] for entry in want]
    assert shards_per_device(None, k) == jax_shards_per_device(None, k) == 1


def test_backend_rule():
    """NCCL only where every rank is on CUDA with a card of its own."""
    rule = distributed.device_backend
    assert rule([("h", 0), ("h", 1)], True) == "nccl"
    assert rule([("a", 0), ("b", 0)], True) == "nccl"
    assert rule([("h", 0)], True) == "nccl"
    assert rule([("h", 0), ("h", 0)], True) == "gloo"
    assert rule([("h", 0), ("h", 1), ("h", 0)], True) == "gloo"
    assert rule([("h", -1), ("h", -1)], False) == "gloo"
    assert rule([("a", -1), ("b", -1)], False) == "gloo"


@pytest.fixture(scope="module")
def rcv1_small():
    return synth_sparse(256, 400, nnz_mean=12, seed=5)


def _same_rows(part, whole, lo, hi):
    assert part.k == whole.k and part.n == whole.n
    assert part.shard_lo == lo and part.m == hi - lo
    np.testing.assert_array_equal(part.counts, whole.counts[lo:hi])
    np.testing.assert_array_equal(part.global_counts, whole.counts)
    for name, t in whole.shard_arrays().items():
        assert torch.equal(part.shard_arrays()[name], t[lo:hi]), name


@pytest.mark.parametrize("world,k", [(2, 4), (4, 4), (2, 8)])
@pytest.mark.parametrize("layout", ["dense", "sparse", "hybrid", "twin"])
def test_rank_build_is_rows_of_the_whole(rcv1_small, world, k, layout):
    """Rank r of P builds rows [r*m, (r+1)*m) of the single-process build:
    dense, sparse, the hybrid panel (hot columns from the whole file) and
    the eval twin."""
    kw = dict(layout="dense" if layout == "dense" else "sparse",
              dtype=F64, device="cpu",
              hot_cols=128 if layout == "hybrid" else 0,
              eval_dense=layout == "twin")
    whole = shard_dataset(rcv1_small, k, **kw)
    m = k // world
    for r in range(world):
        part = shard_dataset(rcv1_small, k, part=(r, world), **kw)
        _same_rows(part, whole, r * m, (r + 1) * m)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_rank_column_build_is_rows_of_the_whole(rcv1_small, layout):
    whole, b = shard_columns(rcv1_small, 4, dtype=F64, device="cpu",
                             layout=layout)
    for r in range(2):
        part, b_r = shard_columns(rcv1_small, 4, dtype=F64, device="cpu",
                                  layout=layout, part=(r, 2))
        assert torch.equal(b_r, b)
        _same_rows(part, whole, 2 * r, 2 * r + 2)


def test_rank_build_refuses_a_gang_that_does_not_divide_k(rcv1_small):
    with pytest.raises(ValueError, match="K=6 shards cannot multiplex onto "
                                         "4 devices"):
        shard_dataset(rcv1_small, 6, device="cpu", part=(0, 4))


@pytest.mark.parametrize("mode", prng.MODES)
def test_rank_tables_are_rows_of_the_whole(mode):
    """A rank's tables, host and through the draw kernel's plain version,
    are rows [lo, hi) of the whole run's, bit for bit."""
    counts = np.array([50, 50, 49, 49, 49, 49, 48, 33])
    whole = prng.host_tables(mode, 7, 13, counts, 5, 3)
    t0 = torch.tensor(5, dtype=torch.int64)
    for lo, hi in ((0, 4), (4, 8), (2, 3), (7, 8)):
        host = prng.host_tables(mode, 7, 13, counts[lo:hi], 5, 3, lane0=lo)
        drawn = prng.draw_tables(mode, 7, 13, torch.as_tensor(counts[lo:hi]),
                                 t0, 3, lane0=lo)
        sampler = base.IndexSampler(mode, 7, 13, counts[lo:hi], lane0=lo)
        assert torch.equal(host, whole[:, lo:hi])
        assert torch.equal(drawn, whole[:, lo:hi])
        assert torch.equal(sampler.chunk_indices(5, 3), whole[:, lo:hi])


# --- the census on a world-size-1 gloo group ---------------------------


@pytest.fixture(scope="module")
def mesh1():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.maybe_initialize(f"127.0.0.1:{port}", 0, 1)
    try:
        yield make_mesh(None, "cpu")
    finally:
        distributed.shutdown()


ROUNDS, EVAL = 12, 4


def _ds(data, layout, mesh, hot=0):
    ds = shard_dataset(data, 4, layout=layout, dtype=F64, device="cpu",
                       hot_cols=hot)
    return dataclasses.replace(ds, mesh=mesh)


def _solvers():
    p = Params(n=256, num_rounds=ROUNDS, local_iters=10, lam=0.01)
    dbg = DebugParams(debug_iter=EVAL, seed=1)
    return {
        "cocoa+ exact": lambda ds, **kw: run_cocoa(ds, p, dbg, plus=True,
                                                   quiet=True, **kw),
        "cocoa fast": lambda ds, **kw: run_cocoa(ds, p, dbg, plus=False,
                                                 math="fast", quiet=True,
                                                 **kw),
        "block": lambda ds, **kw: run_cocoa(ds, p, dbg, plus=True,
                                            math="fast", block_size=8,
                                            quiet=True, **kw),
        "mini-batch cd": lambda ds, **kw: run_minibatch_cd(
            ds, p, dbg, math="fast", quiet=True, **kw),
        "mini-batch sgd": lambda ds, **kw: run_sgd(ds, p, dbg, local=False,
                                                   quiet=True, **kw),
        "local sgd": lambda ds, **kw: run_sgd(ds, p, dbg, local=True,
                                              quiet=True, **kw),
        "dist gd": lambda ds, **kw: run_dist_gd(ds, p, dbg, quiet=True,
                                                **kw),
    }


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("solver", list(_solvers()))
@pytest.mark.parametrize("loop", ["chunk 1", "chunk 3", "default",
                                  "device loop"])
def test_census_one_all_reduce_a_round_and_an_eval(mesh1, rcv1_small,
                                                   layout, solver, loop):
    """Every solver family's run on a one-rank gang makes ROUNDS + evals
    all-reduces whatever the chunk length, and equals the run without a
    gang bit for bit."""
    kw = {"chunk 1": dict(scan_chunk=1), "chunk 3": dict(scan_chunk=3),
          "default": {}, "device loop": dict(device_loop=True)}[loop]
    run = _solvers()[solver]
    before = all_reduce_sum.calls
    out = run(_ds(rcv1_small, layout, mesh1), **kw)
    assert all_reduce_sum.calls - before == ROUNDS + ROUNDS // EVAL
    ref = run(_ds(rcv1_small, layout, None), **kw)
    for a, b in zip(out[:-1], ref[:-1]):
        assert torch.equal(a, b)
    assert [r.gap for r in out[-1].records] == \
        [r.gap for r in ref[-1].records]


@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_census_prox(mesh1, rcv1_small, l2):
    """ProxCoCoA+: one all-reduce of dr a round and one of the eval's
    column sums; the lasso's max |a_j.r| adds one maximum an eval."""
    ds, b = shard_columns(rcv1_small, 4, dtype=F64, device="cpu")
    p = Params(n=400, num_rounds=ROUNDS, local_iters=6, lam=2.0,
               smoothing=l2)
    dbg = DebugParams(debug_iter=EVAL, seed=1)
    s0, m0 = all_reduce_sum.calls, all_reduce_max.calls
    x, r, _ = run_prox_cocoa(dataclasses.replace(ds, mesh=mesh1), b, p, dbg,
                             quiet=True)
    assert all_reduce_sum.calls - s0 == ROUNDS + ROUNDS // EVAL
    assert all_reduce_max.calls - m0 == (ROUNDS // EVAL if l2 == 0 else 0)
    x_ref, r_ref, _ = run_prox_cocoa(ds, b, p, dbg, quiet=True)
    assert torch.equal(x, x_ref) and torch.equal(r, r_ref)


def test_host_gather_is_the_whole_alpha(mesh1):
    """The checkpoint's gather over a one-rank host group returns the
    rank's shards as they are, on the host."""
    a = torch.arange(12, dtype=F64).reshape(3, 4)
    assert torch.equal(distributed.host_gather_shards(a, 0), a)
    assert distributed.host_allgather_bytes(b"xy") == [b"xy"]
    assert distributed.post_device(torch.device("cpu"))[0][1] == -1


def test_gang_fields_default_to_the_whole(rcv1_small):
    ds = shard_dataset(rcv1_small, 4, device="cpu")
    assert (ds.k, ds.m, ds.shard_lo, ds.mesh) == (4, 4, 0, None)
    np.testing.assert_array_equal(ds.global_counts, ds.counts)
