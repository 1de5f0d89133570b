"""Real gangs on the CPU: 2 and 4 ranks over gloo, each rank a process
(tests/torch_gang_worker.py) holding only its own shards, float64.  Each
gang runs a list of cases, one ``RESULT`` line a case, so process start-up
is paid once a gang.  Every case holds the ranks bit for bit equal, and
w and alpha within 1e-12 of the JAX package's single-process run of the
same case (the JAX package's own multi-host pin,
tests/test_multihost.py:121-122), its eval records at rtol 1e-9;
ProxCoCoA+'s coordinates and residual within 1e-9, the pin its
single-process port holds (tests/test_torch_prox.py).  One case is held
against the JAX package's in-process multiplexed mesh
(``make_mesh(2)``, tests/test_multiplex.py:46)."""

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
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.solvers import run_prox_cocoa as jax_prox  # noqa: E402
from cocoa_tpu.solvers.dist_gd import run_dist_gd as jax_dist_gd  # noqa: E402
from cocoa_tpu.solvers.minibatch_cd import \
    run_minibatch_cd as jax_cd  # noqa: E402
from cocoa_tpu.solvers.sgd import run_sgd as jax_sgd  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(TESTS, "torch_gang_worker.py")
ATOL = 1e-12
PROX_ATOL = 1e-9
RTOL = 1e-9

_BASE = dict(k=4, rounds=12, debug_iter=4, h=20)
# the 2-rank gang's cases: each solver family, the three layouts, K=4
# (m=2 shards a rank) and K=2 (m=1), the three block routes, both loops,
# the accelerated loop and the sigma' anneal
CASES2 = [dict(_BASE, **c) for c in (
    dict(name="cocoa+ dense exact", solver="cocoa", layout="dense"),
    dict(name="cocoa dense exact K=2", solver="cocoa", layout="dense",
         plus=False, k=2),
    dict(name="cocoa+ sparse fast", solver="cocoa", layout="sparse",
         math="fast"),
    dict(name="cocoa sparse fast K=2 jax", solver="cocoa", layout="sparse",
         math="fast", plus=False, k=2, rng="jax"),
    dict(name="cocoa+ hybrid fast", solver="cocoa", layout="sparse",
         math="fast", hot=128),
    dict(name="block sparse-gram", solver="cocoa", layout="sparse",
         math="fast", block=128, h=30),
    dict(name="block fused", solver="cocoa", layout="dense", math="fast",
         block=128, h=30, rng="permuted"),
    dict(name="block split", solver="cocoa", layout="dense", math="fast",
         block=256, h=30),
    dict(name="mini-batch cd", solver="cd", layout="dense", math="fast"),
    dict(name="prox lasso dense", solver="prox", layout="dense", lam=2.0,
         h=6),
    dict(name="prox elastic sparse", solver="prox", layout="sparse",
         lam=2.0, l2=0.3, h=6),
    dict(name="mini-batch sgd", solver="sgd", layout="sparse",
         local=False),
    dict(name="local sgd", solver="sgd", layout="dense", local=True),
    dict(name="dist gd", solver="dist_gd", layout="sparse"),
    dict(name="device loop", solver="cocoa", layout="sparse", math="fast",
         device_loop=True),
    dict(name="scan chunk 3", solver="cocoa", layout="dense", math="fast",
         scan_chunk=3),
    dict(name="accel", solver="cocoa", layout="dense", math="fast",
         rounds=60, debug_iter=5, gap_target=1e-9, accel="on"),
    dict(name="sigma anneal", solver="cocoa", layout="sparse", math="fast",
         rounds=60, debug_iter=5, gap_target=1e-9, sigma="auto",
         schedule="anneal"),
)]
# the 4-rank gang: m=1 and m=2 a rank, rows and columns
CASES4 = [dict(_BASE, **c) for c in (
    dict(name="4 ranks cocoa+ sparse fast", solver="cocoa", layout="sparse",
         math="fast"),
    dict(name="4 ranks K=8 cocoa dense", solver="cocoa", layout="dense",
         plus=False, k=8),
    dict(name="4 ranks prox lasso", solver="prox", layout="dense", lam=2.0,
         h=6),
)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(world: int, data, cases, tmp) -> dict:
    """Spawn ``world`` ranks over ``cases``; returns {name: [result of rank
    0, ...]}.  Every child is killed on any failure."""
    path = os.path.join(tmp, "data.npz")
    np.savez(path, labels=data.labels, indptr=data.indptr,
             indices=data.indices, values=data.values,
             num_features=data.num_features)
    spec = os.path.join(tmp, f"cases{world}.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(port), path, spec],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                rec = json.loads(line[7:])
                results.setdefault(rec["name"], []).append(rec)
    return results


@pytest.fixture(scope="module")
def gangs(tiny_data, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gang"))
    out = run_gang(2, tiny_data, CASES2, tmp)
    out.update(run_gang(4, tiny_data, CASES4, tmp))
    return out


def jax_run(data, case, mesh=None):
    """The case through the JAX package in one process (or on ``mesh``):
    (w, alpha or None, Trajectory)."""
    k = case["k"]
    debug = JaxDebug(debug_iter=case["debug_iter"], seed=3)
    rng = case.get("rng", "reference")
    if case["solver"] == "prox":
        ds, b = jax_columns(data, k, dtype=jnp.float64,
                            layout=case["layout"])
        params = JaxParams(n=data.n, num_rounds=case["rounds"],
                           local_iters=case["h"], lam=case["lam"],
                           smoothing=case.get("l2", 0.0), loss="lasso")
        x, r, traj = jax_prox(ds, b, params, debug, rng=rng, quiet=True,
                              math=case.get("math", "fast"))
        return r, x, traj
    ds = jax_shard(data, k=k, layout=case["layout"], dtype=jnp.float64,
                   hot_cols=case.get("hot", 0), mesh=mesh)
    test = jax_shard(data, k=k, layout=case["layout"], dtype=jnp.float64,
                     mesh=mesh)
    params = JaxParams(n=data.n, num_rounds=case["rounds"],
                       local_iters=case["h"], lam=case.get("lam", 0.01),
                       sigma=case.get("sigma"))
    kw = dict(test_ds=test, rng=rng, quiet=True, mesh=mesh,
              device_loop=case.get("device_loop", False))
    if case.get("scan_chunk"):
        kw["scan_chunk"] = case["scan_chunk"]
    solver = case["solver"]
    if solver == "cocoa":
        return jax_cocoa(ds, params, debug, plus=case.get("plus", True),
                         math=case.get("math", "exact"),
                         block_size=case.get("block", 0),
                         gap_target=case.get("gap_target"),
                         accel=case.get("accel"),
                         sigma_schedule=case.get("schedule"), **kw)
    if solver == "cd":
        return jax_cd(ds, params, debug, math=case.get("math", "exact"),
                      block_size=case.get("block", 0), **kw)
    if solver == "sgd":
        w, traj = jax_sgd(ds, params, debug, local=case["local"], **kw)
        return w, None, traj
    kw.pop("rng")
    w, traj = jax_dist_gd(ds, params, debug, **kw)
    return w, None, traj


def _records(traj):
    return [[r.round, r.primal, r.gap, r.test_error] for r in traj.records]


def _close_records(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for a, b in zip(got, want):
        for x, y in zip(a[1:], b[1:]):
            if y is None:
                assert x is None
            else:
                np.testing.assert_allclose(x, y, rtol=RTOL, atol=1e-14)


def _hold_to_jax(rec, case, w_j, a_j, traj_j):
    tol = PROX_ATOL if case["solver"] == "prox" else ATOL
    w = np.asarray(rec["w"])
    np.testing.assert_allclose(w, np.asarray(w_j)[:len(w)], rtol=0,
                               atol=tol)
    assert not np.any(np.asarray(w_j)[len(w):])
    if a_j is not None:
        alpha = np.asarray(rec["alpha"])
        a_j = np.asarray(a_j)
        np.testing.assert_allclose(alpha, a_j[:, :alpha.shape[1]], rtol=0,
                                   atol=tol)
        assert not np.any(a_j[:, alpha.shape[1]:])
    _close_records(rec["records"], _records(traj_j))
    assert rec["stopped"] == traj_j.stopped


@pytest.mark.parametrize("case", CASES2 + CASES4,
                         ids=[c["name"] for c in CASES2 + CASES4])
def test_gang_matches_jax_single_process(gangs, tiny_data, case):
    recs = gangs[case["name"]]
    world = 4 if case in CASES4 else 2
    assert len(recs) == world
    for rec in recs:
        assert "error" not in rec, rec.get("error")
    # every rank holds the same w, alpha and records, bit for bit
    for rec in recs[1:]:
        for key in ("w", "alpha", "records", "stopped", "calls"):
            assert rec[key] == recs[0][key], key
    # one all-reduce a round and one an eval, on the fixed-round runs
    if case.get("gap_target") is None:
        assert recs[0]["calls"] == case["rounds"] + len(recs[0]["records"])
    _hold_to_jax(recs[0], case, *jax_run(tiny_data, case))


def test_gang_matches_jax_multiplexed_mesh(gangs, tiny_data):
    """K=4 on the 2-rank gang against K=4 on JAX's 2-device dp mesh in one
    process: the same multiplexing contract (m=2 a position)."""
    case = CASES2[0]
    _hold_to_jax(gangs[case["name"]][0], case,
                 *jax_run(tiny_data, case, mesh=jax_make_mesh(2)))
