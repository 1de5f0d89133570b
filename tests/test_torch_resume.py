"""Checkpoints and ``--resume`` in the port (cocoa_torch/checkpoint.py,
solvers/base.py ``drive``/``drive_device``, cli.py ``_restore``) against
the JAX package, float64 on the CPU, mirroring tests/test_solvers.py:
207,269,337,359,381, tests/test_prox.py:212, tests/test_device_paths.py:
157, tests/test_sigma_anneal.py:153,181, tests/test_accel.py:227,241,262,
tests/test_divergence.py:132,208, tests/test_cli_flags.py:56,
tests/test_chaos.py:484 and tests/test_crash_resume.py.

Every solver, on the chunked loop and on ``--deviceLoop``, is checkpointed
at round 5 and resumed to round 10:
- from the port's own checkpoint it equals the port's uninterrupted run
  bit for bit (the records after the resume point, the final state);
- from a checkpoint the JAX package wrote it matches JAX's uninterrupted
  run: final state to 1e-12 absolute, primal to relative 1e-12 and gaps
  to 1e-12 of the primal at each eval after the resume point;
- the JAX package resumes the port's checkpoint to the same tolerances.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from conftest import SMALL_TRAIN  # noqa: E402
from cocoa_tpu import checkpoint as jax_ckpt  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.solvers import run_dist_gd as jax_dist_gd  # noqa: E402
from cocoa_tpu.solvers import run_minibatch_cd as jax_mbcd  # noqa: E402
from cocoa_tpu.solvers import run_prox_cocoa as jax_prox  # noqa: E402
from cocoa_tpu.solvers import run_sgd as jax_sgd  # noqa: E402
from cocoa_torch import checkpoint as ckpt  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.solvers import base  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402
from test_torch_gap_target import ROBUST_SEED, assert_same_console, \
    assert_same_run, coherent, port_ds  # noqa: E402
from test_torch_prox import _problem  # noqa: E402

K = 4
HALF, FULL = 5, 10
DEBUG_ITER = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOPS = [pytest.param(False, id="chunked"), pytest.param(True, id="device")]
KEYS = ("round", "primal", "gap", "test_error", "sigma", "sigma_stage",
        "stall")


# --- the solvers, each through both packages ---------------------------------


def _sdca_data(tiny_data):
    ds_j = jax_shard(tiny_data, k=K, layout="dense", dtype=jnp.float64)
    return ds_j, port_ds(ds_j)


def _prox_data(tiny_data):
    """The lasso design's column shards, the port's from the JAX
    package's arrays (so each package can resume the other's state)."""
    A, b, data_j, _ = _problem(seed=2)
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout="dense")
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    return (ds_j, b_j), (port_ds(ds_j), torch.as_tensor(np.array(b_j))), \
        dict(n=A.shape[1], lam=lam, loss="lasso", smoothing=0.0)


class Solver:
    """One menu entry in both packages: ``run(pkg, rounds, debug,
    restored, device_loop)`` -> (w, alpha or None, trajectory), where
    ``restored`` maps a checkpoint's (meta, arrays) to the keywords a
    resumed run takes."""

    def __init__(self, name, alg, jax_fn, port_fn, kw=None, prox=False,
                 dual=True):
        self.name, self.alg = name, alg
        self.jax_fn, self.port_fn = jax_fn, port_fn
        self.kw = kw or {}
        self.prox, self.dual = prox, dual

    def data(self, tiny_data):
        if self.prox:
            return _prox_data(tiny_data)
        ds_j, ds = _sdca_data(tiny_data)
        return ds_j, ds, dict(n=tiny_data.n, lam=0.01)

    def resume_kw(self, meta, arrays):
        if meta is None:
            return {}
        start = meta["round"] + 1
        if self.prox:
            return dict(r_init=arrays["w"], x_init=arrays["alpha"],
                        start_round=start)
        out = dict(w_init=arrays["w"], start_round=start)
        if self.dual:
            out["alpha_init"] = arrays["alpha"]
        return out

    def run(self, jax, data, rounds, debug, restored=(None, None),
            device_loop=False):
        ds_j, ds, p = data
        kw = dict(self.kw, quiet=True, **self.resume_kw(*restored))
        params = dict(p, num_rounds=rounds, local_iters=12)
        if jax:
            fn, pk, dset = self.jax_fn, JaxParams(**params), ds_j
        else:
            fn, pk, dset = self.port_fn, Params(**params), ds
            kw["device_loop"] = device_loop
        if self.prox:
            x, r, traj = fn(dset[0], dset[1], pk, debug, **kw)
            return r, x, traj
        out = fn(dset, pk, debug, **kw)
        return (out[0], out[1] if self.dual else None, out[-1])


SOLVERS = {s.name: s for s in [
    Solver("cocoa+", "CoCoA+", jax_cocoa, port_cocoa.run_cocoa,
           dict(plus=True)),
    Solver("cocoa", "CoCoA", jax_cocoa, port_cocoa.run_cocoa,
           dict(plus=False, rng="permuted")),
    Solver("cocoa+ block", "CoCoA+", jax_cocoa, port_cocoa.run_cocoa,
           dict(plus=True, math="fast", block_size=4)),
    Solver("mini-batch cd", "Mini-batch CD", jax_mbcd, run_minibatch_cd),
    Solver("mini-batch sgd", "Mini-batch SGD", jax_sgd, run_sgd,
           dict(local=False), dual=False),
    Solver("local sgd", "Local SGD", jax_sgd, run_sgd, dict(local=True),
           dual=False),
    Solver("distgd", "Dist SGD", jax_dist_gd, run_dist_gd, dual=False),
    Solver("prox", "ProxCoCoA+", jax_prox, run_prox_cocoa, prox=True),
    Solver("prox block", "ProxCoCoA+", jax_prox, run_prox_cocoa,
           dict(math="fast", block_size=4), prox=True),
]}


def _debug(jax, directory=""):
    cls = JaxDebug if jax else DebugParams
    return cls(debug_iter=DEBUG_ITER, seed=0,
               chkpt_iter=HALF if directory else FULL + 1,
               chkpt_dir=str(directory))


def _np(x):
    return None if x is None else np.asarray(x)


def _same_bits(a, b, after=0):
    """Two runs of the port bit for bit: the records past round ``after``
    (wall times aside), the stop reason and the final state."""
    (w_a, al_a, t_a), (w_b, al_b, t_b) = a, b
    assert [tuple(getattr(r, k) for k in KEYS) for r in t_a.records
            if r.round > after] == \
        [tuple(getattr(r, k) for k in KEYS) for r in t_b.records
         if r.round > after]
    assert t_a.stopped == t_b.stopped
    assert torch.equal(w_a, w_b)
    assert (al_a is None) == (al_b is None)
    if al_a is not None:
        assert torch.equal(al_a, al_b)


def _close_to_jax(port, ref, after=HALF):
    """The port's run against JAX's: final state to 1e-12 absolute, and
    the evals past round ``after`` at the driver ladder's tolerances."""
    (w, al, t), (w_j, al_j, t_j) = port, ref
    np.testing.assert_allclose(_np(w), _np(w_j), rtol=0, atol=1e-12)
    assert (al is None) == (al_j is None)
    if al is not None:
        np.testing.assert_allclose(_np(al), _np(al_j), rtol=0, atol=1e-12)

    class Cut:
        def __init__(self, traj):
            self.stopped = traj.stopped
            self.records = [r for r in traj.records if r.round > after]

    assert_same_run(Cut(t), Cut(t_j))
    assert [r.round for r in t.records if r.round > after] == [6, 8, 10]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, tiny_data):
    """Per solver, lazily: JAX's uninterrupted 10-round run, and the
    directory of JAX's 5-round run checkpointed at round 5."""
    cache = {}

    def get(name):
        if name not in cache:
            s = SOLVERS[name]
            data = s.data(tiny_data)
            d = tmp_path_factory.mktemp("jax_ckpt")
            s.run(True, data, HALF, _debug(True, d))
            cache[name] = (s.run(True, data, FULL, _debug(True)), str(d))
        return cache[name]
    return get


# --- every solver: resume = uninterrupted ------------------------------------


@pytest.mark.parametrize("device_loop", LOOPS)
@pytest.mark.parametrize("name", list(SOLVERS))
def test_resume_own_checkpoint_bit_for_bit(tiny_data, tmp_path, name,
                                           device_loop):
    """The port checkpointed at round 5 and resumed to 10 equals its
    uninterrupted 10-round run bit for bit (tests/test_solvers.py:337,
    359,381; tests/test_prox.py:212), on both loops; the checkpoint holds
    the 5-round run's final state and one save was counted."""
    s = SOLVERS[name]
    data = s.data(tiny_data)
    full = s.run(False, data, FULL, _debug(False), device_loop=device_loop)
    half = s.run(False, data, HALF, _debug(False, tmp_path),
                 device_loop=device_loop)
    assert half[2].saves == 1
    path = ckpt.latest(str(tmp_path), s.alg)
    assert os.path.basename(path) == \
        f"{s.alg.replace(' ', '_')}-r{HALF:06d}.npz"
    meta, arrays = ckpt.load_full(path)
    assert meta["round"] == HALF and meta["seed"] == 0
    assert ("gap" in meta) == s.dual
    assert np.array_equal(arrays["w"], half[0].numpy())
    assert ("alpha" in arrays) == s.dual
    resumed = s.run(False, data, FULL, _debug(False), (meta, arrays),
                    device_loop=device_loop)
    _same_bits(resumed, full, after=HALF)


@pytest.mark.parametrize("device_loop", LOOPS)
@pytest.mark.parametrize("name", list(SOLVERS))
def test_resume_jax_checkpoint_matches_jax(tiny_data, jax_runs, name,
                                           device_loop):
    """The port resumed from the JAX package's round-5 checkpoint matches
    JAX's uninterrupted 10-round run (module docstring)."""
    s = SOLVERS[name]
    ref, directory = jax_runs(name)
    path = ckpt.latest(directory, s.alg)
    assert path.endswith(f"-r{HALF:06d}.npz")
    resumed = s.run(False, s.data(tiny_data), FULL, _debug(False),
                    ckpt.load_full(path), device_loop=device_loop)
    _close_to_jax(resumed, ref)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_jax_resumes_port_checkpoint(tiny_data, tmp_path, jax_runs, name):
    """The port's round-5 checkpoint passes the JAX package's validate,
    carries the meta keys JAX's does, and JAX resumed from it matches
    JAX's uninterrupted run."""
    s = SOLVERS[name]
    data = s.data(tiny_data)
    ref, directory = jax_runs(name)
    s.run(False, data, HALF, _debug(False, tmp_path))
    path = jax_ckpt.latest(str(tmp_path), s.alg)
    assert jax_ckpt.validate(path) is None
    meta, arrays = jax_ckpt.load_full(path)
    meta_j, arrays_j = jax_ckpt.load_full(jax_ckpt.latest(directory, s.alg))
    assert sorted(meta) == sorted(meta_j)
    assert sorted(arrays) == sorted(arrays_j)
    resumed = s.run(True, data, FULL, _debug(True), (meta, arrays))
    _close_to_jax(resumed, ref)


# --- the drivers' save points ------------------------------------------------


@pytest.mark.parametrize("device_loop", LOOPS)
def test_save_rounds_match_jax(tiny_data, tmp_path, monkeypatch,
                               device_loop):
    """A chkptIter that is not a multiple of debugIter: the chunked loop
    saves at each multiple (its chunks end there), the device loop at the
    first super-block boundary past it (blocks capped at ceil(3 / 2) = 2
    chunks: rounds 4, 8, 12; the tail's round 13 is one round past the
    last save), in both packages; the files hold the same rounds and
    states."""
    monkeypatch.setattr(ckpt, "KEEP_GENERATIONS", 100)
    monkeypatch.setattr(jax_ckpt, "KEEP_GENERATIONS", 100)
    ds_j, ds = _sdca_data(tiny_data)
    p = dict(n=tiny_data.n, num_rounds=13, local_iters=12, lam=0.01)
    dirs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        debug = dict(debug_iter=2, seed=0, chkpt_iter=3, chkpt_dir=str(d))
        if pkg == "jax":
            jax_cocoa(ds_j, JaxParams(**p), JaxDebug(**debug), plus=True,
                      quiet=True, device_loop=device_loop)
        else:
            _, _, traj = port_cocoa.run_cocoa(
                ds, Params(**p), DebugParams(**debug), plus=True, quiet=True,
                device_loop=device_loop)
            assert traj.saves == (3 if device_loop else 4)
        dirs[pkg] = d
    rounds = [int(os.path.basename(x)[8:14])
              for x in ckpt.generations(str(dirs["port"]), "CoCoA+")]
    assert rounds == ([4, 8, 12] if device_loop else [3, 6, 9, 12])
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"]))
    for r in rounds:
        name = f"CoCoA+-r{r:06d}.npz"
        meta, arrays = ckpt.load_full(str(dirs["port"] / name))
        meta_j, arrays_j = jax_ckpt.load_full(str(dirs["jax"] / name))
        assert sorted(meta) == sorted(meta_j)
        for k in meta:  # algorithm, round, seed, shapes (and sched) exact
            if k != "gap":
                assert meta[k] == meta_j[k], k
        assert abs(meta["gap"] - meta_j["gap"]) < 1e-12
        for k in ("w", "alpha"):
            np.testing.assert_allclose(arrays[k], arrays_j[k], atol=1e-12)


def test_chkpt_iter_on_cadence_adds_no_chunk(tiny_data, tmp_path,
                                             monkeypatch):
    """A chkptIter that is a multiple of debugIter ends no chunk that an
    eval does not, so a captured run gains no graph: the chunked loop
    runs the same (start, length) chunks with and without it."""
    _, ds = _sdca_data(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=17, local_iters=12, lam=0.01)
    calls = []
    real = base.ChunkRunner.__call__

    def spy(self, key, t, c, iterate):
        calls.append((t, c))
        return real(self, key, t, c, iterate)

    monkeypatch.setattr(base.ChunkRunner, "__call__", spy)
    seen = []
    for d in ("", str(tmp_path)):
        calls.clear()
        port_cocoa.run_cocoa(ds, p, DebugParams(debug_iter=4, seed=0,
                                                chkpt_iter=8, chkpt_dir=d),
                             plus=True, quiet=True, scan_chunk=3)
        seen.append(list(calls))
    assert seen[0] == seen[1]
    assert {c for _, c in seen[0]} == {1, 3}


def _target_stop_setup(tiny_data):
    """Off-cadence resume (start 6, debugIter 2) with chkptIter 5: the
    device loop's blocks are capped at 3 chunks, the first runs rounds
    7-12, and a target met at round 10 stops it after two chunks, with
    round 10 at least chkptIter past the last save (5)."""
    _, ds = _sdca_data(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=40, local_iters=12, lam=0.01)
    five = port_cocoa.run_cocoa(ds, dataclass_replace(p, num_rounds=5),
                                DebugParams(debug_iter=2, seed=0),
                                plus=True, quiet=True)
    full = port_cocoa.run_cocoa(ds, p, DebugParams(debug_iter=2, seed=0),
                                plus=True, quiet=True)
    gaps = {r.round: r.gap for r in full[2].records}
    assert all(gaps[r] > gaps[10] for r in (6, 8))
    return ds, p, five, gaps[10] + 1e-15


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


@pytest.mark.parametrize("dead", [False, True], ids=["live", "dead chunks"])
def test_device_loop_checkpoint_round_after_early_stop(tiny_data, tmp_path,
                                                       monkeypatch, dead):
    """tests/test_device_paths.py:157: a target met mid-super-block saves
    at the round the run reached (10), not the block's end (12), with the
    state the run returns.  With ``dead`` every step of the block is
    queued and run even after the stop, as design B replays chunks on the
    card (solvers/base.py DeviceLoopRunner): writes commit only while the
    run is live, so the dead chunk reaches neither the state nor the
    checkpoint."""
    if dead:
        def all_steps(self, k, n):
            for _ in range(n):
                self._step(k, self.v)
            return n
        monkeypatch.setattr(base.DeviceLoopRunner, "_steps", all_steps)
    ds, p, (w5, a5, _), target = _target_stop_setup(tiny_data)
    debug = DebugParams(debug_iter=2, seed=0, chkpt_iter=5,
                        chkpt_dir=str(tmp_path))
    kw = dict(plus=True, quiet=True, gap_target=target, w_init=w5,
              alpha_init=a5, start_round=6)
    chunked = port_cocoa.run_cocoa(ds, p, DebugParams(debug_iter=2, seed=0),
                                   **kw)
    w, a, traj = port_cocoa.run_cocoa(ds, p, debug, device_loop=True, **kw)
    _same_bits((w, a, traj), chunked)
    assert traj.stopped == "target" and traj.records[-1].round == 10
    assert traj.dead_chunks == (1 if dead else 0)
    meta, arrays = ckpt.load_full(ckpt.latest(str(tmp_path), "CoCoA+"))
    assert meta["round"] == 10 and traj.saves == 1
    assert meta["gap"] == traj.records[-1].gap
    assert np.array_equal(arrays["w"], w.numpy())
    assert np.array_equal(arrays["alpha"], a.numpy())


@pytest.mark.parametrize("device_loop", LOOPS)
def test_off_cadence_resume(tiny_data, device_loop):
    """tests/test_solvers.py:269: resumed at round 2 with debugIter 2, the
    evals stay at rounds 2, 4, 6, 8 on both loops, equal bit for bit."""
    _, ds = _sdca_data(tiny_data)
    p1 = Params(n=tiny_data.n, num_rounds=1, local_iters=20, lam=0.01)
    w1, a1, _ = port_cocoa.run_cocoa(ds, p1, DebugParams(), plus=True,
                                     quiet=True)
    p = dataclass_replace(p1, num_rounds=9)
    d = DebugParams(debug_iter=2, seed=0)
    kw = dict(plus=True, quiet=True, w_init=w1, alpha_init=a1,
              start_round=2)
    out = port_cocoa.run_cocoa(ds, p, d, device_loop=device_loop, **kw)
    assert [r.round for r in out[2].records] == [2, 4, 6, 8]
    _same_bits(out, port_cocoa.run_cocoa(ds, p, d, **kw))


def test_corrupt_newest_resumes_previous_bit_identical(tiny_data, tmp_path):
    """tests/test_chaos.py:484: tear the newest checkpoint; the resume
    falls back one generation and ends bit for bit."""
    _, ds = _sdca_data(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=20, local_iters=8, lam=0.01)
    d = DebugParams(debug_iter=5, seed=0, chkpt_iter=5,
                    chkpt_dir=str(tmp_path))
    full = port_cocoa.run_cocoa(ds, p, d, plus=True, quiet=True)
    gens = ckpt.generations(str(tmp_path), "CoCoA+")
    assert [os.path.basename(g) for g in gens] == [
        "CoCoA+-r000015.npz", "CoCoA+-r000020.npz"]
    with open(gens[-1], "r+b") as f:
        f.truncate(80)
    path = ckpt.latest(str(tmp_path), "CoCoA+")
    assert path == gens[0]
    meta, w0, a0 = ckpt.load(path)
    assert meta["round"] == 15
    res = port_cocoa.run_cocoa(ds, p, DebugParams(debug_iter=5, seed=0),
                               plus=True, quiet=True, w_init=w0,
                               alpha_init=a0, start_round=16)
    _same_bits(res, full, after=15)


def test_jump_scatter_reproducible_on_cpu():
    """The secant jump's scatter (ops/rows.py shards_axpy) adds each
    column's terms in slot order on the CPU too: a large scatter, which
    index_put with accumulate splits over racing threads, gives the same
    bits every time, those of a serial numpy scatter."""
    from cocoa_torch.ops import rows

    rng = np.random.default_rng(3)
    cols = torch.as_tensor(rng.integers(0, 3000, 400_000))
    vals = torch.as_tensor(rng.normal(size=400_000).astype(np.float32))
    want = np.zeros(3000, np.float32)
    np.add.at(want, cols.numpy(), vals.numpy())
    for _ in range(4):
        got = rows._scatter_add(torch.zeros(3000), cols, vals)
        assert np.array_equal(got.numpy(), want)


def test_align_alpha_pads_and_refuses(tiny_data):
    """A restored alpha with fewer padded rows a shard is zero-padded;
    one that cannot be this data's is refused with JAX's message."""
    _, ds = _sdca_data(tiny_data)
    short = np.ones((K, int(ds.counts.max())))
    a = base.align_alpha(short, ds)
    assert a.shape == (K, ds.n_shard)
    assert torch.equal(a[:, short.shape[1]:], torch.zeros(
        K, ds.n_shard - short.shape[1], dtype=torch.float64))
    # a JAX checkpoint's wider shard axis: zeros past n_shard are cut
    wide = np.zeros((K, ds.n_shard + 9))
    wide[:, :3] = 0.5
    assert torch.equal(base.align_alpha(wide, ds),
                       torch.as_tensor(wide[:, :ds.n_shard]))
    wide[0, ds.n_shard] = 1.0
    with pytest.raises(ValueError, match="different data or numSplits"):
        base.align_alpha(wide, ds)
    with pytest.raises(ValueError, match="incompatible with K=4"):
        base.align_alpha(np.ones((3, ds.n_shard)), ds)
    with pytest.raises(ValueError, match="different data or numSplits"):
        base.align_alpha(np.ones((K, 2)), ds)


def test_bf16_resume_bit_for_bit(tiny_data, tmp_path):
    """A bfloat16 run checkpoints its state as ``|V2`` bytes and resumes
    from them bit for bit (the JAX package cannot cast them back)."""
    _, ds64 = _sdca_data(tiny_data)
    ds = dataclass_replace(ds64, **{f: getattr(ds64, f).to(torch.bfloat16)
                                    for f in ("labels", "mask", "sq_norms",
                                              "X")})
    p = Params(n=tiny_data.n, num_rounds=FULL, local_iters=12, lam=0.01)
    kw = dict(plus=True, quiet=True, math="fast")
    full = port_cocoa.run_cocoa(ds, p, _debug(False), **kw)
    port_cocoa.run_cocoa(ds, dataclass_replace(p, num_rounds=HALF),
                         _debug(False, tmp_path), **kw)
    path = ckpt.latest(str(tmp_path), "CoCoA+")
    assert jax_ckpt.validate(path) is None
    with np.load(path) as f:
        assert f["w"].dtype.str == "|V2"
    meta, arrays = ckpt.load_full(path)
    assert arrays["w"].dtype == torch.bfloat16
    res = port_cocoa.run_cocoa(ds, p, _debug(False), w_init=arrays["w"],
                               alpha_init=arrays["alpha"],
                               start_round=meta["round"] + 1, **kw)
    assert res[0].dtype == torch.bfloat16
    _same_bits(res, full, after=HALF)


# --- the schedule's state: sigma' anneal, sigma' auto, accel -----------------


def _anneal_run(device_loop, directory="", **kw):
    _, ds, n = coherent(seed=ROBUST_SEED)
    return port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=700, local_iters=16, lam=1e-4,
                   sigma=kw.pop("sigma", 1.0)),
        DebugParams(debug_iter=25, seed=0, chkpt_iter=100,
                    chkpt_dir=directory), plus=True,
        quiet=kw.pop("quiet", True), math="fast", gap_target=1e-3,
        rng="jax", sigma_schedule="anneal", device_loop=device_loop, **kw)


@pytest.mark.parametrize("device_loop", LOOPS)
def test_anneal_resume_mid_schedule_bit_identical(tmp_path, monkeypatch,
                                                  device_loop):
    """tests/test_sigma_anneal.py:153: resumed from a checkpoint taken
    mid-window at stage 0 with its sched vector, the anneal backs off at
    the same round and ends bit for bit as the uninterrupted run."""
    monkeypatch.setattr(ckpt, "KEEP_GENERATIONS", 1000)
    full = _anneal_run(device_loop, str(tmp_path))
    assert full[2].stopped == "target" and full[2].records[-1].sigma == 2.0
    path = os.path.join(str(tmp_path), "CoCoA+-r000200.npz")
    meta, arrays = ckpt.load_full(path)
    sched = np.asarray(meta["sched"], np.float32)
    assert sched.shape == (base.SCHED_LEN,)
    assert sched[0] == 0.0 and sched[1] > 0, "a mid-window stage-0 save"
    assert sched[4] == meta["round"] + 1
    res = _anneal_run(device_loop, w_init=arrays["w"],
                      alpha_init=arrays["alpha"],
                      start_round=meta["round"] + 1, sched_init=sched)
    _same_bits(res, full, after=meta["round"])


def test_anneal_resume_without_sched_falls_back_to_safe(capsys):
    """tests/test_sigma_anneal.py:181: resumed without the schedule's
    state, the anneal continues at the safe sigma' (K gamma = 4)."""
    rng = np.random.default_rng(0)
    w0 = torch.as_tensor(rng.normal(size=16) * 0.01)
    _, _, traj = _anneal_run(False, sigma="auto", w_init=w0, start_round=5,
                             quiet=False)
    out = capsys.readouterr().out
    assert "sigma anneal: resumed run has no schedule state; continuing " \
           "with the safe σ′=K·γ=4" in out
    assert all(r.sigma is None for r in traj.records)


def test_sigma_auto_resumed_run_skips_trial(capsys):
    """tests/test_divergence.py:208: a resumed sigma' auto trial goes to
    the safe sigma' at once, equal to an explicit safe resume."""
    _, ds, n = coherent()
    params = Params(n=n, num_rounds=60, local_iters=16, lam=1e-4,
                    sigma="auto")
    debug = DebugParams(debug_iter=4, seed=0)
    w0 = torch.as_tensor(np.random.default_rng(0).normal(size=16) * 0.01)
    kw = dict(plus=True, math="fast", gap_target=1e-3, rng="jax",
              w_init=w0, start_round=5)
    auto = port_cocoa.run_cocoa(ds, params, debug, quiet=False,
                                sigma_schedule="trial", **kw)
    assert "resumed run continues with the safe" in capsys.readouterr().out
    safe = port_cocoa.run_cocoa(ds, dataclass_replace(params, sigma=None),
                                debug, quiet=True, **kw)
    _same_bits(auto, safe)


def test_diverged_trial_checkpoints_deleted(tmp_path, monkeypatch, capsys):
    """tests/test_divergence.py:132: a diverged sigma' trial's checkpoints
    go before the safe rerun, only those: another algorithm's file, a
    file that was there before the trial and a new one past the round the
    trial reached stay."""
    from cocoa_torch.utils.logging import RoundRecord, Trajectory

    _, ds, n = coherent()
    (tmp_path / "CoCoA-r000008.npz").write_bytes(b"x")
    (tmp_path / "CoCoA+-r000500.npz").write_bytes(b"x")
    real = port_cocoa.run_sdca_family
    calls = []

    def spy(ds_, params_, debug_, name_, alg, **kw):
        calls.append(alg[2])
        if alg[2] == 2.0:
            for f in ("CoCoA+-r000392.npz", "CoCoA+-r000392.npz.json",
                      "CoCoA+-r000400.npz"):
                (tmp_path / f).write_bytes(b"x")
            t = Trajectory(name_, quiet=True)
            t.records.append(RoundRecord(round=392, wall_time=None, gap=5.0))
            t.stopped = "diverged"
            return None, None, t
        return real(ds_, params_, debug_, name_, alg, **kw)

    monkeypatch.setattr(port_cocoa, "run_sdca_family", spy)
    params = Params(n=n, num_rounds=400, local_iters=16, lam=1e-4,
                    sigma="auto")
    debug = DebugParams(debug_iter=4, seed=0, chkpt_iter=8,
                        chkpt_dir=str(tmp_path))
    _, _, traj = port_cocoa.run_cocoa(
        ds, params, debug, plus=True, quiet=False, math="fast",
        gap_target=1e-3, rng="jax", sigma_schedule="trial")
    assert calls[:2] == [2.0, 4.0]
    assert traj.stopped == "target"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert "CoCoA+-r000392.npz" not in names
    assert "CoCoA+-r000392.npz.json" not in names
    assert {"CoCoA-r000008.npz", "CoCoA+-r000500.npz",
            "CoCoA+-r000400.npz"} <= set(names)
    assert "restarting with the safe" in capsys.readouterr().out


def _accel_run(ds, device_loop, directory="", accel="on", **kw):
    p = Params(n=ds.n, num_rounds=200, local_iters=12, lam=0.01)
    return port_cocoa.run_cocoa(
        ds, p, DebugParams(debug_iter=5, seed=0, chkpt_iter=20,
                           chkpt_dir=directory), plus=True, quiet=True,
        math="fast", rng="permuted", gap_target=1e-8, accel=accel,
        theta="adaptive" if accel == "on" else None,
        device_loop=device_loop, **kw)


@pytest.mark.parametrize("device_loop", LOOPS)
def test_accel_resume_mid_momentum_bit_identical(tiny_data, tmp_path,
                                                 monkeypatch, device_loop):
    """tests/test_accel.py:227,241: an accelerated run's checkpoint holds
    the bank ``hist`` (2, K, n_shard) and the 13-slot sched vector;
    resumed from it mid-momentum, the run ends bit for bit as the
    uninterrupted one."""
    monkeypatch.setattr(ckpt, "KEEP_GENERATIONS", 1000)
    _, ds = _sdca_data(tiny_data)
    full = _accel_run(ds, device_loop, str(tmp_path))
    path = os.path.join(str(tmp_path), "CoCoA+-r000040.npz")
    meta, arrays = ckpt.load_full(path)
    assert arrays["hist"].shape == (2,) + arrays["alpha"].shape
    sched = np.asarray(meta["sched"], np.float32)
    assert sched.shape == (base.SCHED_LEN + base.ACCEL_LEN,)
    assert sched[base.A_HIST] > 0 or sched[base.A_JUMP] > 0, \
        "a mid-momentum save"
    res = _accel_run(ds, device_loop, w_init=arrays["w"],
                     alpha_init=arrays["alpha"], hist_init=arrays["hist"],
                     sched_init=sched, start_round=meta["round"] + 1)
    _same_bits(res, full, after=meta["round"])


def test_accel_off_resumes_accel_checkpoint(tiny_data, tmp_path,
                                            monkeypatch):
    """tests/test_accel.py:262: an accel checkpoint restored into an
    --accel=off run keeps the sigma' head and drops the momentum state."""
    monkeypatch.setattr(ckpt, "KEEP_GENERATIONS", 1000)
    _, ds = _sdca_data(tiny_data)
    _accel_run(ds, False, str(tmp_path))
    meta, arrays = ckpt.load_full(os.path.join(str(tmp_path),
                                               "CoCoA+-r000040.npz"))
    _, _, traj = _accel_run(ds, False, accel="off", w_init=arrays["w"],
                            alpha_init=arrays["alpha"],
                            sched_init=np.asarray(meta["sched"], np.float32),
                            start_round=meta["round"] + 1)
    assert traj.records and traj.records[0].round > meta["round"]


# --- the CLI -----------------------------------------------------------------


def _demo_argv(ck, rounds=2):
    return [f"--trainFile={SMALL_TRAIN}", "--numFeatures=9947",
            f"--numRounds={rounds}", "--localIterFrac=0.002",
            "--numSplits=4", "--lambda=.001", "--dtype=float64",
            "--debugIter=1", "--chkptIter=1", f"--chkptDir={ck}"]


@pytest.mark.parametrize("loop", [[], ["--deviceLoop"]],
                         ids=["chunked", "device"])
def test_cli_resume_covers_full_menu(tmp_path, capsys, loop):
    """tests/test_cli_flags.py:56: --resume restores every algorithm of
    the menu, each printing the JAX CLI's line."""
    argv = _demo_argv(tmp_path / "ck") + ["--justCoCoA=false", "--quiet",
                                          "--device=cpu"] + loop
    assert cli.main(argv) == 0
    capsys.readouterr()
    assert cli.main(argv + ["--resume"]) == 0
    out = capsys.readouterr().out
    for alg in ("CoCoA+", "CoCoA", "Mini-batch CD", "Mini-batch SGD",
                "Local SGD", "Dist SGD"):
        name = alg.replace(" ", "_")
        assert f"resuming {alg} from round 2 " \
               f"({tmp_path / 'ck' / name}-r000002.npz)" in out, alg


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_resume_across_packages(tmp_path, capsys, writer):
    """One CLI checkpoints the demo at round 2 (the menu, and the lasso),
    the other resumes it to round 4: the resumed console equals the JAX
    CLI's uninterrupted 4-round run at the driver ladder's tolerances."""
    ck = tmp_path / "ck"
    jax_main = (jax_cli.main, ["--mesh=1"])
    port_main = (cli.main, ["--device=cpu"])
    first, second = (jax_main, port_main) if writer == "jax" else \
        (port_main, jax_main)
    for extra in (["--justCoCoA=false"],
                  ["--objective=lasso", "--lambda=0.1", "--layout=sparse"]):
        first[0](_demo_argv(ck) + extra + first[1])
        capsys.readouterr()
        assert second[0](_demo_argv(ck, 4) + extra + second[1]
                         + ["--resume"]) == 0
        out = capsys.readouterr().out
        assert "resuming" in out and "from round 2" in out
        jax_cli.main(_demo_argv(tmp_path / "ref", 4) + extra + ["--mesh=1"])
        ref = capsys.readouterr().out
        got = [ln for ln in out.splitlines()
               if not ln.startswith("resuming")]
        # the uninterrupted run's evals at rounds 1 and 2 (an "Iteration"
        # line and its numbers) are before the resume point
        want, skip = [], False
        for ln in ref.splitlines():
            if ln.startswith("Iteration: "):
                skip = int(ln.split()[1]) <= 2
            elif not ln.startswith(("primal", "test error")):
                skip = False
            if not skip:
                want.append(ln)
        assert_same_console("\n".join(want), "\n".join(got))


def test_cli_resume_without_chkpt_dir_exits_2(capsys):
    """--resume without --chkptDir: both CLIs exit 2 with one line."""
    argv = [f"--trainFile={SMALL_TRAIN}", "--numFeatures=9947", "--resume"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 2
    err_j = capsys.readouterr().err
    assert cli.main(argv + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert err.strip() == err_j.strip() == \
        "error: --resume requires --chkptDir"
    assert "Running" not in out


def test_cli_takes_chkpt_flags():
    """--chkptDir and --resume are ported; --chkptIter maps as in JAX
    (past the last round without a directory)."""
    assert "chkptDir" not in cli._NOT_PORTED
    assert "resume" not in cli._NOT_PORTED
    cfg, unported = cli.parse_args(["--chkptDir=d", "--chkptIter=7",
                                    "--resume", "--numRounds=30"])
    assert not unported and cfg.resume == "true"
    assert cfg.to_debug().chkpt_iter == 7 and cfg.to_debug().chkpt_dir == "d"
    cfg, _ = cli.parse_args(["--chkptIter=7", "--numRounds=30"])
    assert cfg.to_debug().chkpt_iter == 31


# --- a killed CLI run, resumed (tests/test_crash_resume.py) -----------------


def _summary(out: str):
    return [ln.strip() for ln in out.splitlines()
            if "Total Objective" in ln or "Duality Gap" in ln]


@pytest.mark.slow
@pytest.mark.parametrize("extra", [[], ["--deviceLoop"]],
                         ids=["chunked", "deviceloop"])
def test_sigkill_then_resume_matches_uninterrupted(tmp_path, extra):
    """The port's CLI SIGKILLed once its first checkpoint exists, then
    relaunched with --resume from a mid-run round, ends with the summary
    of an uninterrupted run."""
    argv = [sys.executable, "-m", "cocoa_torch.cli",
            f"--trainFile={SMALL_TRAIN}", "--numFeatures=9947",
            "--numRounds=400", "--localIterFrac=1", "--numSplits=4",
            "--lambda=.001", "--debugIter=4", "--chkptIter=4",
            "--device=cpu"] + extra
    env = {**os.environ, "PYTHONPATH": ROOT}

    def run(args):
        return subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)

    ck = tmp_path / "ck"
    ref = run(argv + [f"--chkptDir={tmp_path / 'ref'}"])
    assert ref.returncode == 0, ref.stderr[-2000:]
    os.makedirs(ck)
    with open(tmp_path / "killed.log", "w") as log:
        proc = subprocess.Popen(argv + [f"--chkptDir={ck}"], cwd=ROOT,
                                env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 300
            while time.time() < deadline and not any(
                    f.endswith(".npz") for f in os.listdir(ck)):
                assert proc.poll() is None, "finished before a checkpoint"
                time.sleep(0.05)
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
    res = run(argv + [f"--chkptDir={ck}", "--resume"])
    assert res.returncode == 0, res.stderr[-2000:]
    resumed = [ln for ln in res.stdout.splitlines() if "resuming" in ln]
    assert resumed and int(resumed[0].split("from round ")[1].split()[0]) \
        < 400
    assert _summary(res.stdout) == _summary(ref.stdout)
