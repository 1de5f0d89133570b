"""The device-resident run (``--deviceLoop``, solvers/base.py
``drive_device``) against the JAX package's device loop and against the
port's own chunked loop, float64 on the CPU, mirroring
tests/test_solvers.py:241,290,323, tests/test_device_paths.py:48,73,100,
128, tests/test_sigma_anneal.py:121, tests/test_divergence.py:98,
tests/test_accel.py:215, tests/test_block.py:137 and
tests/test_prox.py:104.

On the CPU the port's device loop runs its chunk steps eagerly: the same
ops as the captured steps on the card, each write committed only while
the run is live.  It must equal the port's chunked loop bit for bit
(records, stop reason, final w and alpha), and the device twin of the
ladder (``ladder_step``) the host twins bit for bit.

Against the JAX package the tolerances are the driver ladder's
(tests/test_torch_gap_target.py): the stop reason, every eval's round
and sigma' equal; primal objectives and test errors to relative 1e-12,
gaps to 1e-12 of the primal; a diverging run's numbers only before round
125, on data seed 7 (whose bail-out round does not move with rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse as jax_synth  # noqa: E402
from cocoa_tpu.solvers import base as jax_base  # noqa: E402
from cocoa_tpu.solvers import cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.solvers import run_dist_gd as jax_dist_gd  # noqa: E402
from cocoa_tpu.solvers import run_minibatch_cd as jax_mbcd  # noqa: E402
from cocoa_tpu.solvers import run_prox_cocoa as jax_prox  # noqa: E402
from cocoa_tpu.solvers import run_sgd as jax_sgd  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.evals import objectives  # noqa: E402
from cocoa_torch.solvers import base  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from cocoa_torch.solvers.dist_gd import run_dist_gd  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402
from cocoa_torch.solvers.sgd import run_sgd  # noqa: E402
from test_torch_gap_target import CHAOS_FROM, DEMO, ROBUST_SEED, \
    assert_same_console, assert_same_run, both_clis, coherent, \
    port_ds  # noqa: E402
from test_torch_prox import _problem  # noqa: E402
from test_torch_scan_chunk import argv_of, write_train  # noqa: E402

K = 4
RTOL = 1e-12
F64 = torch.float64


def _tiny(tiny_data, layout="dense"):
    ds_j = jax_shard(tiny_data, k=K, layout=layout, dtype=jnp.float64)
    return ds_j, port_ds(ds_j)


def _same_bits(a, b):
    """Two runs of the port bit for bit: every record's numbers (its wall
    time aside), the stop reason and the final state."""
    (w_a, al_a, t_a), (w_b, al_b, t_b) = a, b
    keys = ("round", "primal", "gap", "test_error", "sigma", "sigma_stage",
            "stall")
    assert [tuple(getattr(r, k) for k in keys) for r in t_a.records] == \
        [tuple(getattr(r, k) for k in keys) for r in t_b.records]
    assert t_a.stopped == t_b.stopped
    assert torch.equal(w_a, w_b)
    assert (al_a is None) == (al_b is None)
    if al_a is not None:
        assert torch.equal(al_a, al_b)


def _close(traj, traj_j, upto=None):
    """The port's records against JAX's device loop (module docstring)."""
    assert_same_run(traj, traj_j, upto=upto)


# --- the device twin of the ladder ------------------------------------------


def _gaps(seed, tgt, n=80):
    """Gaps that fall, stall, rise, tie the target and go missing (NaN)."""
    rng = np.random.default_rng(seed)
    g, out = 1.0, []
    for _ in range(n):
        u = rng.random()
        if u < 0.08:
            out.append(float("nan"))
            continue
        if u < 0.14 and tgt is not None:
            out.append(tgt)
            continue
        g *= float(rng.choice([0.4, 0.7, 0.95, 1.0, 1.3, 2.5]))
        out.append(g)
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n_stages,n_theta", [(3, 0), (1, 1), (1, 2),
                                              (3, 2), (8, 3)])
@pytest.mark.parametrize("tgt", [None, 1e-2])
def test_ladder_step_matches_host_twins(seed, n_stages, n_theta, tgt):
    """ladder_step against sched_host_step and accel_host_step, step by
    step over a gap sweep, bit for bit: the sched vector, the bank push,
    and the row's stage, stall, Theta stage and restarts columns.  On a
    target hit the host steps do not run: the device changes no stage,
    bank, jump or restart, and its logged stall is the host's preview."""
    accel = n_theta > 0
    # the guard's own watch (no sched slot) is the next test's
    lad = base.Ladder(tgt, n_stages > 1, n_stages, 3, n_theta)
    anneal = lad.anneal
    s = base.sched_init_array(1, accel=accel)
    rng = np.random.default_rng(seed)
    hist = torch.as_tensor(rng.random((2, 3, 5)))
    alpha = torch.as_tensor(rng.random((3, 5)))
    for gap in _gaps(seed, tgt):
        s[4] += np.float32(5)
        if accel:
            s[base.A_JUMP] = 0.0  # the chunk's head cleared it
        metrics = torch.tensor([1.0, gap, float("nan")], dtype=F64)
        sched_d, _, hist_d, done_tgt, _, row = base.ladder_step(
            lad, metrics, torch.from_numpy(s.copy()), None,
            hist if accel else None, alpha if accel else None)
        sched_d, row = sched_d.numpy(), row.numpy()
        host_gap = None if np.isnan(gap) else gap
        hit = tgt is not None and host_gap is not None and host_gap <= tgt
        assert bool(done_tgt) == hit
        if hit:
            if anneal:
                _, _, stl = base._watch_update(
                    np, base._gap32(host_gap), s[2], s[3], s[1],
                    np.float32(base.STALL_REL))
                assert row[3] == s[0] and row[4] == stl
            assert sched_d[0] == s[0]
            if accel:
                for slot in (base.A_HIST, base.A_JUMP, base.A_RESTARTS,
                             base.A_LASTGAP, base.A_TH_STAGE):
                    assert sched_d[slot] == s[slot]
                assert torch.equal(hist_d, hist)
            continue
        backed = False
        if anneal:
            s, backed = base.sched_host_step(s, host_gap, 3, n_stages)
        if accel:
            s, _, _ = base.accel_host_step(s, host_gap, n_theta, tgt,
                                           seam=backed)
            want = hist if s[base.A_JUMP] > 0 else torch.stack([hist[1],
                                                                alpha])
            assert torch.equal(hist_d, want)
            hist = want
            assert row[5] == s[base.A_TH_STAGE]
            assert row[6] == s[base.A_RESTARTS]
        else:
            assert np.isnan(row[5]) and np.isnan(row[6])
        assert np.array_equal(sched_d.view(np.uint32), s.view(np.uint32))
        if anneal:
            assert row[3] == s[0] and row[4] == s[1]


@pytest.mark.parametrize("seed", range(4))
def test_ladder_step_guard_matches_gap_watch(seed):
    """The guard's watch on the device against the host's _GapWatch, a
    NaN gap counting as +inf (JAX's device rule), and the target winning
    a tie with the bail-out."""
    tgt = 1e-3
    lad = base.Ladder(tgt, True, 0, 4)
    watch = (torch.zeros((), dtype=torch.int64),
             torch.full((), float("inf"), dtype=F64),
             torch.full((), float("inf"), dtype=F64))
    host = base._GapWatch(n_evals=4)
    for gap in _gaps(seed, tgt):
        metrics = torch.tensor([1.0, gap, float("nan")], dtype=F64)
        _, watch, _, done_tgt, done_stall, row = base.ladder_step(
            lad, metrics, None, watch, None, None)
        fired = host.update(float("inf") if np.isnan(gap) else gap)
        row = row.numpy()
        assert bool(done_tgt) == (gap <= tgt)
        assert bool(done_stall) == (fired and not gap <= tgt)
        assert int(watch[0]) == host.stall == row[4]
        assert float(watch[1]) == host.best
        assert np.isnan(row[3]) and np.isnan(row[5])


def test_ladder_without_target_never_stops():
    """A fixed-round run executes its budget: no guard, no stop flag."""
    lad = base.Ladder(None, True, 0, 2)
    assert not lad.guard and not lad.anneal
    for gap in (1.0, 2.0, 3.0, 4.0, float("nan")):
        out = base.ladder_step(lad, torch.tensor([1.0, gap, 0.0], dtype=F64),
                               None, None, None, None)
        assert not bool(out[3]) and not bool(out[4])
        assert out[5][4] == 0.0


def test_super_blocks_match_jax(monkeypatch):
    """The super-block sizes as JAX computes them (cocoa_tpu/solvers/
    base.py:1302-1337), equal and geometric, under a shrunk table cap."""
    import math

    def jax_sizes(n_full, chunk_ints, gap_target):
        max_block = max(1, jax_base.MAX_IDX_TABLE_BYTES // (4 * chunk_ints))
        if gap_target is None or \
                n_full * chunk_ints <= jax_base.SMALL_TABLE_INTS:
            n_blocks = math.ceil(n_full / max_block)
            g = per = math.ceil(n_full / n_blocks)
        else:
            per, g = None, max(1, jax_base.SMALL_TABLE_INTS // chunk_ints)
        out, rem = [], n_full
        while rem > 0:
            b = min(per or g, max_block, rem)
            g = min(g * 2, max_block)
            out.append(b)
            rem -= b
        return out

    assert base.MAX_IDX_TABLE_BYTES == jax_base.MAX_IDX_TABLE_BYTES
    assert base.SMALL_TABLE_INTS == jax_base.SMALL_TABLE_INTS
    for cap in (None, 4 * 2 * 100):
        if cap is not None:
            monkeypatch.setattr(base, "MAX_IDX_TABLE_BYTES", cap)
            monkeypatch.setattr(jax_base, "MAX_IDX_TABLE_BYTES", cap)
        for n_full, ints, tgt in ((5, 100, None), (64, 25, 1e-4),
                                  (64, 25 * 8 * 253, 1e-4),
                                  (3000, 2000, 1e-3), (7, 100, 1e-3)):
            assert base.super_blocks(n_full, ints, tgt) == \
                jax_sizes(n_full, ints, tgt)


@pytest.mark.parametrize("hot_cols", [0, 6])
def test_shards_axpy_nonzero_slots_same_sum(tiny_data, hot_cols):
    """The secant jump's scatter over the nonzero slots alone equals the
    scatter over every padded slot, bit for bit (padding adds 0)."""
    from cocoa_torch.ops import rows

    ds_j = jax_shard(tiny_data, k=K, layout="sparse", dtype=jnp.float64,
                     hot_cols=hot_cols)
    shards = port_ds(ds_j).shard_arrays()
    rng = np.random.default_rng(1)
    coefs = torch.as_tensor(rng.normal(size=shards["labels"].shape))
    vec = torch.as_tensor(rng.normal(size=tiny_data.num_features))
    slots = rows.nonzero_slots(shards)
    assert slots[0].numel() == int((shards["sp_values"] != 0).sum())
    assert torch.equal(rows.shards_axpy(coefs, shards, vec, slots),
                       rows.shards_axpy(coefs, shards, vec))


# --- the device loop equals the chunked loop (the port, bit for bit) -------


def _coherent_run(device_loop, seed=ROBUST_SEED, **kw):
    _, ds, n = coherent(seed=seed)
    return port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=700, local_iters=16, lam=1e-4,
                   sigma=1.0),
        DebugParams(debug_iter=25, seed=0), plus=True, quiet=True,
        math="fast", gap_target=1e-3, rng="jax", device_loop=device_loop,
        **kw)


def _sdca(tiny_data, layout="dense", **kw):
    def run(device_loop):
        _, ds = _tiny(tiny_data, layout)
        p = dict(n=tiny_data.n, num_rounds=30, local_iters=12, lam=0.01)
        extra = dict(kw)
        for f in ("num_rounds", "local_iters", "lam", "sigma"):
            if f in extra:
                p[f] = extra.pop(f)
        plus = extra.pop("plus", True)
        return port_cocoa.run_cocoa(
            ds, Params(**p), DebugParams(debug_iter=5, seed=0), plus=plus,
            quiet=True, test_ds=ds, device_loop=device_loop, **extra)
    return run


CASES = {
    "cocoa+": lambda td: _sdca(td),
    "cocoa": lambda td: _sdca(td, plus=False, rng="permuted"),
    "fast sparse": lambda td: _sdca(td, "sparse", math="fast", rng="jax"),
    "block": lambda td: _sdca(td, math="fast", block_size=4),
    "gap target": lambda td: _sdca(td, num_rounds=200, gap_target=0.05),
    "host tables": lambda td: _sdca(td, num_rounds=200, gap_target=0.05,
                                    sampling="host", rng="permuted"),
    "accel": lambda td: _sdca(td, num_rounds=200, gap_target=1e-4,
                              accel="on", math="fast", rng="permuted"),
    "theta": lambda td: _sdca(td, num_rounds=200, gap_target=1e-4,
                              accel="on", theta="adaptive",
                              rng="permuted"),
    "warm start": lambda td: _sdca(td, num_rounds=200, gap_target=1e-4,
                                   warm_start=(0.5, 10)),
    "sigma auto": lambda td: _sdca(td, num_rounds=200, gap_target=1e-4,
                                   sigma="auto", math="fast"),
    "anneal": lambda td: lambda dl: _coherent_run(
        dl, sigma_schedule="anneal"),
    "diverged": lambda td: lambda dl: _coherent_run(dl),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_loop_equals_chunked(tiny_data, case):
    """The SDCA family through both loops: records, stop reason, w and
    alpha bit for bit, with one fetch of the device a super-block."""
    run = CASES[case](tiny_data)
    chunked, device = run(False), run(True)
    _same_bits(chunked, device)
    traj = device[2]
    assert traj.fetches < chunked[2].fetches or len(traj.records) <= 1
    assert all(r.wall_time is None for r in traj.records[:-1])
    if case == "anneal":
        assert [r.sigma for r in traj.records][-1] == 2.0
    if case == "diverged":
        assert traj.stopped == "diverged" and traj.records[-1].round == 425


def test_device_loop_equals_chunked_menu_and_prox(tiny_data):
    """SGD (local and mini-batch), DistGD, mini-batch CD and ProxCoCoA+
    through both loops, bit for bit."""
    _, ds = _tiny(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=12, local_iters=15, lam=0.01)
    d = DebugParams(debug_iter=4, seed=0)
    for local in (True, False):
        w0, t0 = run_sgd(ds, p, d, local=local, quiet=True, test_ds=ds)
        w1, t1 = run_sgd(ds, p, d, local=local, quiet=True, test_ds=ds,
                         device_loop=True)
        _same_bits((w0, None, t0), (w1, None, t1))
        assert t1.fetches == 1 and all(r.gap is None for r in t1.records)
    w0, t0 = run_dist_gd(ds, p, d, quiet=True)
    w1, t1 = run_dist_gd(ds, p, d, quiet=True, device_loop=True)
    _same_bits((w0, None, t0), (w1, None, t1))
    _same_bits(run_minibatch_cd(ds, p, d, quiet=True, gap_target=0.5),
               run_minibatch_cd(ds, p, d, quiet=True, gap_target=0.5,
                                device_loop=True))
    A, b, _, data_t = _problem(seed=2)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    cols, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                              layout="dense")
    kw = dict(n=A.shape[1], num_rounds=40, local_iters=8, lam=lam,
              smoothing=0.0, loss="lasso")
    out = [run_prox_cocoa(cols, b_t, Params(**kw),
                          DebugParams(debug_iter=4, seed=3), quiet=True,
                          gap_target=1e-3, device_loop=dl)
           for dl in (False, True)]
    _same_bits(*[(r, x, t) for x, r, t in out])


def test_head_and_tail_off_cadence(tiny_data):
    """drive with a start round off the eval cadence: the head runs to
    the next boundary and evaluates on the host, the tail after the last
    boundary runs without an eval; the device loop equals the chunked
    loop bit for bit and JAX's device loop at the tolerances
    (tests/test_solvers.py::test_device_loop_off_cadence_resume)."""
    ds_j, ds = _tiny(tiny_data)
    p1 = dict(n=tiny_data.n, num_rounds=1, local_iters=20, lam=0.01)
    w1, a1, _ = jax_cocoa.run_cocoa(ds_j, JaxParams(**p1), JaxDebug(),
                                    plus=True, quiet=True)
    p = dict(p1, num_rounds=9)
    _, _, traj_j = jax_cocoa.run_cocoa(
        ds_j, JaxParams(**p), JaxDebug(debug_iter=2, seed=0), plus=True,
        quiet=True, w_init=w1, alpha_init=a1, start_round=2,
        device_loop=True)
    params = Params(**p)
    alg = port_cocoa._alg_config(params, K, True)
    body = base.per_round(port_cocoa._sdca_round_parts(
        params, alg[0], alg[1], alg[2], math="exact", ds=ds))
    shards = ds.shard_arrays()

    def metrics(state):
        return objectives.eval_metrics(state[0], state[1], shards,
                                       params.lam, ds.n)

    state0 = (torch.as_tensor(np.array(w1)), torch.as_tensor(np.array(a1)))
    out = []
    for device_loop in (False, True):
        sampler = base.make_sampler("reference", 0, 20, ds.counts, "auto", 9)
        (w, a), traj = base.drive(
            "CoCoA+", params, DebugParams(debug_iter=2, seed=0), state0,
            body, metrics, sampler, "cpu", 2, quiet=True, start_round=2,
            n_iterate=2, device_loop=device_loop)
        out.append((w, a, traj))
    _same_bits(*out)
    traj = out[1][2]
    assert [r.round for r in traj.records] == [2, 4, 6, 8]
    assert traj.records[0].wall_time is not None  # the head's host eval
    assert traj.records[1].wall_time is None
    assert traj.fetches == 2  # the head's eval and one super-block
    _close(traj, traj_j)


# --- against JAX's device loop ------------------------------------------------


@pytest.mark.parametrize("plus", [True, False])
def test_device_loop_matches_jax(tiny_data, plus):
    """tests/test_solvers.py:241: records with test errors and the final
    (w, alpha), with a num_rounds % debugIter tail."""
    ds_j, ds = _tiny(tiny_data)
    p = dict(n=tiny_data.n, num_rounds=7, local_iters=20, lam=0.01)
    w_j, a_j, t_j = jax_cocoa.run_cocoa(
        ds_j, JaxParams(**p), JaxDebug(debug_iter=2, seed=0), plus=plus,
        test_ds=ds_j, quiet=True, device_loop=True)
    w, a, t = port_cocoa.run_cocoa(
        ds, Params(**p), DebugParams(debug_iter=2, seed=0), plus=plus,
        test_ds=ds, quiet=True, device_loop=True)
    assert [r.round for r in t.records] == [2, 4, 6]
    _close(t, t_j)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("sampling", ["host", "device"])
def test_super_blocks_equal_one_block(tiny_data, monkeypatch, sampling):
    """tests/test_solvers.py:290: super-blocks of 2, 2 and 1 chunks (host
    tables; device tables ride one block) equal one block, and a target
    met in the second block stops at the chunked run's round and JAX's."""
    ds_j, ds = _tiny(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=10, local_iters=20, lam=0.01)
    d = DebugParams(debug_iter=2, seed=0)
    kw = dict(plus=True, quiet=True, sampling=sampling, device_loop=True)
    one = port_cocoa.run_cocoa(ds, p, d, **kw)
    monkeypatch.setattr(base, "MAX_IDX_TABLE_BYTES",
                        4 * 2 * d.debug_iter * K * p.local_iters)
    split = port_cocoa.run_cocoa(ds, p, d, **kw)
    _same_bits(one, split)
    assert split[2].fetches == (3 if sampling == "host" else 1)
    target = float(one[2].records[2].gap) + 1e-15
    chunked = port_cocoa.run_cocoa(ds, p, d, plus=True, quiet=True,
                                   gap_target=target)
    stopped = port_cocoa.run_cocoa(ds, p, d, gap_target=target, **kw)
    _same_bits(chunked, stopped)
    assert stopped[2].records[-1].round == 6
    _, _, t_j = jax_cocoa.run_cocoa(
        ds_j, JaxParams(n=tiny_data.n, num_rounds=10, local_iters=20,
                        lam=0.01), JaxDebug(debug_iter=2, seed=0),
        plus=True, quiet=True, gap_target=target, device_loop=True)
    _close(stopped[2], t_j)


def test_gap_target_stop_matches_jax(tiny_data):
    """tests/test_solvers.py:323: the device-side stop at JAX's round."""
    ds_j, ds = _tiny(tiny_data)
    p = dict(n=tiny_data.n, num_rounds=40, local_iters=20, lam=0.01)
    kw = dict(plus=True, quiet=True, gap_target=0.08, device_loop=True)
    _, _, t_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                    JaxDebug(debug_iter=2, seed=0), **kw)
    _, _, t = port_cocoa.run_cocoa(ds, Params(**p),
                                   DebugParams(debug_iter=2, seed=0), **kw)
    assert t.stopped == "target" and t.records[-1].gap <= 0.08
    _close(t, t_j)


def test_menu_matches_jax(tiny_data):
    """tests/test_device_paths.py:48,73,100: SGD (local and mini-batch),
    DistGD and mini-batch CD (dense and sparse) on JAX's device loop: the
    primal per eval (no gap without a dual) and the final w."""
    p = dict(n=tiny_data.n, num_rounds=12, local_iters=15, lam=0.01)
    kw = dict(quiet=True, device_loop=True)
    ds_j, ds = _tiny(tiny_data)
    for local in (True, False):
        w_j, t_j = jax_sgd(ds_j, JaxParams(**p),
                           JaxDebug(debug_iter=4, seed=0), local=local, **kw)
        w, t = run_sgd(ds, Params(**p), DebugParams(debug_iter=4, seed=0),
                       local=local, **kw)
        _close(t, t_j)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-12)
    w_j, t_j = jax_dist_gd(ds_j, JaxParams(**p),
                           JaxDebug(debug_iter=4, seed=0), **kw)
    w, t = run_dist_gd(ds, Params(**p), DebugParams(debug_iter=4, seed=0),
                       **kw)
    _close(t, t_j)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-12)
    for layout in ("dense", "sparse"):
        ds_j, ds = _tiny(tiny_data, layout)
        w_j, a_j, t_j = jax_mbcd(ds_j, JaxParams(**p),
                                 JaxDebug(debug_iter=4, seed=0), **kw)
        w, a, t = run_minibatch_cd(ds, Params(**p),
                                   DebugParams(debug_iter=4, seed=0), **kw)
        _close(t, t_j)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-12)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-12)


def test_block_final_wall_stamps(tiny_data, monkeypatch):
    """tests/test_device_paths.py:128: with super-blocks of one chunk
    (host tables), each block's last record carries the time of its
    fetch, monotone, and no other record a time."""
    _, ds = _tiny(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=20, local_iters=15, lam=0.01)
    d = DebugParams(debug_iter=2, seed=0)
    monkeypatch.setattr(base, "MAX_IDX_TABLE_BYTES",
                        4 * 1 * d.debug_iter * K * p.local_iters)
    _, _, traj = port_cocoa.run_cocoa(ds, p, d, plus=True, quiet=True,
                                      device_loop=True, sampling="host")
    stamps = [r.wall_time for r in traj.records]
    assert len(stamps) == 10 and None not in stamps
    assert stamps == sorted(stamps)
    assert traj.fetches == 10
    _, _, traj = port_cocoa.run_cocoa(ds, p, d, plus=True, quiet=True,
                                      device_loop=True)
    assert [r.wall_time is None for r in traj.records] == [True] * 9 + [False]


def test_anneal_backoff_matches_jax(capsys):
    """tests/test_sigma_anneal.py:121 on the robust seed's coherent
    shards: the device loop backs sigma' off to 2 at JAX's round, prints
    JAX's device-loop line, and certifies at JAX's round."""
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    p = dict(n=n, num_rounds=700, local_iters=16, lam=1e-4, sigma=1.0)
    kw = dict(plus=True, quiet=False, math="fast", gap_target=1e-3,
              rng="jax", sigma_schedule="anneal", device_loop=True)
    _, _, t_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                    JaxDebug(debug_iter=25, seed=0), **kw)
    _, _, t = port_cocoa.run_cocoa(ds, Params(**p),
                                   DebugParams(debug_iter=25, seed=0), **kw)
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert t.stopped == t_j.stopped == "target"
    assert t.records[-1].round == t_j.records[-1].round == 600
    _close(t, t_j, upto=CHAOS_FROM)
    line = ("CoCoA+: σ′ anneal — backed off to σ′=2 in the device loop at "
            "round 425 (iterate kept, certificate exact)")
    assert line in ref.splitlines() and line in out.splitlines()


def test_bailout_matches_jax(capsys):
    """tests/test_divergence.py:98 on seed 7: the device loop bails out at
    JAX's round (425) with JAX's DIVERGED line."""
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    p = dict(n=n, num_rounds=1600, local_iters=16, lam=1e-4, sigma=1.0)
    kw = dict(plus=True, quiet=False, math="fast", gap_target=1e-3,
              rng="jax", device_loop=True)
    _, _, t_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                    JaxDebug(debug_iter=25, seed=0), **kw)
    _, _, t = port_cocoa.run_cocoa(ds, Params(**p),
                                   DebugParams(debug_iter=25, seed=0), **kw)
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert t.stopped == t_j.stopped == "diverged"
    assert t.records[-1].round == t_j.records[-1].round == 425
    _close(t, t_j, upto=CHAOS_FROM)
    line = [ln for ln in ref.splitlines() if "DIVERGED" in ln]
    assert len(line) == 1 and line == [ln for ln in out.splitlines()
                                       if "DIVERGED" in ln]


@pytest.mark.parametrize("theta", ["fixed", "adaptive"])
def test_accel_matches_jax(theta, capsys):
    """tests/test_accel.py:215: an accelerated run (sparse rows, permuted
    draws, lambda=1e-3, H=32, cadence 5, to a gap of 3e-3) on both device
    loops: the same gaps and stop round, and no restart line printed (the
    device loop's events stay on the card, as in JAX's)."""
    data = jax_synth(512, 128, nnz_mean=12, seed=0)
    ds_j = jax_shard(data, k=K, layout="dense", dtype=jnp.float64)
    ds = port_ds(ds_j)
    p = dict(n=data.n, num_rounds=200, local_iters=32, lam=1e-3)
    kw = dict(plus=True, quiet=False, math="exact" if theta == "adaptive"
              else "fast", rng="permuted", gap_target=3e-3, accel="on",
              theta=theta, device_loop=True)
    _, _, t_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                    JaxDebug(debug_iter=5, seed=0), **kw)
    _, alpha, t = port_cocoa.run_cocoa(ds, Params(**p),
                                       DebugParams(debug_iter=5, seed=0),
                                       **kw)
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert t.stopped == "target" and t.records[-1].round < 200
    _close(t, t_j)
    assert_same_console(ref, out)
    assert "momentum restart" not in out
    assert float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0


def test_block_path_matches_jax(tiny_data):
    """tests/test_block.py:137: the block round (B=8, sparse rows) on both
    device loops, to a gap target."""
    ds_j, ds = _tiny(tiny_data, "sparse")
    p = dict(n=tiny_data.n, num_rounds=60, local_iters=24, lam=0.01)
    kw = dict(plus=True, quiet=True, math="fast", block_size=8,
              rng="permuted", gap_target=1e-3, device_loop=True)
    w_j, a_j, t_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                        JaxDebug(debug_iter=4, seed=0), **kw)
    w, a, t = port_cocoa.run_cocoa(ds, Params(**p),
                                   DebugParams(debug_iter=4, seed=0), **kw)
    _close(t, t_j)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-12)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-12)


@pytest.mark.parametrize("l2", [0.0, 0.3])
def test_prox_matches_jax(l2):
    """tests/test_prox.py:104: ProxCoCoA+ on both device loops (the lasso
    metrics as the in-loop eval), lasso and elastic net."""
    A, b, data_j, data_t = _problem(seed=2)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    kw = dict(n=A.shape[1], num_rounds=12, local_iters=8, lam=lam,
              smoothing=l2, loss="lasso")
    ds_j, b_j = jax_columns(data_j, K, dtype=jnp.float64, layout="dense")
    x_j, r_j, t_j = jax_prox(ds_j, b_j, JaxParams(**kw),
                             JaxDebug(debug_iter=4, seed=3), quiet=True,
                             device_loop=True)
    ds, b_t = shard_columns(data_t, K, dtype=F64, device="cpu",
                            layout="dense")
    x, r, t = run_prox_cocoa(ds, b_t, Params(**kw),
                             DebugParams(debug_iter=4, seed=3), quiet=True,
                             device_loop=True)
    assert [r_.round for r_ in t.records] == [4, 8, 12]
    _close(t, t_j)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j)[:A.shape[0]],
                               atol=1e-9)


# --- the CLI -------------------------------------------------------------------


def test_cli_demo_matches_jax(capsys):
    """The demo in float64 with --deviceLoop to a 1e-4 gap (accel auto)
    through both CLIs: the same lines, stop rounds equal, primal to 1e-12,
    gaps to 1e-12 of the primal."""
    argv = DEMO + ["--numRounds=500", "--gapTarget=1e-4", "--deviceLoop"]
    (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
    assert rc_j == rc == 0
    assert_same_console(ref, out)
    assert "Iteration: 370" in out and "Iteration: 440" in out
    assert "momentum restart" not in out


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    path = tmp_path_factory.mktemp("device_loop") / "train.dat"
    write_train(path)
    return path


@pytest.mark.parametrize("name", ["cocoa", "menu", "block", "lasso", "sigma",
                                  "accel", "warm"])
def test_cli_commands_match_jax(name, train, capsys):
    """tests/test_torch_scan_chunk.py's commands with --deviceLoop through
    both CLIs (CoCoA+ and CoCoA, the --justCoCoA=false menu, --blockSize,
    the lasso, sigma' auto, --accel, --warmStart), and the port's lines
    equal its chunked loop's."""
    argv = argv_of(name, train)
    assert jax_cli.main(argv + ["--deviceLoop", "--mesh=1"]) == 0
    ref = capsys.readouterr().out
    assert cli.main(argv + ["--deviceLoop", "--device=cpu"]) == 0
    out = capsys.readouterr().out
    assert_same_console(ref, out)
    assert cli.main(argv + ["--deviceLoop=false", "--device=cpu"]) == 0
    chunked = capsys.readouterr().out
    keep = [ln for ln in chunked.splitlines() if "momentum restart" not in ln
            and not ln.startswith("device_loop")]
    assert keep == [ln for ln in out.splitlines()
                    if not ln.startswith("device_loop")]


def test_cli_lasso_blocks_theta_match_jax(train, capsys):
    """The lasso in blocks and --theta=adaptive with --deviceLoop."""
    for extra in (["--objective=lasso", "--lambda=.1", "--math=fast",
                   "--blockSize=4"],
                  ["--accel=on", "--theta=adaptive", "--gapTarget=1e-9",
                   "--rng=permuted", "--numRounds=24"]):
        argv = argv_of("cocoa", train)
        if extra[0] == "--objective=lasso":
            argv = [a for a in argv if not a.startswith("--testFile")]
        argv += extra + ["--deviceLoop"]
        (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
        assert rc_j == rc == 0
        assert_same_console(ref, out)


def test_cli_device_loop_needs_debug_iter(train, capsys):
    """--deviceLoop --debugIter=0 exits 2 with the JAX CLI's message."""
    argv = argv_of("cocoa", train) + ["--deviceLoop", "--debugIter=0"]
    assert jax_cli.main(argv + ["--mesh=1"]) == 2
    err_j = capsys.readouterr().err
    assert cli.main(argv + ["--device=cpu"]) == 2
    out, err = capsys.readouterr()
    assert err.strip() == err_j.strip() == (
        "error: --deviceLoop requires --debugIter > 0 (the eval cadence is "
        "the device loop's chunk axis)")
    assert "Running" not in out


def test_device_loop_refuses_eager_chunks_on_cuda(tiny_data):
    """On CUDA the device loop is captured graphs: capture=False (the
    chunked loop's eager comparison mode) is refused, not run on the
    host; and without an eval cadence there is no device loop."""
    _, ds = _tiny(tiny_data)
    p = Params(n=tiny_data.n, num_rounds=4, local_iters=5, lam=0.01)
    with pytest.raises(ValueError, match="captured CUDA graphs"):
        base.drive("CoCoA+", p, DebugParams(debug_iter=2), (None,), None,
                   None, None, "cuda", 2, capture=False, device_loop=True)
    with pytest.raises(ValueError, match="debug_iter > 0"):
        port_cocoa.run_cocoa(ds, p, DebugParams(debug_iter=0), plus=True,
                             quiet=True, device_loop=True)
