"""The port's accelerated outer loop (``--accel``, ``--theta``) against the
JAX package, float64 on the CPU: the Theta ladder, the secant coefficient
and the per-eval bookkeeping (host twins), ``accel="off"`` and ``auto``,
accelerated runs on the dense, padded-CSR and hybrid layouts (their gaps,
restarts and stop round), ``shards_axpy`` on the three layouts, and Theta
adaptive on exact math and its refusals.

Tolerances as in tests/test_torch_gap_target.py: the twins exactly (the
secant coefficient in float32 and float64 to the bit); stop reason, eval
rounds, restart and Theta lines equal; primal to relative 1e-12 and the
gap to 1e-12 of the primal; ``shards_axpy`` to 1e-12 relative to the
largest entry."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse as jax_synth  # noqa: E402
from cocoa_tpu.ops import rows as jax_rows  # noqa: E402
from cocoa_tpu.solvers import base as jax_base  # noqa: E402
from cocoa_tpu.solvers import cocoa as jax_cocoa  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.ops import rows  # noqa: E402
from cocoa_torch.solvers import base  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from test_torch_gap_target import DEMO, assert_same_console, \
    assert_same_run, both_clis, port_ds  # noqa: E402


def _data(n=512, d=128, seed=3, layout="dense", hot_cols=0):
    """JAX's synth rows sharded K=4 in float64: (JAX's, the port's, n)."""
    data = jax_synth(n, d, nnz_mean=12, seed=seed)
    ds_j = jax_shard(data, k=4, layout=layout, dtype=jnp.float64,
                     hot_cols=hot_cols)
    return ds_j, port_ds(ds_j), data.n


def _runs(ds_j, ds, n, plus=True, num_rounds=100, local_iters=16, lam=1e-2,
          debug_iter=10, **kw):
    """The same run_cocoa call on both packages: (JAX's, the port's)
    (w, alpha, Trajectory).  JAX runs its rounds in chunks at the eval
    cadence (``scan_chunk``), as its CLI does: the same trajectory as its
    per-round driver, without a dispatch a round."""
    p = dict(n=n, num_rounds=num_rounds, local_iters=local_iters, lam=lam)
    kw = {**dict(plus=plus, quiet=True, math="fast", rng="permuted"), **kw}
    out_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                JaxDebug(debug_iter=debug_iter, seed=0),
                                scan_chunk=debug_iter, **kw)
    out = port_cocoa.run_cocoa(ds, Params(**p),
                               DebugParams(debug_iter=debug_iter, seed=0),
                               **kw)
    return out_j, out


# --- the host twins ------------------------------------------------------


@pytest.mark.parametrize("h", [1, 2, 3, 16, 253, 1000])
@pytest.mark.parametrize("adaptive", [False, True])
def test_theta_ladder_matches_jax(h, adaptive):
    assert base.theta_ladder(h, adaptive) == jax_base.theta_ladder(h, adaptive)


def test_accel_constants_match_jax():
    names = ("SCHED_LEN", "ACCEL_LEN", "A_HIST", "A_JUMP", "A_RESTARTS",
             "A_LASTGAP", "A_TH_STAGE", "A_TH_STALL", "A_TH_BEST",
             "A_TH_BPREV", "ACCEL_CMIN", "ACCEL_CMAX", "ACCEL_RHO_CAP",
             "THETA_DIVS", "THETA_REL", "THETA_EVALS", "THETA_NEAR")
    assert [getattr(base, n) for n in names] == \
        [getattr(jax_base, n) for n in names]


RHOS = [-5.0, -1.0, -0.5, 0.0, 0.3, 0.73, 0.8999999, 0.9, 0.90000004, 0.95,
        0.999, 1.0, 2.0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_secant_coef_matches_jax(dtype):
    """numpy against JAX's numpy twin, torch against jnp: equal bits,
    float32 constants applied to a float64 rho as JAX applies them."""
    for rho in RHOS:
        r_np = np.dtype(dtype).type(rho)
        assert base.secant_coef(np, r_np) == jax_base.secant_coef(np, r_np)
        mine = base.secant_coef(torch, torch.tensor(rho,
                                                    dtype=getattr(torch,
                                                                  dtype)))
        ref = jax_base.secant_coef(jnp, jnp.asarray(rho, dtype=dtype))
        assert mine.dtype == getattr(torch, dtype)
        assert float(mine) == float(ref), rho


def test_secant_coef_fixture():
    """tests/test_accel.py::test_secant_coef."""
    assert base.secant_coef(np, np.float32(-1.0)) == np.float32(-0.5)
    assert base.secant_coef(np, np.float32(0.0)) == np.float32(0.0)
    c = base.secant_coef(np, np.float32(0.73))
    assert np.isclose(float(c), 0.73 / 0.27, rtol=1e-5)
    assert base.secant_coef(np, np.float32(0.999)) == np.float32(3.0)
    assert base.secant_coef(np, np.float32(-5.0)) == np.float32(-0.5)


def _gaps(seed, n=50):
    rng = np.random.default_rng(seed)
    g, out = 10.0, []
    for _ in range(n):
        g *= float(rng.choice([0.3, 0.5, 0.8, 0.95, 1.2]))
        out.append(None if rng.random() < 0.05 else g)
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_theta", [1, 2, 3])
@pytest.mark.parametrize("target", [None, 1e-3])
def test_accel_host_step_matches_jax(seed, n_theta, target):
    """Every sched vector and flag of a random eval sequence, with jumps
    consumed as the chunk head consumes them and sigma' seams at random."""
    rng = np.random.default_rng(100 + seed)
    s = base.sched_init_array(1, accel=True)
    s_j = np.asarray(jax_base.sched_init_array(1, accel=True))
    for g in _gaps(seed):
        seam = bool(rng.random() < 0.2)
        s, restarted, staged = base.accel_host_step(s, g, n_theta, target,
                                                    seam=seam)
        s_j, restarted_j, staged_j = jax_base.accel_host_step(
            s_j, g, n_theta, target, seam=seam)
        assert (restarted, staged) == (restarted_j, staged_j)
        np.testing.assert_array_equal(s, s_j)
        s[base.A_JUMP] = s_j[base.A_JUMP] = 0.0


def test_accel_host_step_fixture():
    """tests/test_accel.py::test_accel_host_step_bank_arm_restart."""
    s = base.sched_init_array(1, accel=True)
    s, restarted, _ = base.accel_host_step(s, 1.0, 1, None)
    assert not restarted and s[base.A_HIST] == 1.0 and s[base.A_JUMP] == 0
    s, restarted, _ = base.accel_host_step(s, 0.5, 1, None)
    assert not restarted and s[base.A_HIST] == 2.0 and s[base.A_JUMP] == 0
    s, restarted, _ = base.accel_host_step(s, 0.25, 1, None)
    assert s[base.A_JUMP] == 1.0 and s[base.A_HIST] == 0.0
    s[base.A_JUMP] = 0.0
    s, restarted, _ = base.accel_host_step(s, 0.6, 1, None)
    assert restarted and s[base.A_HIST] == 1.0 and s[base.A_RESTARTS] == 1.0


# --- accel off and auto ----------------------------------------------------


MODES = {"exact dense": ("exact", "dense", 0),
         "exact sparse": ("exact", "sparse", 0),
         "fast dense": ("fast", "dense", 0),
         "fast sparse": ("fast", "sparse", 0),
         "fast sparse block 4": ("fast", "sparse", 4),
         "fast dense block 8": ("fast", "dense", 8)}


@pytest.mark.parametrize("mode", list(MODES))
def test_accel_off_is_the_plain_path(mode):
    """tests/test_accel.py:177: ``accel="off"`` with a target runs the
    rounds of the targetless path bit for bit, and stops where JAX
    stops."""
    math, layout, block = MODES[mode]
    ds_j, ds, n = _data(layout=layout)
    kw = dict(math=math, block_size=block)
    (_, _, traj_j), (w, alpha, traj) = _runs(ds_j, ds, n, gap_target=1e-3,
                                             accel="off", **kw)
    assert traj.stopped == "target"
    assert_same_run(traj, traj_j)
    stop = traj.records[-1].round
    w_p, a_p, traj_p = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=stop, local_iters=16, lam=1e-2),
        DebugParams(debug_iter=10, seed=0), plus=True, quiet=True,
        rng="permuted", **kw)
    assert torch.equal(w, w_p) and torch.equal(alpha, a_p)
    assert [r.gap for r in traj.records] == [r.gap for r in traj_p.records]


def test_accel_auto_resolution():
    """tests/test_accel.py:196: auto without a target is the plain path;
    with a target it is ``on`` for CoCoA+ and ``off`` for CoCoA."""
    ds_j, ds, n = _data()

    def run(plus=True, **kw):
        return port_cocoa.run_cocoa(
            ds, Params(n=n, num_rounds=60, local_iters=16, lam=1e-2),
            DebugParams(debug_iter=10, seed=0), plus=plus, quiet=True,
            math="fast", rng="permuted", **kw)

    w_a, _, _ = run(accel="auto")
    w_p, _, _ = run()
    assert torch.equal(w_a, w_p)
    w_on, _, _ = run(accel="on", gap_target=1e-9)
    w_au, _, _ = run(accel="auto", gap_target=1e-9)
    w_off, _, _ = run(accel="off", gap_target=1e-9)
    assert torch.equal(w_on, w_au) and not torch.equal(w_on, w_off)
    w_c, _, _ = run(plus=False, accel="auto", gap_target=1e-9)
    w_c0, _, _ = run(plus=False, gap_target=1e-9)
    assert torch.equal(w_c, w_c0)


# --- accelerated runs against JAX ------------------------------------------


LAYOUTS = {"dense": dict(layout="dense"), "sparse": dict(layout="sparse"),
           "hybrid": dict(layout="sparse", hot_cols=16)}


@pytest.mark.parametrize("theta", ["fixed", "adaptive"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_accelerated_run_matches_jax(layout, theta, capsys):
    """tests/test_accel.py:379 and :394: a restart-prone accelerated run
    (lambda=1e-3, H=32, cadence 5, to a gap of 3e-3) on each layout: the
    same gaps, restart and Theta lines, and stop round."""
    ds_j, ds, n = _data(seed=0, **LAYOUTS[layout])
    p = dict(n=n, num_rounds=200, local_iters=32, lam=1e-3)
    kw = dict(plus=True, quiet=False, math="fast", rng="permuted",
              gap_target=3e-3, accel="on", theta=theta)
    _, _, traj_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                       JaxDebug(debug_iter=5, seed=0), **kw)
    _, alpha, traj = port_cocoa.run_cocoa(ds, Params(**p),
                                          DebugParams(debug_iter=5, seed=0),
                                          **kw)
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert traj.stopped == "target" and traj.records[-1].round < 200
    assert_same_run(traj, traj_j)
    assert_same_console(ref, out)
    if theta == "adaptive":
        assert "CoCoA+: Θ schedule — local accuracy raised to H=32" in out
    else:
        assert "CoCoA+: momentum restart at round" in out
    assert float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0


@pytest.mark.parametrize("theta", ["fixed", "adaptive"])
def test_accel_on_exact_math_matches_jax(theta):
    """Theta adaptive runs on the plain route, exact math, as JAX's
    non-Pallas route runs it."""
    ds_j, ds, n = _data()
    (_, _, traj_j), (_, _, traj) = _runs(ds_j, ds, n, math="exact",
                                         gap_target=1e-6, accel="on",
                                         theta=theta)
    assert_same_run(traj, traj_j)


def test_accel_with_sigma_anneal_matches_jax():
    """tests/test_accel.py::test_accel_combines_with_sigma_anneal."""
    ds_j, ds, n = _data()
    p = dict(n=n, num_rounds=100, local_iters=16, lam=1e-2, sigma="auto")
    kw = dict(plus=True, quiet=True, math="fast", rng="permuted",
              gap_target=1e-6, accel="on", theta="adaptive")
    _, _, traj_j = jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                                       JaxDebug(debug_iter=10, seed=0), **kw)
    _, _, traj = port_cocoa.run_cocoa(ds, Params(**p),
                                      DebugParams(debug_iter=10, seed=0),
                                      **kw)
    assert traj.records[-1].sigma is not None
    assert_same_run(traj, traj_j)


# --- shards_axpy -----------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shards_axpy_matches_jax(layout):
    """ops/rows.shards_axpy against JAX's on each layout, and the hybrid
    split against the dense layout (tests/test_accel.py:411)."""
    ds_j, ds, n = _data(n=256, d=64, seed=7, **LAYOUTS[layout])
    rng = np.random.default_rng(0)
    coefs = rng.normal(size=(4, ds_j.n_shard))
    vec = rng.normal(size=64)
    ref = np.asarray(jax_rows.shards_axpy(jnp.asarray(coefs),
                                          ds_j.shard_arrays(),
                                          jnp.asarray(vec)))
    mine = rows.shards_axpy(torch.tensor(coefs), ds.shard_arrays(),
                            torch.tensor(vec))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    dense_j, dense, _ = _data(n=256, d=64, seed=7)
    flat = rows.shards_axpy(torch.tensor(coefs), dense.shard_arrays(),
                            torch.tensor(vec))
    np.testing.assert_allclose(mine.numpy(), flat.numpy(), rtol=0,
                               atol=1e-12 * np.abs(ref).max())


# --- Theta: refusals and fallback -------------------------------------------


def test_theta_adaptive_refused_on_block_and_kernel_route(monkeypatch):
    """JAX's message where JAX refuses: the block round; and the port's
    kernel route (``fast_round_route == "kernel"``), which stands in for
    JAX's Pallas route, refuses before any launch."""
    ds_j, ds, n = _data()
    kw = dict(gap_target=1e-6, accel="on", theta="adaptive")
    with pytest.raises(ValueError) as ref:
        _runs(ds_j, ds, n, block_size=4, **kw)
    with pytest.raises(ValueError) as mine:
        port_cocoa.run_cocoa(ds, Params(n=n, num_rounds=10, local_iters=16,
                                        lam=1e-2),
                             DebugParams(debug_iter=5, seed=0), plus=True,
                             quiet=True, math="fast", block_size=4, **kw)
    assert str(mine.value) == str(ref.value)
    assert "--theta=adaptive slices" in str(mine.value)
    monkeypatch.setattr(port_cocoa, "fast_round_route",
                        lambda *a: "kernel")
    with pytest.raises(ValueError) as routed:
        port_cocoa.run_cocoa(ds, Params(n=n, num_rounds=10, local_iters=16,
                                        lam=1e-2),
                             DebugParams(debug_iter=5, seed=0), plus=True,
                             quiet=True, math="fast", **kw)
    assert str(routed.value) == str(ref.value)


def test_theta_adaptive_degrades_when_accel_auto_resolves_off():
    """tests/test_accel.py:429: plain CoCoA with accel auto runs Theta
    fixed; an explicit accel off with Theta adaptive raises JAX's
    message."""
    ds_j, ds, n = _data()
    p = dict(n=n, num_rounds=20, local_iters=8, lam=1e-2)
    _, _, traj = port_cocoa.run_cocoa(
        ds, Params(**p), DebugParams(debug_iter=5, seed=0), plus=False,
        quiet=True, gap_target=1e-6, accel="auto", theta="adaptive")
    assert traj.records[-1].round == 20
    kw = dict(plus=True, quiet=True, gap_target=1e-6, accel="off",
              theta="adaptive")
    with pytest.raises(ValueError) as ref:
        jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                            JaxDebug(debug_iter=5, seed=0), **kw)
    with pytest.raises(ValueError) as mine:
        port_cocoa.run_cocoa(ds, Params(**p),
                             DebugParams(debug_iter=5, seed=0), **kw)
    assert str(mine.value) == str(ref.value)


VALIDATIONS = {
    "accel fast": dict(accel="fast"),
    "theta warp": dict(accel="on", theta="warp", gap_target=1e-6),
    "theta without accel": dict(theta="adaptive", gap_target=1e-6),
    "accel on the trial": dict(sigma="auto", accel="on",
                               sigma_schedule="trial", gap_target=1e-6),
    "accel without evals": dict(accel="on", gap_target=1e-6, debug_iter=0),
    "theta without a target": dict(accel="on", theta="adaptive"),
}


@pytest.mark.parametrize("name", list(VALIDATIONS))
def test_accel_validations_match_jax(name):
    """tests/test_accel.py::test_accel_validations: JAX's messages."""
    ds_j, ds, n = _data()
    kw = dict(VALIDATIONS[name])
    di = kw.pop("debug_iter", 5)
    p = dict(n=n, num_rounds=20, local_iters=8, lam=1e-2,
             sigma=kw.pop("sigma", None))
    with pytest.raises(ValueError) as ref:
        jax_cocoa.run_cocoa(ds_j, JaxParams(**p),
                            JaxDebug(debug_iter=di, seed=0), plus=True,
                            quiet=True, **kw)
    with pytest.raises(ValueError) as mine:
        port_cocoa.run_cocoa(ds, Params(**p), DebugParams(debug_iter=di,
                                                          seed=0),
                             plus=True, quiet=True, **kw)
    assert str(mine.value) == str(ref.value)


# --- the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--accel=on", "--theta=adaptive", "--math=exact"],
    ["--accel=off"],
    ["--warmStart=0.5,15", "--math=fast"]], ids=" ".join)
def test_cli_accel_flags_match_jax(extra, capsys):
    """The demo in float64 to a gap of 1e-2 within 100 rounds with the
    accel flags through both CLIs, the flag echo excepted."""
    argv = DEMO + ["--numRounds=100", "--gapTarget=1e-2"] + extra
    (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
    assert rc_j == rc == 0
    assert_same_console(ref, out)
