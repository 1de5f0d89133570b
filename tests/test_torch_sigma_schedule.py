"""The port's sigma' schedule against the JAX package, float64 on the CPU:
the ladder and the host twins of the sched vector, the anneal with and
without a backoff, ``--sigma=auto`` under ``--sigmaSchedule=trial`` and
its fallback, the warm start, the validations with JAX's messages, and
``--sigma=auto --gapTarget=1e-4`` on the demo through both CLIs.

Tolerances as in tests/test_torch_gap_target.py: the twins exactly; stop
reason, eval rounds and sigma' per record equal; primal to relative
1e-12 and the gap to 1e-12 of the primal, before round 125 in a run that
oscillates."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse as jax_synth  # noqa: E402
from cocoa_tpu.solvers import base as jax_base  # noqa: E402
from cocoa_tpu.solvers import cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.utils.logging import RoundRecord as JaxRecord  # noqa: E402
from cocoa_tpu.utils.logging import Trajectory as JaxTrajectory  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.solvers import base  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from cocoa_torch.utils.logging import RoundRecord, Trajectory  # noqa: E402
from test_torch_gap_target import CHAOS_FROM, DEMO, ROBUST_SEED, \
    assert_same_console, assert_same_run, both_clis, coherent, \
    port_ds  # noqa: E402

K, LAM = 4, 1e-4


def _both(ds_j, ds, n, jax_kw=None, **kw):
    """The same run_cocoa call on both packages: (JAX's, the port's)
    (w, alpha, Trajectory).  ``kw`` holds Params fields, ``debug_iter``
    and run_cocoa's keywords."""
    fields = {f: kw.pop(f) for f in ("num_rounds", "local_iters", "lam",
                                     "sigma", "loss", "smoothing")
              if f in kw}
    di = kw.pop("debug_iter")
    out_j = jax_cocoa.run_cocoa(ds_j, JaxParams(n=n, **fields),
                                JaxDebug(debug_iter=di, seed=0),
                                **{**kw, **(jax_kw or {})})
    out = port_cocoa.run_cocoa(ds, Params(n=n, **fields),
                               DebugParams(debug_iter=di, seed=0), **kw)
    return out_j, out


def _transitions(traj):
    sig = [(r.round, r.sigma) for r in traj.records]
    return [sig[0]] + [b for a, b in zip(sig, sig[1:]) if b[1] != a[1]]


def _benign():
    """tests/test_sigma_anneal.py's benign data (JAX's synth, 512 x 128),
    dense float64, on both packages."""
    data = jax_synth(512, 128, nnz_mean=12, seed=3)
    ds_j = jax_shard(data, k=4, layout="dense", dtype=jnp.float64)
    return ds_j, port_ds(ds_j), data.n


# --- the host twins -------------------------------------------------------


@pytest.mark.parametrize("start,safe", [
    (4.0, 8.0), (3.5, 8.0), (1.0, 4.0), (8.0, 8.0), (9.0, 8.0), (1e-6, 8.0),
    (0.3, 16.0), (2.0, 3.0), (0.5, 4.0)])
def test_anneal_levels_matches_jax(start, safe):
    assert base.anneal_levels(start, safe) == \
        jax_base.anneal_levels(start, safe)
    assert base.MAX_SIGMA_LEVELS == jax_base.MAX_SIGMA_LEVELS


@pytest.mark.parametrize("accel", [False, True])
@pytest.mark.parametrize("restore", [None, 5, 13])
def test_sched_init_array_matches_jax(accel, restore):
    init = None
    if restore is not None:
        init = np.arange(restore, dtype=np.float32) + 0.5
    mine = base.sched_init_array(7, init, accel=accel)
    ref = np.asarray(jax_base.sched_init_array(7, init, accel=accel))
    assert mine.dtype == np.float32 and isinstance(mine, np.ndarray)
    np.testing.assert_array_equal(mine, ref)


def test_sched_init_array_refuses_as_jax():
    with pytest.raises(ValueError) as mine:
        base.sched_init_array(1, np.zeros(9, np.float32))
    with pytest.raises(ValueError) as ref:
        jax_base.sched_init_array(1, np.zeros(9, np.float32))
    assert str(mine.value) == str(ref.value)


def _gaps(seed, n=60):
    rng = np.random.default_rng(seed)
    g, out = 1.0, []
    for _ in range(n):
        g *= float(rng.choice([0.5, 0.9, 0.99, 1.0, 1.3, 4.0]))
        out.append(float("nan") if rng.random() < 0.05 else g)
    return out


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("stall_evals,n_stages", [(3, 2), (2, 4), (12, 3),
                                                   (1, 8)])
def test_sched_host_step_matches_jax(seed, stall_evals, n_stages):
    """tests/test_sigma_anneal.py:78 on random gap sequences: every
    vector, and every backoff, equal."""
    s = base.sched_init_array(1)
    s_j = np.asarray(jax_base.sched_init_array(1))
    for g in _gaps(seed):
        s, backed = base.sched_host_step(s, g, stall_evals, n_stages)
        s_j, backed_j = jax_base.sched_host_step(s_j, g, stall_evals,
                                                 n_stages)
        assert backed == backed_j
        np.testing.assert_array_equal(s, s_j)


def test_sched_host_step_fixture():
    """tests/test_sigma_anneal.py::test_sched_host_step_is_gapwatch_twin."""
    s = base.sched_init_array(1)
    fires = []
    for g in [1.0, 0.9, 0.7, 5.0, 0.6, 0.55]:
        s, backed = base.sched_host_step(s, g, stall_evals=3, n_stages=2)
        fires.append(backed)
    assert fires == [False] * 5 + [True]
    assert s[0] == 1.0 and s[1] == 0.0 and np.isinf(s[2]) and np.isinf(s[3])
    for _ in range(5):
        s, backed = base.sched_host_step(s, 0.55, stall_evals=3, n_stages=2)
        assert not backed
    assert s[0] == 1.0


# --- the anneal ------------------------------------------------------------


def test_anneal_backoff_matches_jax(capsys):
    """tests/test_sigma_anneal.py:102 and :249 on the coherent shards of
    the robust seed: sigma' = 1 = K/4 stalls, backs off to 2 at JAX's
    round with JAX's line, keeps the iterate and certifies at JAX's
    round, with sigma' and its stage per record as in JAX."""
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    (_, _, traj_j), (_, _, traj) = _both(
        ds_j, ds, n, num_rounds=1600, local_iters=16, lam=LAM, sigma=1.0,
        debug_iter=25, plus=True, quiet=False, math="fast", gap_target=1e-3,
        rng="jax", sigma_schedule="anneal")
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert traj.stopped == traj_j.stopped == "target"
    assert _transitions(traj) == _transitions(traj_j) == [(25, 1.0),
                                                          (425, 2.0)]
    assert traj.records[-1].round == traj_j.records[-1].round == 600
    assert_same_run(traj, traj_j, upto=CHAOS_FROM)
    levels = base.anneal_levels(1.0, K)
    assert [r.sigma_stage for r in traj.records] == \
        [levels.index(r.sigma) for r in traj_j.records]
    line = ("CoCoA+: σ′ anneal — gap stalled for 12 evals; backing off to "
            "σ′=2 at round 425 (iterate kept, certificate exact)")
    assert line in ref.splitlines() and line in out.splitlines()


def test_anneal_backoff_seed0():
    """tests/test_sigma_anneal.py's own shards: both packages back off
    within the ladder (never before the stall window) and certify."""
    ds_j, ds, n = coherent()
    (_, _, traj_j), (_, _, traj) = _both(
        ds_j, ds, n, num_rounds=1600, local_iters=16, lam=LAM, sigma=1.0,
        debug_iter=25, plus=True, quiet=True, math="fast", gap_target=1e-3,
        rng="jax", sigma_schedule="anneal")
    for t in (traj, traj_j):
        trans = _transitions(t)
        assert t.stopped == "target" and t.records[-1].round < 1600
        assert [s for _, s in trans] == [1.0, 2.0]
        assert trans[1][0] >= 12 * 25
    for a, b in zip(traj.records, traj_j.records):
        if a.round >= CHAOS_FROM:
            break
        np.testing.assert_allclose(a.primal, b.primal, rtol=1e-12)
        assert abs(a.gap - b.gap) <= 1e-12 * abs(b.primal)


def test_anneal_no_backoff_bitexact_vs_fixed_sigma():
    """tests/test_sigma_anneal.py:134: on benign data at sigma' = K/2 the
    watch never fires; the scheduled run equals the fixed-sigma' run bit
    for bit, and JAX's."""
    ds_j, ds, n = _benign()
    kw = dict(num_rounds=100, local_iters=16, lam=1e-2, sigma=2.0,
              debug_iter=10, plus=True, quiet=True, math="fast",
              gap_target=1e-6, rng="permuted")
    (_, _, traj_j), (w_a, a_a, traj) = _both(ds_j, ds, n,
                                             sigma_schedule="anneal", **kw)
    assert_same_run(traj, traj_j)
    assert all(r.sigma == 2.0 and r.sigma_stage == 0 for r in traj.records)
    kw.pop("debug_iter")
    w_f, a_f, traj_f = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=100, local_iters=16, lam=1e-2, sigma=2.0),
        DebugParams(debug_iter=10, seed=0), plus=True, quiet=True,
        math="fast", gap_target=1e-6, rng="permuted")
    assert torch.equal(w_a, w_f) and torch.equal(a_a, a_f)
    assert [r.gap for r in traj.records] == [r.gap for r in traj_f.records]


def test_sigma_auto_defaults_to_anneal_matches_jax():
    """tests/test_sigma_anneal.py:228: --sigma=auto anneals from K/2 and
    certifies there on the coherent shards at cadence 4."""
    ds_j, ds, n = coherent()
    (_, _, traj_j), (_, _, traj) = _both(
        ds_j, ds, n, num_rounds=400, local_iters=16, lam=LAM, sigma="auto",
        debug_iter=4, plus=True, quiet=True, math="fast", gap_target=1e-3,
        rng="jax")
    assert traj.stopped == "target" and traj.records[-1].sigma == K / 2.0
    assert_same_run(traj, traj_j)


# --- the trial ---------------------------------------------------------------


def test_trial_converges_matches_jax(capsys):
    """tests/test_divergence.py::test_sigma_auto_trial_converges: the
    K*gamma/2 trial certifies, no restart; and it equals the fixed
    sigma' = K/2 run bit for bit (tests/test_sigma_anneal.py:249)."""
    ds_j, ds, n = coherent()
    kw = dict(num_rounds=400, local_iters=16, lam=LAM, debug_iter=4,
              plus=True, quiet=False, math="fast", gap_target=1e-3,
              rng="jax")
    (_, _, traj_j), (w_t, a_t, traj) = _both(
        ds_j, ds, n, sigma="auto", sigma_schedule="trial", **kw)
    assert "restarting with the safe" not in capsys.readouterr().out
    assert traj.stopped == "target"
    assert_same_run(traj, traj_j)
    w_f, a_f, _ = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=400, local_iters=16, lam=LAM,
                   sigma=K / 2.0), DebugParams(debug_iter=4, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax")
    assert torch.equal(w_t, w_f) and torch.equal(a_t, a_f)


def test_trial_fallback_matches_jax(monkeypatch, capsys):
    """tests/test_divergence.py::test_sigma_auto_fallback_on_divergence
    without checkpoints: the trial's divergence is injected in both
    packages; each restarts from scratch at the safe sigma' = K*gamma
    with JAX's line, and the safe runs agree."""
    ds_j, ds, n = coherent()
    trial = K / 2.0
    calls = {"jax": [], "port": []}

    def spy(tag, real, traj_cls, rec_cls):
        def run(ds_, params_, debug_, name_, alg, **kw):
            calls[tag].append(alg[2])
            if alg[2] == trial:
                t = traj_cls(name_, quiet=True)
                t.records.append(rec_cls(round=392, wall_time=None, gap=5.0))
                t.stopped = "diverged"
                return None, None, t
            return real(ds_, params_, debug_, name_, alg, **kw)
        return run

    monkeypatch.setattr(jax_cocoa, "run_sdca_family",
                        spy("jax", jax_cocoa.run_sdca_family, JaxTrajectory,
                            JaxRecord))
    monkeypatch.setattr(port_cocoa, "run_sdca_family",
                        spy("port", port_cocoa.run_sdca_family, Trajectory,
                            RoundRecord))
    (_, _, traj_j), (_, _, traj) = _both(
        ds_j, ds, n, num_rounds=400, local_iters=16, lam=LAM, sigma="auto",
        debug_iter=4, plus=True, quiet=False, math="fast", gap_target=1e-3,
        rng="jax", sigma_schedule="trial")
    assert calls["port"] == calls["jax"] == [trial, float(K)]
    # each package prints the line, then its safe run
    line = ("sigma=auto: σ′=K·γ/2=2 diverged; restarting with the safe "
            "σ′=K·γ=4\n")
    blank, ref, out = capsys.readouterr().out.split(line)
    assert blank == "" and ref.startswith("\nRunning CoCoA+")
    assert traj.stopped == "target"
    assert_same_run(traj, traj_j)
    assert_same_console(ref, out)


# --- the warm start ------------------------------------------------------


@pytest.mark.parametrize("sigma,target", [(None, None), ("auto", 1e-6)])
def test_warm_start_matches_jax(sigma, target):
    """tests/test_sigma_anneal.py:268 and :291: smooth_hinge(0.5) for the
    first 30 rounds, then hinge; alone and with the anneal."""
    ds_j, ds, n = _benign()
    (_, _, traj_j), (_, _, traj) = _both(
        ds_j, ds, n, num_rounds=100, local_iters=16, lam=1e-2, sigma=sigma,
        debug_iter=10, plus=True, quiet=True, math="fast", rng="permuted",
        warm_start=(0.5, 30), gap_target=target)
    assert_same_run(traj, traj_j)
    if sigma == "auto":
        assert traj.records[-1].sigma == 2.0


def test_warm_start_rounds_up_to_cadence(capsys):
    """--warmStart's rounds go up to the debugIter cadence with JAX's line,
    and the run equals the one asked at the cadence bit for bit."""
    ds_j, ds, n = _benign()
    kw = dict(num_rounds=50, local_iters=16, lam=1e-2, debug_iter=10,
              plus=True, math="fast", rng="permuted")
    (_, _, traj_j), (w_a, a_a, traj) = _both(ds_j, ds, n, quiet=False,
                                             warm_start=(0.5, 23), **kw)
    ref, out = capsys.readouterr().out.split("\nRunning CoCoA+")[:2]
    line = ("warmStart: handoff rounded up to round 30 (the debugIter=10 "
            "cadence the device loop chunks on)")
    assert ref.splitlines() == [line]
    assert out.splitlines()[-1] == line
    assert_same_run(traj, traj_j)
    w_b, a_b, _ = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=50, local_iters=16, lam=1e-2),
        DebugParams(debug_iter=10, seed=0), plus=True, math="fast",
        rng="permuted", quiet=True, warm_start=(0.5, 30))
    assert torch.equal(w_a, w_b) and torch.equal(a_a, a_b)


# --- validations -----------------------------------------------------------


VALIDATIONS = {
    "auto without a target": dict(sigma="auto"),
    "auto with the guard off": dict(sigma="auto", gap_target=1e-3,
                                    divergence_guard="off"),
    "trial without auto": dict(sigma=2.0, sigma_schedule="trial"),
    "an unknown schedule": dict(sigma="auto", sigma_schedule="nope"),
    "trial without a target": dict(sigma="auto", sigma_schedule="trial"),
    "trial with the guard off": dict(sigma="auto", sigma_schedule="trial",
                                     gap_target=1e-3,
                                     divergence_guard="off"),
    "anneal from 1 without a target": dict(sigma=1.0,
                                           sigma_schedule="anneal"),
    "warm start on logistic": dict(loss="logistic", warm_start=(0.5, 30)),
    "warm start smoothing 0": dict(warm_start=(0.0, 30)),
    "warm start 0 rounds": dict(warm_start=(0.5, 0)),
    "warm start without evals": dict(warm_start=(0.5, 30), debug_iter=0),
    "a bad guard flag": dict(gap_target=1e-3, divergence_guard="maybe"),
}


@pytest.mark.parametrize("name", list(VALIDATIONS))
def test_validations_match_jax(name):
    """tests/test_sigma_anneal.py:228 and :303, tests/test_divergence.py:
    176: each misuse raises ValueError with JAX's message."""
    ds_j, ds, n = coherent()
    kw = {**dict(num_rounds=10, local_iters=4, lam=LAM, debug_iter=2,
                 plus=True, quiet=True), **VALIDATIONS[name]}
    with pytest.raises(ValueError) as ref:
        _both(ds_j, ds, n, **dict(kw))
    with pytest.raises(ValueError) as mine:
        kw.pop("plus")
        fields = {f: kw.pop(f) for f in ("num_rounds", "local_iters", "lam",
                                         "sigma", "loss") if f in kw}
        port_cocoa.run_cocoa(ds, Params(n=n, **fields),
                             DebugParams(debug_iter=kw.pop("debug_iter"),
                                         seed=0), plus=True, **kw)
    assert str(mine.value) == str(ref.value)


def test_sigma_auto_plain_cocoa_is_default():
    """tests/test_divergence.py::test_sigma_auto_validation: plain CoCoA
    ignores sigma', so auto runs the default, bit for bit."""
    ds_j, ds, n = coherent()
    kw = dict(n=n, num_rounds=10, local_iters=4, lam=LAM)
    debug = DebugParams(debug_iter=2, seed=0)
    w_auto, _, _ = port_cocoa.run_cocoa(ds, Params(sigma="auto", **kw),
                                        debug, plus=False, quiet=True)
    w_none, _, _ = port_cocoa.run_cocoa(ds, Params(**kw), debug, plus=False,
                                        quiet=True)
    assert torch.equal(w_auto, w_none)


# --- the CLI -----------------------------------------------------------------


def test_cli_sigma_auto_demo_matches_jax(capsys):
    """The acceptance command: --sigma=auto --gapTarget=1e-4 on the demo
    in float64 within 500 rounds, both CLIs, the flag echo excepted."""
    argv = DEMO + ["--numRounds=500", "--sigma=auto", "--gapTarget=1e-4"]
    (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
    assert rc_j == rc == 0
    assert_same_console(ref, out)


CLI_MISUSE = [
    ["--sigma=auto"],
    ["--sigmaSchedule=fast", "--gapTarget=1e-3"],
    ["--sigmaSchedule=trial", "--gapTarget=1e-3"],
    ["--sigmaSchedule=anneal", "--sigma=1"],
    ["--accel=fast", "--gapTarget=1e-3"],
    ["--theta=warp", "--gapTarget=1e-3"],
    ["--accel=on"],
    ["--accel=on", "--sigma=auto", "--sigmaSchedule=trial",
     "--gapTarget=1e-3"],
    ["--theta=adaptive", "--accel=off", "--gapTarget=1e-3"],
    ["--theta=adaptive"],
    ["--warmStart=0.5"],
    ["--warmStart=x,30"],
    ["--warmStart=0,30"],
    ["--warmStart=0.5,30", "--loss=logistic"],
    ["--warmStart=0.5,30", "--debugIter=0"],
    ["--divergenceGuard=maybe", "--gapTarget=1e-3"],
    ["--divergenceGuard=off", "--sigma=auto", "--gapTarget=1e-3"],
    ["--divergenceGuard=off", "--sigma=1", "--sigmaSchedule=anneal",
     "--gapTarget=1e-3"],
]


@pytest.mark.parametrize("extra", CLI_MISUSE, ids=" ".join)
def test_cli_misuse_matches_jax(extra, capsys):
    """Each misuse of the ladder's flags exits 2 with the JAX CLI's
    message, before any data is read."""
    argv = DEMO + ["--numRounds=20"] + extra
    (rc_j, _, err_j), (rc, out, err) = both_clis(argv, capsys)
    assert rc_j == rc == 2
    assert err.startswith("error: ") and err.strip() == err_j.strip()
    assert "Running" not in out
