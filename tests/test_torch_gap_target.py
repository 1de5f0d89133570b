"""The port's gap-targeted driver against the JAX package, float64 on the
CPU: the divergence guard's stall watch and its resolution, the early stop
at a gap target and its ``stopped`` reason, the coherent-shard bail-out,
ProxCoCoA+ and mini-batch CD with a target or a guard, the bfloat16
refusals, ``--quiet`` and ``--trajOut``, and the demo through both CLIs
with ``--gapTarget=1e-4`` (accel auto: on for CoCoA+).

Tolerances: the host twins agree exactly; a run's stop reason and every
eval's round are equal; its primal objectives and test errors agree to
relative 1e-12, and its gaps to 1e-12 of the eval's primal objective (the
gap is the primal less the dual, two sums of the primal's size, summed
in other orders by XLA and by torch).

A run that diverges (sigma' below what the data tolerate) oscillates, and
the oscillation multiplies the packages' rounding differences by about 10
every 25 rounds, from 1e-15 at round 25 to O(1) by round 400 on the
coherent shards.  Its numbers are held only over the evals before round
125; its verdict and rounds are held on data seed 7, whose bail-out round
(425) stayed put in 12 of 12 runs with X perturbed by 3e-7 in float32 and
float64, where the seed-0 shards of tests/test_divergence.py bail out at
rounds that move with the rounding (JAX 750, the port 825)."""

import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from conftest import DEMO_NUM_FEATURES, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.columns import shard_columns as jax_columns  # noqa: E402
from cocoa_tpu.data.libsvm import LibsvmData as JaxLibsvm  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers import base as jax_base  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_tpu.solvers.minibatch_cd import \
    run_minibatch_cd as jax_run_minibatch  # noqa: E402
from cocoa_tpu.solvers.prox_cocoa import \
    run_prox_cocoa as jax_run_prox  # noqa: E402
from cocoa_torch import cli, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import shard_dataset  # noqa: E402
from cocoa_torch.data.columns import shard_columns  # noqa: E402
from cocoa_torch.data.libsvm import LibsvmData  # noqa: E402
from cocoa_torch.solvers import base, run_cocoa  # noqa: E402
from cocoa_torch.solvers.minibatch_cd import run_minibatch_cd  # noqa: E402
from cocoa_torch.solvers.prox_cocoa import run_prox_cocoa  # noqa: E402

RTOL = 1e-12
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
        "--numSplits=4", "--localIterFrac=0.1", "--lambda=.001",
        "--dtype=float64"]
_NUMBER = re.compile(r"^(\s*[A-Za-z -]+: )(-?[0-9][^ ]*)$")
# the flag echo: each RunConfig field, one a line (the two packages'
# fields differ)
_ECHO = re.compile(r"^[a-z_0-9]+: ")


# --- shared with test_torch_sigma_schedule.py and test_torch_accel.py -----


def port_ds(ds_j):
    """The port's dataset from the JAX package's shards (float64)."""
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    return interop.dataset_from_numpy(arrays, ds_j.layout, ds_j.n,
                                      ds_j.num_features, device="cpu")


# the coherent shards' data seed whose divergence verdicts do not move
# with rounding (module docstring), and the last round whose evals a
# diverging run holds to the tolerances
ROBUST_SEED = 7
CHAOS_FROM = 125


def coherent(k=4, m=32, d=16, seed=0):
    """tests/test_divergence.py's K identical shards (the same m rows
    repeated K times, so the true coupling is sigma' = K) in float64:
    (JAX dataset, port dataset, n)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, d))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.where(X @ rng.standard_normal(d) >= 0, 1.0, -1.0)
    n = k * m
    data = JaxLibsvm(labels=np.tile(y, k),
                     indptr=np.arange(0, (n + 1) * d, d, dtype=np.int64),
                     indices=np.tile(np.arange(d, dtype=np.int32), n),
                     values=np.tile(X, (k, 1)).reshape(-1), num_features=d)
    ds_j = jax_shard(data, k=k, layout="dense", dtype=jnp.float64)
    return ds_j, port_ds(ds_j), n


def assert_same_run(traj, traj_j, upto=None):
    """The same stop reason, eval rounds and sigma' per record; primal and
    test error to relative 1e-12, the gap to 1e-12 of the primal (at the
    evals before round ``upto``, when given)."""
    assert traj.stopped == traj_j.stopped
    assert [r.round for r in traj.records] == \
        [r.round for r in traj_j.records]
    assert [r.sigma for r in traj.records] == \
        [r.sigma for r in traj_j.records]
    for a, b in zip(traj.records, traj_j.records):
        if upto is not None and a.round >= upto:
            break
        np.testing.assert_allclose(a.primal, b.primal, rtol=RTOL)
        if b.test_error is not None:
            np.testing.assert_allclose(a.test_error, b.test_error,
                                       rtol=RTOL)
        if b.gap is None:
            assert a.gap is None
        else:
            assert abs(a.gap - b.gap) <= RTOL * abs(b.primal), \
                (a.round, a.gap, b.gap)


def both_clis(argv, capsys):
    """(rc, stdout, stderr) of the JAX CLI and of the port's, one command."""
    out = []
    for main, extra in ((jax_cli.main, ["--mesh=1"]),
                        (cli.main, ["--device=cpu"])):
        rc = main(argv + extra)
        o, e = capsys.readouterr()
        out.append((rc, o, e))
    return out


def assert_same_console(ref, out):
    """Line by line, the flag echo left out: equal text, and each number
    as :func:`assert_same_run` holds it (a gap against the primal printed
    before it)."""
    a = [ln for ln in ref.splitlines() if not _ECHO.match(ln)
         or ln.startswith(("primal", "test error"))]
    b = [ln for ln in out.splitlines() if not _ECHO.match(ln)
         or ln.startswith(("primal", "test error"))]
    assert len(a) == len(b)
    primal = None
    for x, y in zip(a, b):
        mx, my = _NUMBER.match(x), _NUMBER.match(y)
        if mx is None or x.startswith("Iteration"):
            assert x == y
            continue
        assert my is not None and mx.group(1) == my.group(1), (x, y)
        fx, fy = float(mx.group(2)), float(my.group(2))
        if "gap" in x or "Gap" in x:
            assert abs(fx - fy) <= RTOL * abs(primal), (x, y)
        else:
            np.testing.assert_allclose(fy, fx, rtol=RTOL)
            if "bjective" in x:
                primal = fx


# --- the stall watch and the guard --------------------------------------


def _gap_sequence(seed):
    """Gaps that fall, stall, oscillate and skip evals (None)."""
    rng = np.random.default_rng(seed)
    g, out = 1.0, []
    for _ in range(80):
        g *= float(rng.choice([0.6, 0.95, 1.0, 1.4, 3.0]))
        out.append(None if rng.random() < 0.1 else g)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_evals,rel", [(3, 0.75), (12, 0.75), (2, 0.5)])
def test_gap_watch_matches_jax(seed, n_evals, rel):
    mine, ref = base._GapWatch(n_evals, rel), jax_base._GapWatch(n_evals, rel)
    for g in _gap_sequence(seed):
        assert mine.update(g) == ref.update(g)
        assert (mine.best, mine.best_prev, mine.stall) == \
            (ref.best, ref.best_prev, ref.stall)


@pytest.mark.parametrize("debug_iter", [-1, 0, 1, 4, 10, 25, 26, 299, 1000])
def test_stall_window_matches_jax(debug_iter):
    assert base.stall_window(debug_iter) == jax_base.stall_window(debug_iter)
    assert (base.STALL_EVALS, base.STALL_ROUNDS, base.STALL_REL) == \
        (jax_base.STALL_EVALS, jax_base.STALL_ROUNDS, jax_base.STALL_REL)


@pytest.mark.parametrize("flag", ["auto", "on", "off"])
@pytest.mark.parametrize("mode", ["plus", "cocoa", "frozen", "prox"])
@pytest.mark.parametrize("sigma", [1.0, 3.999, 4.0, 8.0])
def test_resolve_divergence_guard_matches_jax(flag, mode, sigma):
    assert base.resolve_divergence_guard(flag, mode, sigma, 4, 1.0) == \
        jax_base.resolve_divergence_guard(flag, mode, sigma, 4, 1.0)


def test_resolve_divergence_guard_refuses_as_jax():
    with pytest.raises(ValueError) as mine:
        base.resolve_divergence_guard("maybe", "plus", 1.0, 4, 1.0)
    with pytest.raises(ValueError) as ref:
        jax_base.resolve_divergence_guard("maybe", "plus", 1.0, 4, 1.0)
    assert str(mine.value) == str(ref.value)


# --- the early stop and the bail-out -----------------------------------------


@pytest.mark.parametrize("math", ["exact", "fast"])
@pytest.mark.parametrize("plus", [True, False])
def test_early_stop_matches_jax(tiny_data, math, plus):
    """tests/test_solvers.py::test_gap_target_early_stop: K=2 dense shards,
    H=50, a 1e-3 target within 200 rounds, and the same stop here."""
    ds_j = jax_shard(tiny_data, k=2, layout="dense", dtype=jnp.float64)
    kw = dict(n=tiny_data.n, num_rounds=200, local_iters=50, lam=0.01)
    _, _, traj_j = jax_run_cocoa(ds_j, JaxParams(**kw),
                                 JaxDebug(debug_iter=5, seed=0), plus=plus,
                                 quiet=True, gap_target=1e-3, math=math)
    w, alpha, traj = run_cocoa(port_ds(ds_j), Params(**kw),
                               DebugParams(debug_iter=5, seed=0), plus=plus,
                               quiet=True, gap_target=1e-3, math=math)
    assert traj_j.stopped == "target" and traj_j.records[-1].round < 200
    assert traj.records[-1].gap <= 1e-3
    assert_same_run(traj, traj_j)


def test_no_target_runs_the_full_budget(tiny_data):
    ds_j = jax_shard(tiny_data, k=2, layout="dense", dtype=jnp.float64)
    _, _, traj = run_cocoa(port_ds(ds_j), Params(n=tiny_data.n, num_rounds=30,
                                                 local_iters=50, lam=0.01),
                           DebugParams(debug_iter=5, seed=0), plus=True,
                           quiet=True)
    assert traj.stopped is None and traj.records[-1].round == 30


def _bail(seed, quiet=True):
    """tests/test_divergence.py::_bail_run on the float64 coherent shards of
    data seed ``seed``: sigma' = 1 = K/4, cadence 25, 1600 rounds; the
    guard (auto) is armed below K*gamma.  (JAX's, the port's) trajectory."""
    ds_j, ds, n = coherent(seed=seed)
    kw = dict(n=n, num_rounds=1600, local_iters=16, lam=1e-4, sigma=1.0)
    run = dict(plus=True, quiet=quiet, math="fast", gap_target=1e-3,
               rng="jax")
    _, _, traj_j = jax_run_cocoa(ds_j, JaxParams(**kw),
                                 JaxDebug(debug_iter=25, seed=0), **run)
    _, _, traj = run_cocoa(ds, Params(**kw), DebugParams(debug_iter=25,
                                                         seed=0), **run)
    return traj_j, traj


def test_coherent_shard_bailout_matches_jax(capsys):
    """The bail-out at JAX's round (425) with JAX's DIVERGED line; the
    console otherwise equal up to the oscillation's growth."""
    traj_j, traj = _bail(ROBUST_SEED, quiet=False)
    ref, out = capsys.readouterr().out.split("\nRunning")[1:]
    assert traj_j.stopped == traj.stopped == "diverged"
    assert traj_j.records[-1].round == traj.records[-1].round == 425
    assert_same_run(traj, traj_j, upto=CHAOS_FROM)
    line = [ln for ln in ref.splitlines() if "DIVERGED" in ln]
    assert line == [ln for ln in out.splitlines() if "DIVERGED" in ln]
    assert line == ["CoCoA+: DIVERGED — best duality gap made no material "
                    "progress over 12 consecutive evaluations; stopped at "
                    "round 425 (σ′ set below the safe K·γ bound? see "
                    "--sigma)"]


def test_coherent_shard_bailout_seed0():
    """tests/test_divergence.py's own shards: both bail out, and agree
    until the oscillation has grown the rounding (module docstring)."""
    traj_j, traj = _bail(0)
    assert traj_j.stopped == traj.stopped == "diverged"
    assert max(traj_j.records[-1].round, traj.records[-1].round) < 1600
    for a, b in zip(traj.records, traj_j.records):
        if a.round >= CHAOS_FROM:
            break
        np.testing.assert_allclose(a.primal, b.primal, rtol=RTOL)
        assert abs(a.gap - b.gap) <= RTOL * abs(b.primal)


def test_guard_off_runs_to_the_budget():
    """The same config with the guard off never bails out."""
    ds_j, ds, n = coherent()
    _, _, traj = run_cocoa(ds, Params(n=n, num_rounds=200, local_iters=16,
                                      lam=1e-4, sigma=1.0),
                           DebugParams(debug_iter=25, seed=0), plus=True,
                           quiet=True, math="fast", gap_target=1e-9,
                           rng="jax", divergence_guard="off")
    assert traj.stopped is None and traj.records[-1].round == 200


def _lasso(seed=2, n=48, d=26):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, d)) / np.sqrt(n)
    x_true = np.zeros(d)
    x_true[rng.choice(d, 5, replace=False)] = 3 * rng.normal(size=5)
    b = A @ x_true + 0.01 * rng.normal(size=n)
    rows, cols = np.nonzero(A)
    fields = dict(labels=b, indptr=np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int64),
        indices=cols.astype(np.int32), values=A[rows, cols], num_features=d)
    return A, b, JaxLibsvm(**fields), LibsvmData(**fields)


@pytest.mark.parametrize("guard", ["auto", "on"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_prox_cocoa_gap_target_matches_jax(layout, guard):
    """ProxCoCoA+ to an absolute gap target, as in JAX."""
    A, b, data_j, data_t = _lasso()
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    kw = dict(n=A.shape[1], num_rounds=400, local_iters=8, lam=lam,
              loss="lasso", smoothing=0.0)
    target = 1e-6 * 0.5 * float(b @ b)
    ds_j, b_j = jax_columns(data_j, 4, dtype=jnp.float64, layout=layout)
    _, _, traj_j = jax_run_prox(ds_j, b_j, JaxParams(**kw),
                                JaxDebug(debug_iter=4, seed=3), quiet=True,
                                gap_target=target, divergence_guard=guard)
    ds, b_t = shard_columns(data_t, 4, dtype=torch.float64, device="cpu",
                            layout=layout)
    _, _, traj = run_prox_cocoa(ds, b_t, Params(**kw),
                                DebugParams(debug_iter=4, seed=3),
                                quiet=True, gap_target=target,
                                divergence_guard=guard)
    assert traj_j.stopped == "target" and traj_j.records[-1].round < 400
    assert_same_run(traj, traj_j)


@pytest.mark.parametrize("guard", ["auto", "on"])
@pytest.mark.parametrize("math", ["exact", "fast"])
def test_minibatch_cd_gap_target_matches_jax(tiny_data, math, guard):
    """Mini-batch CD to a gap target, the guard forced on or left to auto
    (which never arms: the frozen subproblem reads no sigma')."""
    ds_j = jax_shard(tiny_data, k=4, layout="sparse", dtype=jnp.float64)
    kw = dict(n=tiny_data.n, num_rounds=300, local_iters=20, lam=0.01)
    _, _, traj_j = jax_run_minibatch(ds_j, JaxParams(**kw),
                                     JaxDebug(debug_iter=10, seed=0),
                                     quiet=True, gap_target=0.15, math=math,
                                     divergence_guard=guard)
    _, _, traj = run_minibatch_cd(port_ds(ds_j), Params(**kw),
                                  DebugParams(debug_iter=10, seed=0),
                                  quiet=True, gap_target=0.15, math=math,
                                  divergence_guard=guard)
    assert traj_j.stopped == "target" and traj_j.records[-1].round < 300
    assert_same_run(traj, traj_j)


# --- bfloat16 ---------------------------------------------------------------


def test_bf16_gap_target_refused(tiny_data):
    """tests/test_bf16.py::test_bf16_gap_target_rejected: the library
    refuses a gap target in bfloat16 with JAX's message."""
    ds_j = jax_shard(tiny_data, k=4, layout="dense", dtype=jnp.bfloat16)
    ds = shard_dataset(LibsvmData(
        labels=tiny_data.labels, indptr=tiny_data.indptr,
        indices=tiny_data.indices, values=tiny_data.values,
        num_features=tiny_data.num_features), 4, layout="dense",
        dtype=torch.bfloat16, device="cpu")
    kw = dict(n=tiny_data.n, num_rounds=10, local_iters=8, lam=1e-2)
    with pytest.raises(ValueError, match="bfloat16") as ref:
        jax_run_cocoa(ds_j, JaxParams(**kw), JaxDebug(debug_iter=5, seed=0),
                      plus=True, quiet=True, math="fast", gap_target=1e-4)
    with pytest.raises(ValueError, match="bfloat16") as mine:
        run_cocoa(ds, Params(**kw), DebugParams(debug_iter=5, seed=0),
                  plus=True, quiet=True, math="fast", gap_target=1e-4)
    assert str(mine.value) == str(ref.value)


def _write_tiny_libsvm(path):
    rows = ["+1 1:0.5 3:1.0", "-1 2:0.25 4:0.5", "+1 1:0.75",
            "-1 3:0.5 4:0.25"] * 8
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("extra", [[], ["--objective=lasso"]])
def test_cli_refuses_bf16_gap_target(tmp_path, capsys, extra):
    """tests/test_bf16.py::test_cli_rejects_bf16_gap_target, both CLIs."""
    train = tmp_path / "tiny.dat"
    _write_tiny_libsvm(train)
    argv = [f"--trainFile={train}", "--numFeatures=4", "--numSplits=2",
            "--numRounds=4", "--localIterFrac=0.5", "--lambda=.01",
            "--debugIter=2", "--dtype=bfloat16", "--gapTarget=1e-4"] + extra
    (rc_j, _, err_j), (rc, out, err) = both_clis(argv, capsys)
    assert rc_j == rc == 2
    assert err.strip() == err_j.strip()
    assert "bfloat16" in err and "Running" not in out


# --- the CLI -----------------------------------------------------------------


def test_cli_quiet_prints_nothing(capsys):
    argv = DEMO + ["--numRounds=20", "--gapTarget=1e-4", "--quiet",
                   "--justCoCoA=false"]
    (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
    assert rc_j == rc == 0
    assert out == ref == ""


def test_cli_traj_out_matches_jax(tmp_path, capsys):
    """``--trajOut=P`` writes P.<algorithm>.jsonl for each run, the JAX
    CLI's records (wall_time and the manifest header excepted), the last
    carrying ``stopped``; the lasso's file is P.ProxCoCoA+.jsonl."""
    runs = {"svm": (DEMO + ["--numRounds=100", "--gapTarget=1e-2",
                            "--justCoCoA=false", "--quiet"],
                    ("CoCoA+", "CoCoA", "Mini-batch_CD", "Mini-batch_SGD",
                     "Local_SGD", "Dist_SGD")),
            "lasso": (DEMO + ["--numRounds=40", "--objective=lasso",
                              "--lambda=.1", "--gapTarget=150", "--quiet"],
                      ("ProxCoCoA+",))}
    for label, (argv, names) in runs.items():
        files = {}
        for tag, main, extra in (("jax", jax_cli.main, ["--mesh=1"]),
                                 ("port", cli.main, ["--device=cpu"])):
            prefix = tmp_path / f"{label}_{tag}"
            assert main(argv + extra + [f"--trajOut={prefix}"]) == 0
            files[tag] = {name: (tmp_path / f"{label}_{tag}.{name}.jsonl")
                          .read_text().splitlines() for name in names}
        capsys.readouterr()
        for name in names:
            ref = [json.loads(ln) for ln in files["jax"][name]]
            mine = [json.loads(ln) for ln in files["port"][name]]
            assert mine[0]["manifest"]["algorithm"] == \
                ref[0]["manifest"]["algorithm"]
            assert mine[0]["manifest"]["records"] == len(mine) - 1
            assert "config_hash" in mine[0]["manifest"]
            assert len(mine) == len(ref)
            for a, b in zip(mine[1:], ref[1:]):
                assert set(a) == set(b), name
                assert a.pop("wall_time") >= 0
                b.pop("wall_time")
                primal = b["primal"]
                for key in ("primal", "gap", "test_error"):
                    x, y = a.pop(key), b.pop(key)
                    if y is None:
                        assert x is None
                    elif key == "gap":
                        assert abs(x - y) <= RTOL * abs(primal)
                    else:
                        np.testing.assert_allclose(x, y, rtol=RTOL)
                assert a == b
        # CoCoA+ reaches its target (round 70), and so does the lasso
        # (round 30); CoCoA does not within 100 rounds, and the targetless
        # baselines end with stopped = null too
        assert json.loads(files["port"][names[0]][-1])["stopped"] == "target"


def test_cli_gap_target_demo_matches_jax(capsys):
    """The acceptance command: the demo in float64 to a 1e-4 gap within
    500 rounds, accel auto (on for CoCoA+, with a momentum restart; off
    for CoCoA): the same lines as the JAX CLI, the flag echo excepted."""
    argv = DEMO + ["--numRounds=500", "--gapTarget=1e-4"]
    (rc_j, ref, _), (rc, out, _) = both_clis(argv, capsys)
    assert rc_j == rc == 0
    assert_same_console(ref, out)
    assert "CoCoA+: momentum restart at round 340" in out
    # CoCoA+ stops at round 370, CoCoA at 440
    assert out.count("Iteration: 370\n") == 2
    assert out.count("Iteration: 440\n") == 1 and "Iteration: 450" not in out
