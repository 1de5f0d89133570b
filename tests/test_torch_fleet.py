"""Fleet training in the port (cocoa_torch/data/fleet.py,
cocoa_torch/solvers/fleet.py) against the JAX package and against
itself, on the CPU, mirroring tests/test_fleet.py:68-360 (its two mesh
tests wait for the port's mesh, ROADMAP Queue A 6).

Within the port the pins are bit for bit: a one-tenant fleet equals the
port's solo run in the three drive modes and both lane modes, at both
maths (the solo plain round at ``--math=fast``); every ``map`` lane
equals its solo run; a certified tenant's (w, alpha) is frozen.

Against the JAX package, float64: the port's fleet equals the JAX solo
runs of its tenants to 1e-12 relative, with the same certified rounds.
The JAX fleet itself stages lambda*n, 1/n and the eval's reciprocal in
float32 at every dtype (cocoa_tpu/solvers/fleet.py:162-175), which
moves its float64 numbers ~1e-8 relative from its own solo runs; it is
held to the port at 1e-6 relative with equal certified rounds."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data import fleet as jax_fleet  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_tpu.solvers.fleet import \
    run_cocoa_fleet as jax_run_fleet  # noqa: E402
from cocoa_tpu.telemetry import events as jax_events  # noqa: E402
from cocoa_tpu.telemetry import schema as jax_schema  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data import fleet as fleet_mod  # noqa: E402
from cocoa_torch.data.fleet import TenantSpec, build_fleet, \
    fleet_from_datasets, load_fleet_manifest, synth_fleet_specs, \
    write_fleet_manifest  # noqa: E402
from cocoa_torch.solvers import base, run_cocoa, run_cocoa_fleet  # noqa: E402
from cocoa_torch.telemetry import events, schema  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
from test_torch_gap_target import ROBUST_SEED, coherent  # noqa: E402

DEBUG = DebugParams(debug_iter=10, seed=0, chkpt_iter=10**9, chkpt_dir="")
DEBUG5 = DebugParams(debug_iter=5, seed=0, chkpt_iter=10**9, chkpt_dir="")
MIXED_SPECS = [
    TenantSpec("A", "synth:dense:n=96,d=32,seed=7", lam=0.1,
               gap_target=1e-2),
    TenantSpec("B", "synth:dense:n=96,d=32,seed=8", lam=0.001,
               gap_target=1e-4),
]


def _fleet(specs, dtype=torch.float32, k=2, frac=0.25):
    return build_fleet(specs, k=k, local_iter_frac=frac, dtype=dtype,
                       device="cpu")


def _params(fleet, rounds, **kw):
    return Params(n=0, num_rounds=rounds, local_iters=fleet.local_iters,
                  gamma=1.0, loss="hinge", **kw)


def _solo(fleet, t, rounds, target, debug=DEBUG, **kw):
    ds = fleet.tenant_ds(t)
    sp = Params(n=ds.n, num_rounds=rounds, local_iters=fleet.local_iters,
                lam=float(fleet.lams[t]), gamma=1.0, loss="hinge",
                sigma=kw.pop("sigma", None))
    return run_cocoa(ds, sp, debug, plus=True, gap_target=target,
                     device_loop=True, quiet=True, **kw)


def _same_lane(res, t, w, alpha, traj):
    """Lane t of a fleet run is the solo run bit for bit: (w, alpha), and
    each eval's primal and gap up to the solo run's stop."""
    assert torch.equal(res.w[t], w)
    assert torch.equal(res.alpha[t, :, :alpha.shape[1]], alpha)
    assert not res.alpha[t, :, alpha.shape[1]:].any()
    n = len(traj.records)
    assert [r.primal for r in traj.records] == list(res.traj[:n, t, 0])
    assert [r.gap for r in traj.records] == list(res.traj[:n, t, 1])


# --- manifest and loader ----------------------------------------------------


def test_manifest_round_trip_both_packages(tmp_path):
    specs = synth_fleet_specs(3, n=64, d=16, gap_target=1e-2)
    port_path, jax_path = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    write_fleet_manifest(port_path, specs)
    jax_fleet.write_fleet_manifest(jax_path, jax_fleet.synth_fleet_specs(
        3, n=64, d=16, gap_target=1e-2))
    assert open(port_path).read() == open(jax_path).read()
    for path in (port_path, jax_path):
        assert schema.check_file(path) == []
        assert schema.check_file(path, kind="fleet") == []
        assert jax_schema.check_file(path, kind="fleet") == []
        got = load_fleet_manifest(path)
        want = jax_fleet.load_fleet_manifest(path)
        assert [vars(s) for s in got] == [vars(s) for s in want]
    assert [s.tenant for s in got] == [s.tenant for s in specs]


def _messages(fn_port, fn_jax):
    msgs = []
    for fn in (fn_port, fn_jax):
        with pytest.raises(ValueError) as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


def test_manifest_rejections_match_jax(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    row = {"tenant": "a", "dataset": "synth:dense:n=8,d=4", "lam": 0.1}
    cases = [
        ([{"fleet_manifest": {"version": 1}}, row, {**row, "lam": 0.2}],
         "duplicates"),
        ([{"tenant": "a", "lam": 0.1}], "fleet_manifest header"),
        ([{"fleet_manifest": {"version": 1}}, {**row, "gap_taget": 1e-3}],
         "unknown field 'gap_taget'"),
        ([{"fleet_manifest": {"version": 1}}], "names no tenants"),
    ]
    for lines, needle in cases:
        with open(path, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
        msg = _messages(lambda: load_fleet_manifest(path),
                        lambda: jax_fleet.load_fleet_manifest(path))
        assert needle in msg


@pytest.mark.parametrize("specs,kw,needle", [
    ([("a", "synth:dense:n=64,d=16"), ("b", "synth:dense:n=64,d=8")], {},
     "d=[8, 16]"),
    ([("a", "synth:dense:n=64,d=16"), ("b", "synth:dense:n=256,d=16")],
     dict(local_iter_frac=0.5), "H ="),
    ([("a", "synth:dense:n=3,d=16")], dict(k=4), "lower numSplits"),
    ([("a", "synth:sparse:n=3,d=16")], {}, "synth refs are"),
    ([("a", "synth:dense:n=3")], {}, "needs integer n= and d="),
    ([("a", "synth:dense:n=3,d=4,zz=1")], {}, "unknown keys"),
    ([("a", "synth:dense:n=3,d=4,q")], {}, "bad key=value"),
    ([("a", "some/file.svm")], {}, "positive num_features"),
], ids=["d", "H", "empty shard", "sparse", "no d", "unknown", "bad kv",
        "file"])
def test_build_fleet_rejections_match_jax(specs, kw, needle):
    ts = [TenantSpec(t, ref, 0.1) for t, ref in specs]
    jts = [jax_fleet.TenantSpec(t, ref, 0.1) for t, ref in specs]
    k = kw.pop("k", 2)
    msg = _messages(lambda: build_fleet(ts, k=k, device="cpu", **kw),
                    lambda: jax_fleet.build_fleet(jts, k=k, **kw))
    assert needle in msg


def test_build_fleet_rejects_mixed_loss_like_jax():
    ts = [TenantSpec("a", "synth:dense:n=64,d=16", 0.1),
          TenantSpec("b", "synth:dense:n=64,d=16", 0.1,
                     loss="smooth_hinge", smoothing=0.5)]
    jts = [jax_fleet.TenantSpec(**vars(s)) for s in ts]
    assert "one loss phase" in _messages(
        lambda: build_fleet(ts, k=2, device="cpu"),
        lambda: jax_fleet.build_fleet(jts, k=2))
    msg = _messages(
        lambda: fleet_from_datasets([], [0.1]),
        lambda: jax_fleet.fleet_from_datasets([], [0.1]))
    assert "at least one dataset" in msg


def test_build_fleet_one_parse_per_ref_and_jax_slabs(monkeypatch):
    calls = []
    real = fleet_mod.parse_dataset_ref

    def counting(ref, num_features=0):
        calls.append(ref)
        return real(ref, num_features)

    monkeypatch.setattr(fleet_mod, "parse_dataset_ref", counting)
    shared = "synth:dense:n=64,d=16,seed=3"
    other = "synth:dense:n=64,d=16,seed=4"
    specs = [TenantSpec(f"t{i}", shared, 0.01) for i in range(4)]
    specs.append(TenantSpec("t4", other, 0.02))
    fleet = _fleet(specs)
    assert calls == [shared, other]
    assert fleet.t == 5
    for t in range(1, 4):
        assert torch.equal(fleet.X[0], fleet.X[t])
        assert fleet.X[0].data_ptr() != fleet.X[t].data_ptr()
    assert not torch.equal(fleet.X[0], fleet.X[4])
    jf = jax_fleet.build_fleet(
        [jax_fleet.TenantSpec(**vars(s)) for s in specs], k=2)
    m = fleet.n_shard
    for key in ("X", "labels", "mask", "sq_norms"):
        assert np.array_equal(getattr(fleet, key).numpy(),
                              np.asarray(getattr(jf, key))[:, :, :m])
    assert np.array_equal(fleet.counts, jf.counts)
    assert np.array_equal(fleet.lams, jf.lams)


def test_build_fleet_pads_unequal_tenants():
    fleet = _fleet([
        TenantSpec("small", "synth:dense:n=48,d=16,seed=1", 0.1),
        TenantSpec("big", "synth:dense:n=96,d=16,seed=2", 0.1),
        TenantSpec("odd", "synth:dense:n=77,d=16,seed=3", 0.1)],
        frac=0.0)
    assert fleet.local_iters == 1
    assert fleet.n_shard == 48          # the fleet max, not rounded up
    assert fleet.counts.tolist() == [[24, 24], [48, 48], [39, 38]]
    assert [float(fleet.mask[t].sum()) for t in range(3)] == [48, 96, 77]
    assert not fleet.X[0, :, 24:].any() and not fleet.labels[2, 1, 38:].any()
    solo = fleet.tenant_ds(2)
    assert solo.n_shard == 39 and solo.X.is_contiguous()
    assert torch.equal(solo.X, fleet.X[2, :, :39])


# --- one tenant == the solo run, bit for bit --------------------------------

MODES = {"plain": ({}, {}),
         "anneal": (dict(sigma="auto"),
                    dict(sigma="auto", sigma_schedule="anneal")),
         "accel": ({}, dict(accel="on"))}


@pytest.mark.parametrize("lanes", ["vmap", "map"])
@pytest.mark.parametrize("math", ["exact", "fast"])
@pytest.mark.parametrize("mode", list(MODES))
def test_t1_fleet_is_the_solo_run(mode, math, lanes):
    fleet = _fleet(synth_fleet_specs(1, n=64, d=16, gap_target=3e-3,
                                     lam_lo=0.01))
    fkw, skw = MODES[mode]
    res = run_cocoa_fleet(fleet, _params(fleet, 100, **fkw), DEBUG5,
                          drive_mode=mode, math=math, lane_exec=lanes,
                          quiet=True)
    w, alpha, traj = _solo(fleet, 0, 100, 3e-3, debug=DEBUG5, math=math,
                           **skw)
    _same_lane(res, 0, w, alpha, traj)
    assert res.evals == len(traj.records)
    assert bool(res.certified[0]) == (traj.stopped == "target")
    if traj.stopped == "target":
        assert int(res.cert_round[0]) == traj.records[-1].round
    if mode == "anneal":
        assert [int(s) for s in res.traj[:, 0, 3]] == \
            [r.sigma_stage for r in traj.records]


def test_t1_fleet_certifies_and_accel_jumps():
    """The accel mode's jumps and a certification, on a one-tenant fleet
    against the solo device loop."""
    fleet = _fleet(synth_fleet_specs(1, n=96, d=32, gap_target=1e-6,
                                     lam_lo=0.05))
    res = run_cocoa_fleet(fleet, _params(fleet, 300), DEBUG5,
                          drive_mode="accel", quiet=True)
    w, alpha, traj = _solo(fleet, 0, 300, 1e-6, debug=DEBUG5, accel="on")
    _same_lane(res, 0, w, alpha, traj)
    assert traj.stopped == "target" and bool(res.certified[0])
    assert int(res.cert_round[0]) == traj.records[-1].round < 300
    assert res.evals == len(traj.records)


def test_anneal_backs_off_in_lockstep_with_solo():
    """The coherent shards at sigma' = K/4 (tests/test_fleet.py:212): the
    fleet lane backs off at the solo device loop's round and lands bit
    for bit, at --math=fast with jax draws in map lanes."""
    _, ds, n = coherent(seed=ROBUST_SEED)
    fleet = fleet_from_datasets([ds], [1e-4], gap_targets=[1e-3],
                                local_iters=16)
    debug = DebugParams(debug_iter=25, seed=0, chkpt_iter=10**9,
                        chkpt_dir="")
    params = Params(n=0, num_rounds=1600, local_iters=16, sigma=1.0)
    res = run_cocoa_fleet(fleet, params, debug, drive_mode="anneal",
                          math="fast", rng="jax", quiet=True,
                          lane_exec="map")
    sp = Params(n=n, num_rounds=1600, local_iters=16, lam=1e-4, sigma=1.0)
    w, alpha, traj = run_cocoa(ds, sp, debug, plus=True, quiet=True,
                               math="fast", device_loop=True,
                               gap_target=1e-3, rng="jax",
                               sigma_schedule="anneal")
    assert traj.stopped == "target" and bool(res.certified[0])
    assert int(res.cert_round[0]) == traj.records[-1].round == 600
    stages = res.traj[:res.evals, 0, 3]
    assert stages.max() >= 1.0
    assert list(stages) == [float(r.sigma_stage) for r in traj.records]
    _same_lane(res, 0, w, alpha, traj)


# --- against the JAX package (float64) --------------------------------------


def _jax_solo(jf, t, rounds, target, **kw):
    ds = jf.tenant_ds(t)
    sp = JaxParams(n=ds.n, num_rounds=rounds, local_iters=jf.local_iters,
                   lam=float(jf.lams[t]), gamma=1.0, loss="hinge",
                   sigma=kw.pop("sigma", None))
    return jax_run_cocoa(ds, sp, JaxDebug(debug_iter=10, seed=0,
                                          chkpt_iter=10**9, chkpt_dir=""),
                         plus=True, gap_target=target, device_loop=True,
                         quiet=True, **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("t_count,mode", [(1, "plain"), (3, "plain"),
                                          (3, "anneal"), (3, "accel")])
def test_fleet_matches_jax_float64(t_count, mode):
    specs = synth_fleet_specs(t_count, n=96, d=32, gap_target=1e-2)
    fleet = _fleet(specs, dtype=torch.float64)
    jf = jax_fleet.build_fleet(
        [jax_fleet.TenantSpec(**vars(s)) for s in specs], k=2,
        local_iter_frac=0.25, dtype=jnp.float64)
    fkw, skw = MODES[mode]
    res = run_cocoa_fleet(fleet, _params(fleet, 60, **fkw), DEBUG,
                          drive_mode=mode, quiet=True)
    jres = jax_run_fleet(jf, JaxParams(n=0, num_rounds=60,
                                       local_iters=jf.local_iters,
                                       gamma=1.0, **fkw),
                         JaxDebug(debug_iter=10, seed=0, chkpt_iter=10**9,
                                  chkpt_dir=""), drive_mode=mode,
                         quiet=True)
    m = fleet.n_shard
    assert np.array_equal(res.cert_round, jres.cert_round)
    assert np.array_equal(res.certified, jres.certified)
    assert res.evals == jres.evals
    assert _rel(res.w, jres.w) < 1e-6
    assert _rel(res.alpha, np.asarray(jres.alpha)[:, :, :m]) < 1e-6
    for t in range(t_count):
        w, alpha, traj = _jax_solo(jf, t, 60, 1e-2, **skw)
        assert _rel(res.w[t], w) < 1e-12
        assert _rel(res.alpha[t], np.asarray(alpha)[:, :m]) < 1e-12
        n = len(traj.records)
        assert _rel(res.traj[:n, t, 0], [r.primal for r in traj.records]) \
            < 1e-12
        gaps = np.array([r.gap for r in traj.records])
        assert np.abs(res.traj[:n, t, 1] - gaps).max() <= \
            1e-12 * np.abs(res.traj[:n, t, 0]).max()
        if traj.stopped == "target":
            assert int(res.cert_round[t]) == traj.records[-1].round
    assert res.certified.sum() >= t_count - 1


# --- finished-tenant masking ------------------------------------------------


def test_map_masking_frozen_and_solo_parity():
    fleet = _fleet(MIXED_SPECS)
    res = run_cocoa_fleet(fleet, _params(fleet, 150), DEBUG5,
                          quiet=True, lane_exec="map")
    assert bool(res.certified[0]) and not bool(res.certified[1])
    r_a = int(res.cert_round[0])
    assert 0 < r_a < 150
    short = run_cocoa_fleet(fleet, _params(fleet, r_a), DEBUG5,
                            quiet=True, lane_exec="map")
    assert torch.equal(res.w[0], short.w[0])
    assert torch.equal(res.alpha[0], short.alpha[0])
    j_a = r_a // 5 - 1
    assert np.all(res.traj[j_a:, 0, 1] == res.traj[j_a, 0, 1])
    w, alpha, traj = _solo(fleet, 1, 150, 1e-4, debug=DEBUG5)
    _same_lane(res, 1, w, alpha, traj)
    w, alpha, traj = _solo(fleet, 0, 150, 1e-2, debug=DEBUG5)
    assert torch.equal(res.w[0], w) and traj.records[-1].round == r_a


def test_map_lanes_of_an_unequal_fleet_are_their_solo_runs():
    specs = [TenantSpec("a", "synth:dense:n=96,d=32,seed=1", 0.05,
                        gap_target=1e-3),
             TenantSpec("b", "synth:dense:n=99,d=32,seed=2", 0.002,
                        gap_target=1e-3),
             TenantSpec("c", "synth:dense:n=97,d=32,seed=3", 0.01,
                        gap_target=1e-3)]
    fleet = _fleet(specs)
    assert fleet.counts.tolist() == [[48, 48], [50, 49], [49, 48]]
    for math in ("exact", "fast"):
        res = run_cocoa_fleet(fleet, _params(fleet, 60), DEBUG, math=math,
                              quiet=True, lane_exec="map")
        for t in range(3):
            w, alpha, traj = _solo(fleet, t, 60, 1e-3, math=math)
            _same_lane(res, t, w, alpha, traj)


def test_vmap_masking_certifies_freezes_and_stays_close():
    fleet = _fleet(MIXED_SPECS)
    res = run_cocoa_fleet(fleet, _params(fleet, 150), DEBUG5, quiet=True)
    assert bool(res.certified[0])
    r_a = int(res.cert_round[0])
    short = run_cocoa_fleet(fleet, _params(fleet, r_a), DEBUG5, quiet=True)
    assert torch.equal(res.w[0], short.w[0])
    assert torch.equal(res.alpha[0], short.alpha[0])
    w, _, traj = _solo(fleet, 1, 150, 1e-4, debug=DEBUG5)
    np.testing.assert_allclose(res.w[1].numpy(), w.numpy(), rtol=1e-4,
                               atol=1e-6)
    sp = np.array([r.primal for r in traj.records], np.float32)
    tol = 4 * np.spacing(np.maximum(np.abs(sp), np.float32(1.0)))
    assert np.all(np.abs(res.traj[:len(sp), 1, 1]
                         - [r.gap for r in traj.records]) <= tol)


def test_one_runner_a_run_and_no_capture_on_the_cpu(monkeypatch):
    """The port's counterpart of the one-compile pin: one loop (one
    captured graph on the card, keyed by drive mode and chunk length) a
    run, and none on the CPU, where the steps run eagerly, each read
    once; the run stops at the step that certifies the last tenant."""
    built = []

    class Counting(base.FleetRunner):
        def __init__(self, *a, **kw):
            built.append(a[-1])
            super().__init__(*a, **kw)

    monkeypatch.setattr(base, "FleetRunner", Counting)
    fleet = _fleet(synth_fleet_specs(4, n=64, d=16, gap_target=1e-2,
                                     lam_lo=1e-2))
    res = run_cocoa_fleet(fleet, _params(fleet, 100), DEBUG, quiet=True)
    assert built == [("plain", 10)]
    assert res.graphs == {} and res.dead == 0 and res.replay_ms is None
    assert res.certified.all() and res.rounds_run == res.cert_round.max()
    assert res.rounds_run < 100


@pytest.mark.parametrize("kw,needle", [
    (dict(drive_mode="turbo"), "drive mode must be one of"),
    (dict(lane_exec="pmap"), "vmap|map"),
    (dict(math="approx"), "fleet math"),
    (dict(rounds=55), "multiple of debugIter"),
    (dict(local_iters=3), "disagrees with the fleet's common H"),
    (dict(drive_mode="anneal", targets=False), "needs a gap target"),
    (dict(drive_mode="accel", targets=False), "needs a gap target"),
])
def test_run_rejections_match_jax(kw, needle):
    specs = synth_fleet_specs(2, n=64, d=16, gap_target=1e-2)
    if not kw.pop("targets", True):
        specs[1].gap_target = None
    fleet = _fleet(specs)
    jf = jax_fleet.build_fleet(
        [jax_fleet.TenantSpec(**vars(s)) for s in specs], k=2,
        local_iter_frac=0.25)
    rounds = kw.pop("rounds", 50)
    h = kw.pop("local_iters", fleet.local_iters)
    msg = _messages(
        lambda: run_cocoa_fleet(fleet, Params(n=0, num_rounds=rounds,
                                              local_iters=h), DEBUG,
                                quiet=True, **kw),
        lambda: jax_run_fleet(jf, JaxParams(n=0, num_rounds=rounds,
                                            local_iters=h),
                              JaxDebug(debug_iter=10, seed=0), quiet=True,
                              **kw))
    assert needle in msg


# --- telemetry --------------------------------------------------------------

UNTIMED = {"seq", "ts", "start_ts", "dur_s", "elapsed_s", "pid",
           "models_per_second"}


def _stream(path):
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    return [r for r in recs if r["event"] not in ("host_transfer",
                                                  "compile")]


def test_fleet_events_schema_valid_and_match_jax(tmp_path):
    specs = synth_fleet_specs(3, n=64, d=16, gap_target=1e-2)
    fleet = _fleet(specs, dtype=torch.float64)
    jf = jax_fleet.build_fleet(
        [jax_fleet.TenantSpec(**vars(s)) for s in specs], k=2,
        local_iter_frac=0.25, dtype=jnp.float64)
    paths = {}
    for tag, bus_mod, run in (
            ("port", events, lambda: run_cocoa_fleet(
                fleet, _params(fleet, 60), DEBUG, quiet=True)),
            ("jax", jax_events, lambda: jax_run_fleet(
                jf, JaxParams(n=0, num_rounds=60,
                              local_iters=jf.local_iters),
                JaxDebug(debug_iter=10, seed=0, chkpt_iter=10**9,
                         chkpt_dir=""), quiet=True))):
        bus = bus_mod.get_bus()
        paths[tag] = str(tmp_path / f"{tag}.jsonl")
        metrics = str(tmp_path / f"{tag}.prom")
        bus.configure(jsonl_path=paths[tag])
        writer = None
        if tag == "port":
            writer = bus.subscribe(MetricsWriter(metrics))
        try:
            res = run()
        finally:
            if writer is not None:
                bus.unsubscribe(writer)
            bus.reset()
        if tag == "port":
            port_res = res
    assert schema.check_file(paths["port"]) == []
    assert jax_schema.check_file(paths["port"]) == []
    recs = [json.loads(ln) for ln in open(paths["port"])]
    fetches = [r["label"] for r in recs if r["event"] == "host_transfer"]
    assert fetches == ["fleet_loop_fetch", "fleet_result_fetch"]
    port, ref = _stream(paths["port"]), _stream(paths["jax"])
    assert [r["event"] for r in port] == [r["event"] for r in ref]
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for key in set(a) - UNTIMED:
            if key == "gap":
                # the JAX fleet's float32 staging (module docstring)
                assert abs(a[key] - b[key]) <= 1e-7
            else:
                assert a[key] == b[key], (a["event"], key)
    prog = [r for r in port if r["event"] == "fleet_progress"]
    cert = [r for r in port if r["event"] == "tenant_certified"]
    assert len(prog) == port_res.evals
    assert len(cert) == int(port_res.certified.sum()) > 0
    assert prog[-1]["models_per_second"] == pytest.approx(
        port_res.models_per_second)
    assert all(p["models_per_second"] is None for p in prog[:-1])
    text = open(tmp_path / "port.prom").read()
    assert "cocoa_fleet_tenants_active" in text
    assert "cocoa_tenants_certified_total " + str(len(cert)) in text
    assert "cocoa_fleet_models_per_second" in text
