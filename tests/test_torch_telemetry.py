"""The port's telemetry (cocoa_torch/telemetry/) against the JAX package's,
float64 on the CPU, mirroring the CPU-side cases of tests/test_telemetry.py.

- **The event streams.**  The demo through both CLIs with ``--events
  --metrics --trace``, on the chunked loop and with ``--deviceLoop``
  (flag sets ``--gapTarget``, ``--sigma=1 --sigmaSchedule=anneal`` and
  ``--accel=on``; tests/test_torch_tracing.py holds the rest): the same
  sequence of event names, every typed field equal.  The port's device
  loop decodes each super-block's fetched rows through a ``DeviceTap``,
  the JAX package's fetch-fallback bridge, so the JAX device loop runs
  with that bridge here.  Left out of the comparison: ``seq``, ``ts``,
  ``start_ts``, ``dur_s``, ``elapsed_s`` and ``pid``; the manifest's
  environment keys and ``config_hash``; the config's keys that only one
  package has (``mesh``, ``device``, ...); the ingest record's parse
  seconds and peak RSS.  Numbers: relative 1e-12, the gap to 1e-12 of
  the primal beside it (tests/test_torch_gap_target.py); a diverging
  run's numbers only before round 125 (the rounding grows ~10x every 25
  rounds there), its names, rounds, stages and stall counters all the
  way.
- **No side effects.**  Telemetry on against off: w and alpha
  bit for bit (``torch.equal``), the sched vector in the checkpoints
  equal, ``Trajectory.fetches`` equal, on both loops (through the CLI in
  tests/test_torch_tracing.py).
- **Schema.**  Both packages' checkers accept both packages' streams and
  flight-recorder dumps, and reject the same malformed files.
- **Metrics.**  ``MetricsWriter.render`` gives the JAX writer's text from
  the same event records.
- The satellites of tests/test_telemetry.py on the port: the trajectory
  dump's manifest, ``--quiet`` divergence, ``checkpoint_write``, the
  trial's ``restart``, the textfile, ``layout_split``, the inert bus,
  and the CLI putting the bus and the process's hooks back.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from conftest import DEMO_NUM_FEATURES, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.solvers import cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.telemetry import events as jax_events  # noqa: E402
from cocoa_tpu.telemetry import recorder as jax_recorder  # noqa: E402
from cocoa_tpu.telemetry import schema as jax_schema  # noqa: E402
from cocoa_tpu.telemetry import tracing as jax_tracing  # noqa: E402
from cocoa_tpu.telemetry.metrics import \
    MetricsWriter as JaxMetricsWriter  # noqa: E402
from cocoa_tpu.utils.logging import RoundRecord as JaxRecord  # noqa: E402
from cocoa_tpu.utils.logging import Trajectory as JaxTrajectory  # noqa: E402
from cocoa_torch import checkpoint, cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from cocoa_torch.telemetry import events, recorder, schema, \
    tracing  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
from cocoa_torch.utils.logging import RoundRecord, Trajectory  # noqa: E402
from test_torch_gap_target import CHAOS_FROM, ROBUST_SEED, \
    coherent  # noqa: E402

K, LAM = 4, 1e-4
RTOL = 1e-12
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
        "--numSplits=4", "--localIterFrac=0.1", "--lambda=.001",
        "--dtype=float64", "--quiet"]
LOOPS = {"chunked": [], "device": ["--deviceLoop"]}
# record fields that are times, ids of the process, or its sequence
UNTIMED = {"seq", "ts", "start_ts", "dur_s", "elapsed_s", "pid"}
ENVIRONMENT = {"jax_version", "torch_version", "backend", "device_count",
               "device_kind", "process_count", "config_hash"}
INGEST_TIMED = ("parse_seconds", "peak_rss_bytes")
# the sanitizers' bookkeeping, masked in both streams: JAX's compile
# events are XLA compiles and the port's CUDA graph captures and nvcc
# builds, and each package marks the fetches of its own loop (the port's
# chunked loop one an eval, its device loop one a super-block)
JAX_ONLY_EVENTS = ("compile", "host_transfer")


def reset_all():
    for bus in (events.get_bus(), jax_events.get_bus()):
        bus.reset()
    tracing.reset()
    jax_tracing.reset()


@pytest.fixture(autouse=True)
def clean_buses():
    """Every test starts and ends with inert buses and tracers in both
    packages (process-global singletons)."""
    reset_all()
    yield
    reset_all()


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: the port's rounds at these sizes are many small
    ops, which torch's thread pool slows by an order of magnitude on a
    host whose cores other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fetch_bridge(monkeypatch):
    """The JAX device loop on its fetch-fallback bridge, the form the
    port's device loop takes at every super-block."""
    monkeypatch.setattr(jax_events, "io_callback_supported", lambda: False)


def collect(bus):
    out = []
    bus.subscribe(out.append)
    return out


def read_stream(path):
    """An event JSONL, the sanitizers' events left out."""
    return [e for e in map(json.loads, open(path))
            if e["event"] not in JAX_ONLY_EVENTS]


def _same_number(x, y, key, primal):
    if key == "gap" and primal is not None:
        assert abs(x - y) <= RTOL * abs(primal), (key, x, y)
    else:
        np.testing.assert_allclose(x, y, rtol=RTOL, err_msg=key)


def same_manifest(a, b):
    """The port's run_start manifest ``a`` against JAX's ``b``: the same
    keys but the environment's and the hash, equal on the config keys
    both have, the layout split and the ingest record's untimed
    fields."""
    assert set(a) - ENVIRONMENT == set(b) - ENVIRONMENT
    assert a["torch_version"] == torch.__version__
    assert a["backend"] == "cpu" and a["device_kind"] == "cpu"
    shared = set(a["config"]) & set(b["config"])
    assert {"train_file", "num_splits", "lam", "dtype"} <= shared
    assert {k: a["config"][k] for k in shared} == \
        {k: b["config"][k] for k in shared}
    for key in set(a) - ENVIRONMENT - {"config", "ingest"}:
        assert a[key] == b[key], key
    if "ingest" in b:
        assert {k: v for k, v in a["ingest"].items()
                if k not in INGEST_TIMED} == \
            {k: v for k, v in b["ingest"].items() if k not in INGEST_TIMED}


def assert_same_events(mine, ref, upto=None):
    """The port's records ``mine`` against JAX's ``ref`` (module
    docstring); the numbers of evals at or past round ``upto``, and the
    stall counter that the watch computes from them, unchecked."""
    assert [e["event"] for e in mine] == [e["event"] for e in ref]
    for a, b in zip(mine, ref):
        if b["event"] == "run_start":
            same_manifest(a["manifest"], b["manifest"])
            continue
        assert set(a) - UNTIMED == set(b) - UNTIMED, b["event"]
        t = b.get("t", b.get("round"))
        late = upto is not None and isinstance(t, int) and t >= upto
        for key in set(b) - UNTIMED:
            x, y = a[key], b[key]
            if b["event"] == "ingest" and key in INGEST_TIMED:
                continue
            if isinstance(y, float) or isinstance(x, float):
                assert (x is None) == (y is None), key
                if not late:
                    _same_number(x, y, key, b.get("primal"))
            elif key == "stall" and late:
                assert (x is None) == (y is None), key
            else:
                assert x == y, (b["event"], key, x, y)


def both_cli_streams(tmp_path, argv, setup=None):
    """The same command through both CLIs, each writing the same
    ``--events``/``--metrics`` paths in turn: {"jax"|"port": (event
    records, metrics text)}.  ``setup(tag)`` runs before each CLI.  The
    JAX CLI leaves its bus configured and its flight recorder's hooks
    installed; they are put back after it."""
    ev, prom = tmp_path / "events.jsonl", tmp_path / "metrics.prom"
    out = {}
    for tag, main, extra in (("jax", jax_cli.main, ["--mesh=1"]),
                             ("port", cli.main, ["--device=cpu"])):
        reset_all()
        if setup is not None:
            setup(tag)
        hook, term = sys.excepthook, signal.getsignal(signal.SIGTERM)
        try:
            rc = main(DEMO + argv + [f"--events={ev}", f"--metrics={prom}",
                                     "--trace"] + extra)
        finally:
            sys.excepthook = hook
            signal.signal(signal.SIGTERM, term)
        assert rc == 0, tag
        os.replace(ev, tmp_path / f"events.{tag}.jsonl")
        os.replace(prom, tmp_path / f"metrics.{tag}.prom")
        out[tag] = (read_stream(tmp_path / f"events.{tag}.jsonl"),
                    (tmp_path / f"metrics.{tag}.prom").read_text())
    reset_all()
    return out


def check_both_schemas(*paths):
    for path in paths:
        assert schema.check_file(str(path)) == [], path
        assert jax_schema.check_file(str(path)) == [], path


# time-valued metrics samples (host clocks, not the same in two runs), and
# the counters of the compile and host_transfer events (masked above)
_TIMED_METRICS = ("cocoa_round_seconds", "cocoa_phase_seconds",
                  "cocoa_ingest_seconds", "cocoa_model_gap_age_seconds",
                  "cocoa_compiles_total", "cocoa_host_transfers_total")


def same_metrics(text, ref):
    """Two textfiles with their time-valued samples masked: the same
    lines, every count equal, and the last gap to relative 1e-10 (a gap's
    own relative difference between the packages reaches 1.3e-11; the
    events hold it to 1e-12 of the primal)."""
    def lines(t):
        return [ln.split(" ") for ln in t.splitlines()
                if not ln.startswith(_TIMED_METRICS)]
    a, b = lines(text), lines(ref)
    assert [x[0] for x in a] == [y[0] for y in b]
    for x, y in zip(a, b):
        if x[0] == "cocoa_last_gap":
            np.testing.assert_allclose(float(x[1]), float(y[1]), rtol=1e-10)
        else:
            assert x == y


CLI_FLAG_SETS = {
    "gap": ["--numRounds=100", "--gapTarget=1e-3"],
    "anneal": ["--numRounds=100", "--gapTarget=1e-3", "--sigma=1",
               "--sigmaSchedule=anneal"],
    "accel": ["--numRounds=100", "--gapTarget=1e-3", "--accel=on",
              "--theta=adaptive"],
}


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("flags", list(CLI_FLAG_SETS))
def test_cli_streams_match_jax(flags, loop, tmp_path, jax_fetch_bridge):
    """The demo through both CLIs with --events --metrics --trace: the
    same events, with the same typed fields (module docstring), both
    streams valid under both checkers, and the same metrics textfile
    with its time-valued samples masked."""
    out = both_cli_streams(tmp_path, CLI_FLAG_SETS[flags] + LOOPS[loop])
    (ref, prom_j), (mine, prom) = out["jax"], out["port"]
    assert_same_events(mine, ref)
    names = {e["event"] for e in mine}
    assert {"run_start", "ingest", "span", "round_eval", "run_end"} <= names
    if flags == "accel":
        assert "theta_stage" in names
    check_both_schemas(tmp_path / "events.jax.jsonl",
                       tmp_path / "events.port.jsonl")
    same_metrics(prom, prom_j)


# --- the ladder's events through the solvers ---------------------------------


def _both_runs(device_loop, seed=ROBUST_SEED, **kw):
    """tests/test_telemetry.py's forced-backoff run on both packages'
    solvers (the coherent shards of ``seed``, K=4, cadence 25), each bus
    collecting: (JAX's events, JAX's run, the port's events, the port's
    run)."""
    ds_j, ds, n = coherent(seed=seed)
    fields = dict(num_rounds=1600, local_iters=16, lam=LAM, sigma=1.0)
    run_kw = dict(plus=True, quiet=True, math="fast", gap_target=1e-3,
                  rng="jax", device_loop=device_loop, **kw)
    ev_j = collect(jax_events.get_bus())
    out_j = jax_cocoa.run_cocoa(ds_j, JaxParams(n=n, **fields),
                                JaxDebug(debug_iter=25, seed=0), **run_kw)
    ev = collect(events.get_bus())
    out = port_cocoa.run_cocoa(ds, Params(n=n, **fields),
                               DebugParams(debug_iter=25, seed=0), **run_kw)
    strip = [e for e in ev_j if e["event"] not in JAX_ONLY_EVENTS]
    mine = [e for e in ev if e["event"] not in JAX_ONLY_EVENTS]
    return strip, out_j, mine, out


@pytest.mark.parametrize("device_loop", [False, True])
def test_backoff_streams_match_jax(device_loop, jax_fetch_bridge):
    """The sigma' anneal that backs off (1 -> 2 at round 425 on the robust
    seed's coherent shards): the round_eval and sigma_backoff events of
    both packages, on both loops."""
    ref, _, mine, (_, _, traj) = _both_runs(device_loop,
                                            sigma_schedule="anneal")
    assert traj.stopped == "target"
    backoffs = [e for e in mine if e["event"] == "sigma_backoff"]
    assert [(e["t"], e["from_sigma"], e["sigma"], e["stage"])
            for e in backoffs] == [(425, 1.0, 2.0, 1)]
    assert_same_events(mine, ref, upto=CHAOS_FROM)


@pytest.mark.parametrize("device_loop", [False, True])
def test_divergence_streams_and_dumps_match_jax(device_loop, tmp_path,
                                                jax_fetch_bridge):
    """A fixed sigma' = K/4 on the robust seed's coherent shards bails out
    at round 425: the same events in both packages (numbers before round
    125), the divergence event, and each package's flight-recorder dump
    of it, valid under both checkers."""
    recs = {}
    for tag, bus in (("jax", jax_events.get_bus()),
                     ("port", events.get_bus())):
        bus.configure(jsonl_path=str(tmp_path / f"ev.{tag}.jsonl"))
        lib = jax_recorder if tag == "jax" else recorder
        recs[tag] = lib.install(bus, str(tmp_path / f"ev.{tag}.jsonl"),
                                signals=False)
    hook = sys.excepthook
    try:
        ref, (_, _, traj_j), mine, (_, _, traj) = _both_runs(device_loop)
    finally:
        sys.excepthook = hook
    assert traj.stopped == traj_j.stopped == "diverged"
    div = [e for e in mine if e["event"] == "divergence"]
    assert [(e["t"], e["n_evals"]) for e in div] == [(425, 12)]
    assert_same_events(mine, ref, upto=CHAOS_FROM)
    for tag, rec in recs.items():
        assert rec.dumps and rec.dumps[-1][0] == "divergence"
    check_both_schemas(*(tmp_path / f"ev.{tag}.jsonl{suffix}"
                         for tag in recs for suffix in ("", ".flightrec")))


def test_device_stream_matches_fetched_trajectory_bitforbit():
    """tests/test_telemetry.py:84 on the port: the device loop's events,
    decoded from the fetched rows, equal its records bit for bit, and
    each backoff lands where consecutive records change sigma'."""
    bus = events.get_bus()
    ev = collect(bus)
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    _, _, traj = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0), DebugParams(debug_iter=25, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
        sigma_schedule="anneal", device_loop=True)
    assert traj.stopped == "target"
    evals = [e for e in ev if e["event"] == "round_eval"]
    backoffs = [e for e in ev if e["event"] == "sigma_backoff"]
    assert len(evals) == len(traj.records)
    for e, r in zip(evals, traj.records):
        assert (e["t"], e["primal"], e["gap"], e["sigma"]) == \
            (r.round, r.primal, r.gap, r.sigma)
        assert (e["sigma_stage"], e["stall"]) == (r.sigma_stage, r.stall)
    transitions = [(b.round, a.sigma, b.sigma)
                   for a, b in zip(traj.records, traj.records[1:])
                   if a.sigma != b.sigma]
    assert [(e["t"], e["from_sigma"], e["sigma"]) for e in backoffs] == \
        transitions and transitions
    seqs = [e["seq"] for e in ev]
    assert seqs == sorted(set(seqs))
    for b in backoffs:
        trigger = [e for e in evals if e["t"] == b["t"]]
        assert trigger and trigger[0]["seq"] < b["seq"]


def test_host_and_device_paths_emit_identical_streams():
    """tests/test_telemetry.py:167 on the port: the chunked loop's and the
    device loop's round_eval and sigma_backoff events agree on every
    value the math determines."""
    keep = ("event", "algorithm", "t", "primal", "gap", "sigma",
            "sigma_stage", "stall")
    streams = []
    for device_loop in (False, True):
        reset_all()
        ev = collect(events.get_bus())
        ds_j, ds, n = coherent(seed=ROBUST_SEED)
        port_cocoa.run_cocoa(
            ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                       sigma=1.0), DebugParams(debug_iter=25, seed=0),
            plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
            sigma_schedule="anneal", device_loop=device_loop)
        streams.append([{k: e.get(k) for k in keep} for e in ev
                        if e["event"] in ("round_eval", "sigma_backoff")])
    assert streams[0] == streams[1]


# --- telemetry leaves no trace in the results -------------------------------


@pytest.mark.parametrize("device_loop", [False, True])
def test_telemetry_on_vs_off_state_bit_identical(device_loop, tmp_path):
    """tests/test_telemetry.py:138 on the port: w, alpha, the sched
    vector the checkpoints carry and the fetches, with every sink and the
    tracer on against all off, on both loops."""
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    runs = {}
    for tag in ("on", "off"):
        reset_all()
        if tag == "on":
            events.get_bus().configure(
                jsonl_path=str(tmp_path / "ev.jsonl"),
                metrics_path=str(tmp_path / "m.prom"))
            tracing.configure(enabled=True, worker=0)
            recorder.install(events.get_bus(), str(tmp_path / "ev.jsonl"),
                             signals=False).uninstall()
        debug = DebugParams(debug_iter=25, seed=0, chkpt_iter=100,
                            chkpt_dir=str(tmp_path / tag))
        runs[tag] = port_cocoa.run_cocoa(
            ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                       sigma=1.0), debug, plus=True, quiet=True,
            math="fast", gap_target=1e-3, rng="jax",
            sigma_schedule="anneal", device_loop=device_loop)
    (w1, a1, t1), (w2, a2, t2) = runs["on"], runs["off"]
    assert torch.equal(w1, w2) and torch.equal(a1, a2)
    assert t1.fetches == t2.fetches > 0 and t1.saves == t2.saves > 0
    assert schema.check_file(str(tmp_path / "ev.jsonl")) == []
    names = sorted(os.listdir(tmp_path / "on"))
    assert names == sorted(os.listdir(tmp_path / "off"))
    for name in names:
        if name.endswith(".npz"):
            m1, _, _ = checkpoint.load(str(tmp_path / "on" / name))
            m2, _, _ = checkpoint.load(str(tmp_path / "off" / name))
            assert m1["sched"] == m2["sched"], name


# --- the satellites on the port ----------------------------------------------


def test_trajectory_dump_manifest_and_stopped(tmp_path):
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    _, _, traj = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0), DebugParams(debug_iter=25, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
        sigma_schedule="anneal", device_loop=True)
    traj.meta = {"dataset": "synthetic-coherent", "config_hash": "abc123"}
    path = str(tmp_path / "traj.jsonl")
    traj.dump_jsonl(path)
    lines = [json.loads(s) for s in open(path)]
    man = lines[0]["manifest"]
    assert man["algorithm"] == "CoCoA+"
    assert man["dataset"] == "synthetic-coherent"
    assert man["config_hash"] == "abc123"
    assert "torch_version" in man and man["backend"] == "cpu"
    assert "stopped" not in lines[-2]
    assert lines[-1]["stopped"] == "target"
    assert schema.check_file(path) == []


def test_quiet_divergence_still_leaves_event_trace(capsys):
    ev = collect(events.get_bus())
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    _, _, traj = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0), DebugParams(debug_iter=25, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax")
    assert traj.stopped == "diverged"
    assert "DIVERGED" not in capsys.readouterr().out
    div = [e for e in ev if e["event"] == "divergence"]
    assert len(div) == 1 and div[0]["algorithm"] == "CoCoA+"
    assert div[0]["t"] == traj.records[-1].round
    assert div[0]["n_evals"] >= 12


@pytest.mark.parametrize("device_loop", [False, True])
def test_checkpoint_write_events(device_loop, tmp_path):
    tracing.configure(enabled=True)
    ev = collect(events.get_bus())
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0),
        DebugParams(debug_iter=25, seed=0, chkpt_iter=100,
                    chkpt_dir=str(tmp_path)),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
        sigma_schedule="anneal", device_loop=device_loop)
    writes = [e for e in ev if e["event"] == "checkpoint_write"]
    saves = [e for e in ev if e["event"] == "span"
             and e["phase"] == "checkpoint_save"]
    assert writes and len(saves) == len(writes)
    for e, s in zip(writes, saves):
        assert e["algorithm"] == "CoCoA+" and s["round"] == e["round"]
        assert f"r{e['round']:06d}" in e["path"]
        assert s["seq"] > e["seq"]   # the span closes after its write
    for e in writes[-checkpoint.KEEP_GENERATIONS:]:
        assert os.path.exists(e["path"])
    for e in writes[:-checkpoint.KEEP_GENERATIONS]:
        assert not os.path.exists(e["path"])


def test_sigma_trial_restart_event(monkeypatch):
    """tests/test_telemetry.py:259 on both packages: the injected
    divergence of the K/2 trial emits the same restart event."""
    ds_j, ds, n = coherent()

    def spy(real, traj_cls, rec_cls):
        def run(ds_, params_, debug_, name_, alg, **kw):
            if alg[2] == K / 2.0:
                t = traj_cls(name_, quiet=True)
                t.records.append(rec_cls(round=392, wall_time=None, gap=5.0))
                t.stopped = "diverged"
                return None, None, t
            return real(ds_, params_, debug_, name_, alg, **kw)
        return run

    monkeypatch.setattr(jax_cocoa, "run_sdca_family",
                        spy(jax_cocoa.run_sdca_family, JaxTrajectory,
                            JaxRecord))
    monkeypatch.setattr(port_cocoa, "run_sdca_family",
                        spy(port_cocoa.run_sdca_family, Trajectory,
                            RoundRecord))
    kw = dict(plus=True, quiet=True, math="fast", gap_target=1e-3,
              rng="jax", sigma_schedule="trial")
    out = []
    for bus, run, P, D, data in (
            (jax_events.get_bus(), jax_cocoa.run_cocoa, JaxParams, JaxDebug,
             ds_j),
            (events.get_bus(), port_cocoa.run_cocoa, Params, DebugParams,
             ds)):
        ev = collect(bus)
        run(data, P(n=n, num_rounds=400, local_iters=16, lam=LAM,
                    sigma="auto"), D(debug_iter=4, seed=0), **kw)
        out.append([e for e in ev if e["event"] == "restart"])
    ref, mine = out
    assert len(mine) == 1 and mine[0]["reason"] == "sigma_trial_diverged"
    assert mine[0]["sigma_trial"] == K / 2.0
    assert mine[0]["sigma_safe"] == float(K)
    assert_same_events(mine, ref)


def test_metrics_textfile(tmp_path):
    path = str(tmp_path / "metrics.prom")
    events.get_bus().configure(metrics_path=path)
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    _, _, traj = port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0), DebugParams(debug_iter=25, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
        sigma_schedule="anneal", device_loop=True)
    text = open(path).read()
    vals = {line.split(" ")[0]: line.split(" ")[1]
            for line in text.splitlines() if not line.startswith("#")}
    assert int(vals["cocoa_evals_total"]) == len(traj.records)
    assert int(vals["cocoa_rounds_total"]) == \
        traj.records[-1].round - traj.records[0].round
    assert int(vals["cocoa_sigma_backoffs_total"]) >= 1
    assert float(vals["cocoa_last_gap"]) == traj.records[-1].gap
    assert 'cocoa_round_seconds_bucket{le="+Inf"}' in text
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_metrics_render_matches_jax(tmp_path, jax_fetch_bridge):
    """The two writers fed the same event records (a JAX-made stream and
    a port-made one, each with spans, backoffs and a run_end) render the
    same text."""
    streams = []
    for tag, bus, tr in (("jax", jax_events.get_bus(), jax_tracing),
                         ("port", events.get_bus(), tracing)):
        tr.configure(enabled=True, worker=0)
        streams.append(collect(bus))
    _both_runs(True, sigma_schedule="anneal")
    for recs in streams:
        w_j = JaxMetricsWriter(str(tmp_path / "j.prom"))
        w = MetricsWriter(str(tmp_path / "p.prom"))
        for rec in recs:
            w_j(dict(rec))
            w(dict(rec))
        assert w.render() == w_j.render()
        assert "cocoa_sigma_backoffs_total 1" in w.render()


def test_schema_checker_accepts_results_jsonl():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert schema.check_file(os.path.join(root, "benchmarks",
                                          "results.jsonl")) == []


MALFORMED = {
    "events.jsonl": (
        '{"event": "round_eval", "seq": 2, "ts": 1.0, "algorithm": "X", '
        '"t": 10, "primal": 1.0, "gap": null, "test_error": null, '
        '"sigma": null, "stall": null}\n'
        '{"event": "round_eval", "seq": 1, "ts": 1.0, "algorithm": "X", '
        '"t": 20, "primal": 1.0, "gap": null, "test_error": null, '
        '"sigma": null, "stall": null}\n'
        '{"event": "nonsense", "seq": 3, "ts": 1.0}\n'),
    "typed.jsonl": (
        '{"event": "span", "seq": 1, "ts": 1.0, "phase": "eval", '
        '"span_id": 1.5, "parent_id": null, "worker": 0, '
        '"start_ts": 1.0, "dur_s": "fast"}\n'
        '{"event": "checkpoint_write", "seq": 2, "ts": 1.0, '
        '"algorithm": "X", "round": 3}\n'),
    "dump.flightrec": (
        json.dumps({"flightrec_manifest": {"reason": "x"}}) + "\n"
        + json.dumps({"event": "nonsense", "seq": 1, "ts": 1.0}) + "\n"),
    "torn.flightrec": (
        json.dumps({"flightrec_manifest": {"reason": "sigterm", "ts": 1.0,
                                           "n_events": 3}}) + "\n"
        '{"event": "divergence", "seq": 1, "ts": 1.0, "algorithm": "X", '
        '"t": 5, "n_evals": 12}\n{"event": "run_'),
    "split.jsonl": json.dumps(
        {"event": "run_start", "seq": 1, "ts": 1.0,
         "manifest": {"layout_split": [1, 2]}}) + "\n",
}


@pytest.mark.parametrize("name", list(MALFORMED))
def test_schema_checkers_reject_the_same_malformed(name, tmp_path):
    path = tmp_path / name
    path.write_text(MALFORMED[name])
    errs = schema.check_file(str(path))
    assert errs and errs == jax_schema.check_file(str(path))
    assert schema.main([str(path)]) == 1


def test_schema_trajectory_dialect(tmp_path):
    """A trajectory without its manifest is rejected by both checkers; a
    manifest names its framework's version, jax_version or
    torch_version."""
    traj = tmp_path / "traj.jsonl"
    traj.write_text('{"algorithm": "X", "round": 1, "wall_time": null}\n')
    assert schema.check_file(str(traj), kind="trajectory") != []
    assert jax_schema.check_file(str(traj), kind="trajectory") != []
    head = {"algorithm": "X", "config_hash": "h", "backend": "cpu"}
    rec = json.dumps({"algorithm": "X", "round": 1, "wall_time": None,
                      "primal": 1.0, "gap": None, "test_error": None,
                      "sigma": None, "stopped": None})
    for extra, ok in (({"torch_version": "2"}, True),
                      ({"jax_version": "0.4"}, True), ({}, False)):
        traj.write_text(json.dumps({"manifest": {**head, **extra}}) + "\n"
                        + rec + "\n")
        assert (schema.check_file(str(traj)) == []) == ok, extra


def test_run_start_layout_split_schema(tmp_path):
    split = {"spec": "auto", "hot_cols": 2048, "coverage": 0.75,
             "residual_mean_nnz": 18.4, "residual_max_nnz": 214,
             "panel_bytes": 166723584}
    good = tmp_path / "good.jsonl"
    good.write_text(json.dumps(
        {"event": "run_start", "seq": 1, "ts": 1.0,
         "manifest": {"config": {}, "config_hash": "x",
                      "layout_split": split}}) + "\n")
    assert schema.check_file(str(good)) == []
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(
        {"event": "run_start", "seq": 1, "ts": 1.0,
         "manifest": {"layout_split": {**split, "coverage": "high",
                                       "hot_cols": 2048.5}}}) + "\n")
    errs = schema.check_file(str(bad))
    assert any("coverage" in e for e in errs)
    assert any("hot_cols" in e for e in errs)


def test_inactive_bus_is_inert():
    bus = events.get_bus()
    assert not bus.active()
    assert bus.emit("round_eval", algorithm="X", t=1, primal=0.0) is None
    with pytest.raises(ValueError):
        bus.configure(jsonl_path=os.devnull).emit("no_such_event")


def test_cli_puts_the_bus_and_hooks_back(tmp_path):
    """A CLI run with every sink returns with the bus as the caller left
    it (its own subscriber kept, no sink), the tracer off, and the
    excepthook and SIGTERM handler it found; the next run does not stack
    a second recorder."""
    mine = collect(events.get_bus())
    hook, term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    argv = DEMO + ["--numRounds=20", "--device=cpu",
                   f"--events={tmp_path}/ev.jsonl",
                   f"--metrics={tmp_path}/m.prom", "--trace"]
    for _ in range(2):
        assert cli.main(argv) == 0
        assert sys.excepthook is hook
        assert signal.getsignal(signal.SIGTERM) is term
        bus = events.get_bus()
        assert bus.jsonl_path is None and bus.metrics_writer is None
        assert bus._subscribers == [mine.append]
        assert not tracing.get_tracer().enabled
    starts = [e for e in mine if e["event"] == "run_start"]
    assert len(starts) == 2
    lines = [json.loads(ln) for ln in open(tmp_path / "ev.jsonl")]
    assert [e["seq"] for e in lines] == \
        [e["seq"] for e in mine if e["event"] != "events_rotate"]
