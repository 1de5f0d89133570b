"""The port's span tracing, trace report and flight recorder
(cocoa_torch/telemetry/tracing.py, trace_report.py, recorder.py) against
the JAX package's, float64 on the CPU, mirroring the CPU-side cases of
tests/test_tracing.py (its two gang cases wait for a supervisor).

- **The event streams**, as tests/test_torch_telemetry.py holds them
  (its module docstring has the fields left out and the tolerances), for
  the demo through both CLIs with ``--events --metrics --trace`` on both
  loops: ``--sigma=auto --sigmaSchedule=trial`` with the trial's
  divergence injected into both packages, a ``--chkptDir`` whose newest
  generation is torn before ``--resume``, and ``--hotCols=auto`` (the
  ``layout_split`` record).
- **Tracing leaves no trace in the results**: w, alpha and the sched
  vector bit for bit, the fetches equal; and through the CLI, every
  telemetry flag on against none, each algorithm of the menu on both
  loops.
- **The trace report**: both packages' ``trace_report`` turn a JAX-made
  span stream and a port-made one into identical Chrome traces,
  critical paths, straggler tables and metrics text; and the JAX cases
  of its mechanics on the port.
- The span mechanics, the ``--events`` rotation, the metrics debounce
  and phase gauge, the flight recorder (ring, victim dump, SIGTERM in a
  real process, SIG_IGN), ``--profile`` (the round window and the whole
  run on the CPU activities; the device table's kernel events) and the
  CLI's error lines for every misuse of the seven telemetry flags, which
  equal the JAX CLI's.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.solvers import cocoa as jax_cocoa  # noqa: E402
from cocoa_tpu.telemetry import trace_report as jax_report  # noqa: E402
from cocoa_tpu.utils.logging import RoundRecord as JaxRecord  # noqa: E402
from cocoa_tpu.utils.logging import Trajectory as JaxTrajectory  # noqa: E402
from cocoa_torch import checkpoint, cli  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.solvers import cocoa as port_cocoa  # noqa: E402
from cocoa_torch.telemetry import events, profiling, recorder, schema, \
    trace_report, tracing  # noqa: E402
from cocoa_torch.telemetry import metrics as metrics_mod  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
from cocoa_torch.utils.logging import RoundRecord, Trajectory  # noqa: E402
from test_torch_gap_target import ROBUST_SEED, coherent  # noqa: E402
from test_torch_telemetry import DEMO, LAM, LOOPS, assert_same_events, \
    both_cli_streams, check_both_schemas, clean_buses, collect, \
    jax_fetch_bridge, one_thread, reset_all  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4


# --- the event streams through both CLIs --------------------------------------


def _inject_trial_divergence(monkeypatch):
    """Both packages' sigma' trial (K/2 = 2 on the demo's 4 shards)
    diverges at round 392 without running (tests/test_telemetry.py:259)."""
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


def _torn_checkpoints(tmp_path):
    """A checkpoint directory of the demo (CoCoA+ and CoCoA at rounds 40
    and 60) whose newest CoCoA+ generation is torn; a setup that copies
    it afresh before each CLI."""
    src = tmp_path / "ck_src"
    assert cli.main(DEMO + ["--numRounds=60", "--chkptIter=20",
                            f"--chkptDir={src}", "--device=cpu"]) == 0
    newest = src / "CoCoA+-r000060.npz"
    newest.write_bytes(newest.read_bytes()[:200])
    dst = tmp_path / "ck"

    def setup(tag):
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    return dst, setup


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("flags", ["trial", "chkpt", "hotcols"])
def test_cli_streams_match_jax(flags, loop, tmp_path, monkeypatch,
                               jax_fetch_bridge):
    setup = None
    if flags == "trial":
        _inject_trial_divergence(monkeypatch)
        argv = ["--numRounds=100", "--gapTarget=1e-3", "--sigma=auto",
                "--sigmaSchedule=trial"]
    elif flags == "chkpt":
        ck, setup = _torn_checkpoints(tmp_path)
        argv = ["--numRounds=100", "--chkptIter=20", f"--chkptDir={ck}",
                "--resume"]
    else:
        argv = ["--numRounds=40", "--hotCols=auto"]
    out = both_cli_streams(tmp_path, argv + LOOPS[loop], setup=setup)
    (ref, _), (mine, _) = out["jax"], out["port"]
    assert_same_events(mine, ref)
    check_both_schemas(tmp_path / "events.jax.jsonl",
                       tmp_path / "events.port.jsonl")
    names = [e["event"] for e in mine]
    if flags == "trial":
        restart = [e for e in mine if e["event"] == "restart"]
        assert [(e["reason"], e["round"]) for e in restart] == \
            [("sigma_trial_diverged", 392)]
    elif flags == "chkpt":
        assert names.count("checkpoint_corrupt") == 1
        phases = [e["phase"] for e in mine if e["event"] == "span"]
        assert "checkpoint_validate" in phases
        assert phases.count("checkpoint_save") == \
            names.count("checkpoint_write") > 0
    else:
        split = mine[0]["manifest"]["layout_split"]
        assert split["spec"] == "auto" and split["hot_cols"] > 0
        assert mine[0]["manifest"]["config"]["layout_split"] == split


# --- span mechanics ------------------------------------------------------------


def test_span_nesting_parent_ids_and_attrs():
    ev = collect(events.get_bus())
    tracing.configure(enabled=True, worker=3)
    with tracing.span("round", round=7) as outer:
        with tracing.span("kv_get", key="a") as inner:
            pass
    spans = [e for e in ev if e["event"] == "span"]
    assert [s["phase"] for s in spans] == ["kv_get", "round"]
    inner_s, outer_s = spans
    assert inner_s["span_id"] == inner and outer_s["span_id"] == outer
    assert inner_s["parent_id"] == outer and outer_s["parent_id"] is None
    assert inner_s["worker"] == outer_s["worker"] == 3
    assert outer_s["round"] == 7 and inner_s["key"] == "a"
    assert 0.0 <= inner_s["dur_s"] <= outer_s["dur_s"]


def test_traced_decorator_and_error_attribute():
    ev = collect(events.get_bus())
    tracing.configure(enabled=True)

    @tracing.traced("work", kind="unit")
    def work(x):
        return x + 1

    assert work(1) == 2
    with pytest.raises(ValueError):
        with tracing.span("doomed"):
            raise ValueError("boom")
    spans = [e for e in ev if e["event"] == "span"]
    assert spans[0]["phase"] == "work" and spans[0]["kind"] == "unit"
    assert spans[1]["phase"] == "doomed" and spans[1]["error"] == "ValueError"


def test_disabled_tracer_and_inert_bus_emit_nothing():
    ev = collect(events.get_bus())
    with tracing.span("x"):
        pass
    events.get_bus().reset()
    tracing.configure(enabled=True)
    with tracing.span("y") as sid:
        pass
    assert sid is None
    assert [e for e in ev if e["event"] == "span"] == []


# --- tracing must not perturb the run --------------------------------------------


def _anneal_run(tmp_path, name, device_loop=True):
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    return port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=150, local_iters=16, lam=LAM, sigma=1.0),
        DebugParams(debug_iter=25, seed=0, chkpt_iter=75,
                    chkpt_dir=str(tmp_path / name)),
        plus=True, quiet=True, math="fast", device_loop=device_loop,
        gap_target=1e-3, rng="jax", sigma_schedule="anneal")


@pytest.mark.parametrize("device_loop", [False, True])
def test_tracing_on_vs_off_state_bit_identical(device_loop, tmp_path):
    events.get_bus().configure(jsonl_path=str(tmp_path / "events.jsonl"))
    tracing.configure(enabled=True, worker=0)
    w1, a1, t1 = _anneal_run(tmp_path, "on", device_loop)
    spans = [e for e in map(json.loads, open(tmp_path / "events.jsonl"))
             if e["event"] == "span"]
    assert {s["phase"] for s in spans} >= {"local_solve", "checkpoint_save"}
    assert ("eval" in {s["phase"] for s in spans}) == (not device_loop)
    reset_all()
    w2, a2, t2 = _anneal_run(tmp_path, "off", device_loop)
    assert torch.equal(w1, w2) and torch.equal(a1, a2)
    assert t1.fetches == t2.fetches
    names = sorted(os.listdir(tmp_path / "on"))
    assert names == sorted(os.listdir(tmp_path / "off"))
    for nm in names:
        if nm.endswith(".npz"):
            m1, _, _ = checkpoint.load(str(tmp_path / "on" / nm))
            m2, _, _ = checkpoint.load(str(tmp_path / "off" / nm))
            assert m1["sched"] == m2["sched"], nm


def test_span_stream_schema_valid_and_round_attributed(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    events.get_bus().configure(jsonl_path=ev)
    tracing.configure(enabled=True, worker=0)
    _anneal_run(tmp_path, "run")
    assert schema.check_file(ev) == []
    spans = trace_report.load_spans([ev])
    rounds = {s["_round"] for s in spans if s["phase"] == "local_solve"}
    assert rounds and all(r % 25 == 0 for r in rounds)
    assert {s["_round"] for s in spans
            if s["phase"] == "checkpoint_save"} >= {75, 150}
    path = trace_report.critical_path(spans)
    assert path and all(p["critical_s"] > 0 for p in path)


# --- the trace report ------------------------------------------------------------


def test_trace_reports_agree_on_both_packages_streams(tmp_path,
                                                      jax_fetch_bridge):
    """A JAX-made and a port-made span stream (the demo on the device
    loop, checkpoints included) through both trace_report modules: the
    same Chrome trace, critical path, straggler table and metrics text,
    each stream's artifacts valid under both checkers."""
    both_cli_streams(tmp_path, ["--numRounds=60", "--chkptIter=20",
                                f"--chkptDir={tmp_path}/ck",
                                "--deviceLoop"])
    for tag in ("jax", "port"):
        path = [str(tmp_path / f"events.{tag}.jsonl")]
        spans, spans_j = trace_report.load_spans(path), \
            jax_report.load_spans(path)
        assert spans == spans_j and spans
        trace = trace_report.chrome_trace(spans)
        assert trace == jax_report.chrome_trace(spans_j)
        assert trace_report.check_chrome_trace(trace) == [] == \
            jax_report.check_chrome_trace(trace)
        assert trace_report.critical_path(spans) == \
            jax_report.critical_path(spans_j)
        assert trace_report.stragglers(spans) == \
            jax_report.stragglers(spans_j)
        assert trace_report.metrics_text(spans) == \
            jax_report.metrics_text(spans_j)
        assert trace_report.render_report(spans) == \
            jax_report.render_report(spans_j)


def _synthetic_streams(tmp_path, skew=0.01, rounds=(1, 2)):
    paths = []
    for w in (0, 1):
        reset_all()
        p = str(tmp_path / f"ev{w}.jsonl")
        paths.append(p)
        events.get_bus().configure(jsonl_path=p)
        tracing.configure(enabled=True, worker=w)
        for t in rounds:
            with tracing.span("round", round=t):
                with tracing.span("kv_allgather"):
                    time.sleep(0.002 + (skew if w == 1 else 0.0))
                with tracing.span("local_step"):
                    time.sleep(0.002)
    reset_all()
    return paths


def test_trace_report_merge_critical_path_and_stragglers(tmp_path):
    # worker 1's exchange 50 ms slower a round: a margin no scheduling
    # noise of a loaded host reaches
    paths = _synthetic_streams(tmp_path, skew=0.05)
    spans = trace_report.load_spans(paths)
    assert len(spans) == 12
    cp = trace_report.critical_path(spans)
    assert [c["round"] for c in cp] == [1, 2]
    for c in cp:
        assert {e["phase"] for e in c["entries"]} == {"kv_allgather",
                                                      "local_step"}
        assert all(e["workers"] == 2 for e in c["entries"])
        assert c["critical_s"] >= 0.004
    rows = trace_report.stragglers(spans)
    assert rows[0]["worker"] == 1 and rows[0]["phase"] == "kv_allgather"
    assert rows[0]["slack_s"] > 0.05
    text = trace_report.metrics_text(spans)
    assert 'cocoa_straggler_slack_seconds{worker="1",' \
           'phase="kv_allgather"}' in text
    assert cp == jax_report.critical_path(jax_report.load_spans(paths))


def _leaf(worker, phase, start, dur, round_=1, sid=[0], **attrs):
    sid[0] += 1
    return {"event": "span", "phase": phase, "span_id": sid[0],
            "parent_id": None, "worker": worker, "pid": 100 + worker,
            "start_ts": float(start), "dur_s": float(dur),
            "_round": round_, "round": round_, **attrs}


def test_critical_path_charges_overlapped_same_worker_leaves():
    spans = [
        _leaf(0, "local_solve", 10.0, 1.0),
        _leaf(0, "kv_get", 10.1, 0.8, overlapped=True),
        _leaf(1, "local_solve", 10.0, 1.0),
        _leaf(1, "kv_get", 11.0, 0.8),
    ]
    trace_report.attribute_rounds(spans)
    table = trace_report._per_round_phase_durs(spans)
    assert table[1]["kv_get"][0] == pytest.approx(0.0)
    assert table[1]["kv_get"][1] == pytest.approx(0.8)
    cp = trace_report.critical_path(spans)
    by_phase = {e["phase"]: e for e in cp[0]["entries"]}
    assert by_phase["kv_get"]["worker"] == 1
    assert cp[0]["critical_s"] == pytest.approx(1.8)


def test_charged_same_phase_overlap_unions_not_sums():
    spans = [
        _leaf(0, "kv_get", 0.0, 1.0),
        _leaf(0, "kv_get", 0.5, 1.0),
        _leaf(0, "kv_get", 3.0, 0.25),
        _leaf(1, "kv_get", 0.0, 0.1),
    ]
    trace_report.attribute_rounds(spans)
    table = trace_report._per_round_phase_durs(spans)
    assert table[1]["kv_get"][0] == pytest.approx(1.75)
    assert table[1]["kv_get"][1] == pytest.approx(0.1)


def test_trace_report_chrome_trace_checker_has_teeth(tmp_path):
    paths = _synthetic_streams(tmp_path, rounds=(1,))
    trace = trace_report.chrome_trace(trace_report.load_spans(paths))
    assert trace_report.check_chrome_trace(trace) == []
    assert {e["pid"] for e in trace["traceEvents"] if e["ph"] == "X"} == \
        {0, 1}
    for bad in ({"traceEvents": "nope"},
                {"traceEvents": [{"ph": "X", "name": "x", "pid": 0,
                                  "tid": 0, "ts": 1.0, "dur": -5.0}]},
                {"traceEvents": [{"ph": "Q", "name": "x", "pid": 0,
                                  "tid": 0}]}):
        assert trace_report.check_chrome_trace(bad) != []


def test_trace_report_cli_writes_artifacts(tmp_path, capsys):
    paths = _synthetic_streams(tmp_path, rounds=(1, 2))
    out = str(tmp_path / "trace.json")
    prom = str(tmp_path / "straggler.prom")
    assert trace_report.main([*paths, f"--trace={out}",
                              f"--metrics={prom}"]) == 0
    assert trace_report.check_chrome_trace(json.load(open(out))) == []
    assert "cocoa_straggler_slack_seconds" in open(prom).read()
    assert "critical path" in capsys.readouterr().out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert trace_report.main([str(empty)]) == 1
    assert trace_report.main([]) == 2
    assert trace_report.main(["--bogus"]) == 2
    proc = subprocess.run(
        [sys.executable, "-m", "cocoa_torch.telemetry.trace_report",
         *paths], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "critical path" in proc.stdout


# --- events rotation, metrics -------------------------------------------------


def test_events_rotation_size_cap_and_typed_event(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    bus = events.get_bus()
    bus.configure(jsonl_path=ev, max_bytes=2048)
    for _ in range(60):
        bus.emit("host_transfer", label="x" * 40)
    assert os.path.exists(ev + ".1")
    assert os.path.getsize(ev + ".1") <= 4096
    head = json.loads(open(ev).readline())
    assert head["event"] == "events_rotate"
    assert head["rotated_to"] == ev + ".1" and head["bytes"] >= 2048
    check_both_schemas(ev, ev + ".1")
    assert not os.path.exists(ev + ".2")


def _eval_event(t, ts):
    return {"event": "round_eval", "seq": t, "ts": ts, "algorithm": "X",
            "t": t, "primal": 1.0, "gap": 0.5, "test_error": None,
            "sigma": None, "stall": None}


def test_metrics_debounce_coalesces_and_flushes(tmp_path, monkeypatch):
    writes = []
    real_replace = os.replace

    def counting_replace(a, b):
        writes.append(b)
        return real_replace(a, b)

    monkeypatch.setattr(metrics_mod.os, "replace", counting_replace)
    w = MetricsWriter(str(tmp_path / "m.prom"), flush_interval_s=30.0)
    base = len(writes)
    for t in range(1, 21):
        w(_eval_event(t, float(t)))
    assert len(writes) - base <= 1
    w.flush()
    assert "cocoa_evals_total 20" in open(tmp_path / "m.prom").read()
    before = len(writes)
    w({"event": "run_end", "seq": 99, "ts": 99.0, "algorithm": "X",
       "primal": 1.0, "stopped": "target"})
    assert len(writes) == before + 1


def test_metrics_default_interval_unchanged(tmp_path, monkeypatch):
    writes = []
    real_replace = os.replace
    monkeypatch.setattr(
        metrics_mod.os, "replace",
        lambda a, b: (writes.append(b), real_replace(a, b))[1])
    w = MetricsWriter(str(tmp_path / "m.prom"))
    base = len(writes)
    for t in range(1, 6):
        w(_eval_event(t, float(t)))
    assert len(writes) - base == 5


def test_metrics_phase_seconds_gauge(tmp_path):
    path = str(tmp_path / "m.prom")
    w = MetricsWriter(path)
    for ph, d in (("eval", 0.25), ("local_solve", 1.0), ("eval", 0.25)):
        w({"event": "span", "seq": 1, "ts": 1.0, "phase": ph,
           "span_id": 1, "parent_id": None, "worker": 0,
           "start_ts": 1.0, "dur_s": d})
    text = open(path).read()
    assert 'cocoa_phase_seconds{phase="eval"} 0.5' in text
    assert 'cocoa_phase_seconds{phase="local_solve"} 1.0' in text
    g = MetricsWriter(str(tmp_path / "m.gang"), families="gang")
    g({"event": "span", "seq": 1, "ts": 1.0, "phase": "eval",
       "span_id": 1, "parent_id": None, "worker": None,
       "start_ts": 1.0, "dur_s": 1.0})
    assert "cocoa_phase_seconds" not in open(tmp_path / "m.gang").read()


# --- the flight recorder -----------------------------------------------------------


def test_recorder_ring_bounded_and_divergence_dump(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    bus = events.get_bus()
    bus.configure(jsonl_path=ev)
    rec = recorder.install(bus, ev, capacity=16, signals=False)
    try:
        for i in range(50):
            bus.emit("host_transfer", label=f"t{i}")
        assert len(rec.ring) == 16
        bus.emit("divergence", algorithm="X", t=100, n_evals=12)
    finally:
        rec.uninstall()
    assert rec.dumps and rec.dumps[-1][0] == "divergence"
    path = ev + ".flightrec"
    check_both_schemas(path)
    lines = [json.loads(ln) for ln in open(path)]
    man = lines[0]["flightrec_manifest"]
    assert man["reason"] == "divergence" and man["n_events"] == 16
    assert lines[-1]["event"] == "divergence"
    assert lines[1]["label"] == "t35"


def test_recorder_uninstall_puts_the_hooks_back():
    hook, term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    bus = events.get_bus()
    rec = recorder.install(bus, os.devnull + "x")
    assert sys.excepthook is not hook and bus.active()
    assert signal.getsignal(signal.SIGTERM) is not term
    rec.uninstall()
    assert sys.excepthook is hook and not bus.active()
    assert signal.getsignal(signal.SIGTERM) is term


def test_recorder_dump_victim_tails_stream(tmp_path):
    base = str(tmp_path / "events.jsonl")
    stream = recorder.worker_stream_path(base, 1)
    assert stream == base + ".p1"
    with open(stream, "w") as f:
        for t in range(1, 31):
            f.write(json.dumps(
                {"event": "checkpoint_write", "seq": t, "pid": 4242,
                 "ts": float(t), "algorithm": "Toy", "round": t,
                 "path": "x"}) + "\n")
        f.write('{"event": "span", "seq": 31, "pid": 4242, "ts": 31.0, '
                '"phase": "round", "span_id"')
    out = recorder.dump_victim(base, 1, "worker_died", exit_code=-9,
                               generation=2, last_n=10)
    assert out == stream + ".flightrec"
    check_both_schemas(out)
    lines = [json.loads(ln) for ln in open(out)]
    man = lines[0]["flightrec_manifest"]
    assert man["reason"] == "worker_died" and man["exit_code"] == -9
    assert man["victim_index"] == 1 and man["generation"] == 2
    assert len(lines) == 11 and lines[-1]["round"] == 30
    assert recorder.dump_victim(base, 7, "worker_died") is None


def test_recorder_sigterm_dump_real_process(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    code = f"""
import os, signal
from cocoa_torch.telemetry import events, recorder
bus = events.get_bus()
bus.configure(jsonl_path={ev!r})
rec = recorder.install(bus, {ev!r})
for i in range(5):
    bus.emit("host_transfer", label=f"t{{i}}")
os.kill(os.getpid(), signal.SIGTERM)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == -signal.SIGTERM
    check_both_schemas(ev + ".flightrec")
    man = json.loads(open(ev + ".flightrec").readline())["flightrec_manifest"]
    assert man["reason"] == "sigterm" and man["n_events"] == 5


def test_recorder_sigterm_honors_sig_ign(tmp_path):
    ev = str(tmp_path / "events.jsonl")
    code = f"""
import os, signal
signal.signal(signal.SIGTERM, signal.SIG_IGN)
from cocoa_torch.telemetry import events, recorder
bus = events.get_bus()
bus.configure(jsonl_path={ev!r})
rec = recorder.install(bus, {ev!r})
bus.emit("host_transfer", label="x")
os.kill(os.getpid(), signal.SIGTERM)
print("survived")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "survived" in proc.stdout
    man = json.loads(open(ev + ".flightrec").readline())
    assert man["flightrec_manifest"]["reason"] == "sigterm"


def test_cli_unhandled_exception_dumps_the_recorder(tmp_path, monkeypatch):
    """An exception that leaves the CLI's run dumps the flight recorder
    (reason unhandled_exception) before the hooks are put back."""
    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(cli, "run_cocoa", boom)
    ev = tmp_path / "ev.jsonl"
    with pytest.raises(RuntimeError):
        cli.main(DEMO + ["--numRounds=10", "--device=cpu", f"--events={ev}"])
    man = json.loads(open(f"{ev}.flightrec").readline())["flightrec_manifest"]
    assert man["reason"] == "unhandled_exception"
    assert man["error"] == "RuntimeError"
    check_both_schemas(ev, f"{ev}.flightrec")


# --- telemetry through the CLI, and --profile ---------------------------------


@pytest.mark.parametrize("loop", list(LOOPS))
def test_cli_telemetry_on_vs_off_bit_identical(loop, tmp_path):
    """Through the CLI: every telemetry flag on (events, metrics, trace,
    the flight recorder, a size cap, a debounce) against none, every
    algorithm of the menu's w and alpha bit for bit, the same fetches and
    saves (the profiler, on the CPU a recorder of every op, is held in
    the next tests)."""
    base = DEMO + ["--numRounds=10", "--debugIter=5", "--gapTarget=1e-3",
                   "--device=cpu", "--justCoCoA=false",
                   "--chkptIter=5"] + LOOPS[loop]
    on = [f"--events={tmp_path}/ev.jsonl", f"--metrics={tmp_path}/m.prom",
          "--trace", "--flightRecorder=on", "--eventsMaxMB=64",
          "--metricsInterval=0.5"]
    res = {}
    for tag, extra in (("on", on), ("off", [])):
        rc, res[tag] = cli.run(base + [f"--chkptDir={tmp_path}/{tag}"]
                               + extra)
        assert rc == 0
    assert [r.algorithm for r in res["on"]] == \
        [r.algorithm for r in res["off"]]
    for a, b in zip(res["on"], res["off"]):
        assert torch.equal(a.w, b.w), a.algorithm
        assert (a.alpha is None) == (b.alpha is None)
        if a.alpha is not None:
            assert torch.equal(a.alpha, b.alpha), a.algorithm
        assert a.trajectory.fetches == b.trajectory.fetches
        assert a.trajectory.saves == b.trajectory.saves
    check_both_schemas(tmp_path / "ev.jsonl")


def test_round_window_profiler(monkeypatch, tmp_path):
    """tests/test_telemetry.py:310 on the port, the profiler replaced:
    the window starts at the first eval >= 100 and stops at the first
    >= 200, once."""
    calls = []

    class Fake:
        def start(self):
            calls.append("start")

        def stop(self):
            calls.append("stop")

    monkeypatch.setattr(profiling, "profiler", Fake)
    monkeypatch.setattr(profiling, "export",
                        lambda prof, d: calls.append(("export", d)) or d)
    win = str(tmp_path / "win")
    prof = profiling.RoundWindowProfiler(win, 100, 200)
    events.get_bus().subscribe(prof)
    ev = collect(events.get_bus())
    ds_j, ds, n = coherent(seed=ROBUST_SEED)
    port_cocoa.run_cocoa(
        ds, Params(n=n, num_rounds=1600, local_iters=16, lam=LAM,
                   sigma=1.0), DebugParams(debug_iter=25, seed=0),
        plus=True, quiet=True, math="fast", gap_target=1e-3, rng="jax",
        sigma_schedule="anneal")
    prof.close()
    assert calls == ["start", "stop", ("export", win)]
    evals = [e["t"] for e in ev if e["event"] == "round_eval"]
    assert 100 in evals and 200 in evals


def test_cli_profile_records_the_cpu_activities(tmp_path, capsys):
    """--profile=DIR,START,STOP and --profile=DIR on the CPU: each writes
    one Chrome trace of the CPU activities (no device track here), and
    prints the JAX CLI's line."""
    for spec, line in (("win,5,10", "profiler trace of rounds [5, 10) "
                        "written to"),
                       ("whole", "profiler trace written to")):
        out_dir = tmp_path / spec.split(",")[0]
        argv = [a for a in DEMO if a != "--quiet"] + [
            "--numRounds=10", "--debugIter=5", "--device=cpu",
            f"--profile={out_dir}{spec[len(spec.split(',')[0]):]}"]
        rc, _ = cli.run(argv)
        assert rc == 0
        assert f"{line} {out_dir}" in capsys.readouterr().out
        traces = [f for f in os.listdir(out_dir)
                  if f.endswith(".pt.trace.json")]
        assert len(traces) == 1
        tracks = profiling.parse_trace(str(out_dir))
        assert any(t.startswith("cpu_op:") for t in tracks)
        rows, total = profiling.device_table(tracks)
        assert rows == [] and total == 0
    assert not events.get_bus().active()


def test_device_table_counts_kernels_once(tmp_path):
    """device_table keeps the kernel events of a torch.profiler Chrome
    trace, each once: the annotation that spans them and the flow events
    on the same device track are left out."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "kernel", "name": "sparse_sdca_round_kernel",
         "pid": 0, "tid": 7, "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "sparse_sdca_round_kernel",
         "pid": 0, "tid": 7, "ts": 20.0, "dur": 7.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "chunk",
         "pid": 0, "tid": 7, "ts": 9.0, "dur": 20.0},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 10.0, "id": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 1, "tid": 1, "ts": 8.0, "dur": 1.0}]}
    (tmp_path / "h_1.1.pt.trace.json").write_text(json.dumps(trace))
    rows, total = profiling.device_table(
        profiling.parse_trace(str(tmp_path)))
    assert rows == [("kernel:GPU 0/stream 7", "sparse_sdca_round_kernel",
                     12.0)]
    assert total == 12.0
    assert profiling.kernel_launches(str(tmp_path)) == \
        {"sparse_sdca_round_kernel": 2}


# --- the CLI's flag surface -------------------------------------------------------


MISUSE = [
    ["--trace"],
    ["--flightRecorder=on"],
    ["--flightRecorder=maybe", "--events=E"],
    ["--eventsMaxMB=0", "--events=E"],
    ["--eventsMaxMB=lots", "--events=E"],
    ["--eventsMaxMB=4"],
    ["--metricsInterval=1"],
    ["--metricsInterval=-1", "--metrics=M"],
    ["--metricsInterval=soon", "--metrics=M"],
    ["--profile=D,5"],
    ["--profile=D,a,b"],
    ["--profile=D,5,3"],
    ["--profile=D,0,3"],
]


@pytest.mark.parametrize("extra", MISUSE, ids=" ".join)
def test_cli_flag_misuse_matches_jax(extra, tmp_path, capsys):
    """Each misuse of the seven telemetry flags: exit 2 and the JAX CLI's
    error line, in both CLIs."""
    extra = [a.replace("=E", f"={tmp_path}/e.jsonl")
             .replace("=M", f"={tmp_path}/m.prom")
             .replace("=D,", f"={tmp_path}/prof,") for a in extra]
    lines = []
    for main, dev in ((jax_cli.main, ["--mesh=1"]),
                      (cli.main, ["--device=cpu"])):
        assert main(DEMO + ["--numRounds=2", "--debugIter=2"] + extra
                    + dev) == 2
        lines.append([ln for ln in capsys.readouterr().err.splitlines()
                      if ln.startswith("error:")])
    assert len(lines[1]) == 1 and lines[0] == lines[1]
    assert not os.listdir(tmp_path)


def test_cli_accepts_the_seven_flags(tmp_path, capsys):
    """The seven flags are no longer refused; the rest of the JAX CLI's
    unported flags still are, by name."""
    assert not {"events", "metrics", "trace", "flightRecorder",
                "eventsMaxMB", "metricsInterval", "profile"} & \
        set(cli._NOT_PORTED)
    assert cli.main(DEMO + ["--numRounds=2", "--debugIter=2",
                            "--device=cpu", "--fp=2"]) == 2
    assert "--fp is not yet ported" in capsys.readouterr().err
    rc = cli.main(DEMO + ["--numRounds=4", "--debugIter=2", "--device=cpu",
                          f"--events={tmp_path}/e.jsonl", "--trace",
                          "--flightRecorder", "--eventsMaxMB=1",
                          f"--metrics={tmp_path}/m.prom",
                          "--metricsInterval=0"])
    assert rc == 0
    check_both_schemas(tmp_path / "e.jsonl")
    text = (tmp_path / "m.prom").read_text()
    assert "cocoa_evals_total 4" in text
    assert 'cocoa_phase_seconds{phase="local_solve"}' in text
