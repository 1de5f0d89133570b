"""The port's elastic supervisor under real faults (the counterpart of
tests/test_chaos.py's gang cases, tests/test_multihost.py's watchdog,
tests/test_serving.py's and tests/test_slab_cache.py's elastic pins and
tests/test_tracing.py's gang streams).

Real gloo processes on the CPU: the toy gang (tests/torch_elastic_worker.py,
one all-reduce a round, checkpoints through ``cocoa_torch.checkpoint``)
and the port's CLI, each supervised by ``cocoa_torch.elastic.supervise``
and faulted through tests/_faults.py (SIGKILL, SIGSTOP, a torn newest
checkpoint).  A killed, shrunk and resumed run ends on the unfailed
run's state bit for bit; the CLI's unfailed gang is held to the JAX
CLI's single-process run at 1e-12.  The toy SIGKILL case and the CLI's
K = 2 case run in tier 1; the rest are marked slow, as their JAX
counterparts are.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _faults import (Fault, FaultPlan, checkpoint_at_least,  # noqa: E402
                     sigkill, sigstop, truncate_newest_checkpoint)
from conftest import DEMO_NUM_FEATURES, SMALL_TRAIN  # noqa: E402
from cocoa_torch import checkpoint, elastic  # noqa: E402
from cocoa_torch.telemetry import events as tele_events  # noqa: E402
from cocoa_torch.telemetry import schema, trace_report, tracing  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
import torch_elastic_worker as toy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def clean_bus():
    tele_events.get_bus().reset()
    tracing.reset()
    yield tele_events.get_bus()
    tele_events.get_bus().reset()
    tracing.reset()


@pytest.fixture(autouse=True)
def gang_env(monkeypatch):
    """Workers find the toy module and stay on one thread each."""
    monkeypatch.setenv(
        "PYTHONPATH",
        f"{ROOT}{os.pathsep}{TESTS}{os.pathsep}"
        f"{os.environ.get('PYTHONPATH', '')}")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


# --- the toy gang -------------------------------------------------------------


def _toy_argv(ckdir, k=4, rounds=20, step_s=0.05, extra=()):
    return [f"--chkptDir={ckdir}", f"--numSplits={k}",
            f"--numRounds={rounds}", "--chkptIter=5",
            f"--stepSeconds={step_s}", *extra]


def _toy_w(k, rounds):
    """The toy's final w, as any gang size reaches it."""
    w = np.zeros(k, np.float64)
    for t in range(1, rounds + 1):
        w = w + toy.round_increments(t, k, 0, k)
    return w


def _toy_supervise(argv, n=2, **kw):
    opts = dict(module="torch_elastic_worker", max_restarts=0, poll_s=0.05,
                backoff_base_s=0.0)
    opts.update(kw)
    return elastic.supervise(argv, n, **opts)


def _toy_final(ckdir, algorithm="ToyGang"):
    meta, w, _ = checkpoint.load(checkpoint.latest(str(ckdir), algorithm))
    return meta["round"], np.asarray(w)


def _run_toy_control(ckdir, k=4, rounds=20, step_s=0.05):
    assert _toy_supervise(_toy_argv(ckdir, k, rounds, step_s)) == 0
    return _toy_final(ckdir)


def _tear_once_on_restart(ckdir):
    """on_restart hook: tear the newest checkpoint once, with the gang
    down and before the relaunch (no writer can replace the torn file)."""
    done = []

    def hook(gen, reason, old, new, backoff):
        if not done:
            truncate_newest_checkpoint(ckdir)([])
            done.append(gen)
    return hook


def test_gang_sigkill_shrinks_to_survivor_bit_identical(tmp_path,
                                                        clean_bus):
    """A 2-process gloo gang loses worker 1 to SIGKILL mid-run; the
    supervisor reforms it at P' = 1, which resumes and ends bit for bit
    on the unfailed gang's w (and on the closed form).  The supervisor
    dumps the victim's stream to ``<events>.p1.flightrec``: worker 0's
    gloo all-reduce fails at once and exits 1 in the same poll, and the
    death by a signal names the victim."""
    ck = tmp_path / "ck"
    ev = tmp_path / "events.jsonl"
    clean_bus.configure(jsonl_path=str(ev))
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(1),),
                           trigger=checkpoint_at_least(ck, "ToyGang", 5),
                           name="kill-worker-1"), poll_s=0.02)
    resizes = []
    rc = _toy_supervise(
        _toy_argv(ck, extra=(f"--events={ev}", "--trace")), max_restarts=3,
        num_splits=4, shrink="now", on_generation=plan.on_generation,
        on_restart=lambda gen, reason, old, new, backoff:
            resizes.append((reason, old, new)))
    plan.join()
    assert rc == 0
    assert plan.errors == [] and plan.fired == ["kill-worker-1"]
    assert resizes == [("worker_died", 2, 1)]
    rounds, w = _toy_final(ck)
    assert rounds == 20
    rounds_c, w_c = _run_toy_control(tmp_path / "ref")
    assert rounds_c == 20
    np.testing.assert_array_equal(w, w_c)
    np.testing.assert_array_equal(w, _toy_w(4, 20))

    assert schema.check_file(str(ev)) == []
    recs = _records(ev)
    (resize,) = [r for r in recs if r["event"] == "gang_resize"]
    assert (resize["old_size"], resize["new_size"]) == (2, 1)
    assert resize["exit_code"] == -9
    frec = str(ev) + ".p1.flightrec"
    assert schema.check_file(frec) == []
    frecs = _records(frec)
    man = frecs[0]["flightrec_manifest"]
    assert man["reason"] == "worker_died" and man["source"] == "supervisor"
    assert man["victim_index"] == 1 and man["exit_code"] == -9
    assert man["scope"] == "victim"
    assert frecs[1:] and {r["pid"] for r in frecs[1:]} == {man["victim_pid"]}
    assert any(r["event"] == "span" for r in frecs[1:])


@pytest.mark.slow
def test_gang_kill_plus_torn_checkpoint_resumes_previous(tmp_path, capfd):
    """The same loss with the newest checkpoint also torn (between the
    teardown and the relaunch): the survivor falls back one generation,
    replays the rounds, and still ends on the control's w."""
    ck = tmp_path / "ck"
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(1),),
                           trigger=checkpoint_at_least(ck, "ToyGang", 10),
                           name="kill-worker-1"), poll_s=0.02)
    rc = _toy_supervise(_toy_argv(ck, step_s=0.15), max_restarts=3,
                        num_splits=4, shrink="now",
                        on_generation=plan.on_generation,
                        on_restart=_tear_once_on_restart(ck))
    plan.join()
    assert rc == 0
    assert plan.errors == [] and plan.fired == ["kill-worker-1"]
    assert "resuming ToyGang from round 5" in capfd.readouterr().out
    rounds, w = _toy_final(ck)
    assert rounds == 20
    np.testing.assert_array_equal(w, _run_toy_control(tmp_path / "ref")[1])


@pytest.mark.slow
def test_stall_watchdog_recovers_sigstopped_worker(tmp_path, clean_bus):
    """SIGSTOP worker 1: every process stays alive and the checkpoints
    stop.  The watchdog kills the gang after ``stall_timeout_s`` and
    relaunches it at the same size (``shrink="now"`` spares a stall),
    and the run ends on the closed-form w."""
    ck = tmp_path / "ck"
    ev = tmp_path / "events.jsonl"
    clean_bus.configure(jsonl_path=str(ev))
    plan = FaultPlan(Fault(generation=0, actions=(sigstop(1),),
                           trigger=checkpoint_at_least(ck, "ToyGang", 5),
                           name="stop-worker-1"), poll_s=0.02)

    def token():
        if not ck.is_dir():
            return None
        return tuple(sorted(f for f in os.listdir(ck) if f.endswith(".npz")))

    sizes = []
    rc = _toy_supervise(_toy_argv(ck, extra=(f"--events={ev}",)),
                        max_restarts=3, num_splits=4,
                        shrink="now", progress_token=token,
                        stall_timeout_s=8.0,
                        on_generation=lambda gen, procs: (
                            sizes.append(len(procs)),
                            plan.on_generation(gen, procs)))
    plan.join()
    assert rc == 0
    assert plan.errors == [] and plan.fired == ["stop-worker-1"]
    assert sizes == [2, 2]
    rounds, w = _toy_final(ck)
    assert rounds == 20
    np.testing.assert_array_equal(w, _toy_w(4, 20))
    recs = _records(ev)
    restarts = [r for r in recs if r["event"] == "restart"]
    assert [r["reason"] for r in restarts] == ["gang_stalled"]
    assert not [r for r in recs if r["event"] == "gang_resize"]
    frec = _records(str(ev) + ".flightrec")[0]["flightrec_manifest"]
    assert frec["reason"] == "gang_stalled" and frec["victim_index"] == 0


# --- the CLI gang -------------------------------------------------------------


def _cli_argv(train, ckdir, ev, rounds, cache_dir=None):
    argv = [f"--trainFile={train}", "--numFeatures=64",
            f"--numRounds={rounds}", "--localIterFrac=0.2", "--numSplits=2",
            "--lambda=.01", "--justCoCoA=true", "--debugIter=10",
            f"--chkptDir={ckdir}", "--chkptIter=10", "--dtype=float64",
            f"--events={ev}", "--quiet", "--device=cpu"]
    if cache_dir is not None:
        argv.append(f"--ingestCache={cache_dir}")
    return argv


def _final_gaps(ev_path):
    """The last run_end gap of each algorithm in an events file."""
    return {r["algorithm"]: r["gap"] for r in _records(ev_path)
            if r["event"] == "run_end" and r.get("gap") is not None}


CLI_ROUNDS = 400   # the kill lands near round 10, far from the end


def test_chaos_cli_gang_shrink_bit_identical(tmp_path, clean_bus):
    """The port's CLI as a 2-process gloo gang at K = 2 with
    ``--ingestCache``: worker 1 is SIGKILLed once CoCoA+ has saved round
    10; the gang reforms at 1 and its final (w, alpha, gap) for CoCoA+
    and CoCoA equal the unfailed, uncached gang's bit for bit (at K = 2
    a gang of 2 and of 1 add the two shards' dw in one add either way).
    The reformed generation's ingest is a cache hit that reads no byte.
    The unfailed gang is within 1e-12 of the JAX CLI's single-process
    run of the same flags."""
    from cocoa_tpu import checkpoint as jax_ckpt
    from cocoa_tpu import cli as jax_cli
    from cocoa_tpu.data.synth import synth_sparse, write_libsvm

    data = synth_sparse(96, 64, nnz_mean=8, seed=2)
    train = tmp_path / "train.dat"
    write_libsvm(data, str(train))

    ck, ev = tmp_path / "ck", tmp_path / "events.jsonl"
    clean_bus.configure(jsonl_path=str(ev))
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(1),),
                           trigger=checkpoint_at_least(ck, "CoCoA+", 10),
                           name="chaos"), poll_s=0.005)
    rc = elastic.supervise(
        _cli_argv(train, ck, ev, CLI_ROUNDS, cache_dir=tmp_path / "cache"),
        2, max_restarts=3, poll_s=0.05, num_splits=2, shrink="now",
        backoff_base_s=0.0, on_generation=plan.on_generation)
    plan.join()
    assert rc == 0
    assert plan.errors == [] and plan.fired == ["chaos"]

    ck_ref, ev_ref = tmp_path / "ck_ref", tmp_path / "events_ref.jsonl"
    rc_ref = elastic.supervise(_cli_argv(train, ck_ref, ev_ref, CLI_ROUNDS),
                               2, max_restarts=0, poll_s=0.05,
                               backoff_base_s=0.0)
    assert rc_ref == 0
    states = {}
    for alg in ("CoCoA+", "CoCoA"):
        meta, w, a = checkpoint.load(checkpoint.latest(str(ck), alg))
        meta_r, w_r, a_r = checkpoint.load(checkpoint.latest(str(ck_ref),
                                                             alg))
        assert meta["round"] == meta_r["round"] == CLI_ROUNDS
        np.testing.assert_array_equal(w, w_r)
        np.testing.assert_array_equal(a, a_r)
        states[alg] = (w_r, a_r)
    assert _final_gaps(ev) == _final_gaps(ev_ref)
    assert set(_final_gaps(ev)) == {"CoCoA+", "CoCoA"}

    assert schema.check_file(str(ev)) == []
    recs = _records(ev)
    resizes = [r for r in recs if r["event"] == "gang_resize"]
    assert [(r["old_size"], r["new_size"]) for r in resizes] == [(2, 1)]
    ingests = [r for r in recs if r["event"] == "ingest"]
    assert ingests[0]["cache"] == "miss" and ingests[0]["bytes_read"] > 0
    assert ingests[-1]["cache"] == "hit" and ingests[-1]["bytes_read"] == 0
    resumed = [r for r in recs if r["event"] == "run_start"][-1]
    assert resumed["manifest"]["process_count"] == 1

    # the unfailed gang against the JAX CLI in one process
    ck_j = tmp_path / "ck_jax"
    argv_j = [a for a in _cli_argv(train, ck_j, tmp_path / "ev_j.jsonl",
                                   CLI_ROUNDS)
              if not a.startswith("--device")] + ["--mesh=1"]
    assert jax_cli.main(argv_j) == 0
    for alg, (w_r, a_r) in states.items():
        meta_j, w_j, a_j = jax_ckpt.load(jax_ckpt.latest(str(ck_j), alg))
        assert meta_j["round"] == CLI_ROUNDS
        w_j, a_j = np.asarray(w_j), np.asarray(a_j)
        np.testing.assert_allclose(w_r, w_j, rtol=1e-12,
                                   atol=1e-12 * np.abs(w_j).max())
        np.testing.assert_allclose(a_r, a_j[:, :a_r.shape[1]], rtol=1e-12,
                                   atol=1e-12)
        assert not a_j[:, a_r.shape[1]:].any()
    # the gap to 1e-12 of the primal, which is at most 1 here (hinge, w=0)
    gaps_j = _final_gaps(tmp_path / "ev_j.jsonl")
    for alg, gap in _final_gaps(ev_ref).items():
        assert abs(gap - gaps_j[alg]) <= 1e-12


@pytest.mark.slow
def test_one_worker_restart_reingests_warm_zero_bytes(tmp_path, clean_bus):
    """A supervised one-worker CLI run with ``--ingestCache`` loses its
    worker to SIGKILL mid-run; the relaunched generation re-ingests from
    the cache alone (``cache: hit``, no byte read, no row parsed) and
    the run completes its rounds."""
    ck, ev = tmp_path / "ck", tmp_path / "events.jsonl"
    argv = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
            "--numSplits=4", "--numRounds=400", "--debugIter=10",
            "--localIterFrac=0.05", "--lambda=0.001", "--justCoCoA=true",
            f"--chkptDir={ck}", "--chkptIter=10", "--quiet",
            f"--ingestCache={tmp_path / 'cache'}", f"--events={ev}",
            "--device=cpu"]
    clean_bus.configure(jsonl_path=str(ev))
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(0),),
                           trigger=checkpoint_at_least(ck, "CoCoA+", 10),
                           name="kill-worker"), poll_s=0.005)
    rc = elastic.supervise(argv, 1, max_restarts=3, poll_s=0.05,
                           backoff_base_s=0.0,
                           on_generation=plan.on_generation)
    plan.join()
    assert rc == 0
    assert plan.errors == [] and plan.fired == ["kill-worker"]
    meta, _, _ = checkpoint.load(checkpoint.latest(str(ck), "CoCoA+"))
    assert meta["round"] == 400
    assert schema.check_file(str(ev)) == []
    recs = _records(ev)
    assert [r["reason"] for r in recs if r["event"] == "restart"] == [
        "worker_died"]
    ingests = [r for r in recs if r["event"] == "ingest"]
    assert len(ingests) >= 2
    assert ingests[0]["cache"] == "miss" and ingests[0]["bytes_read"] > 0
    assert ingests[-1]["cache"] == "hit"
    assert ingests[-1]["bytes_read"] == 0 and ingests[-1]["rows"] == 0
    caches = [r for r in recs if r["event"] == "ingest_cache"]
    assert caches[-1]["status"] == "hit"
    assert caches[-1]["shards_cached"] == caches[-1]["shards_total"] == 4


def _ask(sock_file, line):
    sock_file.write(line + "\n")
    sock_file.flush()
    return json.loads(sock_file.readline())


@pytest.mark.slow
def test_serve_answers_through_the_gang_shrink(tmp_path):
    """A ``--serve`` process (the port's CLI) points at the checkpoint
    directory of a toy gang that writes CoCoA+ generations; worker 1 is
    SIGKILLed and the gang shrinks to 1.  Every line sent through the
    kill is answered with the model of the round it names, and the
    server swaps in the reformed gang's first save."""
    ck = tmp_path / "ck"
    k, rounds = 4, 40
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(1),),
                           trigger=checkpoint_at_least(ck, "CoCoA+", 10),
                           name="kill-worker-1"), poll_s=0.02)
    resumed = []

    def on_restart(gen, reason, old, new, backoff):
        meta, _, _ = checkpoint.load(checkpoint.latest(str(ck), "CoCoA+"))
        resumed.append(meta["round"])

    box = {}

    def run_gang():
        box["rc"] = _toy_supervise(
            _toy_argv(ck, k, rounds, step_s=0.1,
                      extra=("--algorithm=CoCoA+",)),
            max_restarts=3, num_splits=k, shrink="now", backoff_base_s=0.2,
            on_generation=plan.on_generation, on_restart=on_restart)

    gang = threading.Thread(target=run_gang, daemon=True)
    gang.start()
    server = subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", "--serve=0",
         f"--chkptDir={ck}", f"--numFeatures={k}", "--device=cpu"],
        cwd=ROOT, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    head = []
    try:
        for line in server.stdout:
            head.append(line)
            if "listening on" in line:
                host, port = line.split("listening on ")[1].split()[0] \
                    .split(":")
                break
        conn = socket.create_connection((host, int(port)), timeout=30)
        f = conn.makefile("rw")
        query = " ".join(f"{j + 1}:1" for j in range(k))
        answers = []
        while gang.is_alive():
            answers.append(_ask(f, query))
            time.sleep(0.02)
        deadline = time.monotonic() + 30
        while answers[-1].get("round") != rounds \
                and time.monotonic() < deadline:
            time.sleep(0.1)
            answers.append(_ask(f, query))
        assert _ask(f, "shutdown") is not None
        conn.close()
        out, _ = server.communicate(timeout=30)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    gang.join(60)
    plan.join()
    assert box.get("rc") == 0
    assert plan.errors == [] and plan.fired == ["kill-worker-1"]
    assert len(resumed) == 1
    assert len(answers) > 20
    assert all("margin" in a for a in answers), \
        [a for a in answers if "margin" not in a][:3]
    for a in answers:
        want = np.float32(np.sum(_toy_w(k, a["round"]).astype(np.float32)))
        np.testing.assert_allclose(a["margin"], want, rtol=1e-5)
    assert answers[-1]["round"] == rounds
    assert {a["round"] for a in answers} & set(range(resumed[0] + 1,
                                                     rounds + 1))
    swaps = "".join(head) + out
    assert f"serve: hot-swapped to r{resumed[0] + 5} " in swaps


@pytest.mark.slow
def test_supervisor_spans_and_gang_metrics(tmp_path, clean_bus):
    """With ``--trace`` the supervisor's ``gang_generation`` and
    ``restart_backoff`` spans join worker 0's stream with no worker tag,
    and ``trace_report`` places them under the supervisor's pid beside
    the workers' spans; its gauges go to ``<metrics>.gang`` alone and
    worker 0's ``<metrics>`` holds no gang family."""
    ck = tmp_path / "ck"
    ev, prom = str(tmp_path / "events.jsonl"), str(tmp_path / "m.prom")
    clean_bus.configure(jsonl_path=ev)
    clean_bus.subscribe(MetricsWriter(prom + ".gang", families="gang"))
    tracing.configure(enabled=True)
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(1),),
                           trigger=checkpoint_at_least(ck, "ToyGang", 5),
                           name="kill-worker-1"), poll_s=0.02)
    rc = _toy_supervise(
        _toy_argv(ck, rounds=12, step_s=0.02,
                  extra=(f"--events={ev}", "--trace", f"--metrics={prom}")),
        max_restarts=3, num_splits=4, shrink="now", backoff_base_s=0.2,
        on_generation=plan.on_generation)
    plan.join()
    assert rc == 0 and plan.fired == ["kill-worker-1"]
    streams = [ev, ev + ".p1"]
    for s in streams:
        assert schema.check_file(s) == []
    spans = trace_report.load_spans(streams)
    mine = [s for s in spans if s["pid"] == os.getpid()]
    assert sorted(s["phase"] for s in mine) == [
        "gang_generation", "gang_generation", "restart_backoff"]
    assert all(s.get("worker") is None
               and trace_report.worker_of(s) == os.getpid() for s in mine)
    gens = sorted((s["generation"], s["gang_size"]) for s in mine
                  if s["phase"] == "gang_generation")
    assert gens == [(1, 2), (2, 1)]
    (backoff,) = [s for s in mine if s["phase"] == "restart_backoff"]
    assert backoff["generation"] == 1 and backoff["backoff_s"] > 0
    assert {trace_report.worker_of(s) for s in spans} == {0, 1, os.getpid()}
    trace = trace_report.chrome_trace(spans)
    assert trace_report.check_chrome_trace(trace) == []
    pids = {e["pid"] for e in trace["traceEvents"] if e.get("ph") == "X"
            and e["name"] in ("gang_generation", "restart_backoff")}
    assert pids == {os.getpid()}
    assert f"from 3 worker(s) [0, 1, {os.getpid()}]" in \
        trace_report.render_report(spans)

    def families(text):
        return {ln.split(" ", 1)[0].split("{", 1)[0]
                for ln in text.splitlines() if ln and not ln.startswith("#")}

    gang_text = open(prom + ".gang").read()
    assert "cocoa_gang_size 1" in gang_text
    assert "cocoa_gang_generations_total 2" in gang_text
    assert "cocoa_restart_backoff_seconds" in gang_text
    assert families(gang_text) == {"cocoa_gang_size",
                                   "cocoa_gang_generations_total",
                                   "cocoa_restart_backoff_seconds"}
    assert not families(open(prom).read()) & families(gang_text)
