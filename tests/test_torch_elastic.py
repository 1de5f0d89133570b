"""The port's elastic supervisor (cocoa_torch/elastic.py) and its CLI
branch against the JAX package's (cocoa_tpu/elastic.py,
cocoa_tpu/cli.py:743-953), on the CPU with no real worker.

Both packages' ``supervise`` run side by side on the same scripted
worker fates through a fake ``_spawn`` (tests/test_elastic.py,
tests/test_chaos.py:56-390): the spawned command lines, the exit code,
the ``on_restart`` calls (backoff floats included), the backoff sleeps,
the ``elastic: ...`` lines on stderr, the events (less ``ts`` and
``pid``), the victim's flight-recorder dump and the ``.gang`` gauges
must be equal.  Both CLIs then run with a spy on ``supervise``
(tests/test_overlap.py:300-310) for each ``--elastic`` and
``--stallTimeout`` spec: the same exit code, stderr lines and
supervisor keywords, and the same ``progress_token`` on the same
directories.  The port's own rules: a death by a signal names the
victim before an exit code seen in the same poll, ``devices=D`` above 1
is refused, and the supervisor branch never reaches ``torch.cuda`` or
the rendezvous.
"""

import json
import os
import random
import time
import types

import pytest

torch = pytest.importorskip("torch")

from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu import elastic as jax_elastic  # noqa: E402
from cocoa_tpu.telemetry import events as jax_events  # noqa: E402
from cocoa_tpu.telemetry import metrics as jax_metrics  # noqa: E402
from cocoa_tpu.telemetry import tracing as jax_tracing  # noqa: E402
from cocoa_torch import cli, elastic  # noqa: E402
from cocoa_torch.telemetry import events as port_events  # noqa: E402
from cocoa_torch.telemetry import metrics as port_metrics  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402
from cocoa_torch.telemetry import tracing as port_tracing  # noqa: E402

PACKAGES = {
    "jax": (jax_elastic, jax_events, jax_metrics, jax_tracing),
    "port": (elastic, port_events, port_metrics, port_tracing),
}
# what differs between two processes' records of the same decisions
VOLATILE = ("ts", "pid", "start_ts", "dur_s")


@pytest.fixture(autouse=True)
def clean_telemetry():
    for _, events, _, tracing in PACKAGES.values():
        events.get_bus().reset()
        tracing.reset()
    yield
    for _, events, _, tracing in PACKAGES.values():
        events.get_bus().reset()
        tracing.reset()


class Proc:
    """A scripted worker: ``poll`` returns ``codes[i]`` on its i-th call
    (the last one from then on; None is alive), ``send_signal`` kills."""

    def __init__(self, codes, log):
        self.codes = list(codes)
        self.calls = 0
        self.log = log
        self.killed = False

    def poll(self):
        if self.killed:
            return -9
        code = self.codes[min(self.calls, len(self.codes) - 1)]
        self.calls += 1
        return code

    def send_signal(self, sig):
        self.killed = True
        self.log.append(("kill", sig))

    def wait(self, timeout=None):
        return self.poll()


def _strip(rec, name):
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    man = out.get("flightrec_manifest")
    if man is not None:
        out["flightrec_manifest"] = {
            k: os.path.basename(v).replace(name, "NAME")
            if k == "victim_stream" else v
            for k, v in man.items() if k not in ("ts", "pid")}
    return out


def _read(path, name):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [_strip(json.loads(ln), name) for ln in f if ln.strip()]


def run_both(monkeypatch, capsys, tmp_path, fates, n, seed_events=(),
             gauges=False, trace=False, expect=None, **kw):
    """Each package's ``supervise(..., n, **kw)`` on the worker fates
    ``fates(generation, i, n, state)`` (a list of poll codes; ``state``
    a dict each run starts empty); returns the JAX run's record after
    asserting the port's equals it."""
    results = {}
    for name, (mod, events, metrics, tracing) in PACKAGES.items():
        spawned, log, sleeps, state = [], [], [], {}

        def spawn(worker_argv, i, n_, port, python, module, quiet_tail,
                  resume):
            if i == 0:
                state["gen"] = state.get("gen", -1) + 1
            spawned.append((list(worker_argv), i, n_, python, module,
                            quiet_tail, resume, type(port).__name__))
            return Proc(fates(state["gen"], i, n_, state), log)

        def sleep(s):
            if s > 0:
                sleeps.append(s)

        fake_time = types.SimpleNamespace(monotonic=time.monotonic,
                                          sleep=sleep)
        monkeypatch.setattr(mod, "_spawn", spawn)
        monkeypatch.setattr(mod, "time", fake_time)
        ev = tmp_path / f"{name}.jsonl"
        with open(ev, "w") as f:
            for rec in seed_events:
                f.write(json.dumps(rec) + "\n")
        bus = events.get_bus()
        bus.configure(jsonl_path=str(ev))
        gang = tmp_path / f"{name}.prom.gang"
        if gauges:
            bus.subscribe(metrics.MetricsWriter(str(gang), families="gang"))
        if trace:
            tracing.configure(enabled=True)
        restarts = []
        kw_run = dict(kw)
        if "progress_token" in kw_run:
            kw_run["progress_token"] = kw_run["progress_token"](state)
        try:
            rc = mod.supervise(
                ["--lambda=.01", *kw_run.pop("argv", [])], n, python="py",
                module="m", poll_s=0.0,
                on_restart=lambda *a: restarts.append(a), **kw_run)
        except expect or () as e:
            rc = (type(e).__name__, str(e))
        finally:
            bus.reset()
            tracing.reset()
        err = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("elastic:")]
        results[name] = dict(
            rc=rc, spawned=spawned, kills=len(log), restarts=restarts,
            sleeps=sleeps, err=err, events=_read(str(ev), name),
            flightrec={p: _read(str(tmp_path / p.replace("NAME", name)),
                                name) for p in ("NAME.jsonl.flightrec",
                                         "NAME.jsonl.p1.flightrec")},
            gang=gang.read_text() if gang.exists() else None)
        if trace and results[name]["events"]:
            spans = [r for r in results[name]["events"]
                     if r["event"] == "span"]
            assert spans and all(s.pop("span_id") for s in spans)
    assert results["port"] == results["jax"]
    return results["jax"]


def dead(code=3):
    return lambda gen, i, n, state: [code]


def wedged(gen, i, n, state):
    return [None]


def test_give_up_after_consecutive_failures(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 1,
                   max_restarts=1, backoff_base_s=0.0, resume=False)
    assert res["rc"] == 3 and len(res["spawned"]) == 2
    assert res["err"][-1] == ("elastic: giving up after 1 consecutive "
                              "failed (last exit code 3) generations")


def test_progress_resets_the_budget(monkeypatch, capsys, tmp_path):
    """The token changes for the first generations (the budget resets and
    the backoff streak with it), then stands still until the budget is
    spent; the backoffs are the same seeded floats in both."""
    def token(state):
        def tok():
            state["calls"] = state.get("calls", 0) + 1
            return min(state["calls"], 4)
        return tok

    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 1,
                   max_restarts=2, progress_token=token,
                   backoff_base_s=0.5, backoff_seed=7, resume=True)
    # three changed tokens reset the budget; two still ones spend it
    assert res["rc"] == 3 and len(res["spawned"]) == 5
    assert res["sleeps"] and res["sleeps"] == [r[4] for r in res["restarts"]]
    assert all(s[6] for s in res["spawned"])   # --resume on every worker


def test_stall_needs_a_token(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 1,
                   stall_timeout_s=1.0, resume=False, expect=ValueError)
    assert res["rc"][0] == "ValueError" and not res["spawned"]


def test_stall_watchdog_restarts_a_wedged_gang(monkeypatch, capsys,
                                               tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, wedged, 2,
                   max_restarts=1, resume=False, stall_timeout_s=0.05,
                   progress_token=lambda state: (lambda: 42),
                   backoff_base_s=0.0)
    assert res["rc"] == 1 and len(res["spawned"]) == 4 and res["kills"] == 4
    assert [e["reason"] for e in res["events"]
            if e["event"] == "restart"] == ["gang_stalled"]


def test_progress_keeps_the_gang_alive(monkeypatch, capsys, tmp_path):
    def fates(gen, i, n, state):
        return [None] * 21 + [0]

    def token(state):
        def tok():
            state["t"] = state.get("t", 0) + 1
            return state["t"]
        return tok

    res = run_both(monkeypatch, capsys, tmp_path, fates, 1, max_restarts=0,
                   resume=False, progress_token=token, stall_timeout_s=0.05,
                   backoff_base_s=0.0)
    assert res["rc"] == 0 and len(res["spawned"]) == 1


def test_shrink_after_the_budget(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 4,
                   max_restarts=1, resume=False, num_splits=8,
                   shrink="auto", backoff_base_s=0.0, trace=True)
    sizes = [s[2] for s in res["spawned"] if s[1] == 0]
    assert sizes == [4, 4, 2, 2, 1, 1] and res["rc"] == 3
    assert [(r[2], r[3]) for r in res["restarts"]] == [
        (4, 4), (4, 2), (2, 2), (2, 1), (1, 1)]
    gens = [(e["generation"], e["gang_size"]) for e in res["events"]
            if e["event"] == "span" and e["phase"] == "gang_generation"]
    assert gens == list(enumerate([4, 4, 2, 2, 1, 1], start=1))


def test_shrink_now(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 4,
                   max_restarts=1, resume=False, num_splits=8, shrink="now",
                   backoff_base_s=1.0, trace=True)
    assert [s[2] for s in res["spawned"] if s[1] == 0] == [4, 2, 1, 1]
    assert res["sleeps"] == [r[4] for r in res["restarts"]]
    assert [e["backoff_s"] for e in res["events"] if e["event"] == "span"
            and e["phase"] == "restart_backoff"] == res["sleeps"]


def test_shrink_now_spares_a_stall(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, wedged, 2,
                   max_restarts=1, resume=False, num_splits=4, shrink="now",
                   backoff_base_s=0.0,
                   progress_token=lambda state: (lambda: 42),
                   stall_timeout_s=0.01)
    assert [s[2] for s in res["spawned"] if s[1] == 0] == [2, 2, 1, 1]
    assert res["rc"] == 1


def test_shrink_rejects_a_non_divisor(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 2,
                   max_restarts=0, resume=False, num_splits=6, shrink="now",
                   devices_per_worker=4, backoff_base_s=0.0)
    assert res["rc"] == 3 and len(res["spawned"]) == 2
    assert "cannot reform the gang" in res["err"][0]
    assert "numSplits=6" in res["err"][0]


def test_shrink_strips_the_mesh(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 4,
                   argv=["--mesh=4"], max_restarts=0, resume=False,
                   num_splits=8, shrink="now", backoff_base_s=0.0)
    by_size = {s[2]: s[0] for s in res["spawned"]}
    assert "--mesh=4" in by_size[4] and "--mesh=4" not in by_size[2]
    assert any("dropping the explicit --mesh" in ln for ln in res["err"])


def test_gang_resize_events_and_schema(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 4,
                   max_restarts=0, resume=False, num_splits=8,
                   shrink="auto", backoff_base_s=0.0)
    assert schema.check_file(str(tmp_path / "port.jsonl")) == []
    resizes = [e for e in res["events"] if e["event"] == "gang_resize"]
    assert [(r["old_size"], r["new_size"]) for r in resizes] == [(4, 2),
                                                                 (2, 1)]
    restarts = [e for e in res["events"] if e["event"] == "restart"]
    assert restarts and all(r["attempt"] >= 1 for r in restarts)


def test_victim_flight_recorder_dump(monkeypatch, capsys, tmp_path):
    seed = [{"event": "checkpoint_write", "seq": t, "pid": 777,
             "ts": float(t), "algorithm": "ToyGang", "round": t,
             "path": "x"} for t in (5, 10)]
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 2,
                   seed_events=seed, max_restarts=0, resume=False,
                   num_splits=4, shrink="now", backoff_base_s=0.0)
    dump = res["flightrec"]["NAME.jsonl.flightrec"]
    man = dump[0]["flightrec_manifest"]
    assert man["reason"] == "worker_died" and man["victim_index"] == 0
    assert man["scope"] == "stream" and man["exit_code"] == 3
    assert schema.check_file(str(tmp_path / "port.jsonl.flightrec")) == []


def test_gang_gauges(monkeypatch, capsys, tmp_path):
    res = run_both(monkeypatch, capsys, tmp_path, dead(3), 4,
                   max_restarts=0, resume=False, num_splits=8,
                   shrink="now", backoff_base_s=0.5, gauges=True)
    assert "cocoa_gang_size 1" in res["gang"]
    assert "cocoa_gang_generations_total 3" in res["gang"]
    assert "cocoa_restart_backoff_seconds" in res["gang"]
    assert "cocoa_rounds_total" not in res["gang"]


def test_victim_is_the_signalled_worker(monkeypatch, tmp_path):
    """The port's rule where JAX's differs: a gloo survivor exits 1 in
    the poll that sees its peer's SIGKILL; the port names the killed
    worker 1, JAX the first failure in rank order, worker 0."""
    assert elastic.first_failure([1, -9]) == (1, -9)
    assert elastic.first_failure([None, 0, 3, 2]) == (2, 3)
    assert elastic.first_failure([-15, -9]) == (0, -15)
    assert elastic.first_failure([None, 0]) is None
    victims = {}
    for name, (mod, events, _, _) in PACKAGES.items():
        spawned = []

        def spawn(worker_argv, i, n, port, python, module, quiet_tail,
                  resume):
            proc = Proc([1 if i == 0 else -9], [])
            proc.pid = 1000 + i
            spawned.append(proc)
            return proc

        monkeypatch.setattr(mod, "_spawn", spawn)
        ev = tmp_path / f"{name}.jsonl"
        ev.write_text("")
        for i, stream in enumerate((ev, tmp_path / f"{name}.jsonl.p1")):
            stream.write_text(json.dumps(
                {"event": "checkpoint_write", "seq": 1, "pid": 1000 + i,
                 "ts": 1.0, "algorithm": "A", "round": 5,
                 "path": "x"}) + "\n")
        events.get_bus().configure(jsonl_path=str(ev))
        restarts = []
        victims[name + " rc"] = mod.supervise(
            [], 2, max_restarts=0, poll_s=0.0, resume=False,
            backoff_base_s=0.0, on_restart=lambda *a: restarts.append(a))
        events.get_bus().reset()
        dumps = [p for p in (f"{ev}.flightrec", f"{ev}.p1.flightrec")
                 if os.path.exists(p)]
        (dump,) = dumps
        with open(dump) as f:
            victims[name] = json.loads(f.readline())["flightrec_manifest"]
    assert (victims["jax rc"], victims["port rc"]) == (1, -9)
    assert victims["jax"]["victim_index"] == 0
    assert victims["jax"]["exit_code"] == 1
    assert victims["port"]["victim_index"] == 1
    assert victims["port"]["exit_code"] == -9
    assert victims["port"]["scope"] == "victim"


@pytest.mark.parametrize("k,current,devices", [
    (k, p, d) for k in (1, 2, 4, 5, 6, 8, 12, 16) for p in (1, 2, 3, 4, 8)
    for d in (1, 2, 4)])
def test_shrink_gang_size_grid(k, current, devices):
    assert elastic.shrink_gang_size(k, current, devices) == \
        jax_elastic.shrink_gang_size(k, current, devices)


def test_backoff_sequence_grid():
    for seed in range(5):
        for base, cap, jitter in ((1.0, 60.0, 0.5), (0.5, 4.0, 0.0),
                                  (0.0, 8.0, 0.5), (2.0, 3.0, 1.0)):
            rj, rp = random.Random(seed), random.Random(seed)
            assert [jax_elastic.backoff_seconds(s, base, cap, jitter, rj)
                    for s in range(0, 9)] == \
                [elastic.backoff_seconds(s, base, cap, jitter, rp)
                 for s in range(0, 9)]


@pytest.mark.parametrize("argv", [
    ["--trainFile=x", "--elastic=2", "--master=h:1", "--resume",
     "--processId=0", "--numProcesses=2", "--lambda=.01"],
    ["--elastic=shrink", "--stallTimeout=60", "--mesh=2", "-resume=false"],
    ["elastic=3", "--numProcesses", "--chkptDir=d", "--stallTimeoutX=1"],
    [],
])
def test_strip_elastic_flags(argv):
    assert elastic.strip_elastic_flags(argv) == \
        jax_elastic.strip_elastic_flags(argv)


def test_worker_environment(monkeypatch):
    """A worker finds the package from any directory, keeps the
    caller's path after it, and binds gloo to the loopback unless told
    otherwise."""
    monkeypatch.setenv("PYTHONPATH", "/a:/b")
    monkeypatch.delenv("GLOO_SOCKET_IFNAME", raising=False)
    monkeypatch.delenv("NCCL_SOCKET_IFNAME", raising=False)
    env = elastic.worker_env()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        elastic.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep) == [root, "/a", "/b"]
    assert env["GLOO_SOCKET_IFNAME"] == env["NCCL_SOCKET_IFNAME"] == "lo"
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "eth9")
    assert elastic.worker_env()["GLOO_SOCKET_IFNAME"] == "eth9"
    monkeypatch.setenv("PYTHONPATH", root)
    assert elastic.worker_env()["PYTHONPATH"] == root


# --- the CLI branch -------------------------------------------------------------


def _spy(monkeypatch, target):
    calls = {}

    def spy(worker_argv, n_workers, **kw):
        calls["argv"] = list(worker_argv)
        calls["n"] = n_workers
        calls.update(kw)
        return 0

    monkeypatch.setattr(target, spy)
    return calls


BASE = ["--trainFile=x.dat", "--numFeatures=10", "--numSplits=4"]

SPECS = [
    ["--elastic=2"],
    ["--elastic=2,shrink", "--chkptDir=CK"],
    ["--elastic=shrink", "--numProcesses=3", "--chkptDir=CK"],
    ["--elastic=1,devices=1", "--chkptDir=CK"],
    ["--elastic=shrink"],
    ["--elastic=two"],
    ["--elastic"],
    ["--elastic=0"],
    ["--elastic=2,devices=0"],
    ["--elastic=2,devices=x"],
    ["--elastic=shrink", "--numProcesses=x"],
    ["--elastic=2", "--numProcesses=x", "--chkptDir=CK"],
    ["--stallTimeout=60"],
    ["--stallTimeout=60", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=300", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=60", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=0", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=-5", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=abc", "--chkptDir=CK"],
    ["--elastic=2", "--stallTimeout=300"],
    ["--elastic=2", "--stallTimeout=300", "--metrics=M"],
    ["--elastic=2", "--stallTimeout=300", "--metrics=M",
     "--metricsInterval=200"],
    ["--elastic=2", "--stallTimeout=300", "--metrics=M",
     "--metricsInterval=100", "--chkptDir=CK"],
    ["--elastic=2", "--chkptDir=CK", "--resume", "--master=h:1",
     "--processId=0", "--numProcesses=2", "--lambda=.01", "--mesh=2"],
    ["--elastic=2", "--chkptDir=CK", "--events=EV", "--metrics=M",
     "--trace"],
]


def _both_clis(monkeypatch, capsys, argv):
    """(rc, stderr lines, supervisor keywords) of the JAX CLI and of the
    port's (which takes --device=cpu on top; its workers get it)."""
    out = []
    for main, target, extra in (
            (jax_cli.main, "cocoa_tpu.elastic.supervise", []),
            (cli.main, "cocoa_torch.elastic.supervise", ["--device=cpu"])):
        calls = _spy(monkeypatch, target)
        rc = main(argv + extra)
        err = capsys.readouterr().err.splitlines()
        if "argv" in calls:
            calls["argv"] = [a for a in calls["argv"] if a not in extra]
        out.append((rc, err, calls))
        jax_events.get_bus().reset()
        jax_tracing.reset()
    return out


@pytest.mark.parametrize("spec", SPECS, ids=[" ".join(s) for s in SPECS])
def test_cli_specs_match_jax(monkeypatch, capsys, tmp_path, spec):
    subs = {"CK": str(tmp_path / "ck"), "M": str(tmp_path / "m.prom"),
            "EV": str(tmp_path / "ev.jsonl")}
    argv = BASE + [a.replace("=CK", "=" + subs["CK"])
                   .replace("=M", "=" + subs["M"])
                   .replace("=EV", "=" + subs["EV"]) for a in spec]
    (rc_j, err_j, kw_j), (rc_p, err_p, kw_p) = _both_clis(
        monkeypatch, capsys, argv)
    assert rc_p == rc_j
    assert err_p == err_j
    tok_j, tok_p = kw_j.pop("progress_token", None), kw_p.pop(
        "progress_token", None)
    assert kw_p == kw_j
    if tok_j is None:
        assert tok_p is None
        return
    # the two tokens on the same directories, as they fill
    assert tok_p() == tok_j()
    os.makedirs(subs["CK"], exist_ok=True)
    assert tok_p() == tok_j()
    for name in ("CoCoA+-r000010.npz", "CoCoA+-r000010.npz.json",
                 "CoCoA-r000020.npz"):
        open(os.path.join(subs["CK"], name), "w").close()
        assert tok_p() == tok_j()
    with open(subs["M"], "w") as f:
        f.write("cocoa_rounds_total 10\n")
    assert tok_p() == tok_j()


def test_cli_refuses_several_devices_a_worker(monkeypatch, capsys):
    """``devices=D`` above 1: JAX shrinks by D devices a worker; the port
    runs one card a worker and refuses it."""
    calls = _spy(monkeypatch, "cocoa_torch.elastic.supervise")
    assert cli.main(BASE + ["--elastic=2,shrink,devices=4",
                            "--device=cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: --elastic devices=4: a port worker "
                          "drives one card") and not calls
    calls = _spy(monkeypatch, "cocoa_tpu.elastic.supervise")
    assert jax_cli.main(BASE + ["--elastic=2,shrink,devices=4"]) == 0
    assert calls["devices_per_worker"] == 4


def test_cli_supervisor_touches_no_device(monkeypatch, capsys, tmp_path):
    """The supervisor branch returns before a device is resolved, a shard
    built or the rendezvous joined: with every such call made to raise
    (and no --device=cpu on a box without CUDA) it hands the gang to
    ``supervise``, and the bus and tracer are put back after."""
    def boom(*a, **k):
        raise AssertionError("the supervisor reached a device or the gang")

    for name in ("init", "is_available", "device_count", "_lazy_init",
                 "set_device", "current_device"):
        monkeypatch.setattr(torch.cuda, name, boom)
    from cocoa_torch.parallel import distributed

    monkeypatch.setattr(distributed, "maybe_initialize", boom)
    monkeypatch.setattr(cli, "resolve_device", boom)
    monkeypatch.setattr(cli, "shard_dataset", boom)
    monkeypatch.setattr(cli.ingest_lib, "stream_shard_dataset", boom)
    calls = _spy(monkeypatch, "cocoa_torch.elastic.supervise")
    ev = str(tmp_path / "ev.jsonl")
    assert cli.main(BASE + ["--elastic=2", f"--chkptDir={tmp_path}",
                            f"--events={ev}", "--trace"]) == 0
    assert calls["n"] == 2 and "--events=" + ev in calls["argv"]
    assert not torch.cuda.is_initialized()
    assert port_events.get_bus().jsonl_path is None
    assert not port_tracing.get_tracer().enabled
