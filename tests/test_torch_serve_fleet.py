"""The port's serving fleet on the CPU: the router over in-process port
servers (routes, sheds, requeues), ``--serveReplicas=2`` through the CLI
with two ``--device=cpu`` replica processes, one SIGKILLed and respawned
under traffic, ``--statusPort``'s plane, and ``--traceSample``; the ops
plane's merge, gauges, latency totals and SLO tracker held against the
JAX package's (cocoa_tpu/telemetry/aggregate.py) on the same textfiles.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from cocoa_tpu.telemetry import aggregate as jax_aggregate  # noqa: E402
from cocoa_torch import checkpoint, serving  # noqa: E402
from cocoa_torch.telemetry import aggregate  # noqa: E402
from cocoa_torch.telemetry import events as tele_events  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 24


@pytest.fixture
def bus(tmp_path):
    b = tele_events.get_bus()
    b.reset()
    path = tmp_path / "events.jsonl"
    b.configure(jsonl_path=str(path))
    yield path
    b.reset()


def _read(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _catalogue(ck, W, round_t=10):
    checkpoint.save(str(ck), "CoCoA+", round_t, W, None, gap=1e-3,
                    tenant_gaps=[1e-3] * W.shape[0],
                    tenant_cert_ts=[1000.0 + t for t in range(W.shape[0])])


def _stack(ck, n_tenants=None):
    w, info = serving.load_model(checkpoint.latest(str(ck), "CoCoA+"))
    slots = serving.ModelSlots(w, info, device="cpu")
    scorer = serving.BatchScorer(D, buckets=(4, 16), max_nnz=8,
                                 n_tenants=n_tenants, device="cpu")
    w_dev, scale, _, form = slots.current()
    scorer.warmup(w_dev, scale, form)
    return slots, scorer, serving.MicroBatcher(scorer, slots, sla_s=0.05,
                                               algorithm="CoCoA+")


def _server(batcher, **kw):
    srv = serving.MarginServer(batcher, D, 8, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _raw(addr, lines):
    """The raw response line of each request line, on one connection."""
    with socket.create_connection(addr, timeout=30) as s:
        f = s.makefile("rwb")
        out = []
        for line in lines:
            f.write((line + "\n").encode())
            f.flush()
            out.append(f.readline())
        return out


def _ask(addr, line):
    return json.loads(_raw(addr, [line])[0])


def _line(qi, qv, tenant=None):
    head = "" if tenant is None else f"tenant={tenant};"
    return head + " ".join(f"{int(i) + 1}:{float(v)!r}"
                           for i, v in zip(qi, qv))


def _queries(rng, n):
    out = []
    for _ in range(n):
        nnz = int(rng.integers(1, 9))
        idx = np.sort(rng.choice(D, size=nnz, replace=False)).astype(np.int32)
        out.append((idx, rng.standard_normal(nnz)))
    return out


# --- the router over in-process servers --------------------------------------


def test_router_routes_requeues_and_sheds(tmp_path, bus):
    T = 4
    rng = np.random.default_rng(11)
    W = rng.standard_normal((T, D)).astype(np.float32)
    _catalogue(tmp_path, W)
    stacks = [_stack(tmp_path, T) for _ in range(2)]
    servers = [_server(s[2], n_tenants=T) for s in stacks]
    router = serving.Router([(f"r{i}", srv.address)
                             for i, srv in enumerate(servers)],
                            sla_s=0.5, route="tenant")
    threading.Thread(target=router.serve_forever, daemon=True).start()
    router.emit_initial_state()
    revive = None
    try:
        queries = _queries(rng, 4)
        for t in range(T):
            for qi, qv in queries:
                got = _ask(router.address, _line(qi, qv, t))
                want = stacks[0][2].score_sync(qi, qv, timeout=10.0,
                                               tenant=t)
                assert got["margin"] == want and got["tenant"] == t
        # tenant affinity: t % 2 is each tenant's home replica
        served = [s[2].requests_total for s in stacks]
        assert served[0] >= 2 * len(queries) and served[1] >= 2 * len(queries)
        # r0 killed as a SIGKILL looks from the router
        servers[0]._tcp.shutdown()
        servers[0]._tcp.server_close()
        router.replicas[0].close_all()
        for t in range(T):
            assert "margin" in _ask(router.address, f"tenant={t};2:1.0")
        assert router.requeue_total >= 1 and router.failed_total == 0
        assert router.replicas_live() == 1
        revive = _stack(tmp_path, T)
        servers.append(_server(revive[2], n_tenants=T))
        router.mark_live("r0", servers[-1].address)
        assert router.replicas_live() == 2
        assert "margin" in _ask(router.address, "tenant=0;2:1.0")
        for rep in router.replicas:
            rep.ewma_s, rep.inflight = 10.0, 9
        shed = _ask(router.address, "tenant=1;2:1.0")
        assert shed.get("shed") is True and "shed:" in shed["error"]
        for rep in router.replicas:
            rep.ewma_s, rep.inflight = 0.0, 0
    finally:
        router.stop()
        router.close()
        for srv in servers:
            srv.close()
        for s in stacks + ([revive] if revive else []):
            s[2].stop()
    events = _read(bus)
    assert schema.check_file(str(bus)) == []
    states = [e["state"] for e in events if e["event"] == "replica_state"]
    assert states.count("live") >= 3 and "dead" in states \
        and "requeue" in states
    shed_ev = [e for e in events if e["event"] == "serve_shed"]
    assert len(shed_ev) == 1 and shed_ev[0]["tenant"] == 1
    assert shed_ev[0]["est_s"] > shed_ev[0]["sla_s"]


def test_trace_sample_answers_byte_for_byte_untraced(tmp_path, bus):
    """An unsampled trace= line is answered with the bytes of the same
    line untraced, on a server and through the router; a sampled one
    adds only its "trace" object, and emits one query_trace event."""
    rng = np.random.default_rng(12)
    w = rng.standard_normal(D).astype(np.float32)
    checkpoint.save(str(tmp_path), "CoCoA+", 5, w, None, gap=1e-3)
    stack = _stack(tmp_path)
    off = _server(stack[2])
    on = _server(stack[2], trace_sample=2)
    router = serving.Router([("r0", off.address)], sla_s=1.0,
                            trace_sample=1)
    quiet = serving.Router([("r0", off.address)], sla_s=1.0)
    for r in (router, quiet):
        threading.Thread(target=r.serve_forever, daemon=True).start()
    try:
        lines = [_line(qi, qv) for qi, qv in _queries(rng, 6)]
        lines.append(";".join(lines[:3]))
        plain = _raw(off.address, lines)
        assert _raw(off.address, [f"trace=ab;{ln}" for ln in lines]) \
            == plain
        assert _raw(quiet.address, [f"trace=ab;{ln}" for ln in lines]) \
            == plain
        for srv in (on.address, router.address):
            traced = _raw(srv, [f"trace=c0ffee;{ln}" for ln in lines])
            n_traced = 0
            for t, p in zip(traced, plain):
                resp = json.loads(t)
                first = resp[0] if isinstance(resp, list) else resp
                if "trace" in first:
                    n_traced += 1
                    assert first.pop("trace")["id"] == "c0ffee"
                assert (json.dumps(resp) + "\n").encode() == p
            # the server samples 1 in 2 trace= lines, the router each
            assert n_traced == (4 if srv == on.address else len(lines))
    finally:
        for r in (router, quiet):
            r.stop()
            r.close()
        off.close()
        on.close()
        stack[2].stop()
    traces = [e for e in _read(bus) if e["event"] == "query_trace"]
    assert len(traces) == 4 + len(lines)
    assert {e["replica"] for e in traces} == {None, "r0"}
    assert schema.check_file(str(bus)) == []


# --- the ops plane against the JAX package's ---------------------------------


def _textfiles(tmp_path):
    """Three processes' textfiles, written by the port's MetricsWriter
    from serving events (a front door and two replicas), plus garbage."""
    paths = {}
    for label, n in (("router", 0), ("r0", 40), ("r1", 25)):
        path = str(tmp_path / f"{label}.prom")
        wtr = MetricsWriter(path)
        base = {"seq": 1, "pid": 1, "ts": 1000.0, "algorithm": "CoCoA+"}
        rng = np.random.default_rng(n)
        for i in range(n):
            lat = float(rng.exponential(0.02))
            wtr({**base, "event": "serve_request", "n": 3, "bucket": 4,
                 "fill_ratio": 0.75, "queue_s": lat / 3,
                 "device_s": lat / 2, "latency_max_s": lat,
                 "latency_mean_s": lat / 2, "model_round": 10 + i})
        if n:
            wtr({**base, "event": "model_swap", "round": 10 + n,
                 "path": "x", "birth_ts": time.time() - 2.0, "gap": 1e-3,
                 "gap_age_s": 2.0, "swap_seq": 1})
        else:
            wtr({**base, "event": "replica_state", "replica": "r0",
                 "state": "requeue", "replicas_live": 1, "requeued": 1})
        paths[label] = path
    with open(paths["r1"], "a") as f:
        f.write("torn{line 3\n\n# HELP x\ncocoa_x notnum\n")
    paths["gone"] = str(tmp_path / "never-written.prom")
    return paths


def test_merge_and_scrapes_match_jax(tmp_path):
    paths = _textfiles(tmp_path)
    mine, theirs = aggregate.read_sources(paths), \
        jax_aggregate.read_sources(paths)
    assert mine == theirs and "gone" not in mine
    assert aggregate.merge_expositions(mine) == \
        jax_aggregate.merge_expositions(theirs)
    for name in ("cocoa_model_round", "cocoa_serve_requeue_total",
                 "cocoa_serve_batches_total", "cocoa_nothing"):
        for text in mine.values():
            assert aggregate.scrape_gauge(text, name) == \
                jax_aggregate.scrape_gauge(text, name)
    for sla in (0.001, 0.01, 0.025, 0.05, 0.1, 1.0):
        assert aggregate.latency_totals(mine, sla) == \
            jax_aggregate.latency_totals(theirs, sla)
    for line in ("cocoa_x 3", 'cocoa_x{a="1"} 2.5', "{oops} 3", "",
                 "cocoa_x{unclosed 3", "# TYPE cocoa_x counter"):
        assert aggregate.split_sample(line) == \
            jax_aggregate.split_sample(line)


def test_slo_tracker_matches_jax():
    rng = np.random.default_rng(13)
    trackers = [mod.SloTracker(0.05, objective=0.99, fast_s=60.0,
                               slow_s=300.0)
                for mod in (aggregate, jax_aggregate)]
    assert trackers[0].status(now=0.0) == trackers[1].status(now=0.0)
    served = over = 0
    now = 1000.0
    for _ in range(200):
        now += float(rng.uniform(1, 20))
        served += int(rng.integers(0, 50))
        over += int(rng.integers(0, 2))
        for t in trackers:
            t.observe(served, over, now=now)
        assert trackers[0].status(now=now) == trackers[1].status(now=now)
    for mod in (aggregate, jax_aggregate):
        with pytest.raises(ValueError, match="objective"):
            mod.SloTracker(0.05, objective=1.0)


def test_status_plane_matches_jax(tmp_path, bus):
    paths = _textfiles(tmp_path)
    live = {"r0": True, "r1": False}
    planes = [mod.StatusServer(lambda: paths, sla_s=0.05,
                               liveness_fn=lambda: live)
              for mod in (aggregate, jax_aggregate)]
    try:
        for render in ("render_metrics", "render_healthz", "render_slo"):
            a, b = (getattr(p, render)() for p in planes)
            if render == "render_slo":
                a, b = json.loads(a), json.loads(b)
            assert a == b, render
        health = json.loads(planes[0].render_healthz())
        assert health["status"] == "degraded" and \
            health["replicas"]["router"]["live"] is None
        planes[0].start()
        base = "http://%s:%d" % planes[0].address
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read().decode() == planes[1].render_metrics()
        with urllib.request.urlopen(base + "/slo", timeout=10) as r:
            assert json.loads(r.read())["sla_ms"] == 50.0
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert e.value.code == 404
    finally:
        planes[0].stop()
        for p in planes[1:]:
            p._http.server_close()
    slo = [e for e in _read(bus) if e["event"] == "slo_status"]
    assert len(slo) == 2 and schema.check_file(str(bus)) == []


# --- the fleet through the CLI -----------------------------------------------


def _http_json(addr, route):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{route}",
                                timeout=10) as r:
        body = r.read().decode()
    return body if route == "/metrics" else json.loads(body)


class _Reader:
    """The fleet CLI's merged stdout, read on a thread and searchable."""

    def __init__(self, proc):
        self.lines = []
        self._cv = threading.Condition()
        threading.Thread(target=self._pump, args=(proc,), daemon=True).start()

    def _pump(self, proc):
        for line in proc.stdout:
            with self._cv:
                self.lines.append(line)
                self._cv.notify_all()

    def wait_for(self, needle, count=1, timeout=120.0):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                hits = [ln for ln in self.lines if needle in ln]
                if len(hits) >= count:
                    return hits[count - 1]
                left = deadline - time.monotonic()
                assert left > 0, f"no {needle!r}:\n" + "".join(self.lines)
                self._cv.wait(left)


def _poll(cond, what, timeout=120.0):
    """Wait for ``cond()`` to hold, up to ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"no {what} in {timeout:g} s"
        time.sleep(0.05)


def test_cli_fleet_sigkill_respawn_status_and_traces(tmp_path):
    """--serveReplicas=2 --serveRoute=tenant over a (T=4, d) catalogue the
    port saved: every tenant's margins those of one in-process catalogue
    server; a replica SIGKILLed under traffic (stopped first, with a line
    held at it) costs no failed line, is requeued and respawned; /metrics,
    /healthz, /slo answer; each traced line yields one query_trace.  The
    waits are polls to a deadline, so a loaded host only slows it."""
    T = 4
    rng = np.random.default_rng(14)
    W = rng.standard_normal((T, D)).astype(np.float32)
    ck = tmp_path / "ck"
    _catalogue(ck, W)
    ref = _stack(ck, T)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cocoa_torch.cli", "--serve=0",
         f"--chkptDir={ck}", f"--numFeatures={D}", "--serveReplicas=2",
         "--serveRoute=tenant", "--serveBatch=4,16", "--serveMaxNnz=8",
         "--statusPort=0", f"--metrics={tmp_path}/m.prom",
         f"--events={tmp_path}/ev.jsonl", "--traceSample=1", "--quiet",
         "--device=cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    out = _Reader(proc)
    try:
        addr = out.wait_for("fleet listening on").split("on ")[1].split()[0]
        addr = (addr.split(":")[0], int(addr.split(":")[1]))
        status = out.wait_for("status listening on").split("on ")[1].strip()
        status = (status.split(":")[0], int(status.split(":")[1]))
        pid0 = int(out.wait_for("replica r0 pid=").split("pid=")[1].split()[0])
        queries = _queries(rng, 3)
        lines = [(t, qi, qv) for t in range(T) for qi, qv in queries]
        for t, qi, qv in lines:
            got = _ask(addr, _line(qi, qv, t))
            assert got["margin"] == ref[2].score_sync(qi, qv, timeout=10,
                                                      tenant=t)
        failed = []
        served = [0]       # lines answered
        waiting = [None]   # (tenant, since) of the line the pump waits on

        def traffic(stop):
            # one line at a time: an idle replica always admits it, so a
            # slow host sheds nothing (router.py)
            while not stop.is_set():
                for t, qi, qv in lines:
                    waiting[0] = (t, time.monotonic())
                    r = _ask(addr, _line(qi, qv, t))
                    waiting[0] = None
                    served[0] += 1
                    if "margin" not in r:
                        failed.append(r)

        def held_at_r0():
            # tenants 0 and 2 are homed on r0 (tenant % 2); a line of
            # theirs open for a second is held by the stopped replica
            w = waiting[0]
            return w is not None and w[0] % 2 == 0 \
                and time.monotonic() - w[1] > 1.0

        stop = threading.Event()
        pump = threading.Thread(target=traffic, args=(stop,), daemon=True)
        pump.start()
        _poll(lambda: served[0] >= len(lines), "traffic before the kill")
        # r0 is stopped first, so that a line is in flight at it when it
        # dies: the router meets the death on that line (a requeue), not
        # first through the fleet's liveness poll, however loaded the host
        os.kill(pid0, signal.SIGSTOP)
        _poll(held_at_r0, "a line held at the stopped replica r0")
        os.kill(pid0, signal.SIGKILL)
        out.wait_for("replica r0 died")
        out.wait_for("replica r0 pid=", count=2)
        # the respawned replica rejoins the routing, and traffic flows on
        _poll(lambda: _http_json(status, "/healthz")["replicas_live"] == 2,
              "replicas_live == 2 after the respawn")
        after = served[0]
        _poll(lambda: served[0] - after >= len(lines),
              "traffic after the respawn")
        stop.set()
        pump.join(60)
        assert not pump.is_alive() and failed == []
        for t, qi, qv in lines:   # the respawned replica answers too
            assert _ask(addr, _line(qi, qv, t))["margin"] == \
                ref[2].score_sync(qi, qv, timeout=10, tenant=t)
        traced = _ask(addr, "trace=beef;tenant=1;3:1.0")
        assert traced["trace"]["id"] == "beef" and traced["tenant"] == 1
        health = _http_json(status, "/healthz")
        assert health["status"] == "ok" and health["replicas_live"] == 2
        slo = _http_json(status, "/slo")
        assert slo["served_total"] >= 0 and slo["replicas_live"] == 2
        merged = _http_json(status, "/metrics")
        requeues = [float(ln.split()[-1]) for ln in merged.splitlines()
                    if ln.startswith('cocoa_serve_requeue_total{replica="'
                                     'router"}')]
        assert requeues and requeues[0] >= 1
        assert _ask(addr, "shutdown") == {"ok": "shutting down"}
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:   # SIGTERM: the router stops its replicas
            proc.terminate()
            proc.wait(30)
        ref[2].stop()
    events = _read(tmp_path / "ev.jsonl")
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("query_trace") == 1
    assert schema.check_file(str(tmp_path / "ev.jsonl")) == []
