"""The round-barrier levers in the port (the counterpart of
tests/test_overlap.py): overlapped exchanges (``--overlapComm``) and
bounded-staleness CoCoA+ aggregation (``--staleRounds``).

Fast half: the store path of cocoa_torch/parallel/distributed.py (the
bounded ``blocking_kv_get`` and its backoff, the keyed all-gather, the
async handle, the host-bytes guard, the ``comm_overlap`` accounting) on
real ``torch.distributed`` stores; the port's ``StaleJoinWindow`` and
``partial_gamma`` beside the JAX package's; the gauges; the device loop's
checkpoint write on a thread (``overlap_io``), bit for bit with the
synchronous save and held to the JAX package's device loop; both CLIs'
flag surface, stderr for stderr.

One gloo gang of 2 processes of the port's harness
(tests/torch_elastic_worker.py ``--real=cocoa``, at the JAX harness's
size) runs in tier 1: ``--overlapComm=on --staleRounds=0`` is bit for bit
with the synchronous control, and ``--staleRounds=1``'s gap trajectory
and final w equal an in-process reference that drives the JAX harness's
own ``_GangCocoa`` (one per process) through the JAX package's
``StaleJoinWindow``.  The join schedule depends on round numbers alone,
so that reference is exact; the port's local solve is the dense SDCA
round's plain version where the JAX harness runs the numpy oracle, so
they agree to rounding: primal and w to 1e-12 relative, the gap to 1e-12
of the primal.

Slow half (as the JAX file's): the 40 % exchange-slack A/B under a
rotating straggler, and a SIGKILL with staleness on that the supervisor
shrinks through.
"""

import json
import os
import socket
import threading
import time
from contextlib import redirect_stderr
from io import StringIO

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import _gang_worker as jax_gang  # noqa: E402
from _faults import Fault, FaultPlan, checkpoint_at_least, \
    sigkill  # noqa: E402
from cocoa_tpu import checkpoint as jax_ckpt  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.data.synth import synth_sparse  # noqa: E402
from cocoa_tpu.parallel import distributed as jax_dist  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_tpu.solvers.cocoa import StaleJoinWindow as JaxWindow  # noqa
from cocoa_tpu.solvers.cocoa import partial_gamma as jax_partial_gamma
from cocoa_torch import checkpoint, cli, elastic, interop  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.parallel import distributed  # noqa: E402
from cocoa_torch.solvers.cocoa import StaleJoinWindow, partial_gamma, \
    run_cocoa  # noqa: E402
from cocoa_torch.telemetry import events as tele_events  # noqa: E402
from cocoa_torch.telemetry import schema, trace_report, tracing  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
import torch_elastic_worker as harness  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
REL = 1e-12


@pytest.fixture(autouse=True)
def clean_bus():
    tele_events.get_bus().reset()
    tracing.reset()
    yield tele_events.get_bus()
    tele_events.get_bus().reset()
    tracing.reset()


def _records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- ExchangeHandle / async all-gather ---------------------------------------


def test_async_allgather_single_process_is_immediate(clean_bus, tmp_path):
    ev = tmp_path / "ev.jsonl"
    clean_bus.configure(jsonl_path=str(ev))
    h = distributed.async_host_allgather_bytes("t0", b"payload")
    assert h.done()
    assert h.join() == [b"payload"]
    # a second join returns the first one's result and emits nothing
    assert h.join() == [b"payload"]
    recs = _records(ev)
    overlaps = [r for r in recs if r["event"] == "comm_overlap"]
    assert len(overlaps) == 1
    assert overlaps[0]["tag"] == "t0"
    assert overlaps[0]["wait_s"] >= 0.0
    assert schema.check_file(str(ev)) == []
    assert distributed.kv_allgather_bytes("k0", b"x") == [b"x"]


def test_async_allgather_rejects_device_values():
    """Tensors on any device, arrays and other values are refused before
    anything is posted, with the JAX package's error: a TypeError whose
    head names the type as JAX's does."""
    bad = (np.zeros(3), [b"x"], "str", 7, torch.zeros(3),
           torch.zeros(3, dtype=torch.float64), jnp.zeros(3))
    for value in bad:
        with pytest.raises(TypeError, match="host bytes") as port:
            distributed.async_host_allgather_bytes("t", value)
        with pytest.raises(TypeError, match="host bytes") as jax_err:
            jax_dist.async_host_allgather_bytes("t", value)
        head = str(port.value).split(":")[0]
        assert head == str(jax_err.value).split(":")[0]
        assert head.endswith(f"got {type(value).__name__}")
        assert "caller's thread" in str(port.value)


def test_exchange_handle_overlaps_and_accounts(clean_bus, tmp_path):
    """A slow collector runs beside the caller's work: hidden_s covers
    the overlapped part, wait_s what the join still waited, and a
    collector's error is raised at the join."""
    ev = tmp_path / "ev.jsonl"
    clean_bus.configure(jsonl_path=str(ev))

    def collect():
        time.sleep(0.12)
        return ["ok"]

    h = distributed.ExchangeHandle("slow", collect=collect,
                                   attrs={"round": 3})
    time.sleep(0.06)          # the caller's work the exchange hides behind
    assert h.join() == ["ok"]
    rec = [r for r in _records(ev) if r["event"] == "comm_overlap"][0]
    assert rec["round"] == 3
    assert rec["hidden_s"] >= 0.04
    assert rec["wait_s"] >= 0.02

    def boom():
        raise RuntimeError("peer died")

    h2 = distributed.ExchangeHandle("err", collect=boom)
    with pytest.raises(RuntimeError, match="peer died"):
        h2.join()
    with pytest.raises(RuntimeError, match="peer died"):
        h2.join()


def test_async_kv_get_over_a_real_store():
    """``async_kv_get`` on a TCP store: a key set later, from another
    client, is joined; a key never set fails within the budget, with the
    JAX package's words naming the key and the peer."""
    store = torch.distributed.TCPStore("127.0.0.1", _free_port(),
                                       is_master=True,
                                       wait_for_workers=False)
    other = torch.distributed.TCPStore("127.0.0.1", store.port,
                                       is_master=False)
    h = distributed.async_kv_get(store, "k1", timeout_s=10.0,
                                 attempt_s=0.5)
    time.sleep(0.1)
    assert not h.done()
    threading.Timer(0.2, lambda: other.set("k1", b"value-of-k1")).start()
    assert h.join() == b"value-of-k1"

    t0 = time.monotonic()
    h = distributed.async_kv_get(store, "missing", timeout_s=0.6,
                                 attempt_s=0.2, what="peer process 1")
    with pytest.raises(RuntimeError) as err:
        h.join()
    assert time.monotonic() - t0 < 5.0
    port_msg = str(err.value)

    class NeverClient:
        def blocking_key_value_get(self, key, timeout_ms):
            time.sleep(timeout_ms / 1000.0)
            raise RuntimeError("DEADLINE_EXCEEDED")

    with pytest.raises(RuntimeError) as jax_err:
        jax_dist.blocking_kv_get(NeverClient(), "missing", timeout_s=0.6,
                                 attempt_s=0.2, what="peer process 1")

    def words(msg):   # the attempt count depends on timing
        return msg.split(" (", 2)[:2], msg.split("):", 1)[1]

    assert words(port_msg) == words(str(jax_err.value))
    assert port_msg.startswith("KV-store key 'missing' (peer process 1) "
                               "never appeared within 0.6s")


# --- StaleJoinWindow policy ---------------------------------------------------


def test_stale_window_round_indexed_join_semantics(clean_bus, tmp_path):
    ev = tmp_path / "ev.jsonl"
    clean_bus.configure(jsonl_path=str(ev))
    w = StaleJoinWindow(2, algorithm="T")
    w.admit(1, [b"a"])
    w.admit(2, [b"b"])
    assert w.join_due(2) == []
    # round 3: round 1's window ends, exactly 2 rounds late, never more
    out = w.join_due(3)
    assert [(r, late) for r, _, late in out] == [(1, 2)]
    out = w.drain(3)
    assert [(r, late) for r, _, late in out] == [(2, 1)]
    assert w.pending_rounds() == []
    w.admit(4, [b"c"])
    with pytest.raises(ValueError, match="already"):
        w.admit(4, [b"d"])
    w.abort()
    assert w.pending_rounds() == []
    lates = [r["rounds_late"] for r in _records(ev)
             if r["event"] == "stale_join"]
    assert lates == [2, 1]          # synchronous joins are not events
    assert schema.check_file(str(ev)) == []


def test_stale_window_joins_as_the_jax_window_does():
    """The same admits, evals and joins through both packages' windows:
    the same joins, the same state, the same refusal of a join later than
    S."""
    rng = np.random.default_rng(3)
    for s in (0, 1, 2, 3):
        port, ref = StaleJoinWindow(s), JaxWindow(s)
        got, want = [], []
        for t in range(1, 40):
            for win, out in ((port, got), (ref, want)):
                win.admit(t, [bytes([t])])
                out.append(("due", t, [(r, late) for r, _, late in
                                       win.join_due(t)]))
            if t % 5 == 0:
                gap = float(rng.random())
                for win, out in ((port, got), (ref, want)):
                    out.append(("drain", [(r, late) for r, _, late in
                                          win.drain(t)]))
                    out.append(("eval", win.on_eval(gap), win.collapsed,
                                win.effective_window()))
        assert got == want
        # a caller that skipped join_due: both refuse the late join
        port, ref = StaleJoinWindow(s), JaxWindow(s)
        for win in (port, ref):
            win.admit(1, [b"x"])
        with pytest.raises(RuntimeError) as a:
            port.drain(s + 2)
        with pytest.raises(RuntimeError) as b:
            ref.drain(s + 2)
        assert str(a.value) == str(b.value)


def test_stale_window_zero_is_synchronous():
    w = StaleJoinWindow(0)
    w.admit(5, [b"x"])
    out = w.join_due(5)
    assert [(r, late) for r, _, late in out] == [(5, 0)]


def test_stale_window_gap_rise_collapses_then_restores():
    w = StaleJoinWindow(3)
    assert w.on_eval(1.0) is False
    assert w.effective_window() == 3
    assert w.on_eval(2.0) is True           # a rise: synchronous
    assert w.collapsed and w.effective_window() == 0
    w.admit(10, [b"x"])
    out = w.join_due(10)
    assert [(r, late) for r, _, late in out] == [(10, 0)]
    assert w.on_eval(1.5) is True           # an improvement restores it
    assert not w.collapsed and w.effective_window() == 3
    assert w.on_eval(None) is False


def test_stale_window_rejects_negative():
    with pytest.raises(ValueError, match="staleRounds") as a:
        StaleJoinWindow(-1)
    with pytest.raises(ValueError) as b:
        JaxWindow(-1)
    assert str(a.value) == str(b.value)


def test_partial_gamma_identity_and_bounds():
    assert partial_gamma(1.0, 4, 4) == 1.0
    assert partial_gamma(0.5, 8, 1) == 0.5
    for k, m in ((4, 4), (8, 1), (3, 2)):
        assert partial_gamma(0.7, k, m) == jax_partial_gamma(0.7, k, m)
    for bad in (0, 5):
        with pytest.raises(ValueError) as a:
            partial_gamma(1.0, 4, bad)
        with pytest.raises(ValueError) as b:
            jax_partial_gamma(1.0, 4, bad)
        assert str(a.value) == str(b.value)


# --- metrics gauges ------------------------------------------------------------


def test_metrics_overlap_and_stale_gauges(tmp_path):
    path = tmp_path / "m.prom"
    w = MetricsWriter(str(path))
    text = path.read_text()
    assert "cocoa_overlap_hidden_seconds" not in text
    assert "cocoa_stale_joins_total" not in text
    base = {"seq": 1, "ts": 0.0, "pid": 1}
    w({**base, "event": "comm_overlap", "tag": "dw3", "hidden_s": 0.5,
       "wait_s": 0.1})
    w({**base, "event": "comm_overlap", "tag": "dw4", "hidden_s": 0.25,
       "wait_s": 0.0})
    for t, r, late in ((4, 3, 1), (6, 4, 2), (7, 6, 1)):
        w({**base, "event": "stale_join", "algorithm": "T", "t": t,
           "round": r, "rounds_late": late, "workers": 2})
    text = path.read_text()
    assert "cocoa_overlap_hidden_seconds 0.75" in text
    assert "cocoa_overlap_wait_seconds 0.1" in text
    assert 'cocoa_stale_joins_total{rounds_late="1"} 2' in text
    assert 'cocoa_stale_joins_total{rounds_late="2"} 1' in text


# --- overlap_io: the device loop's checkpoint write on a thread --------------


def _overlap_problem():
    data = synth_sparse(64, 32, nnz_mean=6, seed=4)
    ds_j = jax_shard(data, k=2, layout="dense", dtype=jnp.float32)
    arrays = {f: np.asarray(v) for f, v in ds_j.shard_arrays().items()}
    ds = interop.dataset_from_numpy(arrays, ds_j.layout, ds_j.n,
                                    ds_j.num_features, device="cpu")
    return data, ds_j, ds


def _generations(directory, algorithm="CoCoA+"):
    return {os.path.basename(p): checkpoint.load(p)
            for p in checkpoint.generations(str(directory), algorithm)}


def test_overlap_io_checkpoints_bit_identical(tmp_path):
    """``overlap_io`` writes the device loop's checkpoints on a thread:
    the run and every generation written are those of the synchronous
    save bit for bit, every write has landed when the run returns, and
    the run is the JAX device loop's with ``overlap_io=True`` to float32
    rounding (relative 1e-5 of the largest |w| and of alpha's range)."""
    data, ds_j, ds = _overlap_problem()
    p = Params(n=data.n, num_rounds=20, local_iters=8, lam=0.01)

    def run(ckdir, overlap):
        d = DebugParams(debug_iter=5, seed=0, chkpt_iter=5,
                        chkpt_dir=str(ckdir))
        return run_cocoa(ds, p, d, plus=True, quiet=True,
                         device_loop=True, overlap_io=overlap)

    w_s, a_s, t_s = run(tmp_path / "sync", False)
    w_o, a_o, t_o = run(tmp_path / "overlap", True)
    assert torch.equal(w_s, w_o) and torch.equal(a_s, a_o)
    assert t_s.saves == t_o.saves > 0
    gens_s, gens_o = (_generations(tmp_path / "sync"),
                      _generations(tmp_path / "overlap"))
    assert sorted(gens_s) == sorted(gens_o) and len(gens_s) == 2
    for name, (meta_s, ws, as_) in gens_s.items():
        meta_o, wo, ao = gens_o[name]
        assert meta_s == meta_o
        np.testing.assert_array_equal(ws, wo)
        np.testing.assert_array_equal(as_, ao)
    meta, wf, af = checkpoint.load(checkpoint.latest(
        str(tmp_path / "overlap"), "CoCoA+"))
    assert meta["round"] == 20
    np.testing.assert_array_equal(wf, w_o.numpy())

    pj = JaxParams(n=data.n, num_rounds=20, local_iters=8, lam=0.01)
    dj = JaxDebug(debug_iter=5, seed=0, chkpt_iter=5,
                  chkpt_dir=str(tmp_path / "jax"))
    w_j, a_j, _ = jax_run_cocoa(ds_j, pj, dj, plus=True, quiet=True,
                                device_loop=True, overlap_io=True)
    scale = float(np.abs(np.asarray(w_j)).max())
    np.testing.assert_allclose(w_o.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(a_o.numpy(), np.asarray(a_j)[:, :a_o.shape[1]],
                               rtol=0, atol=1e-5)
    meta_j, wj_file, _ = jax_ckpt.load(jax_ckpt.latest(
        str(tmp_path / "jax"), "CoCoA+"))
    assert meta_j["round"] == meta["round"] == 20
    np.testing.assert_allclose(wf, wj_file, rtol=0, atol=1e-5 * scale)


def test_overlap_io_writer_error_is_raised(tmp_path, monkeypatch):
    """A write that fails on the writer thread makes the run raise its
    error, at the next save's join or at the return: never swallowed."""
    data, _, ds = _overlap_problem()
    p = Params(n=data.n, num_rounds=20, local_iters=8, lam=0.01)
    real_save = checkpoint.save
    writers = []

    def failing_save(*args, **kw):
        writers.append(threading.current_thread().name)
        if args[2] == 10:
            raise OSError("disk full at round 10")
        return real_save(*args, **kw)

    monkeypatch.setattr(checkpoint, "save", failing_save)
    d = DebugParams(debug_iter=5, seed=0, chkpt_iter=5,
                    chkpt_dir=str(tmp_path / "ck"))
    with pytest.raises(OSError, match="disk full at round 10"):
        run_cocoa(ds, p, d, plus=True, quiet=True, device_loop=True,
                  overlap_io=True)
    assert writers and set(writers) == {"cocoa-ckpt-writer"}
    # the synchronous save raises on the caller's thread, as before
    writers.clear()
    d = DebugParams(debug_iter=5, seed=0, chkpt_iter=5,
                    chkpt_dir=str(tmp_path / "ck2"))
    with pytest.raises(OSError, match="disk full at round 10"):
        run_cocoa(ds, p, d, plus=True, quiet=True, device_loop=True)
    assert set(writers) == {threading.current_thread().name}


# --- the store's backoff ---------------------------------------------------------


def test_kv_backoff_resets_after_full_length_attempt(monkeypatch):
    """Fast failures escalate the pause; an attempt that used its whole
    wait shows the store is listening, so the next fast failure pauses
    at the base again, not at the escalated value (the JAX package's
    pin, tests/test_overlap.py)."""
    monkeypatch.setattr(distributed, "_KV_BACKOFF_BASE_S", 0.01)
    monkeypatch.setattr(distributed, "_KV_BACKOFF_CAP_S", 10.0)
    pauses = []
    real_sleep = time.sleep
    monkeypatch.setattr(distributed.time, "sleep",
                        lambda s: (pauses.append(s), real_sleep(0.001)))

    class Store:
        """fast, fast, SLOW (full length), fast, then the key."""

        def __init__(self):
            self.calls = 0

        def wait(self, keys, timeout):
            self.calls += 1
            if self.calls in (1, 2, 4):
                raise RuntimeError("connection reset")
            if self.calls == 3:
                real_sleep(timeout.total_seconds())
                raise RuntimeError("wait timeout")

        def get(self, key):
            return b"ok"

    assert distributed.blocking_kv_get(Store(), "k", timeout_s=30.0,
                                       attempt_s=0.05) == b"ok"
    assert pauses == pytest.approx([0.01, 0.02, 0.01])


# --- the CLI's flag surface --------------------------------------------------------


BASE_FLAGS = ["--trainFile=x.dat", "--numFeatures=10", "--numSplits=4"]


def _spy(monkeypatch, target):
    calls = {}

    def spy(worker_argv, n_workers, **kw):
        calls["argv"] = list(worker_argv)
        calls["n"] = n_workers
        return 0

    monkeypatch.setattr(target, spy)
    return calls


@pytest.mark.parametrize("flags,rc", [
    (["--overlapComm=maybe"], 2), (["--staleRounds=-1"], 2),
    (["--staleRounds=x"], 2), (["--staleRounds=1"], 2),
    (["--overlapComm=on", "--staleRounds=0"], 0), (["--overlapComm"], 0),
    (["--overlapComm=auto"], 0), (["--overlapComm=off"], 0)])
def test_cli_overlap_and_stale_flag_validation(monkeypatch, flags, rc):
    """Both CLIs under ``--elastic=2`` (their supervisors spied): the same
    exit code and stderr; the accepted spellings reach the workers'
    command line."""
    jax_calls = _spy(monkeypatch, "cocoa_tpu.elastic.supervise")
    port_calls = _spy(monkeypatch, "cocoa_torch.elastic.supervise")
    argv = BASE_FLAGS + flags + ["--elastic=2"]
    errs = []
    for main in (jax_cli.main, cli.main):
        buf = StringIO()
        with redirect_stderr(buf):
            assert main(argv) == rc
        errs.append(buf.getvalue())
    assert errs[1] == errs[0]
    if rc == 2:
        assert errs[0].startswith("error: ")
        if flags == ["--staleRounds=1"]:
            assert "host-exchange" in errs[0]
        assert port_calls == {}
    else:
        assert port_calls["n"] == jax_calls["n"] == 2
        for flag in flags:
            assert flag in port_calls["argv"]
        assert port_calls["argv"] == jax_calls["argv"]


# --- the real-math gang --------------------------------------------------------------


@pytest.fixture
def gang_env(monkeypatch):
    """Workers find the harness and stay on one thread each."""
    monkeypatch.setenv(
        "PYTHONPATH",
        f"{ROOT}{os.pathsep}{TESTS}{os.pathsep}"
        f"{os.environ.get('PYTHONPATH', '')}")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


# the JAX file's tuned problem: certifies the 1e-4 hinge gap in ~130
# synchronous rounds
REAL_FLAGS = ["--real=cocoa", "--numSplits=2", "--numRounds=400",
              "--gapTarget=1e-4", "--lambda=0.01", "--rowsPerShard=64",
              "--numFeatures=32", "--localIters=16", "--device=cpu"]


def _run_gang(tmp_path, name, extra, n=2, **kw):
    ev = str(tmp_path / f"{name}.jsonl")
    opts = dict(module="torch_elastic_worker", max_restarts=0, poll_s=0.05,
                backoff_base_s=0.0, resume=False)
    opts.update(kw)
    rc = elastic.supervise(REAL_FLAGS + list(extra) + [f"--events={ev}"],
                           n, **opts)
    assert rc == 0
    return ev, _records(ev)


def _evals(evs):
    return [(r["t"], r["primal"], r["gap"]) for r in evs
            if r["event"] == "round_eval"]


def jax_reference(flags, stale, nproc=2):
    """The JAX harness's run in one process: its ``_GangCocoa`` for each
    pid, each through the JAX package's StaleJoinWindow, the payload
    lists admitted in round order; returns (evals, w)."""
    opts = jax_gang.parse(flags)
    gangs = [jax_gang._GangCocoa(opts, p, nproc) for p in range(nproc)]
    windows = [JaxWindow(stale, algorithm=jax_gang.REAL_ALGORITHM)
               for _ in range(nproc)]
    debug_iter = int(opts["debugIter"])
    evals = []
    for t in range(1, int(opts["numRounds"]) + 1):
        dws = [g.local_solve(t) for g in gangs]
        for p, g in enumerate(gangs):
            g.contribs[(t, p)] = dws[p]
            g.recompute_w()
        payloads = [dw.tobytes() for dw in dws]
        for g, win in zip(gangs, windows):
            win.admit(t, list(payloads))
            for r, parts, _ in win.join_due(t):
                g.absorb(r, parts)
        if t % debug_iter:
            continue
        for g, win in zip(gangs, windows):
            for r, parts, _ in win.drain(t):
                g.absorb(r, parts)
        totals = np.sum([np.array(g.partials()) for g in gangs], axis=0)
        primal, gap = gangs[0].gap_from_totals(totals[0], totals[1])
        evals.append((t, primal, gap))
        for win in windows:
            win.on_eval(gap)
        if gap <= float(opts["gapTarget"]):
            break
    assert all(np.array_equal(g.w, gangs[0].w) for g in gangs)
    return evals, gangs[0].w


def test_gang_stale_matches_jax_reference_and_off_switch_is_exact(
        tmp_path, gang_env):
    """A gloo gang of 2 of the port's harness: ``--overlapComm=on
    --staleRounds=0`` is the synchronous control bit for bit (every eval,
    every checkpoint generation's w and alpha); ``--overlapComm=on
    --staleRounds=1`` equals the in-process JAX reference (rounds equal,
    primal and final w to 1e-12 relative, gaps to 1e-12 of the primal),
    every round joins, none later than S, and the final checkpoint holds
    the reference's w."""
    common = ["--debugIter=5", "--chkptIter=5"]
    ck = {name: tmp_path / f"ck_{name}" for name in ("ctl", "off", "st")}
    _, evs_ctl = _run_gang(tmp_path, "ctl", common + [
        f"--chkptDir={ck['ctl']}", "--overlapComm=off", "--staleRounds=0"])
    _, evs_off = _run_gang(tmp_path, "off", common + [
        f"--chkptDir={ck['off']}", "--overlapComm=on", "--staleRounds=0"])
    ev, evs_st = _run_gang(tmp_path, "st", common + [
        f"--chkptDir={ck['st']}", "--overlapComm=on", "--staleRounds=1"])

    assert _evals(evs_ctl) == _evals(evs_off)
    assert not [r for r in evs_off if r["event"] == "stale_join"]
    assert [r for r in evs_off if r["event"] == "comm_overlap"]
    gens = {name: _generations(d, "GangCoCoA+") for name, d in ck.items()}
    assert sorted(gens["ctl"]) == sorted(gens["off"]) and gens["ctl"]
    for g, (meta, w, a) in gens["ctl"].items():
        meta_o, w_o, a_o = gens["off"][g]
        assert meta == meta_o
        np.testing.assert_array_equal(w, w_o)
        np.testing.assert_array_equal(a, a_o)

    ref_evals, ref_w = jax_reference(
        [f for f in REAL_FLAGS if not f.startswith("--device")]
        + ["--debugIter=5"], stale=1)
    got = _evals(evs_st)
    assert [t for t, _, _ in got] == [t for t, _, _ in ref_evals]
    for (_, p, g), (_, rp, rg) in zip(got, ref_evals):
        assert abs(p - rp) <= REL * abs(rp)
        assert abs(g - rg) <= REL * abs(rp)
    end = [r for r in evs_st if r["event"] == "run_end"][-1]
    assert end["stopped"] == "target" and end["gap"] <= 1e-4
    last = end["round"]
    lates = [(r["round"], r["rounds_late"]) for r in evs_st
             if r["event"] == "stale_join"]
    assert lates and max(late for _, late in lates) == 1
    # every round joins: the harness exits non-zero unless its log holds
    # each (round, process) contribution once the run has drained, and
    # each late join is of a round the run solved
    assert {r for r, _ in lates} <= set(range(1, last + 1))
    # the stop's eval saves: the final checkpoint holds the run's w
    meta, w_ck, _ = checkpoint.load(checkpoint.latest(str(ck["st"]),
                                                      "GangCoCoA+"))
    assert meta["round"] == last
    np.testing.assert_allclose(w_ck, ref_w, rtol=0,
                               atol=REL * np.abs(ref_w).max())
    assert schema.check_file(ev) == []
    assert schema.check_file(ev + ".p1") == []


# --- slow: the A/B and the resize ----------------------------------------------


@pytest.mark.slow
def test_gang_overlap_stale_cuts_straggler_slack_40pct(tmp_path, gang_env):
    """The JAX file's acceptance A/B on the port's harness: under a
    rotating straggler the exchange phases' straggler slack drops by 40 %
    or more with ``--overlapComm=on --staleRounds=1`` against the
    synchronous control, both certify the 1e-4 gap, and the stale run
    takes at most 1.25x the control's rounds."""
    skew = ["--debugIter=10", "--trace", "--stepSeconds=0.008",
            "--stepSkew=0.03", "--skewEvery=2"]

    def measure(name, levers):
        ev, evs = _run_gang(tmp_path, name, skew + levers)
        assert schema.check_file(ev) == []
        end = [r for r in evs if r["event"] == "run_end"][-1]
        assert end["stopped"] == "target", f"{name} did not certify"
        assert end["gap"] <= 1e-4
        spans = trace_report.load_spans([ev, ev + ".p1"])
        rows = trace_report.stragglers(spans)
        slack = sum(r["slack_s"] for r in rows
                    if r["phase"] in harness.EXCHANGE_PHASES)
        rounds = max(r["t"] for r in evs if r["event"] == "round_eval")
        return slack, rounds, rows

    ctl_slack, ctl_rounds, _ = measure(
        "control", ["--overlapComm=off", "--staleRounds=0"])
    trt_slack, trt_rounds, trt_rows = measure(
        "treatment", ["--overlapComm=on", "--staleRounds=1"])
    assert ctl_slack > 0.5, f"control slack too small to A/B ({ctl_slack})"
    drop = 1.0 - trt_slack / ctl_slack
    assert drop >= 0.40, (
        f"exchange slack only dropped {drop:.0%} "
        f"({ctl_slack:.3f}s -> {trt_slack:.3f}s)")
    assert trt_rounds <= 1.25 * ctl_rounds, (ctl_rounds, trt_rounds)
    assert trt_rows[0]["phase"] == "local_solve"


@pytest.mark.slow
def test_gang_resize_with_staleness_drops_pending_joins(tmp_path, gang_env):
    """SIGKILL worker 1 with staleness and overlap on: the supervisor
    shrinks to the survivor, the dead generation's pending joins die with
    its processes (the store's bounded waits: no deadlock), and the
    resumed 1-worker run certifies from the drained checkpoint."""
    ck = tmp_path / "ck"
    ev = str(tmp_path / "chaos.jsonl")
    tele_events.get_bus().configure(jsonl_path=ev)
    plan = FaultPlan(
        Fault(generation=0, actions=(sigkill(1),),
              trigger=checkpoint_at_least(ck, "GangCoCoA+", 20),
              name="kill-worker-1"),
    )
    resizes = []
    rc = elastic.supervise(
        REAL_FLAGS + [f"--events={ev}", f"--chkptDir={ck}",
                      "--debugIter=5", "--chkptIter=20",
                      "--overlapComm=on", "--staleRounds=1",
                      "--stepSeconds=0.01"],
        2, module="torch_elastic_worker", max_restarts=3, poll_s=0.05,
        num_splits=2, shrink="now", backoff_base_s=0.0,
        on_generation=plan.on_generation,
        on_restart=lambda gen, reason, old, new, backoff:
            resizes.append((old, new)),
    )
    plan.join()
    assert rc == 0
    assert plan.errors == []
    assert plan.fired == ["kill-worker-1"]
    assert (2, 1) in resizes
    recs = _records(ev)
    assert any(r["event"] == "gang_resize" and r["new_size"] == 1
               for r in recs)
    ends = [r for r in recs if r["event"] == "run_end"]
    assert ends and ends[-1]["stopped"] == "target"
    assert ends[-1]["gap"] <= 1e-4
    meta, w, alpha = checkpoint.load(checkpoint.latest(str(ck),
                                                       "GangCoCoA+"))
    assert meta["round"] >= 20 and alpha.shape[0] == 2
    assert schema.check_file(ev) == []
