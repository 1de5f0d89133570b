"""The port's runtime sanitizers (cocoa_torch/analysis/sanitize.py): the
transfer guard's teeth on the CPU, the drive loops' regions sanitized in
float64 (the chunked loop, ``--deviceLoop``, the block round, a fleet of
two) against their unsanitized runs bit for bit and against the JAX
package's runs under its own sanitizer, the capture watch's bridge onto
the telemetry bus, and the metrics textfile's counts of both events.

On the CPU no CUDA graph can be captured, so the capture watch is held
through its emit hook and ``kernels.build``'s report of a build; the
invariant one capture per (branch, chunk length) is checked on the card
(chip_smoke.py phase 25)."""

import json
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from cocoa_tpu.analysis import sanitize as jax_sanitize  # noqa: E402
from cocoa_tpu.config import DebugParams as JaxDebug  # noqa: E402
from cocoa_tpu.config import Params as JaxParams  # noqa: E402
from cocoa_tpu.data import fleet as jax_fleet  # noqa: E402
from cocoa_tpu.data.sharding import shard_dataset as jax_shard  # noqa: E402
from cocoa_tpu.solvers import run_cocoa as jax_run_cocoa  # noqa: E402
from cocoa_tpu.telemetry import schema as jax_schema  # noqa: E402
from cocoa_torch import kernels  # noqa: E402
from cocoa_torch.analysis import sanitize  # noqa: E402
from cocoa_torch.config import DebugParams, Params  # noqa: E402
from cocoa_torch.data.fleet import build_fleet, \
    synth_fleet_specs  # noqa: E402
from cocoa_torch.solvers import base, run_cocoa, run_cocoa_fleet  # noqa: E402
from cocoa_torch.telemetry import events, schema  # noqa: E402
from cocoa_torch.telemetry.metrics import MetricsWriter  # noqa: E402
from test_torch_gap_target import assert_same_run, port_ds  # noqa: E402

K = 4
ATOL = 1e-12


@pytest.fixture(autouse=True)
def clean_bus():
    events.get_bus().reset()
    yield
    events.get_bus().reset()


# --- the guard's teeth -------------------------------------------------------

def _while(t):
    n = 0
    while t[0] > n:
        n += 1
    return n


READS = {
    "item": lambda t: t[0].item(),
    "float": lambda t: float(t[0]),
    "int": lambda t: int(t[1]),
    "if": lambda t: 1 if t[0] else 0,
    "while": _while,
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "np.asarray": lambda t: np.asarray(t),
    "cpu": lambda t: t.cpu(),
    "index": lambda t: [0, 1, 2][t[1].long()],
    "format": lambda t: f"{t[0]:.3f}",
    "equal": lambda t: torch.equal(t, t),
}


@pytest.mark.parametrize("read", list(READS))
def test_guard_refuses_unmarked_reads(read):
    """tests/test_analysis.py:776: on the CPU every tensor stands in for
    the device's, so an unmarked read inside a guarded region raises."""
    t = torch.tensor([1.5, 2.0])
    before = sanitize.refused_total
    with pytest.raises(sanitize.TransferRefused, match="intended_fetch"):
        with sanitize.no_transfers():
            READS[read](t)
    assert sanitize.refused_total == before + 1


@pytest.mark.parametrize("read", list(READS))
def test_intended_fetch_reopens_the_region(read):
    t = torch.tensor([1.5, 2.0])
    with sanitize.sanitizer(strict=False) as s:
        with sanitize.no_transfers():
            with sanitize.intended_fetch("probe"):
                READS[read](t)
            with sanitize.allow_transfers():
                READS[read](t)
    assert s.intended_fetches == 1 and s.unintended == 0


def test_guard_leaves_device_work_and_host_moves_alone():
    t = torch.arange(6.0)
    with sanitize.no_transfers():
        u = torch.where(t > 2, t * 2, t).sum()
        v = t.to("cpu")                       # no transfer on the CPU
        w = t.reshape(2, 3)[1]
        assert u.shape == () and v is t and w.shape == (3,)


def test_device_loop_guard_is_inert_unless_armed():
    t = torch.tensor([3.0])
    with sanitize.device_loop_guard("cpu"):
        assert float(t) == 3.0
    with sanitize.sanitizer(strict="all"):
        with pytest.raises(sanitize.TransferRefused):
            with sanitize.device_loop_guard("cpu"):
                float(t)
    with sanitize.sanitizer(strict="d2h"):
        with pytest.raises(sanitize.TransferRefused):
            float(t)


def test_guard_on_the_card_never_degrades_quietly(monkeypatch):
    """No quiet fallback: a torch without set_sync_debug_mode refuses to
    arm a guard on CUDA."""
    monkeypatch.delattr(torch.cuda, "set_sync_debug_mode")
    with pytest.raises(RuntimeError, match="set_sync_debug_mode"):
        with sanitize.no_transfers("cuda"):
            pass


def test_intended_fetch_emits_host_transfer(tmp_path):
    ev = tmp_path / "ev.jsonl"
    events.get_bus().configure(jsonl_path=str(ev))
    out = events.host_fetch(torch.ones(3), "probe")
    with sanitize.intended_fetch("other"):
        pass
    events.get_bus().reset()
    recs = [json.loads(ln) for ln in open(ev)]
    assert [r["label"] for r in recs if r["event"] == "host_transfer"] == \
        ["probe", "other"]
    assert out.tolist() == [1.0, 1.0, 1.0]
    assert schema.check_file(str(ev)) == []


# --- sanitized runs on the CPU, float64 --------------------------------------


def _tiny(tiny_data, layout="dense"):
    ds_j = jax_shard(tiny_data, k=K, layout=layout, dtype=jnp.float64)
    return ds_j, port_ds(ds_j)


RUNS = {
    "chunked": dict(),
    "device loop": dict(device_loop=True),
    "block": dict(math="fast", block_size=8),
    "block device loop": dict(math="fast", block_size=8, device_loop=True),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_sanitized_run_matches_unsanitized_and_jax(tiny_data, run):
    """tests/test_analysis.py:791,843: under sanitizer(strict="all") a run
    reads the device only through intended_fetch (at least once an eval,
    or once a super-block), is bit for bit with its unsanitized run, and
    within 1e-12 of JAX's run under JAX's sanitizer, eval for eval."""
    kw = RUNS[run]
    ds_j, ds = _tiny(tiny_data, "sparse" if "block" in run else "dense")
    p = dict(n=tiny_data.n, num_rounds=12, lam=0.01, local_iters=15)
    d = dict(debug_iter=4, seed=0)
    ref = run_cocoa(ds, Params(**p), DebugParams(**d), plus=True,
                    quiet=True, **kw)
    with sanitize.sanitizer(strict="all") as s:
        w, alpha, traj = run_cocoa(ds, Params(**p), DebugParams(**d),
                                   plus=True, quiet=True, **kw)
    assert s.unintended == 0
    assert s.intended_fetches == traj.fetches
    assert s.intended_fetches >= (1 if kw.get("device_loop")
                                  else len(traj.records))
    assert s.compiles == []      # no capture and no build on the CPU
    assert torch.equal(w, ref[0]) and torch.equal(alpha, ref[1])
    with jax_sanitize.sanitizer():
        w_j, a_j, traj_j = jax_run_cocoa(ds_j, JaxParams(**p),
                                         JaxDebug(**d), plus=True,
                                         quiet=True, **kw)
    assert len(traj.records) == len(traj_j.records) == 3
    assert_same_run(traj, traj_j)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(alpha.numpy(),
                               np.asarray(a_j)[:, :alpha.shape[1]], rtol=0,
                               atol=ATOL)


def test_sanitized_fleet_matches_unsanitized_and_jax_solo_runs():
    """A fleet of two under sanitizer(strict="all"): its two fetches the
    only reads, bit for bit with the unsanitized fleet, and each lane
    within 1e-12 of JAX's solo run under JAX's sanitizer (the JAX fleet
    stages lambda*n in float32, so the port's lanes are held to JAX's
    solo runs, as tests/test_torch_fleet.py holds them)."""
    specs = synth_fleet_specs(2, n=64, d=16, gap_target=1e-2)
    fleet = build_fleet(specs, k=2, local_iter_frac=0.25,
                        dtype=torch.float64, device="cpu")
    params = Params(n=0, num_rounds=60, local_iters=fleet.local_iters,
                    gamma=1.0, loss="hinge")
    debug = DebugParams(debug_iter=10, seed=0, chkpt_iter=10**9,
                        chkpt_dir="")
    ref = run_cocoa_fleet(fleet, params, debug, quiet=True)
    with sanitize.sanitizer(strict="all") as s:
        res = run_cocoa_fleet(fleet, params, debug, quiet=True)
    assert s.unintended == 0 and s.intended_fetches == 2
    assert torch.equal(res.w, ref.w) and torch.equal(res.alpha, ref.alpha)
    jf = jax_fleet.build_fleet(
        [jax_fleet.TenantSpec(**vars(sp)) for sp in specs], k=2,
        local_iter_frac=0.25, dtype=jnp.float64)
    m = fleet.n_shard
    for t in range(2):
        ds = jf.tenant_ds(t)
        sp = JaxParams(n=ds.n, num_rounds=60, local_iters=jf.local_iters,
                       lam=float(jf.lams[t]), gamma=1.0, loss="hinge")
        with jax_sanitize.sanitizer():
            w, alpha, traj = jax_run_cocoa(
                ds, sp, JaxDebug(debug_iter=10, seed=0, chkpt_iter=10**9,
                                 chkpt_dir=""),
                plus=True, gap_target=1e-2, device_loop=True, quiet=True)
        assert res.evals >= len(traj.records)
        np.testing.assert_allclose(res.w[t].numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(res.alpha[t].numpy(),
                                   np.asarray(alpha)[:, :m], rtol=0,
                                   atol=ATOL)
        primal = [r.primal for r in traj.records]
        np.testing.assert_allclose(res.traj[:len(primal), t, 0], primal,
                                   rtol=ATOL)


# --- telemetry on ------------------------------------------------------------


@pytest.mark.parametrize("device_loop", [False, True])
def test_sanitized_run_telemetry_counts(tiny_data, tmp_path, device_loop):
    """tests/test_analysis.py:810: with every sink attached, the
    host_transfer events equal cocoa_host_transfers_total and the
    sanitizer's count, and the stream validates under both schemas."""
    _, ds = _tiny(tiny_data)
    ev, mp = str(tmp_path / "ev.jsonl"), str(tmp_path / "m.prom")
    events.get_bus().configure(jsonl_path=ev, metrics_path=mp)
    try:
        with sanitize.sanitizer(strict="all") as s:
            run_cocoa(ds, Params(n=tiny_data.n, num_rounds=12, lam=0.01,
                                 local_iters=15),
                      DebugParams(debug_iter=4, seed=0), plus=True,
                      quiet=True, device_loop=device_loop)
    finally:
        events.get_bus().reset()
    assert schema.check_file(ev) == [] and jax_schema.check_file(ev) == []
    evs = [json.loads(ln) for ln in open(ev)]
    fetches = [e["label"] for e in evs if e["event"] == "host_transfer"]
    assert fetches == (["device_loop_fetch"] if device_loop
                       else ["eval_fetch"] * 3)
    text = open(mp).read()
    total = int([ln for ln in text.splitlines()
                 if ln.startswith("cocoa_host_transfers_total")][0].split()[1])
    assert total == len(fetches) == s.intended_fetches
    assert "cocoa_compiles_total 0" in text


def test_metrics_writer_counts_compile_and_transfer(tmp_path):
    """tests/test_analysis.py:853: a compile record (a capture) and a
    host_transfer record fed to the port's MetricsWriter."""
    mp = str(tmp_path / "m.prom")
    w = MetricsWriter(mp)
    w({"event": "compile", "name": "chunk/main/25", "seconds": 0.5,
       "ts": 1.0})
    w({"event": "compile", "name": "nvcc/sparse_sdca", "seconds": 40.0,
       "ts": 2.0})
    w({"event": "host_transfer", "label": "eval_fetch", "ts": 3.0})
    text = open(mp).read()
    assert "cocoa_compiles_total 2" in text
    assert "cocoa_host_transfers_total 1" in text


# --- the capture watch -------------------------------------------------------


def test_capture_watch_bridge_emits_compile_events(tmp_path):
    """The emit hook every capture calls: records go to each open watch
    and, once the bus is configured (which installs the bridge), to the
    bus as schema-valid compile events; an inactive bus gets none."""
    with sanitize.watch_compiles() as outer:
        with sanitize.watch_compiles() as inner:
            sanitize.record_compile("chunk/main/25", 0.125)
        sanitize.record_compile("device_loop/main", 0.25)
    assert [c.name for c in inner] == ["chunk/main/25"]
    assert [c.name for c in outer] == ["chunk/main/25", "device_loop/main"]
    ev = str(tmp_path / "ev.jsonl")
    events.get_bus().configure(jsonl_path=ev)
    assert sanitize._BUS_BRIDGE is events.get_bus()
    sanitize.record_compile("fleet", 0.5)
    events.get_bus().reset()
    sanitize.record_compile("fleet", 0.5)     # inactive: no event
    recs = [json.loads(ln) for ln in open(ev)]
    assert [(r["event"], r["name"], r["seconds"]) for r in recs] == \
        [("compile", "fleet", 0.5)]
    assert schema.check_file(ev) == [] and jax_schema.check_file(ev) == []


def test_branch_names():
    assert base.branch_name(None) == "main"
    assert base.branch_name((1, 0, 253)) == "1-0-253"
    assert base.branch_name("x") == "x"


def test_nvcc_build_reports_to_the_watch(tmp_path, monkeypatch):
    """kernels.build reports each library it compiles as nvcc/<lib>
    (nvcc stood in for, so the test needs no toolkit), and nothing for a
    library already built."""
    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info")

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "run", fake_run)
    with sanitize.watch_compiles() as recs:
        assert kernels.build("draw_tables") == "ptxas info"
        assert kernels.build("draw_tables") == ""
    assert [r.name for r in recs] == ["nvcc/draw_tables"]
    assert recs[0].seconds >= 0
