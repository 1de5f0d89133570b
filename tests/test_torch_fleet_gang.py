"""``--fleet`` across a gang's processes on the CPU: ``python -m
cocoa_torch.cli --fleet=M --master=H:P --processId=i --numProcesses=N``
ranks over gloo, each running the whole fleet as each process of the JAX
CLI does (cocoa_tpu/cli.py:957-973, 1031).

Each rank's tenant lines and summary are held to the JAX CLI's
single-process fleet on the same float64 manifest (the JAX CLI's
multi-process fleet prints the same lines as its single-process one):
lambda, status and certified rounds equal, the gap within 1e-7 +
1e-7·|gap| for the JAX fleet's float32 staging of lambda*n and 1/n
(tests/test_torch_fleet_cli.py).  The ranks agree bit for bit.  Rank r
writes ``<events>`` (rank 0) or ``<events>.p<r>``; rank 0 alone writes the
metrics textfile and ``--trajOut``'s ``P.fleet.jsonl``.  The refusals
beside a gang's ``--fleet`` give the JAX CLI's line and exit 2, and no
peer is left waiting."""

import io
import json
import os
import re
from contextlib import redirect_stderr, redirect_stdout

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_gang_cli  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch.data.fleet import TenantSpec, synth_fleet_specs, \
    write_fleet_manifest  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402

TIMEOUT = 180   # s for a gang's children, then they are killed
MODES = {"plain": [], "map": ["--fleetLanes=map"], "accel": ["--accel=on"]}
_TENANT = re.compile(r"^  (\S+): lambda=(\S+) gap=(\S+) (.*)$", re.M)
_SUMMARY = re.compile(r"^fleet: (\d+)/(\d+) tenants certified, (\d+) "
                      r"rounds, .* \(drive_mode=(\w+), lanes=(\w+)\)$", re.M)


def _close(got, want) -> bool:
    return abs(got - want) <= 1e-7 + 1e-7 * abs(want)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Four float64 tenants of two sizes and two targets, as
    ``test_fleet_run_matches_jax_cli`` builds them."""
    path = str(tmp_path_factory.mktemp("fleet_gang") / "f.jsonl")
    specs = synth_fleet_specs(4, n=96, d=32, gap_target=1e-2)
    specs[1] = TenantSpec("big", "synth:dense:n=98,d=32,seed=9", 0.01,
                          gap_target=3e-3)
    write_fleet_manifest(path, specs)
    return path


def _argv(man):
    return [f"--fleet={man}", "--numSplits=2", "--numRounds=100",
            "--debugIter=10", "--localIterFrac=0.25", "--dtype=float64"]


def _jax(argv):
    """(rc, stdout, error lines) of the JAX CLI in process."""
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        rc = jax_cli.main(argv)
    return rc, so.getvalue(), [ln for ln in se.getvalue().splitlines()
                               if ln.startswith("error:")]


@pytest.fixture(scope="module")
def runs(manifest, tmp_path_factory):
    """Every gang of the file, started together: a gang of 2 in each
    mode (the plain one with ``--events``, per-rank ``--metrics`` and
    ``--trajOut`` paths), and a gang of 1.  Returns ({name: [(rc, stdout,
    stderr)] a rank}, the plain gang's directory)."""
    tmp = tmp_path_factory.mktemp("fleet_gang_runs")
    argvs = {mode: [_argv(manifest) + extra] * 2
             for mode, extra in MODES.items()}
    argvs["plain"] = [
        _argv(manifest) + [f"--events={tmp}/ev.jsonl",
                           f"--metrics={tmp}/m{r}.prom",
                           f"--trajOut={tmp}/t{r}"] for r in (0, 1)]
    argvs["one"] = [_argv(manifest)]
    names = list(argvs)
    done = torch_gang_cli.collect(
        [torch_gang_cli.spawn(argvs[n]) for n in names], TIMEOUT)
    return dict(zip(names, done)), tmp


@pytest.fixture(scope="module")
def jax_runs(manifest):
    """The JAX CLI's single-process fleet's stdout in each mode."""
    out = {}
    for mode, extra in MODES.items():
        rc, text, err = _jax(_argv(manifest) + extra)
        assert rc == 0, err
        out[mode] = text
    return out


def _held_to_jax(out, want):
    got, ref = _TENANT.findall(out), _TENANT.findall(want)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert (a[0], a[1], a[3]) == (b[0], b[1], b[3])
        assert _close(float(a[2]), float(b[2])), (a, b)
    assert _SUMMARY.findall(out) == _SUMMARY.findall(want)
    assert len(_SUMMARY.findall(out)) == 1


@pytest.mark.parametrize("mode", list(MODES))
def test_each_rank_prints_the_jax_fleet(runs, jax_runs, mode):
    r0, r1 = runs[0][mode]
    for rank, (rc, out, err) in enumerate((r0, r1)):
        assert rc == 0, err[-2000:]
        assert (f"gang: rank {rank} of 2 on cpu; each rank runs the whole "
                f"fleet") in out
        _held_to_jax(out, jax_runs[mode])
    # the two ranks' lines, bit for bit
    assert _TENANT.findall(r0[1]) == _TENANT.findall(r1[1])


def test_a_gang_of_one(runs, jax_runs):
    (rc, out, err), = runs[0]["one"]
    assert rc == 0, err[-2000:]
    assert "gang: rank 0 of 1 on cpu" in out
    _held_to_jax(out, jax_runs["plain"])


def test_events_and_metrics_by_rank(runs):
    """Rank 0 writes ``<events>``, rank 1 ``<events>.p1``, each
    schema-valid from ``run_start`` (the gang's flags as given, its
    process count and index) to ``run_end``, with the same certified
    tenants, rounds and gaps; the metrics textfile comes from rank 0."""
    _, tmp = runs
    certified = []
    for rank, path in ((0, f"{tmp}/ev.jsonl"), (1, f"{tmp}/ev.jsonl.p1")):
        assert schema.check_file(path) == [], path
        with open(path) as f:
            evs = [json.loads(ln) for ln in f]
        assert evs[0]["event"] == "run_start"
        assert evs[-1]["event"] == "run_end"
        man = evs[0]["manifest"]
        assert (man["process_count"], man["process_index"]) == (2, rank)
        assert man["config"]["processId"] == str(rank)
        assert man["config"]["numProcesses"] == "2"
        assert man["fleet"]["tenants"] == 4
        certified.append([(e["tenant"], e["t"], e["gap"]) for e in evs
                          if e["event"] == "tenant_certified"])
    assert certified[0] == certified[1] and len(certified[0]) >= 1
    assert not os.path.exists(f"{tmp}/ev.jsonl.p2")
    with open(f"{tmp}/m0.prom") as f:
        assert "cocoa_fleet_models_per_second" in f.read()
    assert not os.path.exists(f"{tmp}/m1.prom")


def test_traj_out_from_rank_0_equals_jax(runs, manifest, tmp_path):
    """``--trajOut``'s rows come from rank 0 alone, equal to the JAX
    CLI's (the gap to 1e-7, models/s apart)."""
    _, tmp = runs
    assert not os.path.exists(f"{tmp}/t1.fleet.jsonl")
    rc, _, err = _jax(_argv(manifest) + [f"--trajOut={tmp_path}/j"])
    assert rc == 0, err
    rows = [[json.loads(ln) for ln in open(path)] for path in
            (f"{tmp}/t0.fleet.jsonl", f"{tmp_path}/j.fleet.jsonl")]
    assert len(rows[0]) == len(rows[1]) == 5
    for a, b in zip(*rows):
        assert set(a) == set(b)
        for key in a:
            if key == "gap":
                assert _close(a[key], b[key])
            elif key != "models_per_second":
                assert a[key] == b[key], key


# (the flags, the processIds given): each rank refuses with the JAX CLI's
# line and exits 2
REFUSALS = {"mesh": (["--mesh=2"], None), "fp": (["--fp=2"], None),
            "elastic": (["--elastic=2"], None),
            "processId": ([], ["x", "x"])}


@pytest.fixture(scope="module")
def refusals(manifest):
    names = list(REFUSALS)
    done = torch_gang_cli.collect(
        [torch_gang_cli.spawn([_argv(manifest) + REFUSALS[n][0]] * 2,
                              ids=REFUSALS[n][1]) for n in names], TIMEOUT)
    return dict(zip(names, done))


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_beside_a_gang_fleet(refusals, manifest, name):
    flags, ids = REFUSALS[name]
    # the JAX CLI refuses these before it would join (the bad rank, the
    # flag surface) or, for --mesh and --fp, once it has joined: its
    # single-process run prints the same line
    gang = (["--master=127.0.0.1:1", "--processId=x", "--numProcesses=2"]
            if ids else [])
    rc, _, want = _jax(_argv(manifest) + flags + gang)
    assert rc == 2 and len(want) == 1
    for rc, out, err in refusals[name]:
        assert rc == 2
        assert [ln for ln in err.splitlines()
                if ln.startswith("error:")] == want
        assert "Running" not in out
