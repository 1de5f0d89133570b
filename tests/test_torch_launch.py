"""One command drives every device: the local launcher
(cocoa_torch/parallel/launch.py) that ``python -m cocoa_torch.cli``
becomes without ``--master`` when its mesh spans more than one device,
and ``--elastic=N,devices=D``, on the CPU (gloo).

- ``--mesh=2`` as one command prints the JAX CLI's one-process
  ``--mesh=2`` numbers at rtol 1e-9 and, line for line, what a
  hand-launched gang's rank 0 prints; ``--numSplits=2 --mesh=2 --fp=2``
  launches four ranks and prints the JAX CLI's (2, 2) mesh numbers.
- A bad ``--mesh``/``--fp`` exits 2 with the JAX CLI's words and starts
  no rank; the inferred mesh and its note follow the JAX CLI's rule on
  the device count; without ``--mesh`` a ``--device=cpu`` run stays in
  one process.
- A SIGKILLed rank, or a SIGTERM to the launcher, ends the launcher
  non-zero with no rank left alive.
- ``--elastic=2,devices=2`` supervises four ranks; a killed rank is
  named as its worker, and the gang resumes to the uninterrupted run's w
  at 1e-12.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_gang_cli  # noqa: E402
from _faults import Fault, FaultPlan, checkpoint_at_least, \
    sigkill  # noqa: E402
from conftest import DEMO_NUM_FEATURES, SMALL_TEST, SMALL_TRAIN  # noqa: E402
from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_torch import checkpoint, cli, elastic  # noqa: E402
from cocoa_torch.parallel import launch  # noqa: E402
from cocoa_torch.telemetry import events as port_events  # noqa: E402

RTOL = 1e-9
ATOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = [f"--trainFile={SMALL_TRAIN}", f"--testFile={SMALL_TEST}",
        f"--numFeatures={DEMO_NUM_FEATURES}", "--numSplits=4",
        "--numRounds=20", "--localIterFrac=0.1", "--lambda=.001",
        "--dtype=float64", "--debugIter=10"]
FP = ["--numSplits=2", "--mesh=2", "--fp=2"]
CPU = ["--device=cpu"]
ENV = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
_NUMBER_LINE = re.compile(
    r"^\s*(primal objective|primal-dual gap|test error|Total Objective "
    r"Value|Duality Gap|Test Error): (\S+)$", re.M)


def _numbers(text):
    return _NUMBER_LINE.findall(text)


def _same_numbers(got, want):
    assert [k for k, _ in got] == [k for k, _ in want] and got
    np.testing.assert_allclose([float(v) for _, v in got],
                               [float(v) for _, v in want], rtol=RTOL,
                               atol=ATOL)


def _command(argv, **kw):
    """``python -m cocoa_torch.cli <argv>`` as one command."""
    return subprocess.Popen([sys.executable, "-m", "cocoa_torch.cli",
                             *argv], cwd=REPO, env=ENV, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            **kw)


def _children(pid):
    """(pid, argv) of each live child of ``pid``, from /proc."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != pid:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
        except (OSError, ValueError, IndexError):
            continue
        out.append((int(entry), argv))
    return out


def _alive(pid) -> bool:
    """Whether ``pid`` is a live process (a zombie counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.fixture(scope="module")
def commands():
    """The one-command runs and a hand-launched gang, started together:
    (rc, stdout, stderr) of each."""
    procs = {"mesh2": [_command(DEMO + ["--mesh=2"] + CPU)],
             "fp": [_command(DEMO + FP + CPU)],
             "hand": torch_gang_cli.spawn([DEMO + ["--mesh=2"]] * 2)}
    got = torch_gang_cli.collect(list(procs.values()), timeout=240)
    return dict(zip(procs, got))


def test_mesh2_one_command_prints_the_jax_mesh_run(commands, capsys):
    """(a) ``--mesh=2`` as one command: the JAX CLI's ``--mesh=2``
    numbers, and the hand-launched gang's rank 0 stdout line for line."""
    (rc, out, err), = commands["mesh2"]
    assert rc == 0, err[-3000:]
    assert "gang: rank 0 of 2 on cpu, device group gloo" in out
    hand = commands["hand"]
    for rc_h, _, err_h in hand:
        assert rc_h == 0, err_h[-3000:]
    assert out.splitlines() == hand[0][1].splitlines()
    assert jax_cli.main(DEMO + ["--mesh=2"]) == 0
    ref = _numbers(capsys.readouterr().out)
    assert len(ref) == 2 * (2 * 3 + 3)
    _same_numbers(_numbers(out), ref)


def test_fp_one_command_prints_the_jax_fp_mesh_run(commands, capsys):
    """(b) ``--numSplits=2 --mesh=2 --fp=2``: four ranks launched, the
    JAX CLI's (2, 2) mesh numbers."""
    (rc, out, err), = commands["fp"]
    assert rc == 0, err[-3000:]
    assert ("gang: rank 0 of 4 on cpu, device group gloo, dp position 0 "
            "of 2, fp slice 0 of 2") in out
    assert jax_cli.main(DEMO + FP) == 0
    _same_numbers(_numbers(out), _numbers(capsys.readouterr().out))


@pytest.fixture
def no_launch(monkeypatch):
    """``launch.run_gang`` replaced by a recorder that starts nothing."""
    calls = []

    def record(argv, ranks, note=None, **kw):
        calls.append((list(argv), ranks, note))
        return 0

    monkeypatch.setattr(launch, "run_gang", record)
    return calls


def _err_lines(capsys):
    return [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("error:")]


REFUSED = [["--mesh=3"], ["--fp=2", "--mesh=1"], ["--mesh=x"],
           ["--fp=2", "--mesh=3"], ["--fp=2", "--mesh=2"]]


@pytest.mark.parametrize("devices", [1, 8])
@pytest.mark.parametrize("flags", REFUSED, ids=" ".join)
def test_bad_mesh_exits_2_before_any_rank(flags, devices, no_launch,
                                          monkeypatch, capsys):
    """(c) A bad ``--mesh``/``--fp`` without ``--master`` exits 2 with the
    JAX CLI's words (its 8 virtual devices named as the port's count)
    and starts no rank."""
    monkeypatch.setattr(cli, "_local_devices", lambda device: devices)
    assert jax_cli.main(DEMO + flags) == 2
    want = [ln.replace("have 8", f"have {devices}")
            for ln in _err_lines(capsys)]
    assert cli.main(DEMO + flags + CPU) == 2
    assert _err_lines(capsys) == want and len(want) == 1
    assert no_launch == []


def test_inferred_mesh_follows_the_jax_rule(no_launch, monkeypatch,
                                            capsys):
    """The largest divisor of K that fits the devices, and JAX's note
    when it leaves some idle: handed to the ranks (which print it after
    their echo) or printed by the one process; the user's rank flags are
    dropped from the ranks' argv."""
    notes = []
    monkeypatch.setattr(cli, "_train",
                        lambda *a, **kw: notes.append(a[-1]) or (0, []))
    for devices, k, ranks in ((8, 4, 4), (8, 6, 6), (8, 5, 5), (8, 7, 7),
                              (4, 6, 3), (2, 7, 1), (1, 4, 1), (8, 1, 1)):
        monkeypatch.setattr(cli, "_local_devices", lambda device: devices)
        argv = DEMO + [f"--numSplits={k}"] + CPU
        assert cli.main(argv) == 0
        if ranks == 1:
            note = notes.pop()
            assert not no_launch
        else:
            assert no_launch[-1][:2] == (argv, ranks)
            note = no_launch.pop()[2]
        want = None if ranks == devices else (
            f"note: inferred mesh uses {ranks} of {devices} devices "
            f"(largest divisor of numSplits={k} that fits); a numSplits "
            f"divisible by {devices} would use every device")
        assert note == want
        if devices == 8:
            # the JAX CLI on its 8 devices prints the same note (then
            # stops at a bad objective, before any data)
            assert jax_cli.main(DEMO + [f"--numSplits={k}",
                                        "--objective=bogus"]) == 2
            assert [ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("note:")] == ([want] if want else [])
        assert cli.main(argv + ["--quiet"]) == 0
        assert (notes.pop() if ranks == 1 else no_launch.pop()[2]) is None
    assert launch.rank_argv(["--a=1", "--processId=9", "--numProcesses=3",
                             "--b"], 1, 2, 1234, python="py") == [
        "py", "-m", "cocoa_torch.cli", "--a=1", "--b",
        "--master=127.0.0.1:1234", "--processId=1", "--numProcesses=2"]


def test_explicit_mesh_shares_a_card(no_launch, monkeypatch, capsys):
    """An explicit ``--mesh`` over more ranks than cards launches them
    with a note on stderr (the JAX CLI would refuse); ``--deviceLoop``
    there is refused with GLOO_DEVICE_LOOP's words before any rank."""
    from cocoa_torch.solvers.base import GLOO_DEVICE_LOOP

    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(cli, "_local_devices", lambda device: 1)
    assert cli.main(DEMO + ["--mesh=2"]) == 0
    assert no_launch[-1][1] == 2
    assert ("note: --mesh=2 x fp=1 puts 2 ranks on 1 card(s): ranks share "
            "a card over gloo") in capsys.readouterr().err
    assert cli.main(DEMO + ["--mesh=2", "--deviceLoop"]) == 2
    assert _err_lines(capsys) == [f"error: {GLOO_DEVICE_LOOP}"]
    assert len(no_launch) == 1
    monkeypatch.setattr(cli, "_local_devices", lambda device: 2)
    assert cli.main(DEMO + ["--mesh=2", "--deviceLoop"]) == 0
    assert "share a card" not in capsys.readouterr().err


def test_no_mesh_on_the_cpu_stays_in_one_process(no_launch, capsys):
    """(d) No ``--mesh`` under ``--device=cpu``: one process, no gang
    line, the same lines as ``--mesh=1``."""
    assert cli.main(DEMO + CPU) == 0
    out = capsys.readouterr().out
    assert "gang:" not in out and "note:" not in out and no_launch == []
    assert cli.main(DEMO + ["--mesh=1"] + CPU) == 0
    assert capsys.readouterr().out == out
    assert len(_numbers(out)) == 2 * (2 * 3 + 3)


LONG = [a for a in DEMO if not a.startswith("--numRounds")] + [
    "--numRounds=1000000", "--mesh=2"] + CPU


@pytest.mark.parametrize("fault", ["sigkill rank 1", "sigterm launcher",
                                   "sigkill launcher"])
def test_a_fault_ends_the_launcher_with_no_rank_left(fault):
    """(e) Once rank 0 has printed its first eval: SIGKILL rank 1, or
    SIGTERM the launcher, or SIGKILL it.  The launcher exits non-zero
    within 15 s, names the failed rank on stderr where it lives to, and
    leaves no rank alive (a SIGKILLed launcher's ranks die with it)."""
    proc = _command(LONG)
    try:
        for line in proc.stdout:
            if line.startswith("Iteration:"):
                break
        ranks = dict((int(next(a for a in argv if a.startswith(
            "--processId="))[12:]), pid) for pid, argv in _children(
            proc.pid))
        assert sorted(ranks) == [0, 1]
        t0 = time.monotonic()
        if fault == "sigkill rank 1":
            os.kill(ranks[1], signal.SIGKILL)
        else:
            proc.send_signal(signal.SIGTERM if fault == "sigterm launcher"
                             else signal.SIGKILL)
        _, err = proc.communicate(timeout=15)
        assert time.monotonic() - t0 < 15
        while (any(_alive(pid) for pid in ranks.values())
               and time.monotonic() - t0 < 15):
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    if fault == "sigkill rank 1":
        assert "launch: rank 1 of 2 failed (exit -9)" in err
        assert proc.returncode == 128 + 9
    elif fault == "sigterm launcher":
        assert re.search(r"launch: rank [01] of 2 failed \(exit -?\d+\)",
                         err), err[-2000:]
    else:
        assert proc.returncode == -9
    assert not any(_alive(pid) for pid in ranks.values())


def test_failed_rank_stderr_is_printed_with_its_rank(monkeypatch, capfd,
                                                    tmp_path):
    """A rank that fails has its stderr printed, each line ``[rank i]``;
    the launcher exits with its code."""
    (tmp_path / "launch_rank_stub.py").write_text(
        "import sys\n"
        "rank = [a for a in sys.argv if a.startswith('--processId=')][0]\n"
        "print('said by', rank, file=sys.stderr)\n"
        "sys.exit(3 if rank.endswith('=1') else 0)\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    assert launch.run_gang(["--x=1"], 3, module="launch_rank_stub") == 3
    err = capfd.readouterr().err
    assert "[rank 1] said by --processId=1" in err
    assert "[rank 2]" not in err
    assert "launch: rank 1 of 3 failed (exit 3)" in err


# --- --elastic=N,devices=D ------------------------------------------------


class _Proc:
    def __init__(self, code):
        self.code, self.pid = code, None

    def poll(self):
        return self.code

    def send_signal(self, sig):
        self.code = -sig

    def wait(self, timeout=None):
        return self.code


def test_supervise_spawns_d_ranks_a_worker(monkeypatch, capsys, tmp_path):
    """N workers of D devices are N x D ranks; rank 3's death is worker
    1's in the ``elastic:`` line and the flight-recorder dump (which
    reads rank 3's stream), and a shrink keeps K % (p x D) == 0."""
    spawned = []
    gen = {"n": -1}

    def spawn(worker_argv, i, n, port, python, module, quiet_tail, resume):
        if i == 0:
            gen["n"] += 1
        spawned.append((gen["n"], i, n))
        return _Proc(-9 if (gen["n"] == 0 and i == 3) else
                     (None if gen["n"] == 0 else 0))

    monkeypatch.setattr(elastic, "_spawn", spawn)
    ev = str(tmp_path / "ev.jsonl")
    with open(ev + ".p3", "w") as f:
        f.write(json.dumps({"event": "round_eval", "t": 10, "pid": 1}) + "\n")
    bus = port_events.get_bus()
    bus.configure(jsonl_path=ev)
    try:
        rc = elastic.supervise(["--x=1"], 2, python="py", module="m",
                               poll_s=0.0, num_splits=4, shrink="now",
                               devices_per_worker=2, backoff_base_s=0.0)
    finally:
        bus.reset()
    assert rc == 0
    assert [(g, n) for g, i, n in spawned if i == 0] == [(0, 4), (1, 2)]
    err = capsys.readouterr().err
    assert ("elastic: worker 1 (rank 3) died (exit -9); reforming the gang "
            "at 1 of 2 workers") in err
    with open(ev + ".p3.flightrec") as f:
        head = json.loads(f.readline())["flightrec_manifest"]
    assert head["victim_index"] == 1 and head["exit_code"] == -9
    assert head["victim_stream"].endswith(".p3")
    with open(ev) as f:
        recs = [json.loads(ln) for ln in f]
    resize = [r for r in recs if r["event"] == "gang_resize"]
    assert [(r["old_size"], r["new_size"]) for r in resize] == [(2, 1)]
    assert elastic.shrink_gang_size(4, 2, 2) == 1
    assert elastic.shrink_gang_size(6, 2, 4) is None


CHAOS = [f"--trainFile={SMALL_TRAIN}", f"--numFeatures={DEMO_NUM_FEATURES}",
         "--numSplits=4", "--numRounds=100", "--localIterFrac=0.1",
         "--lambda=.001", "--dtype=float64", "--debugIter=10",
         "--chkptIter=10", "--justCoCoA=true", "--quiet"]


def test_elastic_devices_resumes_to_the_uninterrupted_w(monkeypatch, capfd,
                                                        tmp_path):
    """(f) ``--elastic=2,devices=2`` at K=4: four ranks; rank 2 (worker
    1) is SIGKILLed once CoCoA+ saved round 10, the gang restarts from
    the checkpoint and ends on the uninterrupted run's w and alpha at
    1e-12."""
    ck = tmp_path / "ck"
    plan = FaultPlan(Fault(generation=0, actions=(sigkill(2),),
                           trigger=checkpoint_at_least(ck, "CoCoA+", 10),
                           name="chaos"), poll_s=0.005)
    real = elastic.supervise
    seen = {}

    def armed(argv, n, **kw):
        seen.update(kw, n=n)
        return real(argv, n, on_generation=plan.on_generation, poll_s=0.05,
                    **dict(kw, backoff_base_s=0.0))

    monkeypatch.setattr(elastic, "supervise", armed)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = cli.main(CHAOS + ["--elastic=2,devices=2", f"--chkptDir={ck}"]
                  + CPU)
    plan.join()
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert plan.errors == [] and plan.fired == ["chaos"]
    assert seen["n"] == 2 and seen["devices_per_worker"] == 2
    assert "elastic: worker 1 (rank 2) died (exit -9); restarting gang" \
        in err
    ref = tmp_path / "ref"
    assert cli.main(CHAOS + [f"--chkptDir={ref}", "--mesh=1"] + CPU) == 0
    for alg in ("CoCoA+", "CoCoA"):
        meta, w, a = checkpoint.load(checkpoint.latest(str(ck), alg))
        meta_r, w_r, a_r = checkpoint.load(checkpoint.latest(str(ref), alg))
        assert meta["round"] == meta_r["round"] == 100
        np.testing.assert_allclose(w, w_r, rtol=0,
                                   atol=ATOL * np.abs(w_r).max())
        np.testing.assert_allclose(a, a_r, rtol=0, atol=ATOL)
