"""``--fleet`` and ``--fleetLanes`` through both CLIs on the CPU: the
JAX CLI's hardening tables (tests/test_cli_flags.py
``test_cli_fleet_flag_hardening`` and
``test_cli_fleet_serve_flag_hardening``) with the same stderr line and
exit code from the port, and a float64 manifest through both with the
same per-tenant lines and ``--trajOut`` rows.

Flags the port does not support yet (``--mesh``, ``--fp``) keep the
port's own refusal beside ``--fleet`` (ROADMAP Queue A); ``--elastic``,
``--staleRounds`` and ``--overlapComm`` get the JAX CLI's.

The JAX fleet stages lambda*n and 1/n in float32 even at
``--dtype=float64`` (cocoa_tpu/solvers/fleet.py:162-175), so its float64
numbers stand ~1e-8 relative from its own solo runs; the port's float64
fleet equals the port's solo runs and the JAX solo runs to 1e-15
(tests/test_torch_fleet.py).  The gaps here are held to 1e-7 absolute
and relative: that staging, not a port fault."""

import io
import json
import re
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

pytest.importorskip("torch")

from cocoa_tpu import cli as jax_cli  # noqa: E402
from cocoa_tpu.data import fleet as jax_fleet  # noqa: E402
from cocoa_torch import cli  # noqa: E402
from cocoa_torch.data.fleet import TenantSpec, synth_fleet_specs, \
    write_fleet_manifest  # noqa: E402


def _both(argv):
    """[(rc, stdout, error lines)] of the JAX CLI, then the port's."""
    out = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device=cpu"])):
        so, se = io.StringIO(), io.StringIO()
        with redirect_stdout(so), redirect_stderr(se):
            rc = main(argv + extra)
        out.append((rc, so.getvalue(), [ln for ln in se.getvalue()
                                        .splitlines()
                                        if ln.startswith("error:")]))
    return out


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fleet") / "fleet.jsonl")
    write_fleet_manifest(path, synth_fleet_specs(2, n=48, d=16,
                                                 gap_target=1e-2))
    return path


def _base(man):
    return [f"--fleet={man}", "--numSplits=2", "--numRounds=20",
            "--debugIter=10", "--localIterFrac=0.25", "--quiet"]


# (extra flags, the JAX CLI's needle); the port prints the JAX CLI's line
HARDENING = [
    (["--resume", "--chkptDir=x"], "v1 surface"),
    (["--chkptDir=CK"], "v1 surface"),
    (["--warmStart=0.1,20", "--loss=hinge"], "loss phase"),
    (["--hotCols=auto"], "dense-layout only"),
    (["--evalDense=auto"], "dense-layout only"),
    (["--blockSize=128", "--math=fast"], "shard axes"),
    (["--blockPipeline=on"], "shard axes"),
    (["--testFile=x"], "test sets"),
    (["--trainFile=x", "--numFeatures=3"], "manifest"),
    (["--objective=lasso"], "lasso"),
    (["--sampling=device"], "host-samples"),
    (["--theta=adaptive", "--accel=on", "--gapTarget=1e-3"],
     "table shape"),
    (["--sigma=auto", "--sigmaSchedule=trial", "--gapTarget=1e-3"],
     "anneal"),
    (["--accel=on", "--sigma=auto", "--gapTarget=1e-3"], "fixed safe"),
    (["--fleetLanes=turbo"], "vmap|map"),
    (["--lambda=0.5"], "comes from the manifest"),
    (["--numFeatures=7"], "dataset ref"),
    (["--gapTarget=oops"], "must be a float"),
    (["--serve=0"], "separate processes"),
    (["--loss=logistic"], "drop --loss=logistic"),
    (["--sigmaSchedule=bogus"], "trial|anneal"),
    (["--elastic=2"], "tenant semantics"),
    (["--staleRounds=1"], "host-exchange"),
    (["--overlapComm=on"], "no per-round exchange"),
]
# the JAX CLI's rows whose flag the port does not support yet
UNPORTED = [["--mesh=4"], ["--fp=2"]]


@pytest.mark.parametrize("extra,needle", HARDENING,
                         ids=[" ".join(e) for e, _ in HARDENING])
def test_fleet_hardening_matches_jax_cli(manifest, tmp_path, extra, needle):
    extra = [a.replace("CK", str(tmp_path)) for a in extra]
    (rc_j, _, err_j), (rc_p, _, err_p) = _both(_base(manifest) + extra)
    assert rc_j == rc_p == 2
    assert len(err_j) == 1 and needle in err_j[0]
    assert err_p == err_j


@pytest.mark.parametrize("extra", UNPORTED, ids=[e[0] for e in UNPORTED])
def test_fleet_unported_flags_keep_the_port_refusal(manifest, extra,
                                                    capsys):
    assert jax_cli.main(_base(manifest) + extra) == 2
    capsys.readouterr()
    assert cli.main(_base(manifest) + extra + ["--device=cpu"]) == 2
    name = extra[0][2:].split("=")[0]
    assert f"error: --{name} is not yet ported to cocoa_torch " \
        f"(ROADMAP Queue A)" in capsys.readouterr().err


def test_fleet_lanes_needs_fleet_and_manifest_shapes(tmp_path):
    res = _both(["--fleetLanes=map", "--trainFile=x", "--numFeatures=3"])
    assert res[0][0] == res[1][0] == 2
    assert res[1][2] == res[0][2] and "needs --fleet" in res[0][2][0]
    bad = str(tmp_path / "bad.jsonl")
    write_fleet_manifest(bad, [
        TenantSpec("a", "synth:dense:n=48,d=16", 0.1, gap_target=1e-2),
        TenantSpec("b", "synth:dense:n=48,d=8", 0.1, gap_target=1e-2)])
    res = _both([f"--fleet={bad}", "--numSplits=2", "--numRounds=20",
                 "--debugIter=10", "--quiet"])
    assert res[0][0] == res[1][0] == 2
    assert res[1][2] == res[0][2] and "d=[8, 16]" in res[0][2][0]
    # a manifest that fails the schema, and a sparse synth ref
    with open(bad, "w") as f:
        f.write(json.dumps({"tenant": "a", "lam": 0.1}) + "\n")
    res = _both([f"--fleet={bad}", "--numSplits=2", "--numRounds=20",
                 "--debugIter=10", "--quiet"])
    assert res[1][2] == res[0][2] and "fleet_manifest header" in res[0][2][0]
    write_fleet_manifest(bad, [TenantSpec("a", "synth:sparse:n=48,d=16",
                                          0.1)])
    res = _both([f"--fleet={bad}", "--numSplits=2", "--quiet"])
    assert res[1][2] == res[0][2] and "synth refs are" in res[0][2][0]
    # --numRounds not a multiple of --debugIter
    write_fleet_manifest(bad, synth_fleet_specs(1, n=48, d=16))
    res = _both([f"--fleet={bad}", "--numSplits=2", "--numRounds=25",
                 "--debugIter=10", "--quiet"])
    assert res[0][0] == res[1][0] == 2
    assert res[1][2] == res[0][2] and "multiple of" in res[0][2][0]


SERVE_FLEET = [
    ["--serveReplicas=2", "CK", "--numFeatures=16", "--trainFile=x"],
    ["--serveRoute=rr", "CK", "--numFeatures=16", "--trainFile=x"],
    ["--serve=0", "CK", "--numFeatures=16", "--serveReplicas=0"],
    ["--serve=0", "CK", "--numFeatures=16", "--serveReplicas=oops"],
    ["--serve=0", "CK", "--numFeatures=16", "--serveReplicas=2",
     "--serveRoute=hash"],
    ["--serve=0", "CK", "--numFeatures=16", "--serveRoute=tenant"],
    ["--serve=0", "CK", "--numFeatures=16", "--serveReplicas=2",
     "--hotCols=auto", "--trainFile=x"],
]


@pytest.mark.parametrize("argv", SERVE_FLEET,
                         ids=[" ".join(a) for a in SERVE_FLEET])
def test_serve_fleet_hardening_matches_jax_cli(tmp_path, argv):
    argv = [f"--chkptDir={tmp_path}" if a == "CK" else a for a in argv]
    (rc_j, _, err_j), (rc_p, _, err_p) = _both(argv)
    assert rc_j == rc_p == 2 and len(err_j) == 1
    assert err_p == err_j


_TENANT = re.compile(r"^  (\S+): lambda=(\S+) gap=(\S+) (.*)$", re.M)
_SUMMARY = re.compile(r"^fleet: (\d+)/(\d+) tenants certified, (\d+) "
                      r"rounds, .* \(drive_mode=(\w+), lanes=(\w+)\)$", re.M)
_RUNNING = re.compile(r"^Running CoCoA\+ fleet: .*$", re.M)


@pytest.mark.parametrize("extra", [[], ["--fleetLanes=map"],
                                   ["--sigma=auto"], ["--accel=on"]],
                         ids=["plain", "map", "anneal", "accel"])
def test_fleet_run_matches_jax_cli(tmp_path, extra):
    """A 4-tenant float64 manifest of two sizes and two targets through
    both CLIs: the same running line (but the padded n_shard), per-tenant
    lines (the gap to 1e-7), summary and ``--trajOut`` rows."""
    man = str(tmp_path / "f.jsonl")
    specs = synth_fleet_specs(4, n=96, d=32, gap_target=1e-2)
    specs[1] = TenantSpec("big", "synth:dense:n=98,d=32,seed=9", 0.01,
                          gap_target=3e-3)
    write_fleet_manifest(man, specs)
    argv = [f"--fleet={man}", "--numSplits=2", "--numRounds=100",
            "--debugIter=10", "--localIterFrac=0.25", "--dtype=float64"]
    outs = []
    for i, (main, dev) in enumerate(((jax_cli.main, []),
                                     (cli.main, ["--device=cpu"]))):
        so = io.StringIO()
        with redirect_stdout(so):
            assert main(argv + extra + dev
                        + [f"--trajOut={tmp_path}/t{i}"]) == 0
        outs.append(so.getvalue())
    (jout, pout) = outs
    # the JAX fleet rounds n_shard up to a multiple of 16, the port not
    assert [re.sub(r"n_shard=\d+", "", ln) for ln in _RUNNING.findall(pout)] \
        == [re.sub(r"n_shard=\d+", "", ln) for ln in _RUNNING.findall(jout)]
    assert "n_shard=49" in pout
    assert _SUMMARY.findall(pout) == _SUMMARY.findall(jout)
    jt, pt = _TENANT.findall(jout), _TENANT.findall(pout)
    assert len(pt) == len(jt) == 4
    for a, b in zip(pt, jt):
        assert (a[0], a[1], a[3]) == (b[0], b[1], b[3])
        assert abs(float(a[2]) - float(b[2])) <= 1e-7 + 1e-7 * abs(
            float(b[2]))
    rows = [[json.loads(ln) for ln in open(f"{tmp_path}/t{i}.fleet.jsonl")]
            for i in (0, 1)]
    for a, b in zip(rows[1], rows[0]):
        assert set(a) == set(b)
        for key in a:
            if key == "models_per_second":
                continue
            if key == "gap":
                assert abs(a[key] - b[key]) <= 1e-7 + 1e-7 * abs(b[key])
            else:
                assert a[key] == b[key], key
    assert jax_fleet.load_fleet_manifest(man)[1].tenant == "big"
