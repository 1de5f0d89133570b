"""torchlint (cocoa_torch/analysis): each rule's known-bad fixture caught
and its known-good one passed, the suppression, baseline and report
machinery (against the JAX package's core, tests/test_analysis.py:662-
750), the kernel-budget sweep and its AST half, and the tree itself
clean through ``python -m cocoa_torch.analysis``."""

import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from cocoa_tpu.analysis import core as jax_core  # noqa: E402
from cocoa_tpu.telemetry import schema as jax_schema  # noqa: E402
from cocoa_torch import analysis  # noqa: E402
from cocoa_torch.analysis import core, kernel_budget, rules  # noqa: E402
from cocoa_torch.analysis.__main__ import main as lint_main  # noqa: E402
from cocoa_torch.ops import sparse_sdca  # noqa: E402
from cocoa_torch.telemetry import schema  # noqa: E402


def lint(tmp_path, code, relpath="fixture.py", rule=None, extra=None):
    """Lint one source fixture (and ``extra`` {relpath: code} beside it);
    returns the findings of ``relpath`` (optionally one rule's)."""
    files = {relpath: code, **(extra or {})}
    sources = {}
    for rel, text in files.items():
        ab = tmp_path / rel
        ab.parent.mkdir(parents=True, exist_ok=True)
        ab.write_text(text)
        src = core.load_source(str(tmp_path), rel)
        assert src is not None, f"fixture {rel} failed to parse"
        sources[src.path] = src
    found = rules.run_static_rules(sources)
    core.fingerprint_findings(found, sources)
    core.apply_suppressions(found, sources)
    found = [f for f in found if f.path == relpath]
    if rule is not None:
        found = [f for f in found if f.rule == rule]
    return found


# --- scatter-order -----------------------------------------------------------

# C5's old shape: a row drawn twice in a block adds two deltas at one index
C5_SHAPE = """
def block_alpha_add(a_vec, bidx, delta):
    a_vec.scatter_add_(1, bidx, delta)
    return a_vec
"""

# C5's fix (ops/local_sdca.py _block_alpha_add): each slot's total summed in
# a fixed order, written with scatter_ (one value a row)
C5_FIXED = """
def block_alpha_add(a_vec, bidx, delta):
    eq = (bidx[:, :, None] == bidx[:, None, :]).to(delta.dtype)
    total = (eq * delta[:, None, :]).sum(-1)
    a_vec.scatter_(1, bidx, a_vec.gather(1, bidx) + total)
"""


def test_scatter_order_catches_c5_shape(tmp_path):
    found = lint(tmp_path, C5_SHAPE, "cocoa_torch/ops/x.py",
                 "scatter-order")
    assert len(found) == 1 and "scatter_add_" in found[0].message
    assert "C4/C5" in found[0].message


def test_scatter_order_passes_c5_fix(tmp_path):
    assert lint(tmp_path, C5_FIXED, "cocoa_torch/ops/x.py",
                "scatter-order") == []


@pytest.mark.parametrize("call", [
    "dw.index_add_(0, cols, vals)",
    "dw.index_add(0, cols, vals)",
    "dw.index_put_((cols,), vals, accumulate=True)",
    "dw.index_put_((cols,), vals, True)",
    "dw.put_(cols, vals, accumulate=True)",
    "torch.Tensor.put_(dw, cols, vals, accumulate=True)",
])
def test_scatter_order_catches_every_spelling(tmp_path, call):
    code = f"import torch\n\ndef f(dw, cols, vals):\n    return {call}\n"
    found = lint(tmp_path, code, "cocoa_torch/solvers/x.py", "scatter-order")
    assert len(found) == 1, call


@pytest.mark.parametrize("call", [
    "dw.index_put_((cols,), vals)",
    "dw.put_(cols, vals)",
    "dw.scatter_(1, cols, vals)",
    "dw.index_copy_(0, cols, vals)",
])
def test_scatter_order_passes_ordered_writes(tmp_path, call):
    code = f"def f(dw, cols, vals):\n    return {call}\n"
    assert lint(tmp_path, code, "cocoa_torch/ops/x.py",
                "scatter-order") == []


def test_scatter_order_scoped_to_ops_and_solvers(tmp_path):
    assert lint(tmp_path, C5_SHAPE, "cocoa_torch/serving/x.py",
                "scatter-order") == []


def test_scatter_order_allowed_with_reason(tmp_path):
    code = """
def row_axpy(vec, idx, vals):
    # torchlint: allow=scatter-order -- a row's columns are distinct
    vec.scatter_add_(1, idx, vals)
"""
    found = lint(tmp_path, code, "cocoa_torch/ops/x.py", "scatter-order")
    assert len(found) == 1 and found[0].suppressed
    assert "distinct" in found[0].suppression_reason


# --- host-sync ---------------------------------------------------------------

HOST_SYNC_BAD = """
import torch
from cocoa_torch.solvers import base

def run(state, metrics, sampler):
    def round_fn(state, idxs_kh, t):
        w, alpha = state
        if (alpha > 0).any():
            alpha = alpha * 2
        scale = float(w.sum())
        top = alpha.max().item()
        n = int(idxs_kh[0, 0])
        rows = alpha.tolist()
        torch.cuda.synchronize()
        return (w * scale, alpha)

    return base.drive("x", None, None, state, base.per_round(round_fn),
                      metrics, sampler, "cuda", 10)
"""

HOST_SYNC_RUNNER = """
from cocoa_torch.solvers.base import ChunkRunner

def helper(x):
    return x.cpu()

def body(key, c, tables, t0, iterate):
    return (helper(iterate[0]),)

runner = ChunkRunner(body, None, "cuda")
"""

HOST_SYNC_GOOD = """
import torch
from cocoa_torch.analysis import sanitize
from cocoa_torch.solvers import base
from cocoa_torch.telemetry import events

def run(state, metrics, sampler, c):
    def round_fn(state, idxs_kh, t):
        w, alpha = state
        alpha = torch.where(alpha > 0, alpha * 2, alpha)
        with sanitize.intended_fetch("probe"):
            top = alpha.max().item()
        seen = events.host_fetch(w, "probe")
        k = int(c)
        return (w, alpha)

    return base.drive("x", None, None, state, base.per_round(round_fn),
                      metrics, sampler, "cuda", 10)

def host_side(t):
    # not captured: reads the device at the host boundary
    return float(t.sum()), t.cpu().numpy()
"""


def test_host_sync_catches_reads_in_captured_code(tmp_path):
    found = lint(tmp_path, HOST_SYNC_BAD, "cocoa_torch/solvers/x.py",
                 "host-sync")
    msgs = sorted(f.message.split(" ")[0] for f in found)
    assert len(found) == 6, [f.message for f in found]
    assert "`if`" in msgs and "`float()`" in msgs and "`int()`" in msgs
    assert "`.item()`" in msgs and "`.tolist()`" in msgs
    assert any("synchronize" in f.message for f in found)


def test_host_sync_follows_runner_bodies_into_helpers(tmp_path):
    found = lint(tmp_path, HOST_SYNC_RUNNER, "cocoa_torch/solvers/x.py",
                 "host-sync")
    assert len(found) == 1 and "`.cpu()`" in found[0].message


def test_host_sync_passes_sanctioned_reads(tmp_path):
    assert lint(tmp_path, HOST_SYNC_GOOD, "cocoa_torch/solvers/x.py",
                "host-sync") == []


def test_host_sync_covers_kernel_wrappers(tmp_path):
    code = """
from cocoa_torch import kernels

def _library():
    return kernels.load("x")

def wrapper(w, row_len):
    width = int(row_len.max())
    return _library().run(w, width)

kernels.count_launches(wrapper, "launches")
"""
    found = lint(tmp_path, code, "cocoa_torch/ops/x.py", "host-sync")
    assert len(found) == 1 and "`int()`" in found[0].message


# --- f64 ---------------------------------------------------------------------

F64_CODE = """
import numpy as np
import torch

def f(x):
    a = torch.zeros(3, dtype=torch.float64)
    b = x.double()
    c = np.asarray(x, np.float64)
    return x.to("float64"), a, b, c
"""


def test_f64_caught_outside_evals(tmp_path):
    found = lint(tmp_path, F64_CODE, "cocoa_torch/ops/x.py", "f64")
    assert len(found) == 4
    assert lint(tmp_path, F64_CODE, "cocoa_torch/evals/x.py", "f64") == []


def test_f64_inline_allow(tmp_path):
    code = """
import numpy as np

def parse(tokens):
    # torchlint: allow=f64 -- host-side exact parse fixture
    return np.asarray(tokens, dtype=np.float64)
"""
    found = lint(tmp_path, code, "cocoa_torch/data/x.py", "f64")
    assert len(found) == 1 and found[0].suppressed
    assert "exact parse" in found[0].suppression_reason


# --- kernel-budget (the AST half) --------------------------------------------

KB_MODULE = """
from cocoa_torch import kernels

def x_plan(width, itemsize, smem_optin):
    return 1, width * itemsize

def _library():
    return kernels.load("x")

def x_round(w):
    plan = x_plan(w.shape[0], 4, kernels.smem_optin(w.device))
    return _library().run(w, *plan)

kernels.count_launches(x_round, "launches")
"""

KB_CONSUMER = """
from cocoa_torch.ops import x

def route(width):
    return x.x_plan(width, 4, 232448)
"""


def test_kernel_budget_plan_nobody_consults_caught(tmp_path):
    found = lint(tmp_path, KB_MODULE, "cocoa_torch/ops/x.py",
                 "kernel-budget")
    assert len(found) == 1 and found[0].severity == "warning"
    assert "x_plan" in found[0].message and "protects nothing" in \
        found[0].message
    assert lint(tmp_path, KB_MODULE, "cocoa_torch/ops/x.py",
                "kernel-budget",
                extra={"cocoa_torch/solvers/y.py": KB_CONSUMER}) == []


def test_kernel_budget_unregistered_wrapper_caught(tmp_path):
    code = KB_MODULE.replace('kernels.count_launches(x_round, "launches")',
                             "")
    found = lint(tmp_path, code, "cocoa_torch/ops/x.py", "kernel-budget",
                 extra={"cocoa_torch/solvers/y.py": KB_CONSUMER})
    assert len(found) == 1 and "count_launches" in found[0].message


def test_kernel_budget_dynamic_smem_needs_a_plan(tmp_path):
    (tmp_path / "cocoa_torch" / "csrc").mkdir(parents=True)
    (tmp_path / "cocoa_torch" / "csrc" / "x.cu").write_text(
        "__global__ void k() { extern __shared__ float s[]; }\n")
    code = """
from cocoa_torch import kernels

def x_round(w):
    return kernels.load("x").run(w)

kernels.count_launches(x_round, "launches")
"""
    found = lint(tmp_path, code, "cocoa_torch/ops/x.py", "kernel-budget")
    assert len(found) == 1 and "no *_plan" in found[0].message
    # a plan that is never given the card's opt-in
    unfed = KB_MODULE.replace("kernels.smem_optin(w.device)", "232448")
    found = lint(tmp_path, unfed, "cocoa_torch/ops/x.py", "kernel-budget",
                 extra={"cocoa_torch/solvers/y.py": KB_CONSUMER})
    assert len(found) == 1 and "smem_optin" in found[0].message
    # a kernel without dynamic shared memory (the draw kernel) needs none
    (tmp_path / "cocoa_torch" / "csrc" / "x.cu").write_text(
        "__global__ void k(int* out) { out[0] = 1; }\n")
    assert lint(tmp_path, code, "cocoa_torch/ops/x.py",
                "kernel-budget") == []


def test_kernel_budget_cpu_sweep_clean():
    """tests/test_analysis.py:334: every plan at every main-path shape
    and corner is within the H100's opt-in."""
    assert kernel_budget.run_budget_checks() == []


def test_kernel_budget_cases_cover_every_kernel():
    cases = kernel_budget.main_path_cases()
    assert {c.tag for c in cases} == {"B1", "B1h", "B2", "B3", "B4", "B5",
                                      "B6", "D"}
    assert all(c.dyn <= kernel_budget.SMEM_OPTIN for c in cases)
    kernels_named = {c.kernel for c in cases}
    assert "gram_pass_kernel<float,1>" in kernels_named
    assert "dense_sdca_round_kernel<float,global,chunked>" in kernels_named
    assert "sparse_sdca_hybrid_kernel<float,smem,regs>" in kernels_named


def test_kernel_budget_catches_an_over_asking_plan(monkeypatch):
    """tests/test_analysis.py:340: a plan that asks for more than the
    opt-in is caught by the sweep."""
    real = sparse_sdca.sparse_plan

    def greedy(width, d, itemsize, smem_optin, **kw):
        in_smem, stages, slot, regs = real(width, d, itemsize, smem_optin,
                                           **kw)
        return in_smem, sparse_sdca.MAX_STAGES, width, regs

    greedy.__module__ = real.__module__
    monkeypatch.setattr(sparse_sdca, "sparse_plan", greedy)
    found = kernel_budget.run_budget_checks()
    assert found and all(f.rule == "kernel-budget" for f in found)
    assert any("over the opt-in" in f.message for f in found)


def test_kernel_budget_catches_a_plan_past_its_corner(monkeypatch):
    def lenient(b, itemsize, smem_optin, stages=None):
        return 1, 8, 0

    monkeypatch.setattr(kernel_budget.bc, "chain_plan", lenient)
    found = kernel_budget.check_corners()
    assert any("CHAIN_MAX_B" in f.message for f in found)


# --- span-hygiene ------------------------------------------------------------

SPAN_BAD = """
from cocoa_torch.solvers.base import ChunkRunner
from cocoa_torch.telemetry import tracing

def body(key, c, tables, t0, iterate):
    with tracing.span("round", c=c):
        return iterate

@tracing.traced("step")
def step_fn(state, tabs):
    return state

def host(w, alpha):
    with tracing.span("eval", top=alpha.max().item(), norm=w.norm()):
        pass

runner = ChunkRunner(body, None, "cuda")
fleet = FleetRunner(step_fn, None, None, None, None, None)
"""

SPAN_GOOD = """
import re
from cocoa_torch.solvers.base import ChunkRunner
from cocoa_torch.telemetry import tracing

def body(key, c, tables, t0, iterate):
    m = re.match("a", "a")
    return iterate, m.span()

def host(name, end):
    with tracing.span("local_solve", algorithm=name, round=end):
        runner(None, end, 10, ())

runner = ChunkRunner(body, None, "cuda")
"""


def test_span_hygiene_caught(tmp_path):
    found = lint(tmp_path, SPAN_BAD, "cocoa_torch/solvers/x.py",
                 "span-hygiene")
    assert len(found) == 3, [f.message for f in found]
    assert any("@traced" in f.message for f in found)
    assert any("attribute reads a device tensor" in f.message
               for f in found)


def test_span_hygiene_host_spans_clean(tmp_path):
    assert lint(tmp_path, SPAN_GOOD, "cocoa_torch/solvers/x.py",
                "span-hygiene") == []


# --- overlap-hygiene ---------------------------------------------------------

OVERLAP_BAD = """
from cocoa_torch.parallel import distributed
from cocoa_torch.solvers.base import ChunkRunner

def body(key, c, tables, t0, iterate):
    h = distributed.async_host_allgather_bytes("t", b"x")
    return iterate

def exchange(payload):
    h = distributed.async_kv_get(None, "k")
    return payload

runner = ChunkRunner(body, None, "cuda")
"""

OVERLAP_GOOD = """
from cocoa_torch.parallel import distributed

def joined(payload):
    h = distributed.async_host_allgather_bytes("t", payload)
    return h.join()

def handed(window, payload):
    h = distributed.async_host_allgather_bytes("t", payload)
    window.admit(h)

def returned(payload):
    h = distributed.async_kv_get(None, "k")
    return h
"""


def test_overlap_hygiene_caught(tmp_path):
    found = lint(tmp_path, OVERLAP_BAD, "cocoa_torch/solvers/x.py",
                 "overlap-hygiene")
    assert len(found) == 2
    assert any("inside captured code" in f.message for f in found)
    assert any("never joined" in f.message for f in found)


def test_overlap_hygiene_joined_or_escaping_clean(tmp_path):
    assert lint(tmp_path, OVERLAP_GOOD, "cocoa_torch/solvers/x.py",
                "overlap-hygiene") == []


# --- fleet-hygiene -----------------------------------------------------------

FLEET_BAD = """
import torch
from cocoa_torch.solvers.base import FleetRunner

def run(lanes, tables, state, key, res):
    def step_fn(state, tabs):
        return state, state

    def eval_fn(state):
        return torch.stack([state[0][t].sum() for t, sh in enumerate(lanes)])

    for t in range(len(res.tenants)):
        print(res.w[t].item())
    return FleetRunner(step_fn, eval_fn, None, tables, state, key)
"""

FLEET_GOOD = """
import torch
from cocoa_torch.solvers.base import FleetRunner
from cocoa_torch.telemetry import events

def run(tables, state, key, res):
    def step_fn(state, tabs):
        return state, state

    def eval_fn(state):
        return state[0].sum(-1)

    w = events.host_fetch(res.w, "fleet_result_fetch")
    for t, tenant in enumerate(res.tenants):
        print(tenant, w[t])
    return FleetRunner(step_fn, eval_fn, None, tables, state, key)
"""


def test_fleet_hygiene_caught(tmp_path):
    found = lint(tmp_path, FLEET_BAD, "cocoa_torch/solvers/x.py",
                 "fleet-hygiene")
    assert len(found) == 2
    assert any("inside captured code" in f.message for f in found)
    assert any("per-tenant `item`" in f.message for f in found)


def test_fleet_hygiene_batched_and_prefetched_clean(tmp_path):
    assert lint(tmp_path, FLEET_GOOD, "cocoa_torch/solvers/x.py",
                "fleet-hygiene") == []


# --- serve-hygiene -----------------------------------------------------------

SERVE_BAD = """
import time
import numpy as np
import torch
from cocoa_torch.solvers.base import ChunkRunner

def drain(requests, width):
    return np.zeros((len(requests), width), np.int32)

def score(w, idx, val):
    out = (w[idx] * val).sum(-1)
    return out.cpu()

def cast(w):
    return w.to(torch.bfloat16)

def scale(w):
    return torch.max(torch.abs(w)) / 127

def body(key, c, tables, t0, iterate):
    t = time.monotonic()
    return iterate

runner = ChunkRunner(body, None, "cuda")
"""

SERVE_GOOD = """
import time
import numpy as np
import torch
from cocoa_torch.telemetry import events

class Scorer:
    def __init__(self, buckets, width):
        self.bufs = {b: np.zeros((b, width), np.int32) for b in buckets}

    def warmup(self, w):
        self.w = w.to(torch.bfloat16)
        return self.score(w, None, None).cpu()

    def score(self, w, idx, val):
        return (w[idx] * val).sum(-1).to(torch.float32)

    def fetch(self, out):
        t0 = time.monotonic()
        return events.host_fetch(out, "serve_fetch"), time.monotonic() - t0
"""


def test_serve_hygiene_caught(tmp_path):
    found = lint(tmp_path, SERVE_BAD, "cocoa_torch/serving/x.py",
                 "serve-hygiene")
    assert len(found) == 5, [f.message for f in found]
    assert any("len(...)" in f.message for f in found)
    assert any("`.cpu()`" in f.message for f in found)
    assert any("clock" in f.message for f in found)
    assert sum("quantization" in f.message for f in found) == 2


def test_serve_hygiene_builders_and_fetch_clean(tmp_path):
    assert lint(tmp_path, SERVE_GOOD, "cocoa_torch/serving/x.py",
                "serve-hygiene") == []


def test_serve_hygiene_scoped_to_serving_and_quantizer(tmp_path):
    assert lint(tmp_path, SERVE_BAD, "cocoa_torch/ops/x.py",
                "serve-hygiene") == []
    quant = "import torch\n\ndef pack(w):\n    return w.to(torch.bfloat16)\n"
    assert lint(tmp_path, quant, "cocoa_torch/serving/quantize.py",
                "serve-hygiene") == []


# --- suppressions, fingerprints, baseline, report ----------------------------


def test_suppression_without_reason_refused(tmp_path):
    code = """
def f(vec, idx, vals):
    # torchlint: allow=scatter-order
    vec.scatter_add_(1, idx, vals)
"""
    found = lint(tmp_path, code, "cocoa_torch/ops/x.py")
    bare = [f for f in found if f.rule == "suppression"]
    assert len(bare) == 1 and bare[0].actionable
    scatter = [f for f in found if f.rule == "scatter-order"]
    assert len(scatter) == 1 and scatter[0].actionable


def test_fingerprints_survive_unrelated_edits(tmp_path):
    found1 = lint(tmp_path, C5_SHAPE, "cocoa_torch/ops/a.py")
    shifted = "# an unrelated comment\n" + C5_SHAPE
    found2 = lint(tmp_path, shifted, "cocoa_torch/ops/a.py")
    fp1 = {f.fingerprint for f in found1}
    assert fp1 and fp1 == {f.fingerprint for f in found2}


def test_baseline_roundtrip(tmp_path):
    findings = lint(tmp_path, C5_SHAPE, "cocoa_torch/ops/a.py")
    bl_path = str(tmp_path / "baseline.json")
    core.write_baseline(findings, bl_path)
    bl = core.load_baseline(bl_path)
    assert all(e["justification"].startswith("TODO") for e in bl.values())
    assert core.apply_baseline(findings, bl) == []
    assert all(f.baselined and not f.actionable for f in findings)
    # fixing the finding leaves a stale entry behind
    assert len(core.apply_baseline([], bl)) == len(bl)


def test_scoped_run_keeps_out_of_scope_baseline(tmp_path):
    findings, sources, stale = analysis.run_analysis(
        targets=["cocoa_torch/solvers"], with_budget_checks=False)
    assert stale == [], [e["fingerprint"] for e in stale]
    before = core.load_baseline()
    assert before, "the port's baseline is expected to be non-empty"
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"entries": list(before.values())}))
    core.write_baseline([f for f in findings if not f.suppressed], str(bl),
                        scanned_paths=set(sources))
    assert core.load_baseline(str(bl)) == before


FIXTURE_ALLOWS = """
import numpy as np

def parse(tokens):
    # {marker}: allow=f64 -- host-side exact parse
    a = np.asarray(tokens, dtype=np.float64)
    b = np.asarray(tokens, dtype=np.float64)  # {marker}: allow=f64,host-sync -- x
    # {marker}: allow=f64
    return a, b
"""


def test_fingerprints_and_allows_match_jax_core(tmp_path):
    """The same fixture through JAX's core and the port's: the same
    suppression map and the same fingerprints (the marker word is the
    only difference)."""
    srcs = {}
    for name, mod, marker in (("jax", jax_core, "jaxlint"),
                              ("port", core, "torchlint")):
        d = tmp_path / name
        d.mkdir()
        (d / "m.py").write_text(FIXTURE_ALLOWS.format(marker=marker))
        srcs[name] = mod.load_source(str(d), "m.py")
    assert srcs["jax"].allows == srcs["port"].allows
    assert len(srcs["port"].allows) == 5
    fps = {}
    for name, mod in (("jax", jax_core), ("port", core)):
        found = [mod.Finding(rule="f64", severity="error", path="m.py",
                             line=ln, col=0, message="m")
                 for ln in (6, 6, 9)]
        mod.fingerprint_findings(found, {"m.py": srcs[name]})
        mod.apply_suppressions(found, {"m.py": srcs[name]})
        fps[name] = [(f.fingerprint, f.suppressed) for f in found]
    assert [f for f, _ in fps["jax"]] == [f for f, _ in fps["port"]]
    assert len({f for f, _ in fps["port"]}) == 3
    # the port suppresses only with a reason; JAX's core with or without
    assert [s for _, s in fps["port"]] == [True, True, False]


def test_report_validates_under_both_schemas(tmp_path):
    findings = lint(tmp_path, C5_SHAPE, "cocoa_torch/ops/a.py")
    report = tmp_path / "report.jsonl"
    core.write_report(str(report), findings, files_scanned=1,
                      rules=analysis.RULES)
    assert schema.check_file(str(report)) == []
    assert jax_schema.check_file(str(report)) == []
    head = json.loads(report.read_text().splitlines()[0])
    assert head["analysis_manifest"]["tool"] == "torchlint"
    lines = report.read_text().splitlines()
    bad = json.loads(lines[1])
    del bad["fingerprint"]
    bad["severity"] = "catastrophic"
    report.write_text("\n".join([lines[0], json.dumps(bad)]) + "\n")
    errs = schema.check_file(str(report))
    assert any("fingerprint" in e for e in errs)
    assert any("catastrophic" in e for e in errs)


def test_rules_are_the_ports():
    assert set(analysis.RULES) == {
        "scatter-order", "host-sync", "f64", "kernel-budget",
        "span-hygiene", "overlap-hygiene", "fleet-hygiene",
        "serve-hygiene", "suppression"}
    # JAX's donation and mesh-api have no torch counterpart
    assert "donation" not in analysis.RULES
    assert "mesh-api" not in analysis.RULES


# --- the tree ----------------------------------------------------------------


def test_tree_is_lint_clean():
    """The acceptance gate: every finding in cocoa_torch fixed, allowed
    inline with a reason, or baselined with a justification."""
    findings, sources, stale = analysis.run_analysis()
    assert any(p.startswith("cocoa_torch/analysis/") for p in sources)
    new = [f for f in findings if f.actionable]
    assert new == [], [f"{f.location()}: {f.message}" for f in new]
    assert stale == [], stale
    for f in findings:
        if f.baselined:
            assert f.justification and "TODO" not in f.justification, \
                f.location()
        if f.suppressed:
            assert f.suppression_reason, f.location()


def test_cli_exits_clean_and_writes_a_valid_report(tmp_path, capsys):
    """tests/test_analysis.py:750,866: `python -m cocoa_torch.analysis`
    exits 0 on the tree with no GPU and no nvcc; its report validates
    under both packages' schemas."""
    report = str(tmp_path / "report.jsonl")
    assert lint_main([f"--report={report}"]) == 0
    assert "torchlint:" in capsys.readouterr().out
    assert schema.check_file(report) == []
    assert jax_schema.check_file(report) == []
    recs = [json.loads(ln) for ln in open(report)]
    assert recs[0]["analysis_manifest"]["files_scanned"] > 50
    assert all(not (r["suppressed"] is False and r["baselined"] is False)
               for r in recs[1:])


@pytest.mark.parametrize("argv,rc", [(["--bogus"], 2),
                                     (["no/such/path"], 2),
                                     (["--no-budget", "cocoa_torch/solvers"], 0)])
def test_cli_exit_codes(argv, rc, capsys):
    assert lint_main(argv) == rc
    capsys.readouterr()


def test_cli_new_finding_exits_1(tmp_path, capsys):
    bl = tmp_path / "empty.json"
    bl.write_text(json.dumps({"entries": []}))
    assert lint_main([f"--baseline={bl}", "--no-budget",
                      "cocoa_torch/data/synth.py"]) == 1
    assert "new findings" in capsys.readouterr().out
