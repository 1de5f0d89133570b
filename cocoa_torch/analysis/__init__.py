"""torchlint: the port's static analysis and runtime sanitizers (the
counterpart of cocoa_tpu/analysis/).

``python -m cocoa_torch.analysis`` lints the package against the port's
own failure classes (order-unstable CUDA scatters, host reads inside
captured CUDA graphs, float64 outside the certificate math, kernel plans
against the shared-memory opt-in, and the tracing, overlap, fleet and
serving hygiene rules) and exits nonzero on any finding that is neither
allowed inline (``# torchlint: allow=<rule> -- reason``) nor carried by
the committed baseline with a justification.

Submodules import lazily: ``analysis.sanitize`` is wired into the drive loops
(solvers/base.py) and must not drag the AST machinery in with it.
"""

from __future__ import annotations

__all__ = ["run_analysis", "RULES"]


def __getattr__(name):
    # RULES lives in rules.py; resolve lazily so importing the package —
    # the drive loops import analysis.sanitize — never pays for the AST pass
    if name == "RULES":
        from cocoa_torch.analysis.rules import RULES

        return RULES
    raise AttributeError(name)


def run_analysis(root=None, targets=None, baseline_path=None,
                 with_budget_checks=True):
    """Run every rule; returns (findings, sources, stale_baseline_entries).
    Findings come back fingerprinted, with inline suppressions and the
    baseline applied.  On a targeted run (``targets`` an explicit subset)
    baseline staleness is scoped to the scanned files."""
    from cocoa_torch.analysis import core, rules

    root = root or core.repo_root()
    scoped = targets is not None and list(targets) != list(core.DEFAULT_SCAN)
    targets = tuple(targets) if targets else core.DEFAULT_SCAN
    sources = {}
    for rel in core.iter_py_files(root, targets):
        src = core.load_source(root, rel)
        if src is not None:
            sources[src.path] = src
    findings = rules.run_static_rules(sources)
    if with_budget_checks:
        from cocoa_torch.analysis import kernel_budget

        findings += kernel_budget.run_budget_checks()
    core.fingerprint_findings(findings, sources)
    core.apply_suppressions(findings, sources)
    baseline = core.load_baseline(baseline_path or core.BASELINE_PATH)
    stale = core.apply_baseline(
        findings, baseline,
        scanned_paths=set(sources) if scoped else None)
    return findings, sources, stale
