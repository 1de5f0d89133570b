"""``python -m cocoa_torch.analysis`` — the torchlint CLI.

Exit codes: 0 = clean (no findings outside the justified baseline and
inline allows), 1 = new findings, 2 = usage error.

Flags:
  --report=PATH       write the full JSONL report (header + one line per
                      finding; ``python -m cocoa_torch.telemetry.schema``
                      validates it)
  --baseline=PATH     baseline file (default: the committed
                      cocoa_torch/analysis/baseline.json)
  --update-baseline   rewrite the baseline from the current findings
                      (existing justifications preserved; new entries
                      get a TODO placeholder to fill in)
  --no-budget         skip the numeric kernel-budget sweep (AST rules
                      only)
  --all               show baselined and allowed findings too
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    report_path = None
    baseline_path = None
    update_baseline = False
    with_budget = True
    show_all = False
    targets = []
    for a in argv:
        if a.startswith("--report="):
            report_path = a.split("=", 1)[1]
        elif a.startswith("--baseline="):
            baseline_path = a.split("=", 1)[1]
        elif a == "--update-baseline":
            update_baseline = True
        elif a == "--no-budget":
            with_budget = False
        elif a == "--all":
            show_all = True
        elif a.startswith("-"):
            print(__doc__, file=sys.stderr)
            return 2
        else:
            targets.append(a)

    from cocoa_torch import analysis
    from cocoa_torch.analysis import core

    if targets:
        root = core.repo_root()
        missing = [t for t in targets
                   if not os.path.exists(os.path.join(root, t))]
        if missing:
            print(f"error: no such path(s) under {root}: "
                  f"{', '.join(missing)} — targets are repo-relative",
                  file=sys.stderr)
            return 2

    findings, sources, stale = analysis.run_analysis(
        targets=targets or None, baseline_path=baseline_path,
        with_budget_checks=with_budget)

    if update_baseline:
        # a path-scoped update must not wipe baseline entries for files
        # outside the scan — carry them over untouched
        n = core.write_baseline(
            findings, baseline_path or core.BASELINE_PATH,
            scanned_paths=set(sources) if targets else None)
        print(f"baseline updated: {n} entr{'y' if n == 1 else 'ies'} "
              f"(fill in any TODO justifications before committing)")

    if report_path:
        core.write_report(report_path, findings, len(sources),
                          analysis.RULES)
        print(f"report: {report_path}")

    new = [f for f in findings if f.actionable]
    base = [f for f in findings if f.baselined]
    supp = [f for f in findings if f.suppressed]

    shown = findings if show_all else new
    for f in sorted(shown, key=lambda f: (f.path, f.line, f.col, f.rule)):
        tag = ("" if f.actionable
               else " [baselined]" if f.baselined else " [allowed]")
        print(f"{f.location()}: {f.severity}[{f.rule}]{tag} {f.message}")
        if f.replacement:
            print(f"    replacement: {f.replacement}")

    for e in stale:
        print(f"stale baseline entry {e['fingerprint']} "
              f"({e['rule']} at {e.get('path', '?')}) — finding no longer "
              f"produced; run --update-baseline to drop it")

    print(f"torchlint: {len(sources)} files, {len(findings)} finding(s): "
          f"{len(new)} new, {len(base)} baselined, {len(supp)} allowed "
          f"inline" + (f", {len(stale)} stale baseline" if stale else ""))
    if new and not update_baseline:
        print("new findings — fix them, add a justified "
              "`# torchlint: allow=<rule> -- reason`, or baseline them with "
              "--update-baseline and a justification")
    return 1 if (new and not update_baseline) else 0


if __name__ == "__main__":
    sys.exit(main())
