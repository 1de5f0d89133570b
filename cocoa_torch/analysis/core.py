"""torchlint core: findings, file scanning, suppression, baseline, report
(the port's copy of cocoa_tpu/analysis/core.py, without jax).

The analyzer is **repo-native**: its rules encode the port's own failure
classes (order-unstable CUDA scatters, host reads inside captured CUDA
graphs, float64 outside the certificate math, kernel plans that nobody
holds to the shared-memory opt-in) rather than generic style.  The
machinery here is rule-agnostic:

- :class:`Finding` — one diagnostic, with a line-number-independent
  ``fingerprint`` (rule + path + normalized source line + occurrence
  index) so a baseline survives unrelated edits;
- inline suppression — ``# torchlint: allow=<rule>[,<rule>] -- reason``
  on the finding's line or the line directly above it.  A suppression
  MUST carry a reason after ``--``: one without is itself a finding
  (rule ``suppression``);
- the committed baseline (``cocoa_torch/analysis/baseline.json``) — known
  findings with justifications.  The CLI fails only on findings that are
  neither suppressed nor baselined;
- the JSONL report — one ``analysis_manifest`` header line plus one line
  per finding, validated by ``cocoa_torch/telemetry/schema.py`` (and by
  the JAX package's checker, which reads the same dialect).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Iterable, Optional

# the scan surface: the port's package.  tests/ is excluded on purpose —
# the known-bad rule fixtures live there, and float64 parity pinning is
# the tests' job
DEFAULT_SCAN = ("cocoa_torch",)

MARKER = "torchlint"

_ALLOW_RE = re.compile(
    r"#\s*torchlint:\s*allow=([\w,\-]+)\s*(?:--\s*(.*))?")


@dataclasses.dataclass
class Finding:
    rule: str
    severity: str          # error | warning | inventory
    path: str              # repo-relative, forward slashes
    line: int              # 1-based
    col: int
    message: str
    replacement: Optional[str] = None
    fingerprint: str = ""
    suppressed: bool = False            # inline ``torchlint: allow``
    suppression_reason: Optional[str] = None
    baselined: bool = False
    justification: Optional[str] = None  # from the baseline entry

    def to_json(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "path": self.path, "line": self.line, "col": self.col,
             "message": self.message, "fingerprint": self.fingerprint,
             "suppressed": self.suppressed, "baselined": self.baselined}
        if self.replacement is not None:
            d["replacement"] = self.replacement
        if self.suppression_reason is not None:
            d["suppression_reason"] = self.suppression_reason
        if self.justification is not None:
            d["justification"] = self.justification
        return d

    @property
    def actionable(self) -> bool:
        """Counts against the exit code: not suppressed, not baselined."""
        return not (self.suppressed or self.baselined)

    def location(self) -> str:
        return f"{self.path}:{self.line}"


@dataclasses.dataclass
class SourceFile:
    """One parsed module, shared by every rule (parse once, visit N times)."""
    path: str              # repo-relative
    abspath: str
    text: str
    lines: list            # raw source lines (no trailing newline)
    tree: ast.AST
    allows: dict           # line (1-based) -> (set of rules | {"*"}, reason)


def repo_root() -> str:
    """The directory holding the ``cocoa_torch`` package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def iter_py_files(root: str, targets: Iterable[str] = DEFAULT_SCAN):
    """Yield repo-relative paths of the .py files to scan."""
    for target in targets:
        top = os.path.join(root, target)
        if os.path.isfile(top):
            if top.endswith(".py"):
                yield os.path.relpath(top, root)
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith((".", "_build")))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.relpath(os.path.join(dirpath, fn), root)


def _allow_entries(text: str) -> tuple:
    """The ``torchlint: allow`` comments of ``text`` as (line, rules,
    reason) entries, and the lines that hold only a comment."""
    comment_only = set()
    entries = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            if tok.line.strip().startswith("#"):
                comment_only.add(tok.start[0])
            m = _ALLOW_RE.search(tok.string)
            if m:
                rules = frozenset(r.strip() for r in m.group(1).split(","))
                reason = (m.group(2) or "").strip() or None
                entries.append((tok.start[0], rules, reason))
    except tokenize.TokenError:
        pass
    return entries, comment_only


def _collect_allows(text: str) -> dict:
    """Map line number -> (allowed rule set, reason) from ``torchlint:
    allow`` comments.  An allow comment covers its own line; a
    comment-only allow also covers the comment block it opens and the
    first code line after it (so a wrapped multi-line justification
    still lands on the statement it annotates)."""
    allows = {}
    entries, comment_only = _allow_entries(text)
    for ln, rules, reason in entries:
        allows[ln] = (rules, reason)
        if ln in comment_only:
            nxt = ln + 1
            while nxt in comment_only:
                allows[nxt] = (rules, reason)
                nxt += 1
            allows[nxt] = (rules, reason)
    return allows


def load_source(root: str, relpath: str) -> Optional[SourceFile]:
    abspath = os.path.join(root, relpath)
    with open(abspath, encoding="utf-8") as f:
        text = f.read()
    try:
        tree = ast.parse(text, filename=relpath)
    except SyntaxError:
        return None  # py_compile catches those; not lint's job
    return SourceFile(
        path=relpath.replace(os.sep, "/"), abspath=abspath, text=text,
        lines=text.splitlines(), tree=tree,
        allows=_collect_allows(text))


def unexplained_allows(sources: dict) -> list:
    """A finding (rule ``suppression``) for every ``torchlint: allow``
    without a reason after ``--``: such an allow suppresses nothing, since
    silence is the failure mode this tool exists to remove."""
    findings = []
    for src in sources.values():
        for ln, rules, reason in _allow_entries(src.text)[0]:
            if reason is None:
                findings.append(Finding(
                    rule="suppression", severity="error", path=src.path,
                    line=ln, col=0,
                    message=(f"`{MARKER}: allow={','.join(sorted(rules))}` "
                             f"without a reason: write why after `--`")))
    return findings


def fingerprint_findings(findings: list, sources: dict) -> None:
    """Assign stable fingerprints: sha256(rule | path | normalized source
    line | message | occurrence index) — line-number independent, so the
    baseline survives edits elsewhere in the file.  The message is part
    of the identity because synthetic findings (the numeric kernel-budget
    sweep) share one (path, line).  The occurrence index disambiguates
    exact duplicates (and makes fingerprints unique, which the schema
    checker asserts)."""
    seen: dict = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        src = sources.get(f.path)
        line_text = ""
        if src is not None and 1 <= f.line <= len(src.lines):
            line_text = " ".join(src.lines[f.line - 1].split())
        key = (f.rule, f.path, line_text, f.message)
        idx = seen.get(key, 0)
        seen[key] = idx + 1
        blob = "|".join((f.rule, f.path, line_text, f.message, str(idx)))
        f.fingerprint = hashlib.sha256(blob.encode()).hexdigest()[:16]


def apply_suppressions(findings: list, sources: dict) -> None:
    for f in findings:
        src = sources.get(f.path)
        if src is None or f.rule == "suppression":
            continue
        entry = src.allows.get(f.line)
        if entry is None:
            continue
        rules, reason = entry
        if reason is not None and (f.rule in rules or "*" in rules):
            f.suppressed = True
            f.suppression_reason = reason


# --- baseline ---------------------------------------------------------------

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str = BASELINE_PATH) -> dict:
    """fingerprint -> entry dict.  Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    out = {}
    for e in data.get("entries", []):
        out[e["fingerprint"]] = e
    return out


def apply_baseline(findings: list, baseline: dict,
                   scanned_paths=None) -> list:
    """Mark baselined findings; returns the STALE baseline entries
    (fingerprints no longer produced).  ``scanned_paths`` scopes
    staleness to what this run looked at: on a targeted run entries for
    unscanned files are out of scope, not stale."""
    live = set()
    for f in findings:
        e = baseline.get(f.fingerprint)
        if e is not None:
            f.baselined = True
            f.justification = e.get("justification")
            live.add(f.fingerprint)
    return [e for fp, e in baseline.items()
            if fp not in live
            and (scanned_paths is None or e.get("path") in scanned_paths)]


def write_baseline(findings: list, path: str = BASELINE_PATH,
                   scanned_paths=None) -> int:
    """Write every unsuppressed finding as a baseline entry, preserving
    existing justifications; a new entry gets a placeholder the committer
    replaces.  On a targeted run (``scanned_paths`` given) entries for
    files outside the scan are carried over untouched."""
    old = load_baseline(path)
    entries = []
    if scanned_paths is not None:
        entries += [e for e in old.values()
                    if e.get("path") not in scanned_paths]
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if f.suppressed:
            continue
        prev = old.get(f.fingerprint, {})
        entries.append({
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "message": f.message,
            "justification": prev.get("justification",
                                      "TODO: justify or fix"),
        })
    entries.sort(key=lambda e: (e.get("path", ""), e.get("line", 0),
                                e.get("rule", "")))
    with open(path, "w") as f:
        json.dump({
            "_comment": (
                "torchlint baseline: known findings the CLI tolerates, each "
                "with a justification.  Regenerate with `python -m "
                "cocoa_torch.analysis --update-baseline` (existing "
                "justifications are preserved); fix code instead of "
                "adding entries whenever possible."),
            "entries": entries,
        }, f, indent=1, sort_keys=False)
        f.write("\n")
    return len(entries)


# --- report -----------------------------------------------------------------


def report_manifest(findings: list, files_scanned: int, rules: list) -> dict:
    import torch

    counts: dict = {}
    for f in findings:
        bucket = ("suppressed" if f.suppressed
                  else "baselined" if f.baselined else "new")
        counts[f.rule] = counts.get(f.rule, {"new": 0, "baselined": 0,
                                             "suppressed": 0})
        counts[f.rule][bucket] += 1
    return {
        "analysis_manifest": {
            "tool": MARKER,
            "version": 1,
            "torch_version": torch.__version__,
            "files_scanned": files_scanned,
            "rules": list(rules),
            "counts": counts,
        }
    }


def write_report(path: str, findings: list, files_scanned: int,
                 rules: list) -> None:
    """JSONL: header line + one line per finding (telemetry/schema.py
    validates this dialect as ``analysis``)."""
    with open(path, "w") as f:
        f.write(json.dumps(report_manifest(findings, files_scanned, rules))
                + "\n")
        for fd in sorted(findings,
                         key=lambda f: (f.path, f.line, f.col, f.rule)):
            f.write(json.dumps(fd.to_json()) + "\n")
