"""Analysis engine: walk paths, run checker plugins, apply
suppressions, render (docs/static_analysis.md).

Deterministic by construction: files are visited in sorted order and
findings are sorted on (path, line, code, message) before rendering, so
the same tree always produces the same report.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

from .core import (
    PACKAGE,
    Checker,
    Finding,
    SUPPRESSION_CODE,
    parse_suppressions,
)

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules",
              ".pytest_cache", ".hypothesis", "build", "dist"}


def default_checkers() -> list[Checker]:
    from .chaos import ChaosCoherenceChecker
    from .clock import ExplicitNowChecker
    from .confkeys import ConfigKeyChecker
    from .errors import TypedErrorChecker
    from .locks import BlockingUnderLockChecker
    from .metrics import MetricsDisciplineChecker

    return [
        ChaosCoherenceChecker(),
        MetricsDisciplineChecker(),
        ExplicitNowChecker(),
        BlockingUnderLockChecker(),
        TypedErrorChecker(),
        ConfigKeyChecker(),
    ]


def iter_py_files(paths) -> list[str]:
    files: list[str] = []
    for path in paths:
        path = os.path.abspath(path)
        if os.path.isfile(path):
            if path.endswith(".py"):
                files.append(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if name.endswith(".py"):
                    files.append(os.path.join(dirpath, name))
    return sorted(set(files))


def find_repo_root(paths) -> str:
    """The directory that CONTAINS the ``mlrun_tpu_torch`` package — walk
    up from the first path until ``mlrun_tpu_torch/__init__.py`` appears.
    Checkers use it to load cross-file contract sources (the chaos
    registry, config defaults, docs tables)."""
    start = os.path.abspath(paths[0] if paths else ".")
    node = start if os.path.isdir(start) else os.path.dirname(start)
    while True:
        if os.path.isfile(os.path.join(node, PACKAGE, "__init__.py")):
            return node
        parent = os.path.dirname(node)
        if parent == node:
            # filesystem root reached: fall back to the checkout this
            # module lives in (…/<root>/mlrun_tpu_torch/analysis/engine.py)
            return os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        node = parent


@dataclass
class AnalysisResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[dict] = field(default_factory=list)
    files_checked: int = 0
    parse_errors: list[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files_checked": self.files_checked,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": self.suppressed,
            "parse_errors": self.parse_errors,
        }


def _rel(path: str, root: str) -> str:
    try:
        rel = os.path.relpath(path, root)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def run_analysis(paths, checkers: list[Checker] | None = None,
                 root: str | None = None) -> AnalysisResult:
    """Run every checker over every ``.py`` file under ``paths``."""
    checkers = default_checkers() if checkers is None else checkers
    files = iter_py_files(paths)
    root = root or find_repo_root(paths or ["."])
    result = AnalysisResult()

    for checker in checkers:
        checker.begin(root)

    raw: list[Finding] = []
    suppressions_by_path: dict[str, list] = {}
    for path in files:
        rel = _rel(path, root)
        try:
            with open(path, encoding="utf-8") as fp:
                source = fp.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            result.parse_errors.append({"path": rel, "error": str(exc)})
            continue
        result.files_checked += 1
        sups, sup_findings = parse_suppressions(source, rel)
        suppressions_by_path[rel] = sups
        raw.extend(sup_findings)
        for checker in checkers:
            raw.extend(checker.visit(tree, source, path) or [])
    for checker in checkers:
        raw.extend(checker.finish() or [])

    for finding in raw:
        finding = Finding(finding.code, _rel(finding.path, root),
                          finding.line, finding.message, finding.remedy)
        sup = next((s for s in suppressions_by_path.get(finding.path, [])
                    if s.matches(finding)), None)
        if sup is not None:
            sup.used = True
            entry = finding.to_dict()
            entry["reason"] = sup.reason
            result.suppressed.append(entry)
        else:
            result.findings.append(finding)

    # a suppression that matched nothing is rot: the site it excused
    # was fixed (delete the comment) or drifted lines (re-anchor it) —
    # exactly the unexplained-ignore decay MLT000 exists to stop
    for rel_path, sups in suppressions_by_path.items():
        for sup in sups:
            if not sup.used:
                result.findings.append(Finding(
                    SUPPRESSION_CODE, rel_path, sup.line,
                    f"suppression for {','.join(sup.codes)} matched "
                    f"no finding",
                    "delete the stale ignore comment, or re-anchor it "
                    "to the line the finding reports"))

    result.findings.sort(key=Finding.sort_key)
    result.suppressed.sort(
        key=lambda d: (d["path"], d["line"], d["code"], d["message"]))
    result.parse_errors.sort(key=lambda d: d["path"])
    return result


def render_human(result: AnalysisResult) -> str:
    lines = []
    for err in result.parse_errors:
        lines.append(f"{err['path']}: PARSE ERROR {err['error']}")
    for finding in result.findings:
        lines.append(finding.render())
    lines.append(
        f"mlt-lint: {result.files_checked} files, "
        f"{len(result.findings)} finding(s), "
        f"{len(result.suppressed)} suppressed"
        + (f", {len(result.parse_errors)} parse error(s)"
           if result.parse_errors else ""))
    return "\n".join(lines)


def render_json(result: AnalysisResult) -> str:
    return json.dumps(result.to_dict(), indent=2, sort_keys=True)
