"""MLT001 — chaos coherence (docs/fault_tolerance.md).

The port keeps its own registry (``mlrun_tpu_torch/chaos/registry.py``)
under the reference's point names, so the fault-point table in
docs/fault_tolerance.md is the contract both registries answer to.

The fault-injection registry is only a safety net if the three views
of it stay coherent:

1. every ``fire("x")`` / ``chaos_fire("x")`` / ``chaos.inject("x")``
   string literal resolves to a declared ``FaultPoints`` attribute
   (and every ``FaultPoints.attr`` read exists) — a typo'd point is
   armed by nobody and fires into the void;
2. every declared point is fired somewhere (production code or the
   tests/ fakes) — a declared-but-unfired point is dead contract;
3. the docs/fault_tolerance.md point table lists every point — the
   table is what operators arm against.

Cross-file by nature: declarations load from chaos/registry.py in
``begin``, fires accumulate per file, coherence is judged in
``finish``. Test files (tests/…) count toward the "fired somewhere"
set but are never flagged — tests fire synthetic points ("p") on
purpose.
"""

from __future__ import annotations

import ast
import os

from .core import PACKAGE, Checker, Finding

CODE = "MLT001"

#: call names whose first string-literal argument is a chaos point
_FIRE_NAMES = {"fire", "chaos_fire"}
_INJECT_NAMES = {"inject"}

#: modules where raw point literals are part of the implementation,
#: not call sites (rationale per entry — the checker allowlist policy)
ALLOWLIST_MODULES = {
    "mlrun_tpu_torch/chaos/registry.py":
        "the registry itself: docstring examples and matching internals",
    "mlrun_tpu_torch/analysis/chaos.py":
        "this checker's own examples",
}


def _load_declared(root: str
                   ) -> tuple[dict[str, int], dict[str, str], set[str],
                              set[str], str]:
    """Parse FaultPoints out of chaos/registry.py WITHOUT importing it.
    Returns ({point value -> decl line}, {attr -> point value},
    {every attr incl. methods}, {attrs listed in all()},
    registry path)."""
    reg_path = os.path.join(root, PACKAGE, "chaos", "registry.py")
    declared: dict[str, int] = {}
    by_attr: dict[str, str] = {}
    attrs: set[str] = set()
    in_all: set[str] = set()
    try:
        with open(reg_path, encoding="utf-8") as fp:
            tree = ast.parse(fp.read())
    except (OSError, SyntaxError):
        return declared, by_attr, attrs, in_all, reg_path
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "FaultPoints":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    for target in stmt.targets:
                        if isinstance(target, ast.Name):
                            attrs.add(target.id)
                            if (isinstance(stmt.value, ast.Constant)
                                    and isinstance(stmt.value.value,
                                                   str)):
                                declared[stmt.value.value] = stmt.lineno
                                by_attr[target.id] = stmt.value.value
                elif isinstance(stmt, ast.FunctionDef):
                    attrs.add(stmt.name)
                    if stmt.name == "all":
                        for sub in ast.walk(stmt):
                            if (isinstance(sub, ast.Attribute)
                                    and isinstance(sub.value, ast.Name)
                                    and sub.value.id == "FaultPoints"):
                                in_all.add(sub.attr)
    return declared, by_attr, attrs, in_all, reg_path


def _point_literals(tree) -> list[tuple[str, int, bool]]:
    """(point, line, is_inject) for every fire/inject call whose first
    arg is a string literal."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = node.func
        name = None
        if isinstance(func, ast.Name):
            name = func.id
        elif isinstance(func, ast.Attribute):
            name = func.attr
        if name not in _FIRE_NAMES and name not in _INJECT_NAMES:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, node.lineno, name in _INJECT_NAMES))
    return out


class ChaosCoherenceChecker(Checker):
    code = CODE
    name = "chaos-coherence"

    def begin(self, root: str) -> None:
        self._root = root
        (self._declared, self._by_attr, self._attrs, self._in_all,
         self._registry_path) = _load_declared(root)
        self._fired: set[str] = set()
        self._whole_tree = False
        self._findings: list[Finding] = []
        try:
            docs = os.path.join(root, "docs", "fault_tolerance.md")
            with open(docs, encoding="utf-8") as fp:
                self._docs_text = fp.read()
        except OSError:
            self._docs_text = None
        # the fakes + chaos suites fire the k8s/provider verbs that
        # production only fires against a real cluster: they count
        # toward "fired somewhere" (never flagged — synthetic points
        # like "p" are a test idiom)
        tests_dir = os.path.join(root, "tests")
        if os.path.isdir(tests_dir):
            for fname in sorted(os.listdir(tests_dir)):
                if not fname.endswith(".py"):
                    continue
                try:
                    with open(os.path.join(tests_dir, fname),
                              encoding="utf-8") as fp:
                        tree = ast.parse(fp.read())
                except (OSError, SyntaxError):
                    continue
                for point, _line, _ in _point_literals(tree):
                    self._fired.add(point)
                for point in _attr_points(tree, self._by_attr):
                    self._fired.add(point)

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        if rel == f"{PACKAGE}/chaos/registry.py":
            # the registry's own FaultPoints.all() enumeration and
            # docstring examples must not count as fires — they would
            # mask the declared-but-never-fired check entirely. Seeing
            # the registry also marks this as a WHOLE-TREE scan: the
            # completeness checks in finish() only bind then (a
            # single-file scan fires almost nothing by construction)
            self._whole_tree = True
            return []
        findings: list[Finding] = []
        in_tests = rel.startswith("tests/")
        allowlisted = rel in ALLOWLIST_MODULES
        for point, line, is_inject in _point_literals(tree):
            self._fired.add(point)
            if in_tests or allowlisted:
                continue
            if point in self._declared:
                continue
            if is_inject and _wildcard_ok(point, self._declared):
                continue
            findings.append(Finding(
                CODE, path, line,
                f"chaos point '{point}' is not declared on FaultPoints",
                "declare it in mlrun_tpu_torch/chaos/registry.py and add it "
                "to FaultPoints.all() + the docs/fault_tolerance.md "
                "point table"))
        # FaultPoints.<attr> reads must resolve
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "FaultPoints"
                    and isinstance(node.ctx, ast.Load)):
                if node.attr in self._by_attr:
                    self._fired.add(self._by_attr[node.attr])
                if node.attr not in self._attrs and not in_tests:
                    findings.append(Finding(
                        CODE, path, node.lineno,
                        f"FaultPoints.{node.attr} does not exist",
                        "declare the point on FaultPoints or fix the "
                        "attribute name"))
        return findings

    def finish(self) -> list[Finding]:
        if not self._whole_tree:
            return []
        findings: list[Finding] = []
        for attr, point in sorted(self._by_attr.items()):
            if self._in_all and attr not in self._in_all:
                findings.append(Finding(
                    CODE, self._registry_path, self._declared[point],
                    f"FaultPoints.{attr} ('{point}') is missing from "
                    f"FaultPoints.all()",
                    "add it to the all() list — tooling that "
                    "enumerates points can't see it otherwise"))
        for point, line in sorted(self._declared.items()):
            if point not in self._fired:
                findings.append(Finding(
                    CODE, self._registry_path, line,
                    f"declared chaos point '{point}' is never fired",
                    "thread fire(FaultPoints...) through the layer it "
                    "guards, or retire the declaration"))
            if self._docs_text is not None \
                    and f"`{point}`" not in self._docs_text:
                findings.append(Finding(
                    CODE, self._registry_path, line,
                    f"chaos point '{point}' missing from the "
                    f"docs/fault_tolerance.md point table",
                    "add a `point` row to the fault-point table"))
        return findings


def _wildcard_ok(point: str, declared: dict[str, int]) -> bool:
    if not point.endswith(".*"):
        return False
    prefix = point[:-1]  # keep the dot
    return any(p.startswith(prefix) for p in declared)


def _attr_points(tree, by_attr: dict[str, str]) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "FaultPoints"
                and node.attr in by_attr):
            out.add(by_attr[node.attr])
    return out
