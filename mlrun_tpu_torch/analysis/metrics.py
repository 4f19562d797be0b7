"""MLT002 — metrics discipline (docs/observability.md).

Four machine-checkable halves of the telemetry contract:

1. **one constructor site per family** — ``REGISTRY.counter/gauge/
   histogram("mlt_*", ...)`` is get-or-create, so a second declaration
   silently aliases the first and the two sites drift (labels, help,
   buckets) without anything failing;
2. **label-key agreement** — every ``FAMILY.inc/set/observe/set_total/
   remove(...)`` call site must pass exactly the declared label keys
   (a missing key raises at runtime only when that code path runs; an
   extra key the same — catch both at parse time);
3. **engine stop/retire coverage** — ``replica``-labeled families an
   engine module feeds must be referenced from that module's
   stop/retire path (functions named stop/close/retire/remove*),
   because scale-down leaking series is the cardinality bug class;
4. **docs coverage** — every declared ``mlt_*`` family appears in the
   docs/observability.md series table.

Declarations and call sites live in different modules, so everything
buffers per file and is judged in ``finish``.
"""

from __future__ import annotations

import ast
import os

from .core import Checker, Finding

CODE = "MLT002"

_CTOR_METHODS = {"counter", "gauge", "histogram"}
_USE_METHODS = {"inc", "set", "observe", "set_total", "remove"}
#: kwargs on use methods that are values, not labels
_VALUE_KWARGS = {"value", "exemplar"}
#: function-name fragments that mark a stop/retire scope
_RETIRE_FRAGMENTS = ("stop", "retire", "remove", "close", "shutdown")

#: engine modules where replica-labeled families must be retired
#: (rationale per entry — the checker allowlist policy)
ENGINE_MODULES = {
    "mlrun_tpu_torch/serving/llm_batch.py":
        "continuous-batching engine: owns the mlt_llm_* replica series",
    "mlrun_tpu_torch/serving/paged.py":
        "paged engine subclass: inherits llm_batch's series ownership",
    "mlrun_tpu_torch/serving/fleet.py":
        "fleet router: owns mlt_fleet_dispatches_total replica series",
    "mlrun_tpu_torch/serving/adapters.py":
        "adapter registry: feeds mlt_adapter_* through its host engine",
}

#: (family, module) pairs exempt from the label-agreement check, with
#: rationale — prefer fixing the call site; this table is for sites
#: that are structurally correct but beyond the AST's reach
LABEL_ALLOWLIST: dict[tuple[str, str], str] = {
}


def _str_tuple(node) -> tuple[str, ...] | None:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.append(elt.value)
        return tuple(out)
    return None


class MetricsDisciplineChecker(Checker):
    code = CODE
    name = "metrics-discipline"

    def begin(self, root: str) -> None:
        self._root = root
        # family -> list of (path, line, labels-or-None)
        self._ctors: dict[str, list] = {}
        # (module rel, var name) -> family (the declaring module's
        # binding wins in that module)
        self._local_vars: dict[tuple, str] = {}
        # var name -> set of families bound to it anywhere; a use in a
        # NON-declaring module resolves only when unambiguous (imports
        # preserve names, but two modules may reuse one name for
        # different families — then the AST can't tell which was
        # imported, so the site is skipped rather than mis-checked)
        self._global_vars: dict[str, set] = {}
        # buffered use sites: (module rel, var, method, labels, path,
        # line)
        self._uses: list[tuple] = []
        # module rel -> set of var names referenced in retire scopes
        self._retire_refs: dict[str, set] = {}
        # module rel -> set of (var, line) with non-retire use
        self._module_uses: dict[str, set] = {}
        try:
            docs = os.path.join(root, "docs", "observability.md")
            with open(docs, encoding="utf-8") as fp:
                self._docs_text = fp.read()
        except OSError:
            self._docs_text = None

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        in_tests = rel.startswith("tests/")
        # -- constructor sites (declarations bind module-level vars) --
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                value = node.value
                fam = self._ctor_family(value)
                if fam is not None and not in_tests:
                    labels = None
                    for kw in value.keywords:
                        if kw.arg == "labels":
                            labels = _str_tuple(kw.value)
                    self._ctors.setdefault(fam, []).append(
                        (path, value.lineno, labels))
                    for target in node.targets:
                        if isinstance(target, ast.Name):
                            self._local_vars[(rel, target.id)] = fam
                            self._global_vars.setdefault(
                                target.id, set()).add(fam)
            elif isinstance(node, ast.Call):
                fam = self._ctor_family(node)
                if fam is not None and not in_tests:
                    # bare (non-assigned) declaration — still a site
                    known = self._ctors.get(fam, [])
                    if not any(line == node.lineno and p == path
                               for p, line, _ in known):
                        self._ctors.setdefault(fam, []).append(
                            (path, node.lineno, None))
        if in_tests:
            return []
        # -- use sites ------------------------------------------------
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _USE_METHODS
                    and isinstance(node.func.value, ast.Name)):
                continue
            var = node.func.value.id
            if not var.isupper():
                continue  # only the module-level family bindings
            if any(kw.arg is None for kw in node.keywords):
                continue  # **labels — dynamic, out of AST reach
            labels = frozenset(kw.arg for kw in node.keywords
                               if kw.arg not in _VALUE_KWARGS)
            self._uses.append((rel, var, node.func.attr, labels, path,
                               node.lineno))
            if node.func.attr != "remove":
                self._module_uses.setdefault(rel, set()).add(var)
        # -- retire scopes --------------------------------------------
        refs = self._retire_refs.setdefault(rel, set())
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(frag in node.name.lower()
                            for frag in _RETIRE_FRAGMENTS):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        refs.add(sub.id)
                    elif isinstance(sub, ast.Attribute):
                        refs.add(sub.attr)
        return []

    def _ctor_family(self, node) -> str | None:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _CTOR_METHODS
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value.startswith("mlt_")):
            return node.args[0].value
        return None

    def _resolve_var(self, rel: str, var: str) -> str | None:
        """Family a variable name denotes in ``rel``: the module's own
        binding, else the globally-unambiguous one (imported names)."""
        local = self._local_vars.get((rel, var))
        if local is not None:
            return local
        fams = self._global_vars.get(var, set())
        return next(iter(fams)) if len(fams) == 1 else None

    def finish(self) -> list[Finding]:
        findings: list[Finding] = []
        # 1. exactly one constructor site per family
        for fam, sites in sorted(self._ctors.items()):
            if len(sites) > 1:
                first = sorted(sites, key=lambda s: (s[0], s[1]))[0]
                for path, line, _labels in sorted(
                        sites, key=lambda s: (s[0], s[1]))[1:]:
                    findings.append(Finding(
                        CODE, path, line,
                        f"family '{fam}' declared again (first at "
                        f"{os.path.relpath(first[0], self._root)}:"
                        f"{first[1]}) — get-or-create aliases them "
                        f"silently",
                        "import the family object from its declaring "
                        "module instead of re-declaring"))
        declared_labels = {
            fam: sites[0][2] or ()
            for fam, sites in self._ctors.items() if sites}
        # 2. label-key agreement at every use site
        for rel, var, method, labels, path, line in self._uses:
            fam = self._resolve_var(rel, var)
            if fam is None or fam not in declared_labels:
                continue
            if (fam, rel) in LABEL_ALLOWLIST:
                continue
            expected = frozenset(declared_labels[fam])
            if labels != expected:
                missing = sorted(expected - labels)
                extra = sorted(labels - expected)
                detail = []
                if missing:
                    detail.append(f"missing {missing}")
                if extra:
                    detail.append(f"unexpected {extra}")
                findings.append(Finding(
                    CODE, path, line,
                    f"{var}.{method} label keys disagree with the "
                    f"'{fam}' declaration ({', '.join(detail)})",
                    f"pass exactly {sorted(expected)} — the declared "
                    f"label-key set"))
        # 3. engine stop/retire coverage for replica-labeled families
        for rel in sorted(self._module_uses):
            if rel not in ENGINE_MODULES:
                continue
            refs = self._retire_refs.get(rel, set())
            for var in sorted(self._module_uses[rel]):
                fam = self._resolve_var(rel, var)
                if fam is None:
                    continue
                if "replica" not in declared_labels.get(fam, ()):
                    continue
                if var not in refs:
                    findings.append(Finding(
                        CODE, os.path.join(self._root, rel), 1,
                        f"replica-labeled family {var} ('{fam}') is fed "
                        f"by this engine module but never referenced "
                        f"from a stop/retire scope",
                        "remove the series in the engine's "
                        "stop()/remove_series() path — scale-down must "
                        "not leak per-replica series"))
        # 4. docs coverage
        if self._docs_text is not None:
            for fam, sites in sorted(self._ctors.items()):
                if fam not in self._docs_text:
                    path, line, _labels = sorted(
                        sites, key=lambda s: (s[0], s[1]))[0]
                    findings.append(Finding(
                        CODE, path, line,
                        f"family '{fam}' missing from the "
                        f"docs/observability.md series table",
                        "add a row to the 'Key series' table"))
        return findings
