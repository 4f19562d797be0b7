"""MLT005 — typed errors on the serving request path.

A ``raise Exception(...)`` / ``raise RuntimeError(...)`` on a request
path is an untyped 500: the resilience layer can't classify it
(retryable? shed? client bug?), the fleet can't decide to re-dispatch
it, and the client gets a stack trace instead of a status. Serving
code raises the typed hierarchy instead — ``ResilienceError``
subclasses (429/503/504 classes the dispatcher understands) or typed
``ValueError`` subclasses for 400-class client mistakes
(docs/serving_resilience.md).

Scope: every module under ``mlrun_tpu_torch/serving/``. Offline/test-only
helpers that legitimately raise untyped go in the allowlist with a
rationale.
"""

from __future__ import annotations

import ast
import os

from .core import PACKAGE, Checker, Finding, walk_functions, walk_own

CODE = "MLT005"

_BARE = {"Exception", "RuntimeError"}

#: (module, function qualname) -> rationale for an untyped raise
ALLOWLIST: dict[tuple[str, str], str] = {
    ("mlrun_tpu_torch/serving/server.py", "GraphServer.test"):
        "offline test entry, never on a live request path — it "
        "re-raises a >=400 mock Response for interactive debugging",
    ("mlrun_tpu_torch/serving/llm.py", "default_device"):
        "runs when an engine is built, never per request: the loud "
        "failure the port's no-CPU-fallback rule asks for, not a request "
        "error a 4xx/5xx class should carry",
}


class TypedErrorChecker(Checker):
    code = CODE
    name = "typed-errors"

    def begin(self, root: str) -> None:
        self._root = root

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        if not rel.startswith(f"{PACKAGE}/serving/"):
            return []
        findings: list[Finding] = []
        for func, qual in walk_functions(tree):
            if (rel, qual) in ALLOWLIST:
                continue
            for node in walk_own(func):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                name = None
                if isinstance(node.exc, ast.Call) \
                        and isinstance(node.exc.func, ast.Name):
                    name = node.exc.func.id
                elif isinstance(node.exc, ast.Name):
                    name = node.exc.id
                if name in _BARE:
                    findings.append(Finding(
                        CODE, path, node.lineno,
                        f"untyped raise {name} in {qual} on the "
                        f"serving path",
                        "raise a ResilienceError subclass (429/503/504 "
                        "classes) or a typed ValueError subclass (400) "
                        "— see docs/serving_resilience.md"))
        return findings
