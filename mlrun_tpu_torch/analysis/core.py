"""Core types for the port's invariant checker — the port's own copy of
the reference's ``analysis/core.py`` (docs/static_analysis.md).

Stdlib-only by contract (``ast`` + ``tokenize``): the analyzer must run
in any environment that can parse the source tree — no torch, no yaml,
no third-party linter framework. Checkers are plugins over one shared
shape:

- :class:`Finding`: one violation — ``MLT0xx`` code, file:line, a
  one-line message, and a one-line remedy (what to change, not just
  what is wrong).
- :class:`Checker`: ``begin(root)`` once per run (load cross-file
  contract sources: the FaultPoints registry, the config defaults
  tree, the docs tables), ``visit(tree, source, path)`` once per file,
  ``finish()`` once at the end for cross-file invariants
  (declared-but-never-fired, family-not-in-docs).
- suppressions: ``# mlt: ignore[MLT004]: <reason>`` on the offending
  line. The reason is REQUIRED — a bare ignore is itself a finding
  (MLT000), because an unexplained suppression is exactly the
  convention rot this tool exists to stop. Checker-level allowlists
  (module tables with one-line rationales) are preferred over inline
  ignores for anything structural; inline ignores are for one-off
  sites.
"""

from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field

#: code for broken suppression comments (missing reason / bad syntax)
SUPPRESSION_CODE = "MLT000"

#: the package this checker holds to its conventions: the repo root is the
#: directory that contains it, and every module table names paths under it
PACKAGE = "mlrun_tpu_torch"

_CODE_RE = re.compile(r"^MLT\d{3}$")
# the marker must BE the comment (anchored at its start), not merely
# appear inside one — prose mentioning the syntax must not arm it
_IGNORE_RE = re.compile(
    r"^#\s*mlt:\s*ignore\[(?P<codes>[^\]]*)\](?P<rest>.*)$")


@dataclass(frozen=True)
class Finding:
    """One invariant violation at a source location."""

    code: str          # MLT0xx
    path: str          # repo-relative where possible
    line: int          # 1-based
    message: str       # what is wrong, one line
    remedy: str = ""   # how to fix it, one line

    def sort_key(self):
        return (self.path, self.line, self.code, self.message)

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "remedy": self.remedy,
        }

    def render(self) -> str:
        text = f"{self.path}:{self.line}: {self.code} {self.message}"
        if self.remedy:
            text += f" [fix: {self.remedy}]"
        return text


class Checker:
    """Checker plugin base. Subclasses set ``code`` + ``name`` and
    override any of the three hooks; all default to no-ops so a purely
    per-file checker only implements ``visit``."""

    code: str = "MLT999"
    name: str = "base"

    def begin(self, root: str) -> None:
        """Called once before any file, with the repo root (the
        directory containing the ``mlrun_tpu_torch`` package). Load
        cross-file contract sources here."""

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        """Called once per parsed file; return per-file findings."""
        return []

    def finish(self) -> list[Finding]:
        """Called once after every file; return cross-file findings."""
        return []


@dataclass
class Suppression:
    """A parsed ``# mlt: ignore[...]`` comment."""

    line: int
    codes: tuple[str, ...]
    reason: str
    used: bool = field(default=False, compare=False)

    def matches(self, finding: Finding) -> bool:
        return finding.line == self.line and finding.code in self.codes


def parse_suppressions(source: str, path: str
                       ) -> tuple[list[Suppression], list[Finding]]:
    """Extract suppression comments via tokenize (never fooled by
    strings that look like comments). Returns (suppressions, findings)
    where findings are MLT000 malformed-suppression violations:
    missing reason, empty/invalid code list."""
    suppressions: list[Suppression] = []
    findings: list[Finding] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(tok.start[0], tok.string) for tok in tokens
                    if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return [], []
    for line, text in comments:
        match = _IGNORE_RE.match(text)
        if not match:
            continue
        codes = tuple(c.strip() for c in match.group("codes").split(",")
                      if c.strip())
        rest = match.group("rest").strip()
        reason = rest[1:].strip() if rest.startswith(":") else ""
        bad = [c for c in codes if not _CODE_RE.match(c)]
        if not codes or bad:
            findings.append(Finding(
                SUPPRESSION_CODE, path, line,
                f"malformed suppression {text.strip()!r}: "
                f"expected mlt: ignore[MLT0xx]: <reason>",
                "use '# mlt: ignore[MLT0xx]: reason' with a real code"))
            continue
        if not reason:
            findings.append(Finding(
                SUPPRESSION_CODE, path, line,
                f"suppression for {','.join(codes)} has no reason",
                "append ': <one-line reason>' — unexplained ignores "
                "are the drift this tool exists to stop"))
            continue
        suppressions.append(Suppression(line, codes, reason))
    return suppressions, findings


def walk_functions(tree):
    """Yield (FunctionDef, qualname) for every function in a module,
    methods qualified as ``Class.method``, nested defs as
    ``outer.inner``."""
    import ast

    def rec(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield child, qual
                yield from rec(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.")
    yield from rec(tree, "")


def walk_own(node):
    """Walk a node's subtree WITHOUT descending into nested
    defs/lambdas/classes — their bodies run later, under their own
    scope, not here."""
    import ast

    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def qualname_parts(node) -> list[str] | None:
    """Flatten an Attribute/Name chain (``a.b.c``) into parts, or None
    when the chain is rooted in something dynamic (a call, a
    subscript)."""
    import ast

    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None
