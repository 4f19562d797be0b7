"""AST-restricted expression evaluator for config-supplied strings — the
port's copy of ``mlrun_tpu/utils/safe_eval.py``.

The remote step's ``url_expression`` / ``body_expression`` come from a
graph spec. ``eval`` with an empty ``__builtins__`` is no sandbox
(``().__class__.__mro__`` reaches everything), so this evaluator walks the
parsed AST and permits a closed set of node types only: literals,
boolean/compare/arithmetic operators, names, subscripts, non-dunder
attribute access, f-strings, conditional expressions, and calls to a small
builtin whitelist.
"""

from __future__ import annotations

import ast
from typing import Any, Mapping

_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.UnaryOp, ast.Not, ast.USub, ast.UAdd,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
    ast.Mod, ast.Pow,
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.In, ast.NotIn, ast.Is, ast.IsNot,
    ast.IfExp,
    ast.Constant, ast.Name, ast.Load,
    ast.Subscript, ast.Slice,
    ast.Attribute,
    ast.Dict, ast.List, ast.Tuple, ast.Set,
    ast.Call,  # NOTE: ast.keyword deliberately absent — kwargs like
    # sorted(key=...) would smuggle computed callables into builtins
    ast.JoinedStr, ast.FormattedValue,
)

_SAFE_BUILTINS: dict[str, Any] = {
    "str": str, "int": int, "float": float, "bool": bool, "len": len,
    "min": min, "max": max, "abs": abs, "round": round, "sum": sum,
    "sorted": sorted, "any": any, "all": all,
    "True": True, "False": False, "None": None,
}


class UnsafeExpressionError(ValueError):
    """The expression uses a construct outside the permitted subset."""


def _check(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise UnsafeExpressionError(
                f"disallowed construct {type(node).__name__!r} in expression")
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_"):
                raise UnsafeExpressionError(
                    f"access to underscore attribute {node.attr!r} "
                    "is not allowed")
            if node.attr in ("format", "format_map"):
                # str.format's mini-language does attribute traversal at
                # runtime ("{0.__class__}") — it would reopen the dunder hole
                raise UnsafeExpressionError(
                    f"{node.attr!r} is not allowed (format-string "
                    "attribute traversal)")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise UnsafeExpressionError(
                f"access to dunder name {node.id!r} is not allowed")
        if isinstance(node, ast.Call):
            fn = node.func
            # only plain-name calls to the builtin whitelist or bound-method
            # calls on values (e.g. "x".upper()) — never computed callables
            # (subscript/call/ifexp funcs would invoke arbitrary objects)
            if isinstance(fn, ast.Name):
                if fn.id not in _SAFE_BUILTINS:
                    raise UnsafeExpressionError(
                        f"call to {fn.id!r} is not allowed")
            elif not isinstance(fn, ast.Attribute):
                raise UnsafeExpressionError(
                    "calls through computed expressions are not allowed")


def safe_eval(expression: str, names: Mapping[str, Any] | None = None) -> Any:
    """Evaluate a restricted expression with the given variable bindings.

    Raises ``UnsafeExpressionError`` (a ``ValueError``) when the expression
    contains anything outside the permitted subset; other evaluation errors
    (``KeyError``, ``TypeError``...) propagate as-is.
    """
    tree = ast.parse(expression, mode="eval")
    _check(tree)
    scope = dict(_SAFE_BUILTINS)
    if names:
        scope.update(names)
    code = compile(tree, "<safe_eval>", "eval")
    return eval(code, {"__builtins__": {}}, scope)  # noqa: S307 - AST-vetted
