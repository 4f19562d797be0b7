"""Type-hint parsing for handler IO — the port's copy of
``mlrun_tpu/package/type_hints.py`` (string-hint resolution and
typing-construct reduction).

``reduce_hint`` turns any annotation — a concrete type, a string like
"pandas.DataFrame", or a typing construct (Optional[X], Union[A, B],
List[int], Annotated[X, ...]) — into the list of concrete candidate types a
packager can match against.
"""

from __future__ import annotations

import builtins
import importlib
import typing
from typing import Any, Union

_SHORTHAND_MODULES = {
    "np": "numpy", "pd": "pandas", "plt": "matplotlib.pyplot",
}


def parse_string_hint(hint: str):
    """Resolve "module.Type" / builtin-name strings to the actual type.
    Handles shorthand module names and nested classes
    ("module.Outer.Inner" — the walk drops path segments from the right
    until a module imports). Returns None when nothing resolves; only
    already-importable modules load, so a hint string cannot trigger
    arbitrary code beyond the named module's import."""
    hint = hint.strip()
    if "." not in hint:
        return getattr(builtins, hint, None)
    module_name, _, attr = hint.rpartition(".")
    module_name = _SHORTHAND_MODULES.get(module_name, module_name)
    while module_name:
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            # peel one segment off the module path onto the qualname
            # (nested class case)
            if "." not in module_name:
                return None
            module_name, _, head = module_name.rpartition(".")
            attr = f"{head}.{attr}"
            continue
        obj = module
        for part in attr.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                return None
        return obj
    return None


def reduce_hint(hint: Any) -> list:
    """Reduce an annotation to concrete candidate types (ordered; empty
    when nothing concrete can be derived)."""
    if hint is None or hint is Any or hint is typing.Any:
        return []
    if isinstance(hint, str):
        resolved = parse_string_hint(hint)
        return reduce_hint(resolved) if resolved is not None else []
    origin = typing.get_origin(hint)
    if origin is None:
        return [hint] if isinstance(hint, type) else []
    if origin is Union:  # Optional[X] is Union[X, None]
        out = []
        for arg in typing.get_args(hint):
            if arg is type(None):
                continue
            out.extend(reduce_hint(arg))
        return out
    if origin is getattr(typing, "Annotated", object()):
        args = typing.get_args(hint)
        return reduce_hint(args[0]) if args else []
    # parameterized generic (List[int], Dict[str, float], ...) → its origin
    return [origin] if isinstance(origin, type) else []
