"""Dotted-path dict helpers and the ISO clock — copies of the reference's
``utils/helpers.py`` functions the serving graph reads."""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any


def now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def split_path(keys: str | list) -> list:
    if isinstance(keys, str):
        return keys.split(".")
    return list(keys)


def get_in(obj: dict, keys: str | list, default: Any = None) -> Any:
    """Read a nested value by dotted path: get_in(d, "spec.image")."""
    node = obj
    for key in split_path(keys):
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def update_in(obj: dict, keys: str | list, value: Any, append: bool = False,
              replace: bool = True):
    """Write a nested value by dotted path, creating intermediate dicts."""
    parts = split_path(keys)
    node = obj
    for key in parts[:-1]:
        node = node.setdefault(key, {})
    last = parts[-1]
    if append:
        node.setdefault(last, [])
        node[last].append(value)
    elif replace or last not in node or node[last] is None:
        node[last] = value
