"""Dotted-path dict helpers, uids, names and the ISO clock — copies of the
reference's ``utils/helpers.py`` functions the serving graph and the run
stack read."""

from __future__ import annotations

import re
import uuid
from datetime import datetime, timezone
from typing import Any

_name_re = re.compile(r"[^a-z0-9-]")


def generate_uid() -> str:
    return uuid.uuid4().hex


def now_date() -> datetime:
    return datetime.now(timezone.utc)


def now_iso() -> str:
    return now_date().isoformat()


def normalize_name(name: str) -> str:
    """Normalize to a dns-1123-ish label: lowercase alnum + '-'."""
    name = name.strip().lower().replace("_", "-").replace(" ", "-")
    name = _name_re.sub("-", name)
    return name.strip("-")


def template_artifact_path(path: str, project: str,
                           uid: str | None = None) -> str:
    if not path:
        return path
    path = path.replace("{{project}}", project).replace("{project}", project)
    if uid:
        path = path.replace("{{run.uid}}", uid).replace("{run_uid}", uid)
    return path


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
