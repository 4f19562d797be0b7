"""General helpers — the port's copy of ``mlrun_tpu/utils/helpers.py``:
dotted-path dict editing, uids, name normalization and checks, the ISO
clock, yaml / json dumps, run and pipeline metadata, and a retrier. The
defaults it fills (project, image) are the run stack's
(``config.run_config``)."""

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


def verify_field_regex(field: str, value: str,
                       pattern: str = r"^[a-z0-9][a-z0-9-]*$"):
    if not re.match(pattern, value or ""):
        raise ValueError(
            f"field '{field}' value '{value}' does not match {pattern}")


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


def dict_to_yaml(obj: dict) -> str:
    import yaml

    return yaml.safe_dump(obj, default_flow_style=False, sort_keys=False)


def dict_to_json(obj: dict) -> str:
    import json

    return json.dumps(obj, default=str)


def fill_run_metadata(run: dict, project: str | None = None) -> dict:
    from ..config import run_config

    meta = run.setdefault("metadata", {})
    meta.setdefault("uid", generate_uid())
    meta.setdefault("project", project or run_config("default_project"))
    meta.setdefault("iteration", 0)
    return run


def new_pipe_metadata(artifact_path: str | None = None) -> dict:
    return {"artifact_path": artifact_path, "generated": now_iso()}


def is_relative_path(path: str) -> bool:
    if not path:
        return False
    return not (path.startswith("/") or "://" in path)


def enrich_image_url(image: str) -> str:
    if image in ("", ".", "auto"):
        from ..config import run_config

        return run_config("default_image")
    return image


def as_list(value: Any) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def retry_until_successful(backoff: float, timeout: float, _logger,
                           verbose: bool, function, *args, **kwargs):
    """Call ``function`` until it succeeds or ``timeout`` seconds pass."""
    import time

    start = time.monotonic()
    last_exc = None
    while time.monotonic() - start < timeout:
        try:
            return function(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 - a retrier catches all
            last_exc = exc
            if verbose and _logger:
                _logger.debug("retrying", error=str(exc))
            time.sleep(backoff)
    raise TimeoutError(
        f"failed to execute {getattr(function, '__name__', function)} "
        f"within {timeout}s: {last_exc}"
    ) from last_exc
