"""Packager base — the port's copy of
``mlrun_tpu/package/packagers/default.py`` (priority ordering,
artifact-type dispatch, temp-file management)."""

from __future__ import annotations

import os
import tempfile
from typing import Any


class DefaultPackager:
    """One type family's pack/unpack logic.

    - ``handled_types``/``can_pack``/``can_unpack`` decide routing;
    - ``priority`` orders the registry (lower = earlier);
    - ``artifact_types`` lists the ``key:artifact_type`` spellings this
      family supports; ``pack`` may branch on the requested one;
    - ``new_file`` hands out temp files the manager cleans up after the
      artifact layer has uploaded them.
    """

    handled_types: tuple = ()
    artifact_types: tuple = ("artifact", "result")
    default_artifact_type = "artifact"
    priority = 5

    def __init__(self):
        self._tmp_paths: list[str] = []

    def can_pack(self, obj: Any) -> bool:
        return isinstance(obj, self.handled_types) \
            if self.handled_types else False

    def can_unpack(self, hint) -> bool:
        return hint in self.handled_types

    def pack(self, context, obj, key: str, artifact_type: str = "", **cfg):
        raise NotImplementedError

    def unpack(self, data_item, hint):
        raise NotImplementedError

    def new_file(self, suffix: str) -> str:
        handle = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
        handle.close()
        self._tmp_paths.append(handle.name)
        return handle.name

    def cleanup(self):
        for path in self._tmp_paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._tmp_paths.clear()
