"""Run helpers — the port's copy of ``new_function`` from
``mlrun_tpu/run.py``. The rest of that module (``get_or_create_ctx``,
``code_to_function``, ``import_function``, ...) is ROADMAP.md item 13."""

from __future__ import annotations

import os
from typing import Callable

from .common.runtimes_constants import RuntimeKinds
from .config import run_config
from .runtimes import get_runtime_class
from .runtimes.base import BaseRuntime
from .utils.helpers import normalize_name


def new_function(name: str = "", project: str = "", tag: str = "",
                 kind: str = "", command: str = "", image: str = "",
                 args: list | None = None, mode: str = "",
                 handler: Callable | None = None, source: str = "",
                 requirements: list | None = None,
                 kfp: bool | None = None) -> BaseRuntime:
    """Create a runtime object of the given kind."""
    kind = kind or RuntimeKinds.local
    runtime = get_runtime_class(kind)()
    runtime.kind = kind
    name = name or (handler.__name__ if handler else "") or \
        (os.path.splitext(os.path.basename(command))[0] if command else "handler")
    runtime.metadata.name = normalize_name(name)
    runtime.metadata.project = project or run_config("default_project")
    runtime.metadata.tag = tag or "latest"
    runtime.spec.command = command
    runtime.spec.image = image
    runtime.spec.args = args or []
    runtime.spec.mode = mode
    if handler is not None:
        if callable(handler):
            runtime.spec.default_handler = handler.__name__
            # kept for in-process execution (local kinds and local=True
            # conversions of remote kinds)
            runtime._handler = handler
        else:
            runtime.spec.default_handler = handler
    if source:
        runtime.spec.build.source = source
    if requirements:
        runtime.with_requirements(requirements)
    return runtime
