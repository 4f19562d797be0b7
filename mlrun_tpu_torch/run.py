"""Run helpers — the port's copy of ``mlrun_tpu/run.py``:
``get_or_create_ctx``, ``new_function``, ``code_to_function``,
``import_function``, ``function_to_module``, ``run_local`` and
``wait_for_pipeline_completion``."""

from __future__ import annotations

import inspect
import json
import os
import socket
from typing import Callable

from .common.runtimes_constants import RuntimeKinds
from .config import resolve_artifact_path, run_config
from .execution import MLClientCtx
from .model import RunObject
from .runtimes import get_runtime_class
from .runtimes.base import BaseRuntime
from .utils.helpers import normalize_name, update_in


def get_or_create_ctx(name: str, uid: str = "", event=None, spec=None,
                      with_env: bool = True, rundb=None, project: str = "",
                      upload_artifacts: bool = False) -> MLClientCtx:
    """Entry point inside user scripts: the run's context from the
    exec-config env when running under the framework, else a fresh one."""
    newspec = {}
    config = os.environ.get(run_config("exec_config_env")) if with_env \
        else None
    if spec:
        newspec = spec.to_dict() if hasattr(spec, "to_dict") else dict(spec)
    elif config:
        newspec = json.loads(config)
    update_in(newspec, "metadata.name", name, replace=False)
    if uid:
        update_in(newspec, "metadata.uid", uid)
    if project:
        update_in(newspec, "metadata.project", project)
    if not newspec.get("spec", {}).get("output_path"):
        update_in(newspec, "spec.output_path", resolve_artifact_path(
            newspec.get("metadata", {}).get("project", "")))
    return MLClientCtx.from_dict(newspec, rundb=rundb,
                                 host=socket.gethostname(),
                                 autocommit=bool(config))


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


def code_to_function(name: str = "", project: str = "", tag: str = "",
                     filename: str = "", handler: str = "", kind: str = "",
                     image: str = "", code_output: str = "",
                     embed_code: bool = True, description: str = "",
                     requirements: list | None = None,
                     categories: list | None = None, labels: dict | None = None,
                     with_doc: bool = True,
                     ignored_tags=None) -> BaseRuntime:
    """A runtime over a python file, its source embedded in the build spec
    (base64 ``functionSourceCode``) and its top-level functions listed as
    entry points."""
    filename = filename or _calling_filename()
    if not filename or not os.path.isfile(filename):
        raise ValueError(
            f"cannot embed code: file '{filename}' not found "
            "(pass filename= explicitly)")
    with open(filename) as fp:
        source_code = fp.read()

    kind = kind or RuntimeKinds.job
    runtime = new_function(name=name or os.path.splitext(
        os.path.basename(filename))[0], project=project, tag=tag, kind=kind,
        image=image)
    if embed_code:
        runtime.spec.build.with_source(source_code)
        runtime.spec.build.origin_filename = filename
        runtime.spec.build.code_origin = filename
    else:
        runtime.spec.command = filename
    runtime.spec.default_handler = handler
    runtime.spec.description = description
    if requirements:
        runtime.with_requirements(requirements)
    if labels:
        for key, value in labels.items():
            runtime.set_label(key, value)
    runtime.metadata.categories = categories or []
    if with_doc:
        runtime.spec.entry_points = _extract_entry_points(source_code)
    return runtime


def import_function(url: str = "", project: str = "", new_name: str = "",
                    secrets: dict | None = None) -> BaseRuntime:
    """A function object from the run db (``db://project/name[:tag]``) or
    from a yaml or json file at any datastore url."""
    if url.startswith("db://"):
        body = url[len("db://"):]
        project_part, _, name_part = body.partition("/")
        tag = ""
        if ":" in name_part:
            name_part, tag = name_part.split(":", 1)
        from .db import get_run_db

        struct = get_run_db().get_function(name_part, project_part, tag)
    elif url.startswith("hub://"):
        from .serving.resilience import not_ported

        raise not_ported("hub:// functions (hub.py)", 14)
    else:
        import yaml

        from .datastore import store_manager

        item = store_manager.object(url=url, secrets=secrets)
        struct = yaml.safe_load(item.get(encoding="utf-8"))
    kind = struct.get("kind", RuntimeKinds.job)
    runtime = get_runtime_class(kind).from_dict(struct)
    runtime.kind = kind
    if new_name:
        runtime.metadata.name = normalize_name(new_name)
    if project:
        runtime.metadata.project = project
    return runtime


def function_to_module(code: str = "", workdir: str = "", secrets=None):
    """Import a function file as a module."""
    import importlib.util
    import sys

    path = os.path.join(workdir or "", code)
    module_name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def run_local(task=None, command: str = "", name: str = "",
              handler: Callable | None = None, params: dict | None = None,
              inputs: dict | None = None, artifact_path: str = "",
              project: str = "") -> RunObject:
    """One local run of a command or handler in this process."""
    fn = new_function(name=name, project=project, kind=RuntimeKinds.local,
                      command=command, handler=handler)
    return fn.run(task, handler=handler, name=name, params=params,
                  inputs=inputs, artifact_path=artifact_path, local=True)


def wait_for_pipeline_completion(run_id, timeout: float = 3600,
                                 expected_statuses: list | None = None,
                                 project: str = ""):
    """Wait for a workflow run to finish."""
    from .projects.pipelines import wait_for_run_completion

    return wait_for_run_completion(run_id, timeout=timeout, project=project,
                                   expected_statuses=expected_statuses)


def _calling_filename() -> str:
    for frame in inspect.stack()[2:]:
        fname = frame.filename
        if "mlrun_tpu_torch" not in fname and not fname.startswith("<"):
            return fname
    return ""


def _extract_entry_points(source_code: str) -> dict:
    """Top-level functions with their docstrings and parameters
    (``fn.doc()``)."""
    import ast

    out = {}
    try:
        tree = ast.parse(source_code)
    except SyntaxError:
        return out
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params = []
            for arg in node.args.args:
                annotation = ""
                if arg.annotation is not None:
                    annotation = ast.unparse(arg.annotation)
                params.append({"name": arg.arg, "type": annotation})
            out[node.name] = {
                "name": node.name,
                "doc": ast.get_docstring(node) or "",
                "parameters": params,
            }
    return out
