"""Local runtimes — the port's copy of ``mlrun_tpu/runtimes/local.py``
(``LocalRuntime``, ``HandlerRuntime``, ``run_exec``, ``exec_from_params``,
``load_module``).

Executes the handler in-process (or a python file via subprocess with the
``MLT_EXEC_CONFIG`` env contract) and captures results via ``MLClientCtx``,
the handler wrapped in the trackers' pre / post hooks (``track/``).
"""

from __future__ import annotations

import base64
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import traceback
from contextlib import redirect_stdout
from typing import Callable, Optional

from ..common.runtimes_constants import RuntimeKinds
from ..config import run_config
from ..execution import MLClientCtx
from ..model import RunObject
from ..package.context_handler import ContextHandler
from .base import BaseRuntime


def load_module(file_name: str, handler_name: str) -> Callable:
    """Import a python file and return the named handler."""
    module_name = os.path.splitext(os.path.basename(file_name))[0]
    spec = importlib.util.spec_from_file_location(module_name, file_name)
    if spec is None:
        raise ImportError(f"cannot import {file_name}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    if not hasattr(module, handler_name):
        raise AttributeError(f"handler '{handler_name}' not found in {file_name}")
    return getattr(module, handler_name)


def exec_from_params(handler: Callable, runobj: RunObject, context: MLClientCtx,
                     cwd: str | None = None) -> dict:
    """Run a python handler with a context, capturing stdout into the run
    log (written from the logging worker only)."""
    context_handler = ContextHandler()
    kwargs = context_handler.parse_inputs(
        handler, context, runobj.spec.parameters, runobj.spec.inputs)
    old_dir = os.getcwd()
    stdout_buf = io.StringIO()
    db = context._db
    try:
        if cwd:
            os.chdir(cwd)
        with redirect_stdout(stdout_buf):
            # hook trackers (mlflow import etc.) around the user handler
            from ..track import tracker_manager

            tracker_manager.pre_run(context)
            returned = handler(**kwargs)
            tracker_manager.post_run(context)
        context_handler.package_results(context, returned, runobj.spec.returns)
        context.commit(completed=True)
    except Exception as exc:  # noqa: BLE001 - report user errors on the run
        error_text = traceback.format_exc()
        with redirect_stdout(stdout_buf):
            print(error_text)
        context.set_state(error=str(exc), commit=True)
    finally:
        os.chdir(old_dir)
        text = stdout_buf.getvalue()
        if text:
            print(text, end="")
            if db is not None and context.is_logging_worker():
                try:
                    db.store_log(context._uid, context.project, text.encode())
                except Exception:  # noqa: BLE001 - log loss is non-fatal
                    pass
    return context.to_dict()


def run_exec(cmd: list[str], args: list[str], env: dict | None = None,
             cwd: str | None = None) -> tuple[str, str, int]:
    """Run a command-line step as a subprocess."""
    full_cmd = list(cmd) + list(args or [])
    process = subprocess.run(
        full_cmd, capture_output=True, text=True, cwd=cwd,
        env={**os.environ, **(env or {})},
    )
    return process.stdout, process.stderr, process.returncode


class HandlerRuntime(BaseRuntime):
    """In-process callable execution."""

    kind = RuntimeKinds.handler

    def _run(self, runobj: RunObject, execution: MLClientCtx) -> dict:
        handler = runobj.spec.handler
        if not callable(handler):
            raise ValueError("handler runtime requires a callable handler")
        execution.set_hostname(socket.gethostname())
        return exec_from_params(handler, runobj, execution)


class LocalRuntime(BaseRuntime):
    """Local file/handler execution."""

    kind = RuntimeKinds.local
    _is_remote = False

    def to_job(self, image: str = ""):
        from .kubejob import KubejobRuntime

        job = KubejobRuntime.from_dict(self.to_dict())
        if image:
            job.spec.image = image
        return job

    def _materialize_code(self) -> Optional[str]:
        """Write embedded source (build.functionSourceCode) to a temp file."""
        build = self.spec.build
        if build and build.functionSourceCode:
            source = base64.b64decode(build.functionSourceCode).decode()
            suffix = ".py"
            fname = build.origin_filename or ""
            temp = tempfile.NamedTemporaryFile(
                suffix=suffix, delete=False, mode="w",
                prefix=os.path.splitext(os.path.basename(fname))[0] + "-"
                if fname else "handler-")
            temp.write(source)
            temp.close()
            return temp.name
        return None

    def _run(self, runobj: RunObject, execution: MLClientCtx) -> dict:
        execution.set_hostname(socket.gethostname())
        handler = runobj.spec.handler
        if not callable(handler) and callable(self._handler):
            if not handler or handler == self._handler.__name__:
                handler = self._handler
        if callable(handler):
            return exec_from_params(handler, runobj, execution,
                                    cwd=self.spec.workdir)

        command = self.spec.command
        code_file = self._materialize_code()
        if code_file:
            command = code_file
        if not command:
            raise ValueError("local runtime needs a command or embedded code")

        handler_name = runobj.spec.handler_name or self.spec.default_handler
        if handler_name and command.endswith(".py"):
            fn = load_module(command, handler_name)
            return exec_from_params(fn, runobj, execution,
                                    cwd=self.spec.workdir)

        # no handler: execute the file as a script with the env contract
        env = {
            run_config("exec_config_env"): json.dumps(runobj.to_dict(),
                                                      default=str),
            "MLT_DBPATH": run_config("dbpath") or "",
        }
        cmd = [sys.executable, command] if command.endswith(".py") else [command]
        stdout, stderr, rc = run_exec(cmd, self.spec.args, env=env,
                                      cwd=self.spec.workdir)
        if stdout:
            print(stdout, end="")
            if execution._db is not None:
                execution._db.store_log(
                    execution._uid, execution.project, stdout.encode())
        if rc != 0:
            execution.set_state(error=stderr[-2000:] or f"exit code {rc}")
        else:
            # the subprocess may have updated the run in the DB itself;
            # reload to pick up its results, else mark completed
            stored = None
            if execution._db is not None:
                stored = execution._db.read_run(
                    execution._uid, execution.project,
                    iter=execution.iteration)
            if stored and stored.get("status", {}).get("results"):
                return stored
            execution.commit(completed=True)
        return execution.to_dict()
