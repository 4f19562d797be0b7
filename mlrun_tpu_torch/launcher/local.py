"""Client-side local launcher — the port's copy of
``mlrun_tpu/launcher/local.py``: runs a task in this process through the
runtime's ``_run`` (a cluster kind with ``local=True`` as a
``LocalRuntime``)."""

from __future__ import annotations

import socket

from ..execution import MLClientCtx
from ..model import RunObject
from .base import BaseLauncher


class ClientLocalLauncher(BaseLauncher):
    """Runs a task in-process through the runtime's ``_run``."""

    def __init__(self, local: bool = True):
        self._is_local = local

    def launch(self, runtime, task: RunObject, schedule=None, watch=True,
               auto_build=False, **kwargs) -> RunObject:
        if schedule:
            raise ValueError(
                "schedules require the remote service (set MLT_DBPATH)")
        self.enrich_runtime(runtime)
        run = self._enrich_run(runtime, task)
        self._validate_run(run)

        # local=True forces in-process execution of any kind's handler;
        # otherwise client-driven kinds (dask/spark/databricks) keep their
        # own _run, which talks to their execution substrate directly
        if runtime.kind not in ("local", "handler", "") and self._is_local:
            runtime = self._convert_to_local(runtime)

        execution = MLClientCtx.from_dict(
            run.to_dict(), host=socket.gethostname())
        runtime._pre_run(run, execution)
        try:
            if run.spec.is_hyper_job():
                result = self._run_with_hyperparams(runtime, run, execution)
            else:
                result = runtime._run(run, execution)
        except Exception as exc:  # noqa: BLE001 - surface on the run object
            execution.set_state(error=str(exc))
            result = execution.to_dict()
        runtime._post_run(result, execution)
        run = self._log_track_results(runtime, result, run)
        self._push_notifications(run)
        return run

    @staticmethod
    def _convert_to_local(runtime):
        """Clone a remote-kind function into a LocalRuntime that executes the
        same code in-process."""
        from ..runtimes.local import LocalRuntime

        local = LocalRuntime.from_dict(runtime.to_dict())
        local.kind = "local"
        local.metadata = runtime.metadata
        local.spec = runtime.spec
        local._handler = getattr(runtime, "_handler", None)
        return local
