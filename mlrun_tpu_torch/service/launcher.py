"""Server-side launcher — the port's copy of
``mlrun_tpu/service/launcher.py``
(reference analog: server/api/launcher.py:40 ServerSideLauncher — enrich →
store function → ctx → generator → runtime_handler.run() :160-168)."""

from __future__ import annotations

import threading

from ..common.runtimes_constants import RunStates, RuntimeKinds
from ..launcher.base import BaseLauncher
from ..model import RunObject
from ..obs import RUN_SUBMITS, get_tracer, trace_id_for
from ..runtimes import get_runtime_class
from ..utils import generate_uid, logger, now_iso
from .runtime_handlers import Provider, get_runtime_handler


class ServerSideLauncher(BaseLauncher):
    def __init__(self, db, provider: Provider):
        self.db = db
        self.provider = provider
        self._handlers: dict[str, object] = {}

    def handler_for(self, kind: str):
        if kind not in self._handlers:
            self._handlers[kind] = get_runtime_handler(
                kind, self.db, self.provider)
        return self._handlers[kind]

    def recover(self):
        """Rebuild handler resource maps after a service restart (reference
        base.py:65 lists cluster resources by label; here DB rows + provider
        discovery)."""
        kinds: set[str] = set()
        lister = getattr(self.db, "list_runtime_resources", None)
        if lister:
            try:
                kinds = {row["kind"] for row in lister() if row.get("kind")}
            except Exception as exc:  # noqa: BLE001
                logger.warning("resource recovery listing failed",
                               error=str(exc))
        if hasattr(self.provider, "list_resources"):
            # provider label discovery must run even for kinds with zero DB
            # rows (lost/fresh DB with live cluster resources)
            kinds |= set(RuntimeKinds.handled_kinds())
        for kind in kinds:
            try:
                self.handler_for(kind).recover_resources()
            except Exception as exc:  # noqa: BLE001 - recover what we can
                logger.warning("resource recovery failed", kind=kind,
                               error=str(exc))

    def monitor_all(self):
        for handler in self._handlers.values():
            try:
                handler.monitor_runs()
            except Exception as exc:  # noqa: BLE001 - keep the loop alive
                logger.warning("monitor_runs failed", error=str(exc))

    def launch(self, runtime, task: RunObject, schedule=None, watch=False,
               auto_build=False, **kwargs) -> RunObject:
        self.enrich_runtime(runtime)
        run = self._enrich_run(runtime, task)
        self._validate_run(run)
        run.status.state = RunStates.pending
        struct = run.to_dict()
        struct["status"]["state"] = RunStates.pending
        self.db.store_run(struct, run.metadata.uid, run.metadata.project)

        if run.spec.is_hyper_job():
            # hyper sweeps fan out as independent child resources; the
            # parent aggregation runs in a service thread
            thread = threading.Thread(
                target=self._run_hyper, args=(runtime, run), daemon=True)
            thread.start()
            return run

        handler = self.handler_for(runtime.kind)
        RUN_SUBMITS.inc(kind=runtime.kind)
        # run-lifecycle trace: every span of this run (submit here,
        # retry/resume/stall in the monitor) shares the uid-derived trace
        # id, so one timeline covers submit → schedule → running → retry
        with get_tracer().span(
                "run.submit", trace_id=trace_id_for(run.metadata.uid),
                attrs={"uid": run.metadata.uid, "kind": runtime.kind,
                       "project": run.metadata.project}):
            try:
                handler.run(runtime, run)
            except Exception as exc:  # noqa: BLE001 - record the failure
                self.db.update_run(
                    {"status.state": RunStates.error,
                     "status.error": str(exc)},
                    run.metadata.uid, run.metadata.project)
                raise
        return run

    def _run_hyper(self, runtime, run: RunObject):
        """Aggregate hyper-param children (executed inline server-side via
        the local provider contract — each iteration is its own resource)."""
        from ..execution import MLClientCtx

        execution = MLClientCtx.from_dict(
            run.to_dict(), rundb=self.db, store_run=False)
        try:
            # the iteration bodies execute through the runtime handler's
            # resource; for the sweep itself we reuse the shared hyper loop
            # with a runtime that launches and waits per child
            wrapper = _HandlerBackedRuntime(self, runtime)
            result = self._run_with_hyperparams(wrapper, run, execution)
        except Exception as exc:  # noqa: BLE001
            self.db.update_run(
                {"status.state": RunStates.error, "status.error": str(exc)},
                run.metadata.uid, run.metadata.project)


class _HandlerBackedRuntime:
    """Adapter giving the hyper loop a `_run(task, ctx)` that launches a
    child resource through the handler and waits for completion."""

    def __init__(self, launcher: ServerSideLauncher, runtime):
        self.launcher = launcher
        self.runtime = runtime

    def _run(self, task: RunObject, execution) -> dict:
        import time

        db = self.launcher.db
        task.metadata.uid = task.metadata.uid or generate_uid()
        db.store_run(task.to_dict(), task.metadata.uid, task.metadata.project,
                     iter=task.metadata.iteration)
        handler = self.launcher.handler_for(self.runtime.kind)
        handler.run(self.runtime, task)
        deadline = time.monotonic() + 24 * 3600
        while time.monotonic() < deadline:
            handler.monitor_runs()
            run = db.read_run(task.metadata.uid, task.metadata.project,
                              iter=task.metadata.iteration) or {}
            state = run.get("status", {}).get("state")
            if state in RunStates.terminal_states():
                return run
            time.sleep(0.5)
        raise TimeoutError("hyper-param iteration timed out")


def rebuild_function(struct: dict):
    """Rebuild a runtime object from its stored dict."""
    kind = struct.get("kind", RuntimeKinds.job)
    runtime = get_runtime_class(kind).from_dict(struct)
    runtime.kind = kind
    return runtime
