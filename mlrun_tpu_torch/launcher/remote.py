"""Client-side remote launcher — the port's copy of
``mlrun_tpu/launcher/remote.py`` (reference analog:
mlrun/launcher/remote.py:34 ClientRemoteLauncher.launch, :123
_submit_job)."""

from __future__ import annotations

from ..common.runtimes_constants import RunStates
from ..model import RunObject
from ..utils import logger
from .base import BaseLauncher


class ClientRemoteLauncher(BaseLauncher):
    """Stores the function in the service and POSTs the run to /submit_job."""

    def launch(self, runtime, task: RunObject, schedule=None, watch=True,
               auto_build=False, **kwargs) -> RunObject:
        self.enrich_runtime(runtime)
        run = self._enrich_run(runtime, task)
        self._validate_run(run)
        db = runtime._get_db()

        if auto_build and not runtime.is_deployed:
            deploy = getattr(runtime, "deploy", None)
            if deploy:
                deploy()

        # store the function so the server launcher can rebuild it
        self._store_function(runtime, run, db)
        return self._submit_job(runtime, run, db, schedule, watch)

    @staticmethod
    def _store_function(runtime, run: RunObject, db):
        hash_key = db.store_function(
            runtime.to_dict(), runtime.metadata.name,
            run.metadata.project, tag=runtime.metadata.tag or "latest",
            versioned=True)
        runtime.metadata.hash = hash_key
        run.spec.function = runtime.uri

    def _submit_job(self, runtime, run: RunObject, db, schedule,
                    watch: bool) -> RunObject:
        body = run.to_dict()
        body["task"] = {"spec": body.get("spec", {}),
                        "metadata": body.get("metadata", {})}
        body["function"] = runtime.to_dict()
        if schedule:
            body["schedule"] = schedule
        resp = db.submit_job(body, schedule=schedule)
        if schedule:
            logger.info("task scheduled", schedule=schedule)
            run.status.state = "scheduled"
            return run
        uid = resp.get("data", resp).get("metadata", {}).get("uid") or \
            run.metadata.uid
        run.metadata.uid = uid
        run._db = db
        if watch:
            state, _ = db.watch_log(uid, run.metadata.project, watch=True)
            run.refresh()
            self._push_notifications(run)
            if run.status.state == RunStates.error:
                raise RuntimeError(
                    f"run {run.metadata.name} failed: {run.status.error}")
        else:
            run.refresh()
        return run
