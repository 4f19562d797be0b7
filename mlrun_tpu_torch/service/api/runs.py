"""Runs + logs + the submit path (reference: endpoints/submit.py:40 →
api/utils.py:207 submit_run; crud/runs.py; crud/logs.py)."""

from __future__ import annotations

import asyncio
from datetime import datetime, timezone

from aiohttp import web

from ...config import run_config, service_config
from ...model import RunObject
from ...utils import generate_uid, get_in, logger, now_iso
from ..cron import CronSchedule
from ..http_utils import (
    API,
    error_response,
    json_response,
    paginate,
    token_paginated_response,
)
from ..launcher import rebuild_function


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/runs/{uid}")
    async def store_run(request):
        body = await request.json()
        state.db.store_run(body, request.match_info["uid"],
                           request.match_info["project"],
                           iter=int(request.query.get("iter", 0)))
        return json_response({"ok": True})

    @r.patch(API + "/projects/{project}/runs/{uid}")
    async def update_run(request):
        body = await request.json()
        state.db.update_run(body, request.match_info["uid"],
                            request.match_info["project"],
                            iter=int(request.query.get("iter", 0)))
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/runs/{uid}")
    async def read_run(request):
        run = state.db.read_run(request.match_info["uid"],
                                request.match_info["project"],
                                iter=int(request.query.get("iter", 0)))
        if run is None:
            return error_response("run not found", 404)
        return json_response({"data": run})

    @r.get(API + "/projects/{project}/runs")
    async def list_runs(request):
        q = request.query
        filters = dict(
            name=q.get("name", ""), project=request.match_info["project"],
            state=q.get("state", ""), labels=q.getall("label", None),
            last=int(q.get("last", 0)), iter=bool(int(q.get("iter", 0))),
            uid=q.getall("uid", None))
        if "page_size" in q or "page_token" in q:
            return token_paginated_response(state, request, "list_runs",
                                            "runs", filters)
        runs = state.db.list_runs(**filters)
        return json_response({"runs": paginate(runs, request)})

    @r.delete(API + "/projects/{project}/runs/{uid}")
    async def del_run(request):
        state.db.del_run(request.match_info["uid"],
                         request.match_info["project"],
                         iter=int(request.query.get("iter", 0)))
        return json_response({"ok": True})

    @r.post(API + "/projects/{project}/runs/{uid}/abort")
    async def abort_run(request):
        uid = request.match_info["uid"]
        project = request.match_info["project"]
        run = state.db.read_run(uid, project)
        if run is None:
            return error_response("run not found", 404)
        kind = get_in(run, "metadata.labels.kind", "job")
        try:
            handler = state.launcher.handler_for(kind)
            handler.abort_run(uid, project)
        except ValueError:
            state.db.abort_run(uid, project)
        state.db.emit_event("run_aborted", {"uid": uid}, project)
        return json_response({"ok": True})

    # -- logs ---------------------------------------------------------------
    @r.post(API + "/projects/{project}/logs/{uid}")
    async def store_log(request):
        body = await request.read()
        state.db.store_log(request.match_info["uid"],
                           request.match_info["project"], body,
                           append=bool(int(request.query.get("append", 1))))
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/logs/{uid}")
    async def get_log(request):
        log_state, data = state.db.get_log(
            request.match_info["uid"], request.match_info["project"],
            offset=int(request.query.get("offset", 0)),
            size=int(request.query.get("size", -1)))
        return web.Response(body=data, headers={
            "x-mlt-run-state": log_state or "unknown"})

    @r.get(API + "/projects/{project}/logs/{uid}/size")
    async def get_log_size(request):
        size = state.db.get_log_size(request.match_info["uid"],
                                     request.match_info["project"])
        return json_response({"size": size})

    # -- submit -------------------------------------------------------------
    @r.post(API + "/submit_job")
    async def submit_job(request):
        """The core submission path (reference endpoints/submit.py:40 →
        api/utils.py:207 submit_run)."""
        body = await request.json()
        function_dict = body.get("function")
        task = body.get("task") or {"metadata": body.get("metadata", {}),
                                    "spec": body.get("spec", {})}
        schedule = body.get("schedule")
        if not function_dict:
            # resolve from the db via task.spec.function uri
            uri = get_in(task, "spec.function", "")
            if not uri:
                return error_response("missing function")
            project_part, _, rest = uri.partition("/")
            name, _, tag = rest.partition(":")
            tag, _, hash_key = tag.partition("@")
            function_dict = state.db.get_function(
                name, project_part, tag=tag or "latest")

        retry_spec = get_in(task, "spec.retry_policy")
        if retry_spec:
            # reject typo'd policies at the door — a misspelled key or
            # failure class would otherwise silently disable retries
            from ...common.schemas.run import RetryPolicy

            try:
                RetryPolicy(**retry_spec)
            except Exception as exc:  # noqa: BLE001 - pydantic details vary
                return error_response(f"bad retry_policy: {exc}")
        run = RunObject.from_dict(
            {"metadata": task.get("metadata", {}),
             "spec": task.get("spec", {})})
        run.metadata.uid = run.metadata.uid or generate_uid()
        run.metadata.project = (run.metadata.project
                                or run_config("default_project"))
        runtime = rebuild_function(function_dict)
        run.metadata.labels.setdefault("kind", runtime.kind)
        # persist the (possibly inline) function: retries after a service
        # restart rebuild the resource from the stored function via
        # spec.function (runtime_handlers._rebuild_from_function), and the
        # reference stores every submitted function the same way
        try:
            state.db.store_function(
                function_dict, runtime.metadata.name,
                runtime.metadata.project or run.metadata.project,
                tag=runtime.metadata.tag or "latest")
        except Exception as exc:  # noqa: BLE001 - submission still valid
            logger.warning("could not persist submitted function",
                           error=str(exc))
        # notification secret-params never reach the stored run or the
        # resource env (reference api/utils.py:221 mask_notification_params)
        from ..secrets import mask_notification_params

        mask_notification_params(state.db, run)

        if schedule:
            record = {
                "name": run.metadata.name, "project": run.metadata.project,
                "kind": "job", "cron_trigger": schedule,
                "scheduled_object": {"function": function_dict,
                                     "task": run.to_dict()},
                "creation_time": now_iso(),
            }
            try:
                cron = CronSchedule(schedule)
            except ValueError as exc:
                return error_response(f"bad schedule: {exc}")
            if cron.min_interval_seconds() < \
                    service_config("scheduler.min_allowed_interval_seconds"):
                return error_response("schedule interval below minimum")
            record["next_run_time"] = str(
                cron.next_after(datetime.now(timezone.utc)))
            state.db.store_schedule(run.metadata.project, run.metadata.name,
                                    record)
            return json_response({"data": {"schedule": schedule,
                                           "metadata":
                                           run.to_dict()["metadata"]}})

        loop = asyncio.get_event_loop()
        try:
            await loop.run_in_executor(
                None, lambda: state.launcher.launch(runtime, run))
        except Exception as exc:  # noqa: BLE001
            return error_response(f"launch failed: {exc}", 500)
        return json_response({"data": run.to_dict()})
