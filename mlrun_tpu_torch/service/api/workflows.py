"""Workflow submission/status + the pipelines surface (reference:
endpoints/workflows.py; endpoints/pipelines.py — a KFP proxy; here
the native workflow runner doubles as the pipeline backend)."""

from __future__ import annotations

import threading

from aiohttp import web

from ...common.runtimes_constants import RunStates
from ...utils import generate_uid, now_iso
from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/workflows/submit")
    async def submit_workflow(request):
        body = await request.json()
        workflow_id = generate_uid()
        project = request.match_info["project"]
        state.workflows[workflow_id] = {
            "id": workflow_id, "project": project,
            "state": RunStates.running, "spec": body, "started": now_iso(),
        }

        def run_workflow():
            try:
                # workflow spec carries the project source + workflow path
                pipeline = body.get("pipeline", {})
                from ...projects import load_project

                proj = load_project(
                    context=pipeline.get("context", "./"),
                    name=project, save=False)
                status = proj.run(
                    name=pipeline.get("name", ""),
                    workflow_path=pipeline.get("path", ""),
                    arguments=body.get("arguments"),
                    artifact_path=body.get("artifact_path", ""),
                    engine="local")
                state.workflows[workflow_id]["state"] = status.state
            except Exception as exc:  # noqa: BLE001
                state.workflows[workflow_id]["state"] = RunStates.error
                state.workflows[workflow_id]["error"] = str(exc)

        threading.Thread(target=run_workflow, daemon=True).start()
        return json_response({"id": workflow_id})

    @r.get(API + "/projects/{project}/workflows/{workflow_id}")
    async def workflow_status(request):
        workflow = state.workflows.get(request.match_info["workflow_id"])
        if workflow is None:
            return error_response("workflow not found", 404)
        return json_response({"state": workflow["state"],
                              "error": workflow.get("error")})

    @r.get(API + "/projects/{project}/pipelines")
    async def list_pipelines(request):
        project = request.match_info["project"]
        runs = [w for w in state.workflows.values()
                if project in ("*", "") or w.get("project") == project]
        return json_response({"runs": sorted(
            runs, key=lambda w: w.get("started", ""), reverse=True),
            "total_size": len(runs)})

    @r.get(API + "/projects/{project}/pipelines/{run_id}")
    async def get_pipeline(request):
        workflow = state.workflows.get(request.match_info["run_id"])
        if workflow is None:
            return error_response("pipeline run not found", 404)
        return json_response({"run": workflow})
