"""Health, specs, introspection, background tasks, and runtime
resources — the port's copy of ``mlrun_tpu/service/api/operations.py``
(reference: endpoints/healthz.py, client_spec,
frontend_spec, background_tasks.py, runtime_resources.py,
utils/memory_reports.py)."""

from __future__ import annotations

from aiohttp import web

from ... import __version__
from ...common.runtimes_constants import RunStates
from ...config import (
    K8S_DEFAULTS,
    OBSERVABILITY_DEFAULTS,
    resolve_artifact_path,
    run_config,
)
from ...utils import get_in
from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    @r.get(f"{API}/healthz")
    async def healthz(request):
        return json_response({"status": "ok", "version": __version__})

    @r.get("/metrics")
    async def metrics(request):
        """Prometheus text exposition of the process-wide registry
        (docs/observability.md): run-lifecycle counters (submits, retries
        by failure class, stall aborts), chaos fire counts, and — when
        this process also serves — the serving/engine series. Root path
        (not under the API base) per scraper convention; left open by the
        auth middleware like healthz. Accept:
        application/openmetrics-text negotiates exemplar-carrying
        OpenMetrics output (default stays Prometheus text 0.0.4)."""
        from ...obs import (
            CONTENT_TYPE,
            OPENMETRICS_CONTENT_TYPE,
            PROBE_REQUESTS,
            REGISTRY,
            wants_openmetrics,
        )

        PROBE_REQUESTS.inc(path="/metrics")
        if not bool(OBSERVABILITY_DEFAULTS["metrics_enabled"]):
            return web.Response(status=404, text="metrics exposition is "
                                "disabled (OBSERVABILITY_DEFAULTS)")
        om = wants_openmetrics(request.headers.get("Accept"))
        return web.Response(
            body=REGISTRY.render(openmetrics=om).encode(),
            headers={"Content-Type": (OPENMETRICS_CONTENT_TYPE if om
                                      else CONTENT_TYPE)})

    # -- debug endpoints (docs/observability.md "Flight recorder & debug
    # endpoints"); root paths like /metrics, but NOT middleware-open —
    # the flight ring and trace arming stay behind the service token
    @r.get("/debug/flight")
    async def debug_flight(request):
        """Live read of the black-box flight ring: run-lifecycle
        decisions (retries, stall detection), chaos fires, breaker
        trips, engine scheduler events — the same sequence a
        crash/stall post-mortem artifact carries. Handler core shared
        with the serving gateway (obs/debug.py)."""
        import json as _json

        from ...obs.debug import flight_snapshot

        try:
            payload = flight_snapshot(request.query.get("kind", ""),
                                      request.query.get("limit", 0))
        except ValueError as exc:
            return error_response(str(exc), 400)
        return web.json_response(
            payload, dumps=lambda d: _json.dumps(d, default=str))

    @r.get("/debug/trace/{trace_id}")
    async def debug_trace(request):
        """Assembled cross-replica waterfall + blocking critical path
        for one trace id (docs/observability.md "Request attribution,
        exemplars & trace assembly"). Handler core shared with the
        serving gateway (obs/debug.py); like the other /debug routes it
        stays behind the service auth token."""
        import asyncio as _asyncio
        import json as _json

        from ...obs.debug import trace_snapshot

        local_only = request.query.get("local", "") in ("1", "true")
        loop = _asyncio.get_event_loop()
        try:
            payload = await loop.run_in_executor(None, lambda: (
                trace_snapshot(request.match_info["trace_id"],
                               local_only=local_only)))
        except ValueError as exc:
            return error_response(str(exc), 400)
        return web.json_response(
            payload, dumps=lambda d: _json.dumps(d, default=str))

    @r.get("/debug/profile")
    async def debug_profile_get(request):
        from ...utils.profiler import profile_status

        return json_response(profile_status())

    @r.post("/debug/profile")
    async def debug_profile_post(request):
        """Arm ``utils/profiler`` for the next N steps/seconds on a live
        trainer or engine in this process (hot loops tick the armed
        capture; the torch.profiler trace artifact registers on stop) —
        profile a production hot loop without a restart."""
        from ...obs.debug import profile_request

        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except ValueError:
                return error_response("body must be JSON", 400)
        try:
            out = profile_request(body)
        except ValueError as exc:
            return error_response(str(exc), 400)
        return json_response(out)

    @r.get(f"{API}/client-spec")
    async def client_spec(request):
        return json_response({
            "version": __version__,
            "namespace": K8S_DEFAULTS["namespace"],
            "default_project": run_config("default_project"),
            "gpu_defaults": {"gpu_product": K8S_DEFAULTS["gpu_product"],
                             "gpus_per_node": K8S_DEFAULTS["gpus_per_node"],
                             "image": K8S_DEFAULTS["image"]},
            "config_overrides": {},
        })

    @r.get(API + "/frontend-spec")
    async def frontend_spec(request):
        from ...common.runtimes_constants import RuntimeKinds

        return json_response({
            "feature_flags": {"tpujob": True, "serving": True,
                              "feature_store": True,
                              "model_monitoring": True},
            "default_artifact_path": resolve_artifact_path("{project}"),
            "runtime_kinds": RuntimeKinds.all(),
        })

    @r.get(API + "/operations/memory-report")
    async def memory_report(request):
        """reference analog: server/api/utils/memory_reports.py (objgraph) —
        here host RSS + device HBM via the profiler util."""
        from ...utils.profiler import memory_report as report

        return json_response({"data": report()})

    # -- background tasks ---------------------------------------------------
    @r.get(API + "/projects/{project}/background-tasks")
    async def list_background_tasks(request):
        return json_response(
            {"background_tasks": state.db.list_background_tasks(
                request.match_info["project"])})

    @r.get(API + "/projects/{project}/background-tasks/{name}")
    async def get_background_task(request):
        task = state.db.get_background_task(
            request.match_info["name"], request.match_info["project"])
        if task is None:
            return error_response("background task not found", 404)
        return json_response({"data": task})

    # -- runtime resources (reference: endpoints/runtime_resources.py —
    # grouped listing + filtered deletion of the cluster resources a run
    # created) --------------------------------------------------------------
    @r.get(API + "/projects/{project}/runtime-resources")
    async def list_runtime_resources(request):
        project = request.match_info["project"]
        kind = request.query.get("kind", "")
        rows = state.db.list_runtime_resources(kind)
        if project not in ("*", ""):
            rows = [row for row in rows if row["project"] == project]
        grouped: dict = {}
        for row in rows:
            handler = state.launcher.handler_for(row["kind"])
            try:
                live_state = handler.provider.state(row["resource_id"])
            except Exception:  # noqa: BLE001 - provider may be gone
                live_state = "unknown"
            grouped.setdefault(row["kind"], []).append({
                **row, "state": live_state})
        return json_response({"runtime_resources": [
            {"kind": kind_, "resources": res}
            for kind_, res in sorted(grouped.items())]})

    @r.delete(API + "/projects/{project}/runtime-resources")
    async def delete_runtime_resources(request):
        project = request.match_info["project"]
        kind = request.query.get("kind", "")
        object_id = request.query.get("object-id", "")
        force = request.query.get("force", "") in ("true", "1")
        deleted = []
        for row in state.db.list_runtime_resources(kind):
            if project not in ("*", "") and row["project"] != project:
                continue
            if object_id and row["resource_id"] != object_id:
                continue
            run = state.db.read_run(row["uid"], row["project"])
            run_state = get_in(run or {}, "status.state", "")
            if not force and run_state not in RunStates.terminal_states():
                continue  # reference refuses to delete live runs w/o force
            handler = state.launcher.handler_for(row["kind"])
            try:
                # goes through the handler so the in-memory resource map is
                # also dropped — otherwise the next monitor tick would probe
                # the deleted resource and mark the run failed
                handler.delete_resources(row["uid"], row["project"],
                                         row["resource_id"])
            except Exception:  # noqa: BLE001 - provider may be gone; keep
                # the mapping so a later retry can still find the resource
                continue
            deleted.append(row)
        return json_response({"deleted": deleted})
