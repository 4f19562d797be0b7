"""Functions, deploy, build, and api-gateways — the port's copy of
``mlrun_tpu/service/api/functions.py``: the deploy routes reach the
deployment manager (``service/deployments.py``), the build routes the
image builder (``service/builder.py``); api gateways are stored as
``api-gateway`` kind function objects."""

from __future__ import annotations

import asyncio

from aiohttp import web

from ...common.runtimes_constants import RuntimeKinds
from ...config import run_config
from ...utils import update_in
from ..http_utils import API, error_response, json_response, paginate


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/functions/{name}")
    async def store_function(request):
        body = await request.json()
        hash_key = state.db.store_function(
            body, request.match_info["name"], request.match_info["project"],
            tag=request.query.get("tag", ""),
            versioned=bool(int(request.query.get("versioned", 0))))
        return json_response({"hash_key": hash_key})

    @r.get(API + "/projects/{project}/functions/{name}")
    async def get_function(request):
        from ...db.base import RunDBError

        try:
            func = state.db.get_function(
                request.match_info["name"], request.match_info["project"],
                tag=request.query.get("tag", ""),
                hash_key=request.query.get("hash_key", ""))
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"func": func})

    @r.get(API + "/projects/{project}/functions")
    async def list_functions(request):
        funcs = state.db.list_functions(
            name=request.query.get("name", ""),
            project=request.match_info["project"],
            tag=request.query.get("tag", ""),
            labels=request.query.getall("label", None))
        return json_response({"funcs": paginate(funcs, request)})

    @r.delete(API + "/projects/{project}/functions/{name}")
    async def delete_function(request):
        # a live gateway dies with its function
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(
            None, lambda: state.deployments.teardown(
                request.match_info["name"], request.match_info["project"],
                store_state=False))
        state.db.delete_function(request.match_info["name"],
                                 request.match_info["project"])
        return json_response({"ok": True})

    @r.post(API + "/projects/{project}/functions/{name}/deploy")
    async def deploy_function(request):
        """Deploy = a RUNNING, addressable gateway. The deployment manager
        starts the port's graph-server process (local provider) or a
        Deployment and a Service (kubernetes) and answers once it is
        invocable."""
        body = await request.json()
        function = body.get("function", {})
        update_in(function, "metadata.name", request.match_info["name"])
        update_in(function, "metadata.project",
                  request.match_info["project"])
        kind = function.get("kind", "")
        if kind not in (RuntimeKinds.serving, RuntimeKinds.remote,
                        RuntimeKinds.application):
            # batch kinds have nothing to run until submitted — deploy just
            # resolves the image + readiness (the build path)
            update_in(function, "status.state", "ready")
            state.db.store_function(
                function, request.match_info["name"],
                request.match_info["project"],
                tag=function.get("metadata", {}).get("tag", "latest"))
            return json_response({"data": {"state": "ready",
                                           "address": ""}})
        loop = asyncio.get_event_loop()
        info = await loop.run_in_executor(
            None, lambda: state.deployments.deploy(function))
        if info["state"] == "error":
            return error_response(
                f"function deploy failed: {info.get('error', '')}", 400)
        return json_response({"data": info})

    @r.delete(API + "/projects/{project}/functions/{name}/deploy")
    async def undeploy_function(request):
        loop = asyncio.get_event_loop()
        removed = await loop.run_in_executor(
            None, lambda: state.deployments.teardown(
                request.match_info["name"], request.match_info["project"]))
        return json_response({"removed": removed})

    # -- build --------------------------------------------------------------
    @r.post(API + "/build/function")
    async def build_function(request):
        """A prebuilt image with its code in the env needs nothing;
        requirements or commands trigger a build — the requirements
        overlay's pre-warm (local provider) or a Kaniko pod (kubernetes),
        tracked as a background task with a retrievable log. The body's
        ``with_tpu`` flag (the reference client's wire name) asks for the
        GPU image."""
        body = await request.json()
        function = body.get("function", {})
        with_gpu = bool(body.get("with_tpu", False))
        loop = asyncio.get_event_loop()
        status = await loop.run_in_executor(
            None, lambda: state.builder.build(function, with_gpu=with_gpu))
        return json_response({"data": {"status": status}})

    @r.get(API + "/build/status")
    async def build_status(request):
        """A build's state and its log from ``offset`` on."""
        status = state.builder.status(
            request.query.get("name", ""),
            request.query.get("project", "") or run_config("default_project"),
            tag=request.query.get("tag", "latest"),
            offset=int(request.query.get("offset", 0) or 0))
        if status["state"] == "not_found":
            return error_response("function not found", 404)
        return json_response({"data": status})

    # -- api gateways (stored as api-gateway kind function objects) ---------
    @r.post(API + "/projects/{project}/api-gateways/{name}")
    async def store_api_gateway(request):
        body = await request.json()
        gateway = body.get("data", body)
        gateway["kind"] = "api-gateway"
        state.db.store_function(gateway, request.match_info["name"],
                                request.match_info["project"],
                                tag="latest")
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/api-gateways/{name}")
    async def get_api_gateway(request):
        from ...db.base import RunDBError

        try:
            gateway = state.db.get_function(
                request.match_info["name"], request.match_info["project"])
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"data": gateway})

    @r.get(API + "/projects/{project}/api-gateways")
    async def list_api_gateways(request):
        funcs = state.db.list_functions(
            project=request.match_info["project"])
        return json_response({"api_gateways": [
            f for f in funcs if f.get("kind") == "api-gateway"]})
