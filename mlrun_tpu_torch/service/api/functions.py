"""Functions, deploy, build, and api-gateways — the port's copy of
``mlrun_tpu/service/api/functions.py`` (reference: crud/functions.py;
endpoints/functions.py:272 build; nuclio function.py:551 deploy;
endpoints/api_gateways.py). The routes that reach the deployment manager,
the image builder or the api gateways (ROADMAP.md item 14, part 14c)
answer 501 with the ``not_ported`` message."""

from __future__ import annotations

from aiohttp import web

from ...common.runtimes_constants import RuntimeKinds
from ...utils import update_in
from ..http_utils import (
    API,
    error_response,
    json_response,
    not_ported_response,
    paginate,
)


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
        # the reference tears the function's live gateway down first; the
        # port deploys none (part 14c)
        state.db.delete_function(request.match_info["name"],
                                 request.match_info["project"])
        return json_response({"ok": True})

    @r.post(API + "/projects/{project}/functions/{name}/deploy")
    async def deploy_function(request):
        """Deploy = a RUNNING, addressable gateway (reference nuclio
        function.py:551; serving.py:580) for the serving kinds, which the
        deployment manager of part 14c builds; a batch kind has nothing to
        run until submitted, so deploy records it ready."""
        body = await request.json()
        function = body.get("function", {})
        update_in(function, "metadata.name", request.match_info["name"])
        update_in(function, "metadata.project",
                  request.match_info["project"])
        kind = function.get("kind", "")
        if kind in (RuntimeKinds.serving, RuntimeKinds.remote,
                    RuntimeKinds.application):
            return not_ported_response(
                f"deploying a '{kind}' function (the deployment manager)")
        update_in(function, "status.state", "ready")
        state.db.store_function(
            function, request.match_info["name"],
            request.match_info["project"],
            tag=function.get("metadata", {}).get("tag", "latest"))
        return json_response({"data": {"state": "ready", "address": ""}})

    @r.delete(API + "/projects/{project}/functions/{name}/deploy")
    async def undeploy_function(request):
        return not_ported_response("tearing a gateway down (the deployment "
                                   "manager)")

    # -- build (part 14c: the image builder) ---------------------------------
    @r.post(API + "/build/function")
    async def build_function(request):
        return not_ported_response("building a function (the image "
                                   "builder)")

    @r.get(API + "/build/status")
    async def build_status(request):
        return not_ported_response("a build's status (the image builder)")

    # -- api gateways (part 14c) ---------------------------------------------
    @r.post(API + "/projects/{project}/api-gateways/{name}")
    async def store_api_gateway(request):
        return not_ported_response("the api gateways")

    @r.get(API + "/projects/{project}/api-gateways/{name}")
    async def get_api_gateway(request):
        return not_ported_response("the api gateways")

    @r.get(API + "/projects/{project}/api-gateways")
    async def list_api_gateways(request):
        return not_ported_response("the api gateways")
