"""Hub source administration + catalog (reference:
server/api/api/endpoints/hub.py)."""

from __future__ import annotations

import os

from aiohttp import web

from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    def _hub_source_path(name: str):
        if name == "default":
            from ...hub import builtin_hub_path

            return builtin_hub_path()
        source = state.db.get_hub_source(name)
        return (source or {}).get("path")

    @r.put(API + "/hub/sources/{name}")
    async def store_hub_source(request):
        body = await request.json()
        name = request.match_info["name"]
        if name == "default":
            return error_response("the default source is built-in", 400)
        state.db.store_hub_source(name, body.get("source") or body,
                                  order=int(body.get("order", -1)))
        return json_response({"data": state.db.get_hub_source(name)})

    @r.get(API + "/hub/sources")
    async def list_hub_sources(request):
        sources = [{"name": "default", "builtin": True}]
        sources.extend(state.db.list_hub_sources())
        return json_response({"sources": sources})

    @r.get(API + "/hub/sources/{name}")
    async def get_hub_source(request):
        name = request.match_info["name"]
        if name == "default":
            return json_response({"data": {"name": "default",
                                           "builtin": True}})
        source = state.db.get_hub_source(name)
        if source is None:
            return error_response(f"hub source {name} not found", 404)
        return json_response({"data": source})

    @r.delete(API + "/hub/sources/{name}")
    async def delete_hub_source(request):
        state.db.delete_hub_source(request.match_info["name"])
        return json_response({"ok": True})

    @r.get(API + "/hub/sources/{name}/items")
    async def hub_catalog(request):
        path = _hub_source_path(request.match_info["name"])
        if not path or not os.path.isdir(path):
            return error_response("hub source has no readable path", 404)
        items = []
        for entry in sorted(os.listdir(path)):
            fn_yaml = os.path.join(path, entry, "function.yaml")
            if os.path.isfile(fn_yaml):
                items.append({"name": entry})
        return json_response({"catalog": items})

    @r.get(API + "/hub/sources/{name}/items/{item}")
    async def hub_item(request):
        import yaml

        path = _hub_source_path(request.match_info["name"])
        item = request.match_info["item"]
        if ".." in item or "/" in item or os.sep in item:
            return error_response("invalid hub item name", 400)
        fn_yaml = os.path.join(path or "", item, "function.yaml")
        if not path or not os.path.isfile(fn_yaml):
            return error_response(f"hub item {item} not found", 404)
        with open(fn_yaml) as f:
            return json_response({"data": yaml.safe_load(f)})
