"""Artifacts + tags (reference: crud/artifacts.py;
server/api/api/endpoints/tags.py)."""

from __future__ import annotations

from aiohttp import web

from ..http_utils import (
    API,
    error_response,
    json_response,
    paginate,
    token_paginated_response,
)


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/artifacts/{key}")
    async def store_artifact(request):
        body = await request.json()
        q = request.query
        state.db.store_artifact(
            request.match_info["key"], body, uid=q.get("uid"),
            iter=int(q.get("iter") or 0), tag=q.get("tag", ""),
            project=request.match_info["project"], tree=q.get("tree"))
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/artifacts/{key}")
    async def read_artifact(request):
        from ...db.base import RunDBError

        q = request.query
        try:
            artifact = state.db.read_artifact(
                request.match_info["key"], tag=q.get("tag"),
                iter=int(q.get("iter") or 0) if q.get("iter") else None,
                project=request.match_info["project"], tree=q.get("tree"),
                uid=q.get("uid"))
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"data": artifact})

    @r.get(API + "/projects/{project}/artifacts")
    async def list_artifacts(request):
        q = request.query
        filters = dict(
            name=q.get("name", ""), project=request.match_info["project"],
            tag=q.get("tag"), labels=q.getall("label", None),
            kind=q.get("kind"), tree=q.get("tree"))
        if "page_size" in q or "page_token" in q:
            return token_paginated_response(
                state, request, "list_artifacts", "artifacts", filters)
        artifacts = state.db.list_artifacts(**filters)
        return json_response(
            {"artifacts": paginate(artifacts, request)})

    @r.delete(API + "/projects/{project}/artifacts/{key}")
    async def del_artifact(request):
        state.db.del_artifact(
            request.match_info["key"], tag=request.query.get("tag"),
            project=request.match_info["project"],
            uid=request.query.get("uid"))
        return json_response({"ok": True})

    # -- tags (reference server/api/api/endpoints/tags.py) ------------------
    @r.post(API + "/projects/{project}/tags/{tag}")
    async def overwrite_tag(request):
        body = await request.json()
        if body.get("kind", "artifact") != "artifact":
            return error_response("only artifact tagging is supported", 400)
        tagged = state.db.tag_artifacts(
            request.match_info["project"], request.match_info["tag"],
            body.get("identifiers") or [])
        return json_response({"tagged": tagged})

    @r.delete(API + "/projects/{project}/tags/{tag}")
    async def delete_tag(request):
        body = await request.json()
        if body.get("kind", "artifact") != "artifact":
            return error_response("only artifact tagging is supported", 400)
        removed = state.db.untag_artifacts(
            request.match_info["project"], request.match_info["tag"],
            body.get("identifiers") or [])
        return json_response({"removed": removed})
