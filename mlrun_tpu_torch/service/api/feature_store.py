"""Feature-store object CRUD (reference: crud/feature_store.py —
feature-sets and feature-vectors share one generic surface)."""

from __future__ import annotations

from aiohttp import web

from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    def _fs_routes(kind: str, store, get, list_, delete):
        @r.post(API + "/projects/{project}/" + kind + "/{name}")
        async def _store(request):
            body = await request.json()
            uid = store(body, name=request.match_info["name"],
                        project=request.match_info["project"],
                        tag=request.query.get("tag"),
                        uid=request.query.get("uid"))
            return json_response({"uid": uid})

        @r.get(API + "/projects/{project}/" + kind + "/{name}")
        async def _get(request):
            from ...db.base import RunDBError

            try:
                obj = get(request.match_info["name"],
                          project=request.match_info["project"],
                          tag=request.query.get("tag"),
                          uid=request.query.get("uid"))
            except RunDBError as exc:
                return error_response(str(exc), 404)
            return json_response({"data": obj})

        @r.get(API + "/projects/{project}/" + kind)
        async def _list(request):
            objs = list_(project=request.match_info["project"],
                         name=request.query.get("name", ""),
                         tag=request.query.get("tag"))
            return json_response({kind.replace("-", "_"): objs})

        @r.delete(API + "/projects/{project}/" + kind + "/{name}")
        async def _delete(request):
            delete(request.match_info["name"],
                   project=request.match_info["project"])
            return json_response({"ok": True})

    _fs_routes("feature-sets", state.db.store_feature_set,
               state.db.get_feature_set, state.db.list_feature_sets,
               state.db.delete_feature_set)
    _fs_routes("feature-vectors", state.db.store_feature_vector,
               state.db.get_feature_vector, state.db.list_feature_vectors,
               state.db.delete_feature_vector)
