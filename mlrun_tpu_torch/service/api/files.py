"""Remote file access (reference server/api/api/endpoints/files.py)."""

from __future__ import annotations

import os

from aiohttp import web

from ...config import service_config
from ..http_utils import API, error_response, json_response


def _file_access_denied(state, path: str) -> str | None:
    """Service internals are never readable through /files (the
    sqlite DB holds project secret values); an optional allowlist
    (``httpdb.files_allowed_paths``) restricts everything else.
    Local paths (bare or file://) are compared by realpath; remote
    URLs (s3:// etc.) by raw prefix."""
    scheme, _, rest = path.partition("://")
    local = not rest or scheme == "file"
    local_path = (rest if scheme == "file" else path) if local else None
    allowed = [p.strip() for p in str(
        service_config("httpdb.files_allowed_paths") or "").split(",")
        if p.strip()]
    if local:
        real = os.path.realpath(local_path)
        dsn = os.path.realpath(getattr(state.db, "dsn", "") or "")
        if dsn and real in (dsn, dsn + "-wal", dsn + "-shm"):
            return "service database is not readable through /files"
        if allowed and not any(
                (not a.partition("://")[1])
                and (real.startswith(os.path.realpath(a) + os.sep)
                     or real == os.path.realpath(a))
                for a in allowed):
            return "path is outside files_allowed_paths"
        return None
    if allowed and not any(path.startswith(a) for a in allowed):
        return "path is outside files_allowed_paths"
    return None


def register(r: web.RouteTableDef, state):
    @r.get(API + "/projects/{project}/files")
    async def get_file(request):
        path = request.query.get("path", "")
        if not path:
            return error_response("path query parameter is required", 400)
        denied = _file_access_denied(state, path)
        if denied:
            return error_response(denied, 403)
        try:
            from ...datastore import store_manager

            size = int(request.query.get("size", 0)) or None
            offset = int(request.query.get("offset", 0))
            body = store_manager.object(url=path).get(size=size,
                                                      offset=offset)
        except FileNotFoundError:
            return error_response(f"file not found: {path}", 404)
        except Exception as exc:  # noqa: BLE001
            return error_response(f"failed to read {path}: {exc}", 400)
        if isinstance(body, str):
            body = body.encode()
        return web.Response(body=body,
                            content_type="application/octet-stream")

    @r.get(API + "/projects/{project}/filestat")
    async def get_filestat(request):
        path = request.query.get("path", "")
        if not path:
            return error_response("path query parameter is required", 400)
        denied = _file_access_denied(state, path)
        if denied:
            return error_response(denied, 403)
        try:
            from ...datastore import store_manager

            stats = store_manager.object(url=path).stat()
        except FileNotFoundError:
            return error_response(f"file not found: {path}", 404)
        except Exception as exc:  # noqa: BLE001
            return error_response(f"failed to stat {path}: {exc}", 400)
        return json_response({"size": stats.size, "modified": stats.modified,
                              "content_type": getattr(stats, "content_type",
                                                      None)})
