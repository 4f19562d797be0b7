"""Shared HTTP helpers for the service's API modules (the service-side
analog of the reference's server/api/api/utils.py response helpers) —
the port's copy of ``mlrun_tpu/service/http_utils.py``."""

from __future__ import annotations

import json

from aiohttp import web

from ..config import service_config

API = service_config("api_base_path").rstrip("/")


def json_response(data, status: int = 200):
    return web.json_response(data, status=status, dumps=lambda d: json.dumps(
        d, default=str))


def error_response(message: str, status: int = 400):
    return web.json_response({"detail": message}, status=status)


def paginate(items: list, request) -> list:
    """limit/offset slicing for list endpoints (reference pagination
    analog — token-based pagination cache is R2)."""
    try:
        offset = int(request.query.get("offset", 0))
        limit = int(request.query.get("limit", 0))
    except ValueError:
        return items
    if offset:
        items = items[offset:]
    if limit:
        items = items[:limit]
    return items


def token_paginated_response(state, request, method: str, key: str,
                             filters: dict):
    """Token-pagination branch shared by list endpoints: parse page
    params, delegate to the DB pagination cache, shape the response."""
    from ..db.base import RunDBError

    q = request.query
    try:
        items, token = state.db.paginated_list(
            method, page_size=int(q.get("page_size", 20)),
            page_token=q.get("page_token", ""), **filters)
    except (RunDBError, ValueError) as exc:
        return error_response(str(exc), 400)
    return json_response({key: items,
                          "pagination": {"page_token": token}})
