"""Chief/worker clusterization — the port's copy of
``mlrun_tpu/service/clusterization.py`` (reference analog:
server/api/main.py:720-757 + utils/clients/chief.py): worker replicas
proxy mutating operations to the chief and serve reads from the shared
DB.

Role comes from ``MLT_CLUSTER_ROLE`` (chief|worker) and
``MLT_CHIEF_URL``; single-instance deployments are implicitly chief.
"""

from __future__ import annotations

import os
from typing import Optional

MUTATING_METHODS = ("POST", "PATCH", "PUT", "DELETE")
# paths a worker may serve locally even when mutating (log append from
# local resources, run updates from in-process executions)
WORKER_ALLOWED_PREFIXES = ("logs",)


def cluster_role() -> str:
    return os.environ.get("MLT_CLUSTER_ROLE", "chief").lower()


def chief_url() -> str:
    return os.environ.get("MLT_CHIEF_URL", "").rstrip("/")


def is_chief() -> bool:
    return cluster_role() != "worker" or not chief_url()


async def maybe_proxy_to_chief(request, chief: bool | None = None
                               ) -> Optional["web.Response"]:
    """On a worker, forward mutating api calls to the chief; returns the
    proxied response, or None when the request should be handled locally.

    ``chief`` is the role captured at app build time — roles must not be
    re-read per request (a chief that later sees worker env would proxy to
    itself forever)."""
    from aiohttp import ClientSession, web

    chief = is_chief() if chief is None else chief
    if chief or request.method not in MUTATING_METHODS:
        return None
    tail = request.path.split("/api/v1/", 1)[-1]
    parts = tail.split("/")
    # projects/<p>/<kind>/... → kind at index 2; bare endpoints at 0
    kind = parts[2] if len(parts) > 2 and parts[0] == "projects" else parts[0]
    if kind in WORKER_ALLOWED_PREFIXES:
        return None
    target = f"{chief_url()}{request.path_qs}"
    body = await request.read()
    async with ClientSession() as session:
        async with session.request(
                request.method, target, data=body,
                headers={"Content-Type":
                         request.headers.get("Content-Type", "")}) as resp:
            payload = await resp.read()
            return web.Response(body=payload, status=resp.status,
                                content_type=resp.content_type)


def clusterization_middleware(chief: bool | None = None):
    from aiohttp import web

    chief = is_chief() if chief is None else chief

    @web.middleware
    async def middleware(request, handler):
        proxied = await maybe_proxy_to_chief(request, chief=chief)
        if proxied is not None:
            return proxied
        return await handler(request)

    return middleware
