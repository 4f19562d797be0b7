"""Schedules CRUD (reference: crud + the APScheduler-backed
scheduler.py surface; firing lives in app.py's scheduler loop /
service/cron.py)."""

from __future__ import annotations

from aiohttp import web

from ..cron import CronSchedule
from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/schedules/{name}")
    async def store_schedule(request):
        body = await request.json()
        try:
            CronSchedule(body.get("cron_trigger", ""))
        except ValueError as exc:
            return error_response(f"bad cron: {exc}")
        state.db.store_schedule(request.match_info["project"],
                                request.match_info["name"], body)
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/schedules/{name}")
    async def get_schedule(request):
        from ...db.base import RunDBError

        try:
            schedule = state.db.get_schedule(request.match_info["project"],
                                             request.match_info["name"])
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"data": schedule})

    @r.get(API + "/projects/{project}/schedules")
    async def list_schedules(request):
        return json_response({"schedules": state.db.list_schedules(
            request.match_info["project"])})

    @r.delete(API + "/projects/{project}/schedules/{name}")
    async def delete_schedule(request):
        state.db.delete_schedule(request.match_info["project"],
                                 request.match_info["name"])
        return json_response({"ok": True})
