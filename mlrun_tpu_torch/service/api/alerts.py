"""Alert configs, silencing windows, and event emission (reference:
crud/alerts.py + events; silencing is this framework's addition)."""

from __future__ import annotations

from aiohttp import web

from ..http_utils import API, error_response, json_response


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/alerts/{name}")
    async def store_alert(request):
        body = await request.json()
        state.db.store_alert_config(request.match_info["name"], body,
                                    request.match_info["project"])
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/alerts/{name}")
    async def get_alert(request):
        from ...db.base import RunDBError

        try:
            alert = state.db.get_alert_config(request.match_info["name"],
                                              request.match_info["project"])
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"data": alert})

    @r.get(API + "/projects/{project}/alerts")
    async def list_alerts(request):
        return json_response({"alerts": state.db.list_alert_configs(
            request.match_info["project"])})

    @r.post(API + "/projects/{project}/alerts/{name}/silence")
    async def silence_alert(request):
        """Open (or clear) a silencing window on an alert config: body
        {"minutes": N} silences for N minutes; {"minutes": 0} clears."""
        from datetime import datetime, timedelta, timezone

        project = request.match_info["project"]
        name = request.match_info["name"]
        body = await request.json()
        try:
            alert = state.db.get_alert_config(name, project)
        except Exception:
            return error_response(f"alert {name} not found", 404)
        minutes = float(body.get("minutes", 0))
        if minutes > 0:
            until = datetime.now(timezone.utc) + timedelta(minutes=minutes)
            alert["silence_until"] = until.isoformat()
        else:
            alert["silence_until"] = ""
        state.db.store_alert_config(name, alert, project)
        return json_response({"data": alert})

    @r.delete(API + "/projects/{project}/alerts/{name}")
    async def delete_alert(request):
        state.db.delete_alert_config(request.match_info["name"],
                                     request.match_info["project"])
        return json_response({"ok": True})

    @r.post(API + "/projects/{project}/events/{kind}")
    async def emit_event(request):
        body = await request.json()
        project = request.match_info["project"]
        kind = request.match_info["kind"]
        state.db.emit_event(kind, body, project)
        from ..alerts import process_event

        fired = process_event(state.db, project, kind, body)
        return json_response({"ok": True, "alerts_fired": fired})
