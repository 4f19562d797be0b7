"""Model endpoints, metric time-series, and the grafana proxy
(reference: crud/model_monitoring/; endpoints/grafana_proxy.py —
simpleJSON datasource contract).

Two grafana datasources live here: ``grafana-proxy/model-endpoints``
(table-shaped, over the model-monitoring DB) and
``grafana-proxy/metrics`` (timeserie-shaped, over the federated
``obs.TimeSeriesStore`` — the fleet-wide series the SLO evaluator and
autoscaler read; docs/observability.md "Federation")."""

from __future__ import annotations

from datetime import datetime, timezone

from aiohttp import web

from ...config import run_config
from ..http_utils import API, error_response, json_response


def _parse_range_ts(value) -> float:
    """Grafana sends ISO-8601 range bounds; accept epoch numbers too
    (epoch milliseconds are detected and converted — a millis bound
    read as seconds would put the range ~50k years out)."""
    if isinstance(value, (int, float)):
        value = float(value)
        return value / 1000.0 if value > 1e11 else value
    parsed = datetime.fromisoformat(str(value).replace("Z", "+00:00"))
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=timezone.utc)
    return parsed.timestamp()


def register(r: web.RouteTableDef, state):
    @r.post(API + "/projects/{project}/model-endpoints/{uid}")
    async def store_endpoint(request):
        body = await request.json()
        state.db.store_model_endpoint(request.match_info["project"],
                                      request.match_info["uid"], body)
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/model-endpoints/{uid}")
    async def get_endpoint(request):
        from ...db.base import RunDBError

        try:
            endpoint = state.db.get_model_endpoint(
                request.match_info["project"], request.match_info["uid"])
        except RunDBError as exc:
            return error_response(str(exc), 404)
        return json_response({"data": endpoint})

    @r.get(API + "/projects/{project}/model-endpoints")
    async def list_endpoints(request):
        endpoints = state.db.list_model_endpoints(
            request.match_info["project"],
            model=request.query.get("model", ""),
            function=request.query.get("function", ""),
            state=request.query.get("state", ""))
        return json_response({"endpoints": endpoints})

    @r.delete(API + "/projects/{project}/model-endpoints/{uid}")
    async def delete_endpoint(request):
        state.db.delete_model_endpoint(request.match_info["project"],
                                       request.match_info["uid"])
        return json_response({"ok": True})

    @r.get(API + "/projects/{project}/model-endpoints/{uid}/metrics")
    async def endpoint_metrics(request):
        """Metric time-series with time-range + downsampling (reference:
        model-endpoint metric values API over the TSDB layer)."""
        from ...model_monitoring.tsdb import get_metrics_tsdb

        q = request.query
        try:
            start = float(q.get("start", 0) or 0)
            end = float(q["end"]) if q.get("end") else None
            max_points = int(q.get("max_points", 1000))
        except ValueError:
            return error_response("bad time range", 400)
        tsdb = get_metrics_tsdb()
        project = request.match_info["project"]
        uid = request.match_info["uid"]
        if q.get("names_only") in ("true", "1"):
            return json_response(
                {"metrics": tsdb.list_metrics(project, uid)})
        return json_response({"series": tsdb.query(
            project, uid, metric=q.get("name", ""), start=start, end=end,
            max_points=max_points)})

    # -- grafana proxy ------------------------------------------------------
    @r.get(API + "/grafana-proxy/model-endpoints")
    async def grafana_health(request):
        return json_response({"status": "ok"})

    @r.post(API + "/grafana-proxy/model-endpoints/search")
    async def grafana_search(request):
        body = await request.json() if request.can_read_body else {}
        project = (body.get("target") or "").split(":")[0] \
            or run_config("default_project")
        endpoints = state.db.list_model_endpoints(project)
        return json_response([e.get("uid") for e in endpoints])

    @r.post(API + "/grafana-proxy/model-endpoints/query")
    async def grafana_query(request):
        body = await request.json()
        rows = []
        columns = [{"text": "endpoint_id", "type": "string"},
                   {"text": "model", "type": "string"},
                   {"text": "requests", "type": "number"},
                   {"text": "avg_latency_microsec", "type": "number"},
                   {"text": "drift_status", "type": "string"}]
        for target in body.get("targets", [{}]):
            spec = (target.get("target") or "")
            project = spec.split(":")[0] or run_config("default_project")
            for endpoint in state.db.list_model_endpoints(project):
                metrics = endpoint.get("metrics", {})
                rows.append([
                    endpoint.get("uid"), endpoint.get("name"),
                    metrics.get("requests", 0),
                    metrics.get("avg_latency_microsec", 0),
                    endpoint.get("drift_status", "")])
        return json_response([{"type": "table", "columns": columns,
                               "rows": rows}])

    # -- grafana proxy: federated metrics time series ------------------------
    @r.get(API + "/grafana-proxy/metrics")
    async def grafana_metrics_health(request):
        return json_response({"status": "ok"})

    @r.post(API + "/grafana-proxy/metrics/search")
    async def grafana_metrics_search(request):
        from ...obs.timeseries import get_store

        body = await request.json() if request.can_read_body else {}
        return json_response(
            get_store().search(str(body.get("target") or "")))

    @r.post(API + "/grafana-proxy/metrics/query")
    async def grafana_metrics_query(request):
        """simpleJSON ``timeserie`` query over the aggregated store.
        Targets: ``name{label="v"}``, ``rate(name)[60]``,
        ``p95(histogram_family)[60]`` (obs/timeseries.parse_target)."""
        from ...obs.timeseries import get_store, grafana_query

        body = await request.json()
        try:
            start = _parse_range_ts((body.get("range") or {})
                                    .get("from", 0))
            end = _parse_range_ts((body.get("range") or {}).get("to", 0))
        except ValueError:
            return error_response("bad time range", 400)
        store = get_store()

        def run_queries():
            # per-bucket rate/quantile evaluation over a wide dashboard
            # range is real CPU — keep it off the service event loop
            out = []
            for target in body.get("targets", []):
                spec = (target.get("target") or "").strip()
                if not spec:
                    continue
                try:
                    out.append(grafana_query(store, spec, start, end))
                except (ValueError, KeyError) as exc:
                    raise web.HTTPBadRequest(
                        reason=f"bad target {spec!r}: {exc}")
            return out

        import asyncio

        try:
            out = await asyncio.get_event_loop().run_in_executor(
                None, run_queries)
        except web.HTTPBadRequest as exc:
            return error_response(exc.reason, 400)
        return json_response(out)
