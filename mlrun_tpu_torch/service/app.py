"""The metadata/orchestration service — aiohttp REST app; the port's copy
of ``mlrun_tpu/service/app.py``.

Reference analog: server/api/main.py:93 FastAPI `app` + the 37 routers in
server/api/api/api.py, reduced to the same REST contract the SDK's HTTPRunDB
speaks. FastAPI/SQLAlchemy are replaced by aiohttp + the embedded SQLite DB.
Periodic tasks mirror main.py:608 (runs monitoring) and the APScheduler-based
Scheduler (utils/scheduler.py) is replaced by service/cron.py.

This module keeps only the app assembly: ServiceState, middleware, the
periodic loops, and run_app. Every route lives in a per-resource module
under ``service/api/`` (the reference's endpoints/+crud/ layout).
"""

from __future__ import annotations

import asyncio
import os
import time
from datetime import datetime, timezone

from aiohttp import web

from .. import __version__
from ..config import (
    OBSERVABILITY_DEFAULTS,
    SERVICE_DEFAULTS,
    run_config,
    service_config,
)
from ..db.sqlitedb import SQLiteRunDB
from ..model import RunObject
from ..utils import generate_uid, logger
from .cron import CronSchedule
from .http_utils import (  # noqa: F401 - re-exported for compat
    API,
    error_response,
    json_response,
    paginate,
    token_paginated_response,
)
from .launcher import ServerSideLauncher, rebuild_function
from .runtime_handlers import LocalProcessProvider


class ServiceState:
    def __init__(self, db: SQLiteRunDB | None = None, provider=None):
        if db is None:
            from ..db.base import sql_dialect_for_dsn

            dsn = str(service_config("httpdb.dsn") or "")
            if sql_dialect_for_dsn(dsn):
                from ..db.sqldb import SQLServerRunDB

                db = SQLServerRunDB(dsn)
            else:
                db = SQLiteRunDB()
        self.db = db
        self.provider = provider or LocalProcessProvider(self.db)
        self.launcher = ServerSideLauncher(self.db, self.provider)
        self.launcher.recover()  # re-adopt resources from before a restart
        from .builder import FunctionBuilder
        from .deployments import DeploymentManager

        self.deployments = DeploymentManager(self.db, self.provider)
        self.builder = FunctionBuilder(self.db, self.provider)
        from .projects_sync import ProjectsFollower

        self.projects_follower = ProjectsFollower(self.db)
        self.background_tasks: dict[str, dict] = {}
        self.workflows: dict[str, dict] = {}
        self.started = time.time()


def auth_middleware():
    """Bearer-token auth for the whole API when a service token is
    configured (``httpdb.auth_token`` / MLT_SERVICE_TOKEN). healthz
    stays open for probes. Without a token the service is open — matching
    the reference's default in-cluster posture."""

    @web.middleware
    async def middleware(request, handler):
        required = service_config("httpdb.auth_token") or os.environ.get(
            "MLT_SERVICE_TOKEN", "")
        # probes and scrapers stay open: healthz for the orchestrator,
        # /metrics for Prometheus (exposition carries no secrets)
        open_paths = {API + "/healthz", "/metrics"}
        if required and request.path.rstrip("/") not in open_paths:
            header = request.headers.get("Authorization", "")
            if header != f"Bearer {required}":
                return error_response("unauthorized", 401)
        return await handler(request)

    return middleware


def build_app(state: ServiceState | None = None) -> web.Application:
    from .api import REGISTRARS
    from .clusterization import clusterization_middleware, is_chief

    state = state or ServiceState()
    app = web.Application(client_max_size=64 * 1024 * 1024,
                          middlewares=[auth_middleware(),
                                       clusterization_middleware()])
    app["state"] = state
    app["is_chief"] = is_chief()

    r = web.RouteTableDef()
    for register in REGISTRARS:
        register(r, state)
    app.add_routes(r)
    app.on_startup.append(_start_periodic)
    app.on_cleanup.append(_stop_periodic)
    return app


async def _start_periodic(app: web.Application):
    state: ServiceState = app["state"]
    if not app.get("is_chief", True):
        # workers proxy mutating ops; only the chief monitors + schedules
        app["_periodic"] = []
        return

    async def monitor_loop():
        while True:
            await asyncio.sleep(
                min(float(service_config("runs.monitoring_interval")), 5.0))
            await asyncio.get_event_loop().run_in_executor(
                None, state.launcher.monitor_all)

    async def gateway_monitor_loop():
        # dead gateways flip their function status to error
        # (service/deployments.py monitor)
        while True:
            await asyncio.sleep(
                min(float(service_config("runs.monitoring_interval")), 5.0))
            try:
                await asyncio.get_event_loop().run_in_executor(
                    None, state.deployments.monitor)
            except Exception as exc:  # noqa: BLE001 - keep the loop alive
                logger.warning("gateway monitor failed", error=str(exc))

    async def scheduler_loop():
        fired: dict[tuple, str] = {}
        while True:
            await asyncio.sleep(
                float(service_config("scheduler.tick_seconds")))
            now = datetime.now(timezone.utc)
            minute_key = now.strftime("%Y%m%d%H%M")
            for schedule in state.db.list_schedules("*"):
                try:
                    cron = CronSchedule(schedule.get("cron_trigger", ""))
                except ValueError:
                    continue
                key = (schedule.get("project"), schedule.get("name"))
                if cron.matches(now) and fired.get(key) != minute_key:
                    fired[key] = minute_key
                    await _fire_schedule(state, schedule)

    app["_periodic"] = [
        asyncio.create_task(monitor_loop()),
        asyncio.create_task(gateway_monitor_loop()),
        asyncio.create_task(scheduler_loop()),
    ]

    slo_conf = OBSERVABILITY_DEFAULTS["slo"]
    if bool(OBSERVABILITY_DEFAULTS["metrics_enabled"]):
        # scrape→store(→burn-rate) loop over the service's own registry
        # (docs/observability.md "Federation" / "SLOs & burn rates").
        # The store ingestion always runs — it backs the grafana
        # /grafana-proxy/metrics datasource — while SLO evaluation only
        # runs when objectives are declared; fleet processes run their
        # own evaluator next to the autoscaler
        async def obs_loop():
            from ..obs import REGISTRY, MetricsAggregator, SLOEvaluator
            from ..obs.timeseries import get_store

            aggregator = MetricsAggregator.from_mlconf()
            evaluator = None
            if list(slo_conf["objectives"]):
                evaluator = SLOEvaluator.from_mlconf(
                    get_store(), project=run_config("default_project"))
            state.slo_evaluator = evaluator

            def evaluate():
                now = time.time()
                aggregator.ingest_text("service", REGISTRY.render(),
                                       at=now)
                aggregator.snapshot_to(get_store(), now)
                if evaluator is not None:
                    evaluator.process(state.db, now)

            while True:
                await asyncio.sleep(float(slo_conf["evaluation_interval_s"]))
                try:
                    await asyncio.get_event_loop().run_in_executor(
                        None, evaluate)
                except Exception as exc:  # noqa: BLE001 - keep the loop
                    logger.warning("obs ingest/slo evaluation failed",
                                   error=str(exc))

        app["_periodic"].append(asyncio.create_task(obs_loop()))

    if state.projects_follower.enabled:
        async def projects_sync_loop():
            while True:
                await asyncio.get_event_loop().run_in_executor(
                    None, state.projects_follower.sync_safe)
                await asyncio.sleep(
                    float(service_config("projects.sync_interval")))

        app["_periodic"].append(asyncio.create_task(projects_sync_loop()))


async def _fire_schedule(state: ServiceState, schedule: dict):
    """reference analog: scheduler.py:991 submit_run_wrapper."""
    try:
        obj = schedule.get("scheduled_object", {})
        runtime = rebuild_function(obj.get("function", {}))
        task = RunObject.from_dict(obj.get("task", {}))
        task.metadata.uid = generate_uid()
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(
            None, lambda: state.launcher.launch(runtime, task))
        schedule["last_run_uri"] = (
            f"{task.metadata.project}/{task.metadata.uid}")
        state.db.store_schedule(schedule.get("project", ""),
                                schedule.get("name", ""), schedule)
        logger.info("schedule fired", name=schedule.get("name"))
    except Exception as exc:  # noqa: BLE001
        logger.error("schedule firing failed", name=schedule.get("name"),
                     error=str(exc))


async def _stop_periodic(app: web.Application):
    for task in app.get("_periodic", []):
        task.cancel()


def run_app(host: str = "", port: int = 0):
    host = host or service_config("httpdb.host")
    port = port or service_config("httpdb.port")
    # make the advertised port consistent for spawned run resources
    SERVICE_DEFAULTS["httpdb"]["port"] = port
    from ..obs import configure_from_mlconf

    configure_from_mlconf()  # span JSONL path / ring for this service
    logger.info("starting mlrun-tpu service", host=host, port=port,
                version=__version__)
    web.run_app(build_app(), host=host, port=port, print=None)


class ServiceThread:
    """The service on ``host:port`` in a daemon thread with its own event
    loop (``run_app`` blocks the calling thread): for a process that
    serves the API beside other work. ``stop()`` runs the app's cleanup
    (the periodic loops end) and joins the thread."""

    def __init__(self, state: ServiceState | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0):
        import threading

        self.state = state or ServiceState()
        self.host = host
        self.port = port or service_config("httpdb.port")
        self._stop = threading.Event()
        started = threading.Event()
        failed: list = []
        loop = asyncio.new_event_loop()

        async def serve():
            runner = web.AppRunner(build_app(self.state))
            await runner.setup()
            try:
                await web.TCPSite(runner, self.host, self.port).start()
            except OSError as exc:
                failed.append(exc)
                started.set()
                await runner.cleanup()
                return
            started.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.02)
            await runner.cleanup()

        def run():
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(serve())
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not started.wait(timeout):
            raise TimeoutError(f"the service did not start in {timeout}s")
        if failed:
            raise failed[0]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        self._thread.join(timeout=timeout)

