"""Both packages' services for the port's service tests: each package's
aiohttp app (``service/app.build_app``) over its own SQLite run db, run in
a thread on an ephemeral ``127.0.0.1`` port, as the reference's
``tests/conftest.py`` ``service`` fixture runs the reference's. Nothing
leaves localhost.

``PKGS`` holds each package's service modules under one set of names, so
one scenario runs on both: ``app``, ``sqlitedb``, ``httpdb``, ``base``
(``RunDBError``), ``cron``, ``secrets``, ``handlers``
(``service/runtime_handlers``), ``deployments``, ``builder``, ``chaos``,
``obs`` and ``timeseries``.
"""

from __future__ import annotations

import asyncio
import socket
import threading
import types

import mlrun_tpu.chaos as jchaos
import mlrun_tpu.obs as jobs
import mlrun_tpu.obs.timeseries as jtimeseries
import mlrun_tpu_torch.chaos as tchaos
import mlrun_tpu_torch.obs as tobs
import mlrun_tpu_torch.obs.timeseries as ttimeseries
from mlrun_tpu.db import base as jbase
from mlrun_tpu.db import httpdb as jhttpdb
from mlrun_tpu.db import sqlitedb as jsqlitedb
from mlrun_tpu.service import app as japp
from mlrun_tpu.service import builder as jbuilder
from mlrun_tpu.service import cron as jcron
from mlrun_tpu.service import deployments as jdeployments
from mlrun_tpu.service import runtime_handlers as jhandlers
from mlrun_tpu.service import secrets as jsecrets
from mlrun_tpu_torch.db import base as tbase
from mlrun_tpu_torch.db import httpdb as thttpdb
from mlrun_tpu_torch.db import sqlitedb as tsqlitedb
from mlrun_tpu_torch.service import app as tapp
from mlrun_tpu_torch.service import builder as tbuilder
from mlrun_tpu_torch.service import cron as tcron
from mlrun_tpu_torch.service import deployments as tdeployments
from mlrun_tpu_torch.service import runtime_handlers as thandlers
from mlrun_tpu_torch.service import secrets as tsecrets

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", app=japp, sqlitedb=jsqlitedb, httpdb=jhttpdb,
        base=jbase, cron=jcron, secrets=jsecrets, handlers=jhandlers,
        deployments=jdeployments, builder=jbuilder, chaos=jchaos, obs=jobs,
        timeseries=jtimeseries),
    "port": types.SimpleNamespace(
        name="port", app=tapp, sqlitedb=tsqlitedb, httpdb=thttpdb,
        base=tbase, cron=tcron, secrets=tsecrets, handlers=thandlers,
        deployments=tdeployments, builder=tbuilder, chaos=tchaos, obs=tobs,
        timeseries=ttimeseries),
}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def advertise_port(pkg, port: int, monkeypatch):
    """The port a package's service tells its resources to report to
    (``httpdb.port``; the reference's lives in ``mlconf``, which the
    shared conftest reloads before every test)."""
    if pkg.name == "jax":
        from mlrun_tpu.config import mlconf

        mlconf.httpdb.port = port
    else:
        from mlrun_tpu_torch.config import SERVICE_DEFAULTS

        monkeypatch.setitem(SERVICE_DEFAULTS["httpdb"], "port", port)


class Service:
    """One package's service in a thread; ``url``, ``state`` (its
    ``ServiceState``) and ``db`` (its ``HTTPRunDB`` client, connected)."""

    def __init__(self, pkg, tmp_path, monkeypatch, provider=None,
                 state=None, port: int = 0, advertise: bool = True):
        self.pkg = pkg
        self.port = port or free_port()
        if advertise:
            advertise_port(pkg, self.port, monkeypatch)
        if state is None:
            root = tmp_path / f"svc-{pkg.name}"
            root.mkdir(exist_ok=True)
            db = pkg.sqlitedb.SQLiteRunDB(str(root / "svc.sqlite"),
                                          logs_dir=str(root / "logs"))
            state = pkg.app.ServiceState(db=db, provider=provider)
        self.state = state
        self.url = f"http://127.0.0.1:{self.port}"
        self._loop = asyncio.new_event_loop()
        self._stop = threading.Event()
        started = threading.Event()

        async def serve():
            from aiohttp import web

            runner = web.AppRunner(pkg.app.build_app(self.state))
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", self.port).start()
            started.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.02)
            await runner.cleanup()

        def run():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(serve())
            self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        assert started.wait(10), f"the {pkg.name} service did not start"
        self.db = pkg.httpdb.HTTPRunDB(self.url).connect()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
