"""The run db — the port's copy of ``mlrun_tpu/db`` (``get_run_db``,
``set_run_db``, ``RunDBInterface``, ``NopDB``, ``SQLiteRunDB``,
``HTTPRunDB``, ``SQLServerRunDB``).

``get_run_db`` opens a client of the service (``HTTPRunDB``) for an
``http(s)://`` url, a server SQL db for a ``postgresql://`` or
``mysql://`` DSN, ``NopDB`` for ``"nop"``, and otherwise the embedded
SQLite db (the reference's schema, so a file either package writes reads
the same in the other).
"""

from __future__ import annotations

import threading

from ..config import run_config
from .base import (  # noqa: F401
    RunDBError,
    RunDBInterface,
    sql_dialect_for_dsn,
)
from .nopdb import NopDB  # noqa: F401
from .sqlitedb import SQLiteRunDB  # noqa: F401

_run_db = None
_lock = threading.Lock()


def get_run_db(url: str = "", secrets: dict | None = None,
               force_reconnect: bool = False) -> RunDBInterface:
    """Return the process-wide run db: the service's HTTP client when a
    dbpath is configured, otherwise the embedded sqlite db (``url``, or
    the configured ``dbpath``, a ``*.sqlite`` path; else the local file
    under ``MLT_HOME``)."""
    global _run_db
    url = url or run_config("dbpath") or ""
    with _lock:
        if _run_db is not None and not force_reconnect:
            return _run_db
        if url.startswith("http"):
            from .httpdb import HTTPRunDB

            _run_db = HTTPRunDB(url).connect(secrets)
        elif url == "nop":
            _run_db = NopDB()
        elif sql_dialect_for_dsn(url):
            # server-grade shared store for clusterized deployments
            from .sqldb import SQLServerRunDB

            _run_db = SQLServerRunDB(url)
        else:
            _run_db = SQLiteRunDB(url if url.endswith(".sqlite") else "")
        return _run_db


def set_run_db(db: RunDBInterface | None):
    """Install a db instance process-wide (None: the next ``get_run_db``
    opens the configured one)."""
    global _run_db
    with _lock:
        _run_db = db
