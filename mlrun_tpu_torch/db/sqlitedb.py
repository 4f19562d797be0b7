"""Embedded SQLite run db — the port's copy of ``mlrun_tpu/db/sqlitedb.py``.

The same schema, schema version and migrations as the reference, and the
same JSON bodies, so a ``.sqlite`` file either package writes reads the
same in the other: runs, artifacts and their tags, functions and their
versions, projects, schedules, feature sets and vectors, model endpoints,
background tasks, alert configs and events, hub sources, runtime
resources, project secrets, page tokens and datastore profiles.

Logs are files under ``<home>/logs/<project>/<uid>``, or lines in the
native log collector daemon (``utils/log_collector.py``) when
``MLT_LOG_COLLECTOR`` names its socket and the daemon answers.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from typing import Optional

from ..common.runtimes_constants import RunStates
from ..config import home_dir, resolve_local_db_path, run_config
from ..utils.helpers import generate_uid, get_in, now_iso, update_in
from .base import RunDBError, RunDBInterface

_SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
    project TEXT NOT NULL, uid TEXT NOT NULL, iteration INTEGER NOT NULL DEFAULT 0,
    name TEXT, state TEXT, start_time TEXT, last_update TEXT, body TEXT,
    PRIMARY KEY (project, uid, iteration)
);
CREATE TABLE IF NOT EXISTS artifacts (
    project TEXT NOT NULL, key TEXT NOT NULL, uid TEXT NOT NULL,
    tree TEXT, iteration INTEGER DEFAULT 0, tag TEXT, kind TEXT,
    updated TEXT, body TEXT,
    PRIMARY KEY (project, key, uid)
);
CREATE TABLE IF NOT EXISTS functions (
    project TEXT NOT NULL, name TEXT NOT NULL, tag TEXT NOT NULL DEFAULT 'latest',
    hash_key TEXT, updated TEXT, body TEXT,
    PRIMARY KEY (project, name, tag)
);
CREATE TABLE IF NOT EXISTS function_versions (
    project TEXT NOT NULL, name TEXT NOT NULL, hash_key TEXT NOT NULL,
    updated TEXT, body TEXT,
    PRIMARY KEY (project, name, hash_key)
);
CREATE TABLE IF NOT EXISTS projects (
    name TEXT PRIMARY KEY, state TEXT, created TEXT, body TEXT
);
CREATE TABLE IF NOT EXISTS schedules (
    project TEXT NOT NULL, name TEXT NOT NULL, kind TEXT,
    cron TEXT, next_run_time TEXT, body TEXT,
    PRIMARY KEY (project, name)
);
CREATE TABLE IF NOT EXISTS feature_sets (
    project TEXT NOT NULL, name TEXT NOT NULL, tag TEXT NOT NULL DEFAULT 'latest',
    uid TEXT, updated TEXT, body TEXT,
    PRIMARY KEY (project, name, tag)
);
CREATE TABLE IF NOT EXISTS feature_vectors (
    project TEXT NOT NULL, name TEXT NOT NULL, tag TEXT NOT NULL DEFAULT 'latest',
    uid TEXT, updated TEXT, body TEXT,
    PRIMARY KEY (project, name, tag)
);
CREATE TABLE IF NOT EXISTS model_endpoints (
    project TEXT NOT NULL, uid TEXT NOT NULL, model TEXT, function TEXT,
    state TEXT, updated TEXT, body TEXT,
    PRIMARY KEY (project, uid)
);
CREATE TABLE IF NOT EXISTS background_tasks (
    project TEXT NOT NULL DEFAULT '', name TEXT NOT NULL, state TEXT,
    created TEXT, updated TEXT, body TEXT,
    PRIMARY KEY (project, name)
);
CREATE TABLE IF NOT EXISTS alert_configs (
    project TEXT NOT NULL, name TEXT NOT NULL, body TEXT,
    PRIMARY KEY (project, name)
);
CREATE TABLE IF NOT EXISTS events (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    project TEXT, kind TEXT, created TEXT, body TEXT
);
CREATE TABLE IF NOT EXISTS hub_sources (
    name TEXT PRIMARY KEY, idx INTEGER, body TEXT
);
CREATE TABLE IF NOT EXISTS runtime_resources (
    project TEXT NOT NULL, uid TEXT NOT NULL, kind TEXT,
    resource_id TEXT, started REAL, tag TEXT NOT NULL DEFAULT '',
    PRIMARY KEY (project, uid)
);
CREATE TABLE IF NOT EXISTS project_secrets (
    project TEXT NOT NULL, provider TEXT NOT NULL DEFAULT 'kubernetes',
    name TEXT NOT NULL, value TEXT,
    PRIMARY KEY (project, provider, name)
);
CREATE TABLE IF NOT EXISTS pagination_cache (
    token TEXT PRIMARY KEY, method TEXT, filters TEXT,
    next_offset INTEGER, created TEXT
);
CREATE TABLE IF NOT EXISTS datastore_profiles (
    project TEXT NOT NULL, name TEXT NOT NULL, type TEXT, body TEXT,
    PRIMARY KEY (project, name)
);
CREATE TABLE IF NOT EXISTS artifact_tags (
    project TEXT NOT NULL, key TEXT NOT NULL, tag TEXT NOT NULL,
    uid TEXT NOT NULL,
    PRIMARY KEY (project, key, tag)
);
CREATE INDEX IF NOT EXISTS idx_runs_project_state ON runs (project, state);
CREATE INDEX IF NOT EXISTS idx_artifacts_proj_key ON artifacts (project, key);
"""

# Schema versioning via PRAGMA user_version (reference analog: the 29
# Alembic migrations under server/api/migrations/). A fresh DB is created
# at SCHEMA_VERSION; an existing DB replays only the missing migrations in
# order. Version 1 is the round-1 pre-versioning schema (user_version 0
# with a populated sqlite_master).
SCHEMA_VERSION = 8

_MIGRATIONS: dict[int, str] = {
    2: """
CREATE TABLE IF NOT EXISTS runtime_resources (
    project TEXT NOT NULL, uid TEXT NOT NULL, kind TEXT,
    resource_id TEXT, started REAL,
    PRIMARY KEY (project, uid)
);
""",
    3: """
CREATE TABLE IF NOT EXISTS project_secrets (
    project TEXT NOT NULL, provider TEXT NOT NULL DEFAULT 'kubernetes',
    name TEXT NOT NULL, value TEXT,
    PRIMARY KEY (project, provider, name)
);
""",
    4: """
CREATE TABLE IF NOT EXISTS pagination_cache (
    token TEXT PRIMARY KEY, method TEXT, filters TEXT,
    next_offset INTEGER, created TEXT
);
""",
    5: """
CREATE TABLE IF NOT EXISTS datastore_profiles (
    project TEXT NOT NULL, name TEXT NOT NULL, type TEXT, body TEXT,
    PRIMARY KEY (project, name)
);
""",
    6: """
CREATE TABLE IF NOT EXISTS hub_sources (
    name TEXT PRIMARY KEY, idx INTEGER NOT NULL DEFAULT 0, body TEXT
);
""",
    7: """
CREATE TABLE IF NOT EXISTS artifact_tags (
    project TEXT NOT NULL, key TEXT NOT NULL, tag TEXT NOT NULL,
    uid TEXT NOT NULL,
    PRIMARY KEY (project, key, tag)
);
""",
    8: """
ALTER TABLE runtime_resources ADD COLUMN tag TEXT NOT NULL DEFAULT '';
""",
}


def _labels_match(body: dict, labels) -> bool:
    if not labels:
        return True
    have = get_in(body, "metadata.labels", {}) or {}
    items = labels.items() if isinstance(labels, dict) else [
        tuple(lbl.split("=", 1)) if "=" in lbl else (lbl, None) for lbl in labels
    ]
    for key, value in items:
        if key not in have:
            return False
        if value is not None and str(have[key]) != str(value):
            return False
    return True


class SQLiteRunDB(RunDBInterface):
    kind = "sqlite"

    def __init__(self, dsn: str = "", logs_dir: str = ""):
        self.dsn = dsn or resolve_local_db_path()
        self.logs_dir = logs_dir or os.path.join(home_dir(), "logs")
        self._local = threading.local()
        self._log_collector = None
        self._log_collector_checked = False
        self._init_schema()

    def _get_log_collector(self):
        """Native mlt-logd client when MLT_LOG_COLLECTOR is configured
        (falls back to direct file IO)."""
        if not self._log_collector_checked:
            self._log_collector_checked = True
            if os.environ.get("MLT_LOG_COLLECTOR"):
                from ..utils.log_collector import LogCollectorClient

                client = LogCollectorClient()
                if client.ping():
                    self._log_collector = client
        return self._log_collector

    # -- plumbing ----------------------------------------------------------
    @property
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.dsn, timeout=30)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            self._local.conn = conn
        return conn

    def _init_schema(self):
        conn = self._conn
        version = conn.execute("PRAGMA user_version").fetchone()[0]
        if version == 0:
            populated = conn.execute(
                "SELECT name FROM sqlite_master "
                "WHERE type='table' AND name='runs'").fetchone()
            if populated:
                version = 1  # pre-versioning (round-1) deployment
            else:
                conn.executescript(_SCHEMA)
                conn.execute(f"PRAGMA user_version={SCHEMA_VERSION}")
                conn.commit()
                return
        if version > SCHEMA_VERSION:
            raise RunDBError(
                f"database schema version {version} is newer than this "
                f"build supports ({SCHEMA_VERSION})")
        for target in range(version + 1, SCHEMA_VERSION + 1):
            conn.executescript(_MIGRATIONS[target])
            conn.execute(f"PRAGMA user_version={target}")
            conn.commit()

    @property
    def schema_version(self) -> int:
        return self._conn.execute("PRAGMA user_version").fetchone()[0]

    def _execute(self, sql: str, params: tuple = ()):
        cur = self._conn.execute(sql, params)
        self._conn.commit()
        return cur

    def _query(self, sql: str, params: tuple = ()) -> list[sqlite3.Row]:
        return self._conn.execute(sql, params).fetchall()

    @staticmethod
    def _project_or_default(project: str) -> str:
        return project or run_config("default_project")

    # -- runs --------------------------------------------------------------
    def store_run(self, struct: dict, uid: str, project: str = "", iter: int = 0):
        project = self._project_or_default(project)
        self._execute(
            "INSERT OR REPLACE INTO runs "
            "(project, uid, iteration, name, state, start_time, last_update, body) "
            "VALUES (?,?,?,?,?,?,?,?)",
            (
                project, uid, iter,
                get_in(struct, "metadata.name", ""),
                get_in(struct, "status.state", RunStates.created),
                get_in(struct, "status.start_time", now_iso()),
                now_iso(), json.dumps(struct, default=str),
            ),
        )

    def update_run(self, updates: dict, uid: str, project: str = "", iter: int = 0):
        project = self._project_or_default(project)
        run = self.read_run(uid, project, iter)
        if run is None:
            raise RunDBError(f"run {project}/{uid} not found")
        for key, value in updates.items():
            update_in(run, key, value)
        update_in(run, "status.last_update", now_iso())
        self.store_run(run, uid, project, iter)
        return run

    def read_run(self, uid: str, project: str = "", iter: int = 0) -> Optional[dict]:
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT body FROM runs WHERE project=? AND uid=? AND iteration=?",
            (project, uid, iter),
        )
        if not rows:
            return None
        return json.loads(rows[0]["body"])

    def list_runs(self, name="", uid=None, project="", labels=None, state="",
                  sort=True, last=0, iter=False, start_time_from=None,
                  start_time_to=None) -> list:
        project = self._project_or_default(project)
        sql = "SELECT body FROM runs WHERE project=?"
        params: list = [project]
        if name:
            sql += " AND name LIKE ?"
            params.append(f"%{name}%")
        if uid:
            uids = uid if isinstance(uid, (list, tuple)) else [uid]
            sql += f" AND uid IN ({','.join('?' * len(uids))})"
            params.extend(uids)
        if state:
            sql += " AND state=?"
            params.append(state)
        if not iter:
            sql += " AND iteration=0"
        if start_time_from:
            sql += " AND start_time>=?"
            params.append(str(start_time_from))
        if start_time_to:
            sql += " AND start_time<=?"
            params.append(str(start_time_to))
        if sort:
            sql += " ORDER BY start_time DESC"
        if last:
            sql += f" LIMIT {int(last)}"
        rows = self._query(sql, tuple(params))
        out = [json.loads(r["body"]) for r in rows]
        return [r for r in out if _labels_match(r, labels)]

    def del_run(self, uid: str, project: str = "", iter: int = 0):
        project = self._project_or_default(project)
        self._execute("DELETE FROM runs WHERE project=? AND uid=? AND iteration=?",
                      (project, uid, iter))

    def del_runs(self, name="", project="", labels=None, state="", days_ago=0):
        for run in self.list_runs(name=name, project=project, labels=labels,
                                  state=state, iter=True):
            self.del_run(get_in(run, "metadata.uid"), project,
                         get_in(run, "metadata.iteration", 0))

    # -- token pagination (reference analog: pagination_cache in
    # server/api/db/sqldb/models.py + paginated list calls in
    # mlrun/db/httpdb.py:304). A token is an opaque handle to a cached
    # (method, filters, position); the same token advances in place on
    # each page and is dropped when the listing is exhausted. ---------------
    _PAGE_TOKEN_TTL_SECONDS = 3600

    def paginated_list(self, method: str, page_size: int = 20,
                       page_token: str = "", **filters
                       ) -> tuple[list, Optional[str]]:
        """Page through any list_* method with an opaque token. Returns
        (items, next_token); next_token is None on the last page.

        Positioning is offset-based over a re-executed query (the filters
        travel with the token), matching the reference's pagination-cache
        semantics: rows inserted/deleted mid-walk can shift later pages.
        """
        import secrets as pysecrets
        from datetime import datetime, timedelta, timezone

        page_size = max(1, int(page_size))
        now = datetime.now(timezone.utc)
        self._execute(
            "DELETE FROM pagination_cache WHERE created < ?",
            ((now - timedelta(
                seconds=self._PAGE_TOKEN_TTL_SECONDS)).isoformat(),))
        if page_token:
            rows = self._query(
                "SELECT method, filters, next_offset FROM pagination_cache "
                "WHERE token=?", (page_token,))
            if not rows:
                raise RunDBError(f"invalid or expired page token "
                                 f"'{page_token}'")
            if rows[0]["method"] != method:
                raise RunDBError(
                    f"page token was issued for {rows[0]['method']!r}, "
                    f"not {method!r}")
            filters = json.loads(rows[0]["filters"])
            offset = int(rows[0]["next_offset"])
        else:
            offset = 0
        if not method.startswith("list_") or not hasattr(self, method):
            raise RunDBError(f"unknown list method '{method}'")
        items = getattr(self, method)(**filters)
        page = items[offset:offset + page_size]
        next_offset = offset + page_size
        if next_offset >= len(items):
            if page_token:
                self._execute("DELETE FROM pagination_cache WHERE token=?",
                              (page_token,))
            return page, None
        token = page_token or pysecrets.token_urlsafe(16)
        self._execute(
            "INSERT OR REPLACE INTO pagination_cache "
            "(token, method, filters, next_offset, created) "
            "VALUES (?,?,?,?,?)",
            (token, method, json.dumps(filters), next_offset,
             now.isoformat()))
        return page, token

    # -- runtime resources (durable handler state; reference recovers by
    # listing cluster resources per label selector, base.py:65 — here the
    # mapping survives service restarts in the DB and is reconciled against
    # the provider on startup) ---------------------------------------------
    def store_runtime_resource(self, uid: str, project: str, kind: str,
                               resource_id: str, started: float,
                               tag: str = ""):
        project = self._project_or_default(project)
        self._execute(
            "INSERT OR REPLACE INTO runtime_resources "
            "(project, uid, kind, resource_id, started, tag) "
            "VALUES (?,?,?,?,?,?)",
            (project, uid, kind, resource_id, started, tag or ""))

    def list_runtime_resources(self, kind: str = "") -> list[dict]:
        sql = ("SELECT project, uid, kind, resource_id, started, tag "
               "FROM runtime_resources")
        params: tuple = ()
        if kind:
            sql += " WHERE kind=?"
            params = (kind,)
        return [dict(row) for row in self._query(sql, params)]

    def del_runtime_resource(self, uid: str, project: str = ""):
        project = self._project_or_default(project)
        self._execute(
            "DELETE FROM runtime_resources WHERE project=? AND uid=?",
            (project, uid))

    # -- project secrets (reference: mlrun/db/httpdb.py:3034-3232 client +
    # k8s-secret store server-side; here a DB-backed store whose VALUES are
    # only readable server-side — the HTTP surface exposes keys alone) -----
    def store_project_secrets(self, project: str, secrets: dict,
                              provider: str = "kubernetes"):
        project = self._project_or_default(project)
        for name, value in (secrets or {}).items():
            self._execute(
                "INSERT OR REPLACE INTO project_secrets "
                "(project, provider, name, value) VALUES (?,?,?,?)",
                (project, provider, name, str(value)))

    def list_project_secret_keys(self, project: str,
                                 provider: str = "kubernetes") -> list[str]:
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT name FROM project_secrets WHERE project=? AND provider=? "
            "ORDER BY name", (project, provider))
        return [row["name"] for row in rows]

    def get_project_secrets(self, project: str, keys: list | None = None,
                            provider: str = "kubernetes") -> dict:
        """Server-side only: returns secret VALUES (never exposed over the
        REST list surface)."""
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT name, value FROM project_secrets "
            "WHERE project=? AND provider=?", (project, provider))
        out = {row["name"]: row["value"] for row in rows}
        if keys is not None:
            out = {k: v for k, v in out.items() if k in keys}
        return out

    def delete_project_secrets(self, project: str, keys: list | None = None,
                               provider: str = "kubernetes"):
        project = self._project_or_default(project)
        if keys is None:
            self._execute(
                "DELETE FROM project_secrets WHERE project=? AND provider=?",
                (project, provider))
            return
        for key in keys:
            self._execute(
                "DELETE FROM project_secrets "
                "WHERE project=? AND provider=? AND name=?",
                (project, provider, key))

    # -- datastore profiles (reference datastore_profile.py server side:
    # public part in the DB, private part in project secrets) --------------
    # -- hub sources (reference analog: server/api/api/endpoints/hub.py
    # source CRUD + catalog; backed here by the hub_sources table) ----------
    def store_hub_source(self, name: str, source: dict, order: int = -1):
        if order < 0:
            existing = self._query(
                "SELECT idx FROM hub_sources WHERE name=?", (name,))
            if existing:
                # update in place keeps the source's position
                order = int(existing[0]["idx"])
            else:
                row = self._query(
                    "SELECT COALESCE(MAX(idx), -1) AS m FROM hub_sources")
                order = int(row[0]["m"]) + 1
        source = dict(source, name=name)
        self._execute(
            "INSERT OR REPLACE INTO hub_sources (name, idx, body) "
            "VALUES (?,?,?)", (name, order, json.dumps(source)))

    def get_hub_source(self, name: str) -> Optional[dict]:
        rows = self._query("SELECT body FROM hub_sources WHERE name=?",
                           (name,))
        return json.loads(rows[0]["body"]) if rows else None

    def list_hub_sources(self) -> list[dict]:
        rows = self._query("SELECT body FROM hub_sources ORDER BY idx")
        return [json.loads(row["body"]) for row in rows]

    def delete_hub_source(self, name: str):
        self._execute("DELETE FROM hub_sources WHERE name=?", (name,))

    # -- tags (reference analog: server/api/api/endpoints/tags.py —
    # overwrite/append/delete a tag on a set of artifact identifiers) ------
    def tag_artifacts(self, project: str, tag: str,
                      identifiers: list[dict]) -> int:
        """Apply ``tag`` to each identified artifact version (key + uid).
        Tags are ADDITIVE through the artifact_tags side table: one uid
        per (project, key) holds a given tag, but tagging never disturbs
        other tags — in particular the 'latest' pointer managed by
        store_artifact. Returns how many versions were tagged."""
        project = self._project_or_default(project)
        tagged = 0
        for ident in identifiers:
            key, uid = ident.get("key"), ident.get("uid")
            if not key:
                continue
            rows = self._query(
                "SELECT uid FROM artifacts WHERE project=? AND key=? "
                + ("AND uid=?" if uid else
                   "ORDER BY updated DESC LIMIT 1"),
                (project, key, uid) if uid else (project, key))
            if not rows:
                continue
            self._execute(
                "INSERT OR REPLACE INTO artifact_tags "
                "(project, key, tag, uid) VALUES (?,?,?,?)",
                (project, key, tag, rows[0]["uid"]))
            tagged += 1
        return tagged

    def _clear_artifact_tag(self, project: str, key: str, tag: str):
        """Clear ``tag`` from every holder, keeping body metadata.tag in
        sync with the tag column (a stale body would claim a tag the row
        no longer owns)."""
        rows = self._query(
            "SELECT uid, body FROM artifacts WHERE project=? AND key=? "
            "AND tag=?", (project, key, tag))
        for row in rows:
            body = json.loads(row["body"])
            update_in(body, "metadata.tag", "")
            self._execute(
                "UPDATE artifacts SET tag='', body=? WHERE project=? "
                "AND key=? AND uid=?",
                (json.dumps(body), project, key, row["uid"]))

    def untag_artifacts(self, project: str, tag: str,
                        identifiers: list[dict]) -> int:
        """Remove ``tag`` from the identified artifacts: side-table rows
        AND a matching column tag (set by store_artifact) are both
        cleared, with body metadata kept in sync."""
        project = self._project_or_default(project)
        removed = 0
        for ident in identifiers:
            key = ident.get("key")
            uid = ident.get("uid")
            if not key:
                continue
            where = "project=? AND key=? AND tag=?"
            args = [project, key, tag]
            if uid:
                where += " AND uid=?"
                args.append(uid)
            cursor = self._execute(
                f"DELETE FROM artifact_tags WHERE {where}", tuple(args))
            removed += cursor.rowcount if cursor is not None else 0
            rows = self._query(
                f"SELECT uid, body FROM artifacts WHERE {where}",
                tuple(args))
            for row in rows:
                body = json.loads(row["body"])
                update_in(body, "metadata.tag", "")
                self._execute(
                    "UPDATE artifacts SET tag='', body=? WHERE project=? "
                    "AND key=? AND uid=?",
                    (json.dumps(body), project, key, row["uid"]))
            removed += len(rows)
        return removed

    def store_datastore_profile(self, profile: dict, project: str = "",
                                private: dict | None = None):
        project = self._project_or_default(project)
        name = profile["name"]
        self._execute(
            "INSERT OR REPLACE INTO datastore_profiles "
            "(project, name, type, body) VALUES (?,?,?,?)",
            (project, name, profile.get("type", "basic"),
             json.dumps(profile)))
        from ..datastore.profiles import PROFILE_SECRET_PREFIX

        if private:
            self.store_project_secrets(
                project, {PROFILE_SECRET_PREFIX + name:
                          json.dumps(private)})
        else:
            # a re-store without a private part is a credential
            # rotation/clear — never leave stale secrets behind
            self.delete_project_secrets(
                project, keys=[PROFILE_SECRET_PREFIX + name])

    def get_datastore_profile(self, name: str, project: str = ""
                              ) -> Optional[dict]:
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT body FROM datastore_profiles WHERE project=? AND name=?",
            (project, name))
        return json.loads(rows[0]["body"]) if rows else None

    def list_datastore_profiles(self, project: str = "") -> list[dict]:
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT body FROM datastore_profiles WHERE project=? "
            "ORDER BY name", (project,))
        return [json.loads(row["body"]) for row in rows]

    def delete_datastore_profile(self, name: str, project: str = ""):
        project = self._project_or_default(project)
        self._execute(
            "DELETE FROM datastore_profiles WHERE project=? AND name=?",
            (project, name))
        from ..datastore.profiles import PROFILE_SECRET_PREFIX

        self.delete_project_secrets(project,
                                    keys=[PROFILE_SECRET_PREFIX + name])

    # -- logs --------------------------------------------------------------
    def _log_path(self, project: str, uid: str) -> str:
        path = os.path.join(self.logs_dir, self._project_or_default(project), uid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def store_log(self, uid: str, project: str = "", body: bytes = b"",
                  append: bool = True):
        if isinstance(body, str):
            body = body.encode()
        collector = self._get_log_collector()
        if collector is not None and append:
            try:
                collector.append(self._project_or_default(project), uid, body)
                return
            except (OSError, RuntimeError):
                self._log_collector = None
        mode = "ab" if append else "wb"
        with open(self._log_path(project, uid), mode) as fp:
            fp.write(body)

    def get_log(self, uid: str, project: str = "", offset: int = 0,
                size: int = -1) -> tuple[str, bytes]:
        run = self.read_run(uid, project)
        state = get_in(run or {}, "status.state", RunStates.unknown)
        collector = self._get_log_collector()
        if collector is not None:
            try:
                return state, collector.get_log(
                    self._project_or_default(project), uid, offset, size)
            except (OSError, RuntimeError):
                self._log_collector = None
        path = self._log_path(project, uid)
        if not os.path.isfile(path):
            return state, b""
        with open(path, "rb") as fp:
            fp.seek(offset)
            data = fp.read(size if size > 0 else -1)
        return state, data

    def get_log_size(self, uid: str, project: str = "") -> int:
        collector = self._get_log_collector()
        if collector is not None:
            try:
                return collector.get_log_size(
                    self._project_or_default(project), uid)
            except (OSError, RuntimeError):
                self._log_collector = None
        path = self._log_path(project, uid)
        return os.path.getsize(path) if os.path.isfile(path) else 0

    # -- artifacts ---------------------------------------------------------
    def store_artifact(self, key, artifact: dict, uid=None, iter=None, tag="",
                       project="", tree=None):
        project = self._project_or_default(project)
        uid = uid or get_in(artifact, "metadata.uid") or generate_uid()
        tag = tag or get_in(artifact, "metadata.tag") or "latest"
        update_in(artifact, "metadata.tag", tag)
        update_in(artifact, "metadata.uid", uid)
        update_in(artifact, "metadata.project", project)
        # only one uid per (project,key) may own a tag (bodies of prior
        # holders are re-synced so they stop claiming the tag); a fresh
        # store also supersedes any side-table assignment of the same tag
        self._clear_artifact_tag(project, key, tag)
        self._execute(
            "DELETE FROM artifact_tags WHERE project=? AND key=? AND tag=?",
            (project, key, tag))
        self._execute(
            "INSERT OR REPLACE INTO artifacts "
            "(project, key, uid, tree, iteration, tag, kind, updated, body) "
            "VALUES (?,?,?,?,?,?,?,?,?)",
            (
                project, key, uid, tree or get_in(artifact, "metadata.tree"),
                iter or get_in(artifact, "metadata.iter", 0), tag,
                artifact.get("kind", "artifact"), now_iso(),
                json.dumps(artifact, default=str),
            ),
        )

    def read_artifact(self, key, tag=None, iter=None, project="", tree=None,
                      uid=None) -> Optional[dict]:
        project = self._project_or_default(project)
        sql = "SELECT body FROM artifacts WHERE project=? AND key=?"
        params: list = [project, key]
        if iter is not None and not uid:
            # iteration addressing applies in EVERY resolution mode
            # (store://...#iter without @tree must not fall through to
            # whichever iteration last claimed the tag)
            sql += " AND iteration=?"
            params.append(iter)
        if uid:
            sql += " AND uid=?"
            params.append(uid)
        elif tree:
            sql += " AND tree=?"
            params.append(tree)
        elif iter is not None:
            # iteration addressing (store://...#N): the newest producer's
            # iteration N. The iteration WINS over any tag part — hyper-run
            # children don't carry the parent's tag, and the tag side-table
            # maps a tag to ONE uid, which can't coexist with an explicit
            # iteration filter
            pass
        else:
            wanted = tag or "latest"
            side = self._query(
                "SELECT uid FROM artifact_tags WHERE project=? AND key=? "
                "AND tag=?", (project, key, wanted))
            side_uid = side[0]["uid"] if side else None
            if side_uid:
                stale = not self._query(
                    "SELECT 1 FROM artifacts WHERE project=? AND key=? "
                    "AND uid=?", (project, key, side_uid))
                if stale:
                    # the tagged version was deleted — drop the stale row
                    # and resolve through the tag column instead
                    self._execute(
                        "DELETE FROM artifact_tags WHERE project=? AND "
                        "key=? AND tag=?", (project, key, wanted))
                    side_uid = None
            if side_uid:
                sql += " AND uid=?"
                params.append(side_uid)
            else:
                sql += " AND tag=?"
                params.append(wanted)
        sql += " ORDER BY updated DESC LIMIT 1"
        rows = self._query(sql, tuple(params))
        if not rows:
            raise RunDBError(f"artifact {project}/{key} (tag={tag}) not found")
        body = json.loads(rows[0]["body"])
        if tag:
            # a side-table tag is a view: report the tag it was read by
            update_in(body, "metadata.tag", tag)
        return body

    def list_artifacts(self, name="", project="", tag=None, labels=None,
                       since=None, until=None, kind=None, category=None,
                       tree=None) -> list:
        project = self._project_or_default(project)
        sql = "SELECT body FROM artifacts WHERE project=?"
        params: list = [project]
        if name:
            sql += " AND key LIKE ?"
            params.append(f"%{name}%")
        if tag and tag != "*":
            sql += (" AND (tag=? OR uid IN (SELECT uid FROM artifact_tags "
                    "WHERE project=? AND key=artifacts.key AND tag=?))")
            params.extend([tag, project, tag])
        if kind:
            sql += " AND kind=?"
            params.append(kind)
        if tree:
            sql += " AND tree=?"
            params.append(tree)
        sql += " ORDER BY updated DESC"
        rows = self._query(sql, tuple(params))
        out = [json.loads(r["body"]) for r in rows]
        return [a for a in out if _labels_match(a, labels)]

    def del_artifact(self, key, tag=None, project="", uid=None):
        project = self._project_or_default(project)
        sql = "DELETE FROM artifacts WHERE project=? AND key=?"
        params: list = [project, key]
        if uid:
            sql += " AND uid=?"
            params.append(uid)
        elif tag:
            sql += " AND tag=?"
            params.append(tag)
        self._execute(sql, tuple(params))
        # side-table rows must not outlive their versions
        if uid:
            self._execute(
                "DELETE FROM artifact_tags WHERE project=? AND key=? "
                "AND uid=?", (project, key, uid))
        elif tag:
            self._execute(
                "DELETE FROM artifact_tags WHERE project=? AND key=? "
                "AND tag=?", (project, key, tag))
        else:
            self._execute(
                "DELETE FROM artifact_tags WHERE project=? AND key=?",
                (project, key))

    # -- functions ---------------------------------------------------------
    def store_function(self, function: dict, name, project="", tag="",
                       versioned=False) -> str:
        import hashlib

        project = self._project_or_default(project)
        tag = tag or get_in(function, "metadata.tag") or "latest"
        body = json.dumps(function, default=str)
        hash_key = hashlib.sha1(body.encode()).hexdigest()
        update_in(function, "metadata.hash", hash_key)
        update_in(function, "metadata.project", project)
        body = json.dumps(function, default=str)
        self._execute(
            "INSERT OR REPLACE INTO functions "
            "(project, name, tag, hash_key, updated, body) VALUES (?,?,?,?,?,?)",
            (project, name, tag, hash_key, now_iso(), body),
        )
        if versioned:
            self._execute(
                "INSERT OR REPLACE INTO function_versions "
                "(project, name, hash_key, updated, body) VALUES (?,?,?,?,?)",
                (project, name, hash_key, now_iso(), body),
            )
        return hash_key

    def get_function(self, name, project="", tag="", hash_key="") -> dict:
        project = self._project_or_default(project)
        if hash_key:
            rows = self._query(
                "SELECT body FROM function_versions WHERE project=? AND name=? "
                "AND hash_key=?", (project, name, hash_key))
        else:
            rows = self._query(
                "SELECT body FROM functions WHERE project=? AND name=? AND tag=?",
                (project, name, tag or "latest"))
        if not rows:
            raise RunDBError(f"function {project}/{name}:{tag or hash_key} not found")
        return json.loads(rows[0]["body"])

    def list_functions(self, name="", project="", tag="", labels=None) -> list:
        project = self._project_or_default(project)
        sql = "SELECT body FROM functions WHERE project=?"
        params: list = [project]
        if name:
            sql += " AND name LIKE ?"
            params.append(f"%{name}%")
        if tag:
            sql += " AND tag=?"
            params.append(tag)
        rows = self._query(sql, tuple(params))
        out = [json.loads(r["body"]) for r in rows]
        return [f for f in out if _labels_match(f, labels)]

    def delete_function(self, name, project=""):
        project = self._project_or_default(project)
        self._execute("DELETE FROM functions WHERE project=? AND name=?",
                      (project, name))
        self._execute("DELETE FROM function_versions WHERE project=? AND name=?",
                      (project, name))

    # -- projects ----------------------------------------------------------
    def store_project(self, name: str, project: dict) -> dict:
        update_in(project, "metadata.name", name)
        state = get_in(project, "status.state", "online")
        created = get_in(project, "metadata.created", now_iso())
        update_in(project, "metadata.created", created)
        self._execute(
            "INSERT OR REPLACE INTO projects (name, state, created, body) "
            "VALUES (?,?,?,?)",
            (name, state, created, json.dumps(project, default=str)),
        )
        return project

    def get_project(self, name: str) -> Optional[dict]:
        rows = self._query("SELECT body FROM projects WHERE name=?", (name,))
        return json.loads(rows[0]["body"]) if rows else None

    def list_projects(self, owner=None, labels=None, state=None) -> list:
        sql = "SELECT body FROM projects"
        params: tuple = ()
        if state:
            sql += " WHERE state=?"
            params = (state,)
        rows = self._query(sql, params)
        out = [json.loads(r["body"]) for r in rows]
        return [p for p in out if _labels_match(p, labels)]

    def delete_project(self, name: str, deletion_strategy: str = "restricted"):
        if deletion_strategy == "restricted":
            runs = self._query(
                "SELECT COUNT(*) AS c FROM runs WHERE project=?", (name,))
            if runs[0]["c"]:
                raise RunDBError(
                    f"project {name} has runs; use deletion_strategy='cascade'")
        for table in ("runs", "artifacts", "functions", "function_versions",
                      "schedules", "feature_sets", "feature_vectors",
                      "model_endpoints", "alert_configs"):
            self._execute(f"DELETE FROM {table} WHERE project=?", (name,))
        self._execute("DELETE FROM projects WHERE name=?", (name,))

    # -- schedules ---------------------------------------------------------
    def store_schedule(self, project: str, name: str, schedule: dict):
        project = self._project_or_default(project)
        self._execute(
            "INSERT OR REPLACE INTO schedules "
            "(project, name, kind, cron, next_run_time, body) VALUES (?,?,?,?,?,?)",
            (project, name, schedule.get("kind", "job"),
             schedule.get("cron_trigger", ""), schedule.get("next_run_time"),
             json.dumps(schedule, default=str)),
        )

    def get_schedule(self, project: str, name: str) -> Optional[dict]:
        rows = self._query(
            "SELECT body FROM schedules WHERE project=? AND name=?",
            (self._project_or_default(project), name))
        if not rows:
            raise RunDBError(f"schedule {project}/{name} not found")
        return json.loads(rows[0]["body"])

    def list_schedules(self, project: str = "") -> list:
        if project and project != "*":
            rows = self._query("SELECT body FROM schedules WHERE project=?",
                               (self._project_or_default(project),))
        else:
            rows = self._query("SELECT body FROM schedules")
        return [json.loads(r["body"]) for r in rows]

    def delete_schedule(self, project: str, name: str):
        self._execute("DELETE FROM schedules WHERE project=? AND name=?",
                      (self._project_or_default(project), name))

    # -- feature store ------------------------------------------------------
    def _store_versioned(self, table: str, obj: dict, name, project, tag, uid):
        project = self._project_or_default(project)
        name = name or get_in(obj, "metadata.name")
        tag = tag or get_in(obj, "metadata.tag") or "latest"
        uid = uid or get_in(obj, "metadata.uid") or generate_uid()
        update_in(obj, "metadata.uid", uid)
        update_in(obj, "metadata.project", project)
        self._execute(
            f"INSERT OR REPLACE INTO {table} "
            "(project, name, tag, uid, updated, body) VALUES (?,?,?,?,?,?)",
            (project, name, tag, uid, now_iso(), json.dumps(obj, default=str)),
        )
        return uid

    def _get_versioned(self, table: str, name, project, tag, uid):
        project = self._project_or_default(project)
        if uid:
            rows = self._query(
                f"SELECT body FROM {table} WHERE project=? AND name=? AND uid=?",
                (project, name, uid))
        else:
            rows = self._query(
                f"SELECT body FROM {table} WHERE project=? AND name=? AND tag=?",
                (project, name, tag or "latest"))
        if not rows:
            raise RunDBError(f"{table} {project}/{name} not found")
        return json.loads(rows[0]["body"])

    def _list_versioned(self, table: str, project, name, tag, labels):
        project = self._project_or_default(project)
        sql = f"SELECT body FROM {table} WHERE project=?"
        params: list = [project]
        if name:
            sql += " AND name LIKE ?"
            params.append(f"%{name}%")
        if tag:
            sql += " AND tag=?"
            params.append(tag)
        rows = self._query(sql, tuple(params))
        out = [json.loads(r["body"]) for r in rows]
        return [o for o in out if _labels_match(o, labels)]

    def store_feature_set(self, feature_set, name=None, project="", tag=None,
                          uid=None, versioned=True):
        return self._store_versioned("feature_sets", feature_set, name, project,
                                     tag, uid)

    def get_feature_set(self, name, project="", tag=None, uid=None):
        return self._get_versioned("feature_sets", name, project, tag, uid)

    def list_feature_sets(self, project="", name="", tag=None, labels=None):
        return self._list_versioned("feature_sets", project, name, tag, labels)

    def delete_feature_set(self, name, project="", tag=None, uid=None):
        self._execute("DELETE FROM feature_sets WHERE project=? AND name=?",
                      (self._project_or_default(project), name))

    def store_feature_vector(self, feature_vector, name=None, project="",
                             tag=None, uid=None, versioned=True):
        return self._store_versioned("feature_vectors", feature_vector, name,
                                     project, tag, uid)

    def get_feature_vector(self, name, project="", tag=None, uid=None):
        return self._get_versioned("feature_vectors", name, project, tag, uid)

    def list_feature_vectors(self, project="", name="", tag=None, labels=None):
        return self._list_versioned("feature_vectors", project, name, tag, labels)

    def delete_feature_vector(self, name, project="", tag=None, uid=None):
        self._execute("DELETE FROM feature_vectors WHERE project=? AND name=?",
                      (self._project_or_default(project), name))

    # -- model endpoints ----------------------------------------------------
    def store_model_endpoint(self, project, endpoint_id, endpoint: dict):
        project = self._project_or_default(project)
        self._execute(
            "INSERT OR REPLACE INTO model_endpoints "
            "(project, uid, model, function, state, updated, body) "
            "VALUES (?,?,?,?,?,?,?)",
            (project, endpoint_id, endpoint.get("model_uri", ""),
             endpoint.get("function_uri", ""), endpoint.get("state", "ready"),
             now_iso(), json.dumps(endpoint, default=str)),
        )

    def get_model_endpoint(self, project, endpoint_id) -> dict:
        rows = self._query(
            "SELECT body FROM model_endpoints WHERE project=? AND uid=?",
            (self._project_or_default(project), endpoint_id))
        if not rows:
            raise RunDBError(f"model endpoint {endpoint_id} not found")
        return json.loads(rows[0]["body"])

    def list_model_endpoints(self, project="", model="", function="",
                             state="") -> list:
        project = self._project_or_default(project)
        sql = "SELECT body FROM model_endpoints WHERE project=?"
        params: list = [project]
        if model:
            sql += " AND model LIKE ?"
            params.append(f"%{model}%")
        if function:
            sql += " AND function LIKE ?"
            params.append(f"%{function}%")
        if state:
            sql += " AND state=?"
            params.append(state)
        rows = self._query(sql, tuple(params))
        return [json.loads(r["body"]) for r in rows]

    def delete_model_endpoint(self, project, endpoint_id):
        self._execute("DELETE FROM model_endpoints WHERE project=? AND uid=?",
                      (self._project_or_default(project), endpoint_id))

    # -- background tasks ---------------------------------------------------
    def store_background_task(self, name: str, state: str, project: str = "",
                              body: dict | None = None):
        self._execute(
            "INSERT OR REPLACE INTO background_tasks "
            "(project, name, state, created, updated, body) VALUES (?,?,?,?,?,?)",
            (project, name, state, now_iso(), now_iso(),
             json.dumps(body or {}, default=str)),
        )

    def list_background_tasks(self, project: str = "") -> list[dict]:
        project = self._project_or_default(project)
        rows = self._query(
            "SELECT name, state, body FROM background_tasks WHERE project=? "
            "ORDER BY name", (project,))
        out = []
        for row in rows:
            body = json.loads(row["body"]) if row["body"] else {}
            body.update({"name": row["name"], "state": row["state"]})
            out.append(body)
        return out

    def get_background_task(self, name: str, project: str = "") -> Optional[dict]:
        rows = self._query(
            "SELECT state, body FROM background_tasks WHERE project=? AND name=?",
            (project, name))
        if not rows:
            return None
        out = json.loads(rows[0]["body"])
        out["state"] = rows[0]["state"]
        out["name"] = name
        return out

    # -- alerts / events ----------------------------------------------------
    def store_alert_config(self, name, config: dict, project=""):
        self._execute(
            "INSERT OR REPLACE INTO alert_configs (project, name, body) "
            "VALUES (?,?,?)",
            (self._project_or_default(project), name,
             json.dumps(config, default=str)),
        )

    def get_alert_config(self, name, project="") -> dict:
        rows = self._query(
            "SELECT body FROM alert_configs WHERE project=? AND name=?",
            (self._project_or_default(project), name))
        if not rows:
            raise RunDBError(f"alert config {name} not found")
        return json.loads(rows[0]["body"])

    def list_alert_configs(self, project="") -> list:
        rows = self._query("SELECT body FROM alert_configs WHERE project=?",
                           (self._project_or_default(project),))
        return [json.loads(r["body"]) for r in rows]

    def delete_alert_config(self, name, project=""):
        self._execute("DELETE FROM alert_configs WHERE project=? AND name=?",
                      (self._project_or_default(project), name))

    def emit_event(self, kind: str, event: dict, project: str = ""):
        self._execute(
            "INSERT INTO events (project, kind, created, body) VALUES (?,?,?,?)",
            (self._project_or_default(project), kind, now_iso(),
             json.dumps(event, default=str)),
        )

    def list_events(self, project: str = "", kind: str = "", since=None) -> list:
        sql = "SELECT kind, created, body FROM events WHERE project=?"
        params: list = [self._project_or_default(project)]
        if kind:
            sql += " AND kind=?"
            params.append(kind)
        if since:
            sql += " AND created>=?"
            params.append(str(since))
        rows = self._query(sql + " ORDER BY id", tuple(params))
        return [
            {"kind": r["kind"], "created": r["created"], **json.loads(r["body"])}
            for r in rows
        ]

    # -- submit (local mode: run in-process) --------------------------------
    def submit_job(self, runspec, schedule=None) -> dict:
        raise RunDBError(
            "submit_job requires a remote service (set MLT_DBPATH); in local "
            "mode runs execute in-process via the local launcher")
