"""Datastore urls — counterpart of ``mlrun_tpu/datastore`` (``base.py``,
``stores.py``, ``profiles.py`` and the store registry of ``datastore.py``).

``store_manager.object(url=...)`` resolves a url into a ``DataItem``:
``file://`` urls and bare paths on the local file system, ``memory://``
in the process, ``store://`` artifact uris through the run db (the
artifact's ``target_path``, its record as the item's ``meta``) and
``ds://<profile>/<path>`` through a datastore profile (the client-side
registry, else the run db's ``get_datastore_profile``), and the object
stores: ``gs`` / ``s3`` / ``az`` / ``hdfs`` ... through fsspec,
``http(s)://`` read only and ``redis://``; ``register_store`` adds a
scheme. ``sources`` and ``targets`` hold the feature store's sources and
targets.
"""

from __future__ import annotations

from typing import Optional

from .base import DataItem, DataStore, FileStats, parse_url  # noqa: F401
from .redis import RedisStore
from .stores import FileStore, FsspecStore, HttpStore, InMemoryStore

schema_to_store: dict[str, type] = {
    "file": FileStore,
    "": FileStore,
    "memory": InMemoryStore,
    "gs": FsspecStore,
    "gcs": FsspecStore,
    "s3": FsspecStore,
    "az": FsspecStore,
    "abfs": FsspecStore,
    "hdfs": FsspecStore,
    "dbfs": FsspecStore,
    "oss": FsspecStore,
    "http": HttpStore,
    "https": HttpStore,
    "redis": RedisStore,
    "rediss": RedisStore,
}


def register_store(scheme: str, cls: type):
    schema_to_store[scheme] = cls


class StoreManager:
    """Caches DataStore instances per (scheme, endpoint) and mints
    DataItems; ``store://`` and ``ds://`` urls resolve through the run db
    (``set(db=...)``, else ``db.get_run_db()``)."""

    def __init__(self, secrets: dict | None = None, db=None):
        self._stores: dict[str, DataStore] = {}
        self._secrets = secrets or {}
        self._db = db

    def set(self, secrets: dict | None = None, db=None) -> "StoreManager":
        if secrets:
            self._secrets.update(secrets)
        if db is not None:
            self._db = db
        return self

    def _get_db(self):
        if self._db is None:
            from ..db import get_run_db

            self._db = get_run_db()
        return self._db

    def get_or_create_store(self, url: str, secrets: dict | None = None,
                            project: str = "") -> tuple[DataStore, str]:
        scheme, endpoint, path = parse_url(url)
        if scheme == "ds":
            # ds://<profile>/<subpath> -> the profile's real url + secrets,
            # resolved against this manager's db and the caller's project
            from .profiles import datastore_profile_read

            profile = datastore_profile_read(endpoint, project=project,
                                             db=self._get_db())
            real_url = profile.url(path)
            merged = dict(profile.secrets())
            merged.update(secrets or {})
            return self.get_or_create_store(real_url, secrets=merged or None,
                                            project=project)
        store_key = f"{scheme}://{endpoint}"
        if store_key not in self._stores or secrets:
            cls = schema_to_store.get(scheme)
            if cls is None:
                raise ValueError(f"unsupported url scheme '{scheme}' ({url})")
            merged = dict(self._secrets)
            merged.update(secrets or {})
            store = cls(self, store_key, scheme, endpoint, secrets=merged)
            if secrets:
                return store, path  # credentialed stores are not cached
            self._stores[store_key] = store
        return self._stores[store_key], path

    def object(self, url: str, key: str = "", project: str = "",
               secrets: dict | None = None) -> DataItem:
        meta = {}
        artifact_url = ""
        if url.startswith("store://"):
            artifact_url = url
            meta = self._resolve_store_resource(url, project) or {}
            target = (meta.get("spec", {}).get("target_path")
                      or meta.get("target_path"))
            if not target:
                raise ValueError(f"artifact {url} has no target_path")
            key = key or meta.get("metadata", {}).get("key", "")
            url = target
        store, path = self.get_or_create_store(url, secrets=secrets,
                                               project=project)
        return DataItem(key or path, store, path, url=url, meta=meta,
                        artifact_url=artifact_url)

    def _resolve_store_resource(self, url: str,
                                project: str = "") -> Optional[dict]:
        """store://artifacts/<project>/<key>[#iter][:tag][@uid] or
        store://<project>/<key> (``#iter`` addresses a hyper-run
        iteration's artifact)."""
        body = url[len("store://"):]
        for prefix in ("artifacts/", "datasets/", "models/"):
            if body.startswith(prefix) and body.count("/") >= 2:
                body = body[len(prefix):]
                break
        tree = None
        if "@" in body:
            body, tree = body.rsplit("@", 1)
        tag = None
        if ":" in body:
            body, tag = body.rsplit(":", 1)
        iteration = None
        if "#" in body:
            body, _, iter_part = body.rpartition("#")
            try:
                iteration = int(iter_part)
            except ValueError:
                body = f"{body}#{iter_part}"  # '#' was part of the key
        parts = body.split("/", 1)
        if len(parts) == 2:
            project, key = parts
        else:
            key = parts[0]
        return self._get_db().read_artifact(
            key, tag=tag, project=project or None, tree=tree, iter=iteration)


store_manager = StoreManager()


from .sources import (  # noqa: E402,F401
    BigQuerySource,
    CSVSource,
    DataFrameSource,
    HttpSource,
    KafkaSource,
    ParquetSource,
    SnowflakeSource,
    SQLSource,
    StreamSource,
)
from .targets import (  # noqa: E402,F401
    CSVTarget,
    DFTarget,
    KafkaTarget,
    NoSqlTarget,
    ParquetTarget,
    RedisNoSqlTarget,
    SQLTarget,
    StreamTarget,
    TSDBTarget,
)
