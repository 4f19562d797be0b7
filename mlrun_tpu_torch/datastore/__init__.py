"""Datastore urls — counterpart of ``mlrun_tpu/datastore`` (``base.py``,
``stores.py`` and the store registry of ``datastore.py``).

``store_manager.object(url=...)`` resolves a url into a ``DataItem``:
``file://`` urls and bare paths on the local file system, ``memory://``
in the process. The reference's object stores and its ``store://`` and
``ds://`` urls (which resolve through the run db) raise ``not_ported``
item 10.
"""

from __future__ import annotations

from ..serving.resilience import not_ported
from .base import DataItem, DataStore, FileStats, parse_url  # noqa: F401
from .stores import (  # noqa: F401
    FileStore,
    FsspecStore,
    HttpStore,
    InMemoryStore,
    RedisStore,
)

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


class StoreManager:
    """Caches DataStore instances per (scheme, endpoint) and mints
    DataItems. The reference's per-store secrets have no store here to
    use them."""

    def __init__(self):
        self._stores: dict[str, DataStore] = {}

    def get_or_create_store(self, url: str) -> tuple[DataStore, str]:
        scheme, endpoint, path = parse_url(url)
        if scheme in ("store", "ds"):
            raise not_ported(f"'{scheme}://' urls, which resolve through "
                             f"the run db ({url})", 10)
        store_key = f"{scheme}://{endpoint}"
        if store_key not in self._stores:
            cls = schema_to_store.get(scheme)
            if cls is None:
                raise ValueError(f"unsupported url scheme '{scheme}' ({url})")
            self._stores[store_key] = cls(self, store_key, scheme, endpoint)
        return self._stores[store_key], path

    def object(self, url: str, key: str = "") -> DataItem:
        store, path = self.get_or_create_store(url)
        return DataItem(key or path, store, path, url=url)


store_manager = StoreManager()
