"""Datastore base classes — counterpart of ``mlrun_tpu/datastore/base.py``.

A ``DataStore`` is a scheme-keyed backend (``file``, ``memory``); a
``DataItem`` is the lazy handle the training and serving entry points
resolve a url into. Reads and writes fire the ``datastore.read`` /
``datastore.write`` fault points of the port's own ``chaos`` registry.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional
from urllib.parse import urlparse

from ..chaos import fire as chaos_fire


class FileStats:
    def __init__(self, size: int | None = None, modified: float | None = None,
                 content_type: str | None = None):
        self.size = size
        self.modified = modified
        self.content_type = content_type

    def __repr__(self):
        return f"FileStats(size={self.size}, modified={self.modified})"


class DataStore:
    """Abstract storage backend keyed by url scheme."""

    kind = "base"
    using_bucket = False

    def __init__(self, parent, name: str, kind: str, endpoint: str = "",
                 secrets: dict | None = None):
        self._parent = parent
        self.name = name
        self.kind = kind
        self.endpoint = endpoint
        self._secrets = secrets or {}

    def _get_secret_or_env(self, key: str, default: str = "") -> str:
        return self._secrets.get(key) or os.environ.get(key, default)

    # -- required backend api ---------------------------------------------
    def get(self, key: str, size: int | None = None, offset: int = 0) -> bytes:
        raise NotImplementedError

    def put(self, key: str, data: bytes | str, append: bool = False):
        raise NotImplementedError

    def stat(self, key: str) -> FileStats:
        raise NotImplementedError

    def listdir(self, key: str) -> list[str]:
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        try:
            self.stat(key)
            return True
        except (FileNotFoundError, KeyError):
            return False

    # -- derived helpers ---------------------------------------------------
    def upload(self, key: str, src_path: str):
        chaos_fire("datastore.write", kind=self.kind, key=key)
        with open(src_path, "rb") as fp:
            self.put(key, fp.read())

    def download(self, key: str, target_path: str):
        chaos_fire("datastore.read", kind=self.kind, key=key)
        data = self.get(key)
        os.makedirs(os.path.dirname(target_path) or ".", exist_ok=True)
        with open(target_path, "wb") as fp:
            fp.write(data if isinstance(data, bytes) else data.encode())

    def url(self, key: str) -> str:
        if self.kind == "file":
            return key
        return f"{self.kind}://{self.endpoint}{key}"

    def as_df(self, key: str, columns=None, df_module=None, format: str = "",
              **kwargs):
        """Load an object into a dataframe (csv / parquet / json by
        suffix)."""
        import io

        import pandas as pd

        df_module = df_module or pd
        fmt = format or key.rsplit(".", 1)[-1].lower()
        raw = self.get(key)
        buf = io.BytesIO(raw if isinstance(raw, bytes) else raw.encode())
        if fmt == "csv":
            df = df_module.read_csv(buf, **kwargs)
        elif fmt in ("parquet", "pq"):
            df = df_module.read_parquet(buf, **kwargs)
        elif fmt == "json":
            df = df_module.read_json(buf, **kwargs)
        else:
            raise ValueError(f"cannot load dataframe from format '{fmt}'")
        if columns:
            df = df[columns]
        return df

    def rm(self, path: str, recursive: bool = False):
        self.delete(path)


class DataItem:
    """Lazy data handle (the reference's ``DataItem``)."""

    def __init__(self, key: str, store: DataStore, subpath: str, url: str = "",
                 meta: dict | None = None, artifact_url: str = ""):
        self._key = key
        self._store = store
        self._path = subpath
        self._url = url
        self._meta = meta or {}
        self._artifact_url = artifact_url
        self._local_path = ""

    @property
    def key(self) -> str:
        return self._key

    @property
    def kind(self) -> str:
        return self._store.kind

    @property
    def meta(self) -> dict:
        return self._meta

    @property
    def url(self) -> str:
        return self._url

    @property
    def artifact_url(self) -> str:
        """The ``store://`` uri the item was resolved from, else its
        url."""
        return self._artifact_url or self._url

    @property
    def store(self) -> DataStore:
        return self._store

    @property
    def suffix(self) -> str:
        _, ext = os.path.splitext(self._path)
        return ext

    def get(self, size=None, offset=0, encoding: str | None = None):
        chaos_fire("datastore.read", kind=self.kind, key=self._path,
                   url=self._url)
        body = self._store.get(self._path, size=size, offset=offset)
        if encoding and isinstance(body, bytes):
            body = body.decode(encoding)
        return body

    def put(self, data, append: bool = False):
        chaos_fire("datastore.write", kind=self.kind, key=self._path,
                   url=self._url)
        self._store.put(self._path, data, append=append)

    def delete(self):
        self._store.delete(self._path)

    def download(self, target_path: str):
        self._store.download(self._path, target_path)

    def stat(self) -> FileStats:
        return self._store.stat(self._path)

    def exists(self) -> bool:
        return self._store.exists(self._path)

    def listdir(self) -> list[str]:
        return self._store.listdir(self._path)

    def as_df(self, columns=None, df_module=None, format: str = "", **kwargs):
        return self._store.as_df(self._path, columns=columns,
                                 df_module=df_module, format=format, **kwargs)

    def local(self) -> str:
        """A local file path (or directory, for a key prefix) holding the
        item: the path itself on the file store, else a temporary copy."""
        if self._store.kind == "file":
            return self._path
        if self._local_path:
            return self._local_path
        if not self._store.exists(self._path):
            # a directory prefix: mirror every key under it
            entries = self._store.listdir(self._path)
            if entries:
                local_dir = tempfile.mkdtemp(prefix="mlt-item-")
                prefix = self._path.rstrip("/")
                for entry in entries:
                    self._store.download(f"{prefix}/{entry}",
                                         os.path.join(local_dir, entry))
                self._local_path = local_dir
                return local_dir
        temp = tempfile.NamedTemporaryFile(suffix=self.suffix or ".tmp",
                                           delete=False)
        temp.close()
        self.download(temp.name)
        self._local_path = temp.name
        return self._local_path

    def ls(self) -> list[str]:
        """Alias of listdir."""
        return self.listdir()

    def open(self, mode: str = "rb"):
        """Open the (locally materialized) item as a file object."""
        return open(self.local(), mode)

    def upload(self, src_path: str):
        """Upload a local file into this item's target."""
        self._store.upload(self._path, src_path)

    def get_artifact_type(self) -> Optional[str]:
        """The artifact's kind when this item resolved a ``store://``
        uri."""
        return self._meta.get("kind") if self._meta else None

    def show(self):
        from ..utils import logger

        logger.info("data item", url=self._url, kind=self.kind)

    def remove_local(self):
        """Drop the temporary copy ``local()`` made (none on the file
        store)."""
        if self._local_path and self._store.kind != "file":
            if os.path.isdir(self._local_path):
                shutil.rmtree(self._local_path, ignore_errors=True)
            elif os.path.exists(self._local_path):
                os.remove(self._local_path)
            self._local_path = ""

    def __str__(self):
        return self._url

    def __repr__(self):
        return f"DataItem({self._url})"


def parse_url(url: str) -> tuple[str, str, str]:
    """Return (scheme, endpoint, path)."""
    parsed = urlparse(url)
    scheme = parsed.scheme or "file"
    endpoint = parsed.netloc
    path = parsed.path
    if scheme == "file" and endpoint:
        path = endpoint + path
        endpoint = ""
    return scheme, endpoint, path
