"""Concrete datastores — counterpart of ``mlrun_tpu/datastore/stores.py``.

``FileStore`` serves ``file://`` urls and bare paths, ``InMemoryStore``
``memory://``, ``FsspecStore`` the object stores (gs, s3, az, hdfs, ...)
and ``HttpStore`` ``http(s)://`` (read only); ``redis.py`` holds
``RedisStore``. The object stores' client packages (``fsspec`` and its
protocol package, ``requests``) are imported inside the calls that use
them.
"""

from __future__ import annotations

import glob as globlib
import os
import time

from .base import DataStore, FileStats


class FileStore(DataStore):
    kind = "file"

    def _abs(self, key: str) -> str:
        return os.path.abspath(os.path.expanduser(key))

    def get(self, key, size=None, offset=0) -> bytes:
        with open(self._abs(key), "rb") as fp:
            if offset:
                fp.seek(offset)
            return fp.read(size) if size else fp.read()

    def put(self, key, data, append=False):
        path = self._abs(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mode = "a" if append else "w"
        if isinstance(data, bytes):
            mode += "b"
        with open(path, mode) as fp:
            fp.write(data)

    def stat(self, key) -> FileStats:
        st = os.stat(self._abs(key))
        return FileStats(size=st.st_size, modified=st.st_mtime)

    def listdir(self, key) -> list[str]:
        path = self._abs(key)
        if os.path.isdir(path):
            out = []
            for root, _, files in os.walk(path):
                rel = os.path.relpath(root, path)
                for f in files:
                    out.append(f if rel == "." else os.path.join(rel, f))
            return out
        return [os.path.basename(p) for p in globlib.glob(path)]

    def delete(self, key):
        path = self._abs(key)
        if os.path.isfile(path):
            os.remove(path)

    def exists(self, key) -> bool:
        return os.path.exists(self._abs(key))


class InMemoryStore(DataStore):
    """memory:// store: one process-wide dict (tests, serving-graph
    queues)."""

    kind = "memory"
    _items: dict[str, bytes] = {}

    def get(self, key, size=None, offset=0):
        data = self._items[key]
        if offset:
            data = data[offset:]
        if size:
            data = data[:size]
        return data

    def put(self, key, data, append=False):
        if isinstance(data, str):
            data = data.encode()
        if append and key in self._items:
            self._items[key] += data
        else:
            self._items[key] = data

    def stat(self, key):
        if key not in self._items:
            raise FileNotFoundError(key)
        return FileStats(size=len(self._items[key]), modified=time.time())

    def listdir(self, key):
        prefix = key.rstrip("/") + "/" if key else ""
        return [k[len(prefix):] for k in self._items if k.startswith(prefix)]

    def delete(self, key):
        self._items.pop(key, None)

    def exists(self, key):
        return key in self._items


class FsspecStore(DataStore):
    """Generic fsspec-protocol store: gs/gcs, s3, az/abfs, hdfs, dbfs,
    oss. Credentials come from the store's secrets (a ``ds://`` profile's)
    or the environment (``AWS_ACCESS_KEY_ID``,
    ``GOOGLE_APPLICATION_CREDENTIALS``, ...). ``fsspec`` and the
    protocol's package (``s3fs``, ``gcsfs``, ``adlfs``) are imported when
    the filesystem is first used."""

    def __init__(self, parent, name, kind, endpoint="", secrets=None):
        super().__init__(parent, name, kind, endpoint, secrets)
        self._fs = None

    @property
    def filesystem(self):
        if self._fs is None:
            import fsspec

            protocol = {"gs": "gcs", "az": "abfs"}.get(self.kind, self.kind)
            self._fs = fsspec.filesystem(protocol, **self.storage_options())
        return self._fs

    def storage_options(self) -> dict:
        """Per-kind credential/option mapping — values come from the
        store's secrets (e.g. a ds:// profile) or the environment."""
        options: dict = {}
        if self.kind == "s3":
            key = self._get_secret_or_env("AWS_ACCESS_KEY_ID")
            secret = self._get_secret_or_env("AWS_SECRET_ACCESS_KEY")
            if key:
                options["key"] = key
                options["secret"] = secret
            endpoint = self._get_secret_or_env("S3_ENDPOINT_URL")
            if endpoint:
                options["endpoint_url"] = endpoint
            region = self._get_secret_or_env("AWS_REGION")
            if region:
                options.setdefault("client_kwargs", {})[
                    "region_name"] = region
            if self._get_secret_or_env("S3_ANONYMOUS").strip().lower() in \
                    ("1", "true", "yes"):
                options["anon"] = True
        elif self.kind in ("gs", "gcs"):
            creds_json = self._get_secret_or_env("GCP_CREDENTIALS")
            creds_path = self._get_secret_or_env(
                "GOOGLE_APPLICATION_CREDENTIALS")
            if creds_json:
                import json as jsonlib

                options["token"] = jsonlib.loads(creds_json)
            elif creds_path:
                options["token"] = creds_path
        elif self.kind in ("az", "abfs"):
            conn = self._get_secret_or_env("AZURE_STORAGE_CONNECTION_STRING")
            if conn:
                options["connection_string"] = conn
            account = self._get_secret_or_env("AZURE_STORAGE_ACCOUNT_NAME")
            if account:
                options["account_name"] = account
            account_key = self._get_secret_or_env(
                "AZURE_STORAGE_ACCOUNT_KEY")
            if account_key:
                options["account_key"] = account_key
            for field, env in (("client_id", "AZURE_STORAGE_CLIENT_ID"),
                               ("client_secret",
                                "AZURE_STORAGE_CLIENT_SECRET"),
                               ("tenant_id", "AZURE_STORAGE_TENANT_ID")):
                value = self._get_secret_or_env(env)
                if value:
                    options[field] = value
        return options

    def _full(self, key: str) -> str:
        return f"{self.endpoint}{key}" if self.endpoint else key.lstrip("/")

    def get(self, key, size=None, offset=0):
        end = offset + size if size else None
        return self.filesystem.cat_file(self._full(key), start=offset or None,
                                        end=end)

    def put(self, key, data, append=False):
        if append:
            raise ValueError(f"append is not supported on {self.kind} store")
        if isinstance(data, str):
            data = data.encode()
        with self.filesystem.open(self._full(key), "wb") as fp:
            fp.write(data)

    def stat(self, key):
        info = self.filesystem.info(self._full(key))
        return FileStats(size=info.get("size"),
                         modified=info.get("mtime") or info.get("LastModified"))

    def listdir(self, key):
        full = self._full(key).rstrip("/")
        # names, not fsspec's detailed dicts; relative to the directory as
        # the filesystem spells it (the memory filesystem roots it at /)
        prefix = self.filesystem._strip_protocol(full).rstrip("/")
        return [p[len(prefix):].lstrip("/")
                for p in self.filesystem.ls(full, detail=False)]

    def delete(self, key):
        self.filesystem.rm(self._full(key))

    def exists(self, key):
        return self.filesystem.exists(self._full(key))


class HttpStore(DataStore):
    """Read-only http(s):// store."""

    def __init__(self, parent, name, kind, endpoint="", secrets=None):
        super().__init__(parent, name, kind, endpoint, secrets)

    def get(self, key, size=None, offset=0):
        import requests

        url = f"{self.kind}://{self.endpoint}{key}"
        resp = requests.get(url, timeout=30)
        resp.raise_for_status()
        data = resp.content
        if offset:
            data = data[offset:]
        if size:
            data = data[:size]
        return data

    def put(self, key, data, append=False):
        raise ValueError("http store is read-only")

    def stat(self, key):
        data = self.get(key)
        return FileStats(size=len(data))

    def listdir(self, key):
        raise ValueError("http store does not support listdir")

    def delete(self, key):
        raise ValueError("http store is read-only")
