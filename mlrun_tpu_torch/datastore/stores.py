"""Concrete datastores — counterpart of ``mlrun_tpu/datastore/stores.py``.

``FileStore`` serves ``file://`` urls and bare paths, ``InMemoryStore``
``memory://``. The object stores of the reference (``FsspecStore`` for
gs / s3 / az / hdfs, ``HttpStore``, ``RedisStore``) need packages and a
network the port's machines do not have; they raise ``not_ported`` item
10 naming the scheme.
"""

from __future__ import annotations

import glob as globlib
import os
import time

from ..serving.resilience import not_ported
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


class _UnportedStore(DataStore):
    def __init__(self, parent, name, kind, endpoint="", secrets=None):
        raise not_ported(f"the '{kind}://' datastore ({type(self).__name__})",
                         10)


class FsspecStore(_UnportedStore):
    """gs / gcs / s3 / az / abfs / hdfs / dbfs / oss in the reference."""


class HttpStore(_UnportedStore):
    """http(s):// in the reference (read only)."""


class RedisStore(_UnportedStore):
    """redis(s):// in the reference."""
