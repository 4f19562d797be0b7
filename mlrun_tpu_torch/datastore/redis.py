"""Redis datastore — the port's copy of ``mlrun_tpu/datastore/redis.py``
(``RedisStore`` for ``redis://`` and ``rediss://`` urls, the backend of
the online feature path).

Keys are plain redis strings under the url path; a parallel ``<key>#t``
member records the write time so ``stat`` can answer ``modified``. The
``redis`` package is imported when the client is first used, and the
client is cached per store instance.
"""

from __future__ import annotations

import time

from .base import DataStore, FileStats


class RedisStore(DataStore):
    kind = "redis"

    def __init__(self, parent, name: str, kind: str, endpoint: str = "",
                 secrets: dict | None = None):
        super().__init__(parent, name, kind, endpoint, secrets)
        self._client = None

    @property
    def client(self):
        if self._client is None:
            try:
                import redis  # gated
            except ImportError as exc:
                raise ImportError(
                    "redis:// urls need the redis package installed"
                ) from exc
            scheme = "rediss" if self.kind == "rediss" else "redis"
            url = f"{scheme}://{self.endpoint or 'localhost:6379'}"
            password = self._get_secret_or_env("REDIS_PASSWORD")
            self._client = redis.from_url(
                url, **({"password": password} if password else {}))
        return self._client

    @staticmethod
    def _key(key: str) -> str:
        return key.lstrip("/")

    def get(self, key, size=None, offset=0) -> bytes:
        value = self.client.get(self._key(key))
        if value is None:
            raise FileNotFoundError(f"redis key {key} not found")
        if offset or size:
            end = (offset + size - 1) if size else -1
            return bytes(value)[offset:None if end == -1 else end + 1]
        return bytes(value)

    def put(self, key, data, append=False):
        data = data.encode() if isinstance(data, str) else bytes(data)
        name = self._key(key)
        if append:
            self.client.append(name, data)
        else:
            self.client.set(name, data)
        self.client.set(f"{name}#t", str(time.time()))

    def stat(self, key) -> FileStats:
        name = self._key(key)
        size = self.client.strlen(name)
        if not size and not self.client.exists(name):
            raise FileNotFoundError(f"redis key {key} not found")
        stamp = self.client.get(f"{name}#t")
        return FileStats(size=int(size),
                         modified=float(stamp) if stamp else None)

    def listdir(self, key) -> list[str]:
        prefix = self._key(key).rstrip("/")
        pattern = f"{prefix}/*" if prefix else "*"
        out = []
        for name in self.client.scan_iter(match=pattern):
            text = name.decode() if isinstance(name, bytes) else name
            if text.endswith("#t"):
                continue
            out.append(text[len(prefix) + 1:] if prefix else text)
        return sorted(out)

    def delete(self, key):
        name = self._key(key)
        self.client.delete(name, f"{name}#t")

    def exists(self, key) -> bool:
        return bool(self.client.exists(self._key(key)))
