"""Secrets store — the port's copy of ``mlrun_tpu/secrets.py``
(``SecretsStore``, ``get_secret_or_env``), which a graph context reads.

Sources: inline kv dicts, env vars (optionally prefixed), env files.
"""

from __future__ import annotations

import os


class SecretsStore:
    def __init__(self):
        self._secrets: dict[str, str] = {}
        self._hidden_sources: list[dict] = []

    @classmethod
    def from_list(cls, src_list: list | None) -> "SecretsStore":
        store = cls()
        for source in src_list or []:
            store.add_source(source.get("kind"), source.get("source"))
        return store

    def add_source(self, kind: str, source=None, prefix: str = ""):
        if kind == "inline":
            if not isinstance(source, dict):
                raise ValueError("inline secrets source must be a dict")
            for key, value in source.items():
                self._secrets[prefix + key] = str(value)
        elif kind == "env":
            # source = "KEY1,KEY2" or None for all MLT_SECRET_* vars
            keys = (source or "").split(",") if source else [
                k for k in os.environ if k.startswith("MLT_SECRET_")
            ]
            for key in keys:
                key = key.strip()
                if key and key in os.environ:
                    name = key[len("MLT_SECRET_"):] if key.startswith(
                        "MLT_SECRET_") else key
                    self._secrets[prefix + name] = os.environ[key]
        elif kind == "file":
            with open(source) as fp:
                for line in fp:
                    line = line.strip()
                    if line and not line.startswith("#") and "=" in line:
                        key, value = line.split("=", 1)
                        self._secrets[prefix + key.strip()] = value.strip()
        elif kind == "vault" or kind == "kubernetes":
            # cluster secret stores are resolved server-side; record only
            self._hidden_sources.append({"kind": kind, "source": source})
        else:
            raise ValueError(f"unsupported secrets source kind '{kind}'")

    def get(self, key: str, default: str | None = None):
        if key in self._secrets:
            return self._secrets[key]
        if key in os.environ:
            return os.environ[key]
        # project secrets injected into resources arrive as MLT_SECRET_*
        # env
        return os.environ.get("MLT_SECRET_" + key, default)

    def items(self):
        return self._secrets.items()

    def has(self, key: str) -> bool:
        return key in self._secrets or key in os.environ

    def to_serial(self) -> list[dict]:
        # inline secrets are redacted when serialized back
        return list(self._hidden_sources)


def get_secret_or_env(key: str, secret_provider=None, default: str = "",
                      prefix: str = "") -> str:
    """Resolve a secret by key: explicit provider first, then the PLAIN
    env var, then the injected project-secret env (MLT_SECRET_<key>, key
    verbatim)."""
    if prefix:
        key = f"{prefix}_{key}"
    if secret_provider is not None:
        value = secret_provider(key) if callable(secret_provider) \
            else secret_provider.get(key)
        if value:
            return value
    return (os.environ.get(key)
            or os.environ.get("MLT_SECRET_" + key)
            or default)
