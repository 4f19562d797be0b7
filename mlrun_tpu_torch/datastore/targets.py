"""Data targets — the port's copy of ``mlrun_tpu/datastore/targets.py``:
the offline and online targets the feature store writes (Parquet, CSV,
the sqlite-backed NoSql KV and its Redis form, Stream, Kafka, SQL on
sqlite, DF and TSDB) and ``resolve_target``. The Redis and Kafka targets
stay gated on their client packages and raise ``ImportError`` without
them, as the reference does. No target falls back to another.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Optional

from ..config import home_dir, run_config
from ..model import ModelObj
from ..utils.helpers import now_iso


class BaseTarget(ModelObj):
    kind = "base"
    _dict_fields = ["kind", "name", "path", "attributes", "partitioned",
                    "key_bucketing_number", "partition_cols", "time_col"]
    is_online = False

    def __init__(self, name: str = "", path: str = "",
                 attributes: dict | None = None, partitioned: bool = False,
                 key_bucketing_number=None, partition_cols=None,
                 time_col=None):
        self.name = name or self.kind
        self.path = path
        self.attributes = attributes or {}
        self.partitioned = partitioned
        self.key_bucketing_number = key_bucketing_number
        self.partition_cols = partition_cols
        self.time_col = time_col

    def default_path(self, project: str, feature_set: str) -> str:
        suffix = {"parquet": ".parquet", "csv": ".csv"}.get(self.kind, "")
        return os.path.join(home_dir(), "feature-store", project,
                            f"{feature_set}-{self.kind}{suffix}")

    def write_dataframe(self, df, key_columns: list | None = None,
                        timestamp_key: str | None = None) -> str:
        raise NotImplementedError

    def as_df(self, columns=None):
        from . import store_manager

        df = store_manager.object(url=self.path).as_df(format=self.kind)
        return df[columns] if columns else df

    def status_record(self) -> dict:
        return {"name": self.name, "kind": self.kind, "path": self.path,
                "updated": now_iso()}


class ParquetTarget(BaseTarget):
    kind = "parquet"

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self.partitioned and (self.partition_cols or timestamp_key):
            cols = self.partition_cols or [timestamp_key]
            df.to_parquet(self.path, partition_cols=cols)
        else:
            df.to_parquet(self.path, index=False)
        return self.path


class CSVTarget(BaseTarget):
    kind = "csv"

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        df.to_csv(self.path, index=False)
        return self.path


class NoSqlTarget(BaseTarget):
    """Online KV target on sqlite (key → json record)."""

    kind = "nosql"
    is_online = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cached_conn = None

    def _conn(self):
        # one cached connection per target instance — get() sits on the
        # online-lookup hot path
        if self._cached_conn is not None:
            return self._cached_conn
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.execute("CREATE TABLE IF NOT EXISTS kv "
                     "(key TEXT PRIMARY KEY, value TEXT)")
        self._cached_conn = conn
        return conn

    def close(self):
        if self._cached_conn is not None:
            self._cached_conn.close()
            self._cached_conn = None

    def default_path(self, project: str, feature_set: str) -> str:
        return os.path.join(home_dir(), "feature-store", project,
                            f"{feature_set}-kv.sqlite")

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        if not key_columns:
            raise ValueError("nosql target requires key columns (entities)")
        with self._conn() as conn:
            for _, row in df.iterrows():
                key = "|".join(str(row[k]) for k in key_columns)
                conn.execute(
                    "INSERT OR REPLACE INTO kv (key, value) VALUES (?, ?)",
                    (key, json.dumps(row.to_dict(), default=str)))
        return self.path

    def get(self, key_values: list) -> Optional[dict]:
        key = "|".join(str(v) for v in key_values)
        with self._conn() as conn:
            row = conn.execute("SELECT value FROM kv WHERE key=?",
                               (key,)).fetchone()
        return json.loads(row[0]) if row else None


class RedisNoSqlTarget(NoSqlTarget):
    """Online KV target on redis (reference datastore/redis.py backs the
    same role): rows live as redis HASHes under
    ``mlt:{project}:{feature_set}:{entity-key}`` so the online feature
    service reads single rows with one HGETALL — the low-latency path a
    shared serving fleet needs (the sqlite NoSqlTarget is single-host)."""

    kind = "redisnosql"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._prefix = ""
        self._cached_client = None

    def _client(self):
        if self._cached_client is None:
            try:
                import redis  # gated
            except ImportError as exc:
                raise ImportError(
                    "RedisNoSqlTarget requires redis-py") from exc
            self._cached_client = redis.from_url(
                self.path or str(run_config("redis_url")))
        return self._cached_client

    def close(self):
        if self._cached_client is not None:
            # actually release the pool's sockets (redis-py keeps them
            # until GC otherwise); close() exists on redis>=4, fall back
            # to the pool disconnect
            client = self._cached_client
            closer = getattr(client, "close", None) or getattr(
                getattr(client, "connection_pool", None), "disconnect",
                None)
            if closer:
                try:
                    closer()
                except Exception:  # noqa: BLE001 - already gone
                    pass
        self._cached_client = None

    def set_namespace(self, project: str, feature_set: str):
        """Key namespace — set on EVERY ingest (a user-supplied redis url
        must not make two feature sets share un-prefixed row keys)."""
        self._prefix = f"mlt:{project}:{feature_set}"

    def default_path(self, project: str, feature_set: str) -> str:
        self.set_namespace(project, feature_set)
        return str(run_config("redis_url"))

    def _row_key(self, key_values: list) -> str:
        key = "|".join(str(v) for v in key_values)
        return f"{self._prefix}:{key}" if self._prefix else key

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        if not key_columns:
            raise ValueError("redis target requires key columns (entities)")
        client = self._client()
        for _, row in df.iterrows():
            key = self._row_key([row[k] for k in key_columns])
            client.hset(key, mapping={
                k: json.dumps(v, default=str)
                for k, v in row.to_dict().items()})
        return self.path or str(run_config("redis_url"))

    def get(self, key_values: list) -> Optional[dict]:
        raw = self._client().hgetall(self._row_key(key_values))
        if not raw:
            return None
        return {
            (k.decode() if isinstance(k, bytes) else k):
            json.loads(v.decode() if isinstance(v, bytes) else v)
            for k, v in raw.items()}

    def status_record(self) -> dict:
        record = super().status_record()
        record["prefix"] = self._prefix
        return record


class StreamTarget(BaseTarget):
    kind = "stream"
    is_online = True

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        from ..serving.streams import get_stream_pusher

        stream = get_stream_pusher(self.path)
        stream.push([row.to_dict() for _, row in df.iterrows()])
        return self.path


class KafkaTarget(BaseTarget):
    kind = "kafka"
    is_online = True

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        from ..serving.streams import _KafkaStream

        brokers = self.attributes.get("brokers", "")
        stream = _KafkaStream(brokers, self.path)
        stream.push([row.to_dict() for _, row in df.iterrows()])
        return self.path


class SQLTarget(BaseTarget):
    kind = "sql"

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        db_url = self.attributes.get("db_url", "")
        table = self.attributes.get("table") or self.name
        if db_url.startswith("sqlite://"):
            db_url = db_url[len("sqlite://"):]
        os.makedirs(os.path.dirname(db_url) or ".", exist_ok=True)
        with sqlite3.connect(db_url) as conn:
            df.to_sql(table, conn, if_exists=self.attributes.get(
                "if_exists", "replace"), index=False)
        return f"sqlite://{db_url}#{table}"


class DFTarget(BaseTarget):
    kind = "dataframe"

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._df = None

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        self._df = df
        return "memory://df"

    def as_df(self, columns=None):
        return self._df[columns] if columns else self._df


class TSDBTarget(BaseTarget):
    """Time-series metrics target: append-only parquet keyed by time."""

    kind = "tsdb"

    def default_path(self, project: str, feature_set: str) -> str:
        return os.path.join(home_dir(), "feature-store", project,
                            f"{feature_set}-tsdb.parquet")

    def write_dataframe(self, df, key_columns=None, timestamp_key=None) -> str:
        import pandas as pd

        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if os.path.isfile(self.path):
            df = pd.concat([pd.read_parquet(self.path), df],
                           ignore_index=True)
        df.to_parquet(self.path, index=False)
        return self.path


target_kind_to_class = {
    cls.kind: cls for cls in (
        ParquetTarget, CSVTarget, NoSqlTarget, RedisNoSqlTarget,
        StreamTarget, KafkaTarget, SQLTarget, DFTarget, TSDBTarget)
}


def resolve_target(target) -> BaseTarget:
    if isinstance(target, BaseTarget):
        return target
    if isinstance(target, dict):
        kind = target.get("kind", "parquet")
        cls = target_kind_to_class.get(kind)
        if cls is None:
            raise ValueError(f"unknown target kind '{kind}'")
        return cls.from_dict(target)
    if isinstance(target, str):
        cls = target_kind_to_class.get(target)
        if cls is None:
            raise ValueError(f"unknown target kind '{target}'")
        return cls()
    raise ValueError(f"unsupported target {type(target)}")
