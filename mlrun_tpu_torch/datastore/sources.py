"""Data sources — the port's copy of ``mlrun_tpu/datastore/sources.py``:
the pandas-engine sources the feature store ingests from (CSV, Parquet,
DataFrame, SQL on sqlite, Stream and any datastore url). BigQuery,
Snowflake and Kafka stay gated on their client packages and raise
``ImportError`` without them, as the reference does; an ``http(s)://``
source reads its url with ``requests``. No source falls back to
another."""

from __future__ import annotations

import os
from typing import Optional

from ..model import ModelObj


class BaseSource(ModelObj):
    kind = "base"
    _dict_fields = ["kind", "name", "path", "attributes", "key_field",
                    "time_field", "schedule", "start_time", "end_time"]

    def __init__(self, name: str = "", path: str = "",
                 attributes: dict | None = None, key_field: str = "",
                 time_field: str = "", schedule: str = "",
                 start_time=None, end_time=None):
        self.name = name
        self.path = path
        self.attributes = attributes or {}
        self.key_field = key_field
        self.time_field = time_field
        self.schedule = schedule
        self.start_time = start_time
        self.end_time = end_time

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        raise NotImplementedError

    def filter_df(self, df):
        if self.time_field and (self.start_time or self.end_time):
            import pandas as pd

            series = pd.to_datetime(df[self.time_field])
            if self.start_time:
                df = df[series >= pd.to_datetime(self.start_time)]
            if self.end_time:
                df = df[series <= pd.to_datetime(self.end_time)]
        return df


class CSVSource(BaseSource):
    kind = "csv"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        from . import store_manager

        parse_dates = self.attributes.get("parse_dates")
        df = store_manager.object(url=self.path).as_df(
            columns=None, format="csv", parse_dates=parse_dates, **kwargs)
        df = self.filter_df(df)
        return df[columns] if columns else df


class ParquetSource(BaseSource):
    kind = "parquet"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        from . import store_manager

        df = store_manager.object(url=self.path).as_df(
            format="parquet", **kwargs)
        df = self.filter_df(df)
        return df[columns] if columns else df


class DataFrameSource(BaseSource):
    kind = "dataframe"

    def __init__(self, df=None, **kwargs):
        super().__init__(**kwargs)
        self._df = df

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        df = self.filter_df(self._df)
        return df[columns] if columns else df


class HttpSource(BaseSource):
    kind = "http"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        import io

        import pandas as pd
        import requests

        resp = requests.get(self.path, timeout=60,
                            headers=self.attributes.get("headers"))
        resp.raise_for_status()
        fmt = self.attributes.get("format") or self.path.rsplit(
            ".", 1)[-1].lower()
        buf = io.BytesIO(resp.content)
        if fmt == "csv":
            df = pd.read_csv(buf)
        elif fmt in ("parquet", "pq"):
            df = pd.read_parquet(buf)
        else:
            df = pd.read_json(buf)
        return df[columns] if columns else df


class SQLSource(BaseSource):
    """SQL table source via sqlite3/dbapi url in attributes["db_url"]."""

    kind = "sql"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        import sqlite3

        import pandas as pd

        db_url = self.attributes.get("db_url", "")
        table = self.attributes.get("table") or self.path
        query = self.attributes.get("query") or f"SELECT * FROM {table}"
        if db_url.startswith("sqlite://"):
            db_url = db_url[len("sqlite://"):]
        with sqlite3.connect(db_url) as conn:
            df = pd.read_sql(query, conn)
        df = self.filter_df(df)
        return df[columns] if columns else df


class BigQuerySource(BaseSource):
    kind = "bigquery"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        try:
            from google.cloud import bigquery  # gated
        except ImportError as exc:
            raise ImportError(
                "BigQuerySource requires google-cloud-bigquery") from exc
        client = bigquery.Client()
        query = self.attributes.get("query") or f"SELECT * FROM `{self.path}`"
        df = client.query(query).to_dataframe()
        return df[columns] if columns else df


class SnowflakeSource(BaseSource):
    """Snowflake table/query source (reference: mlrun/datastore/
    sources.py:737 SnowflakeSource — spark-engine there; here the
    snowflake connector is gated and the connection kwargs are
    testable without it)."""

    kind = "snowflake"

    def connection_kwargs(self) -> dict:
        """Connector kwargs from attributes + SNOWFLAKE_PASSWORD env (the
        secret never lives in the source spec)."""
        attrs = self.attributes
        kwargs = {key: attrs[key] for key in
                  ("account", "user", "warehouse", "database", "schema",
                   "role") if attrs.get(key)}
        password = os.environ.get("SNOWFLAKE_PASSWORD", "")
        if password:
            kwargs["password"] = password
        return kwargs

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        try:
            import snowflake.connector  # gated
        except ImportError as exc:
            raise ImportError(
                "SnowflakeSource requires snowflake-connector-python"
            ) from exc
        query = self.attributes.get("query") or f"SELECT * FROM {self.path}"
        with snowflake.connector.connect(
                **self.connection_kwargs()) as conn:
            df = conn.cursor().execute(query).fetch_pandas_all()
        df = self.filter_df(df)
        return df[columns] if columns else df


class StreamSource(BaseSource):
    """In-memory/file stream source (serving-graph queue input)."""

    kind = "stream"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        import pandas as pd

        from ..serving.streams import _FileStream, get_stream_pusher

        stream = get_stream_pusher(self.path)
        if isinstance(stream, _FileStream):
            items, _ = stream.pull(offset=0, max_items=0)
        elif hasattr(stream, "pull"):
            items = stream.pull(1_000_000)
        else:
            items = []
        df = pd.DataFrame(items)
        return df[columns] if columns else df


class KafkaSource(BaseSource):
    kind = "kafka"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        try:
            from kafka import KafkaConsumer  # gated
        except ImportError as exc:
            raise ImportError("KafkaSource requires kafka-python") from exc
        import json

        import pandas as pd

        consumer = KafkaConsumer(
            self.path, bootstrap_servers=self.attributes.get("brokers"),
            consumer_timeout_ms=int(self.attributes.get("timeout_ms", 5000)),
            auto_offset_reset="earliest")
        rows = [json.loads(m.value) for m in consumer]
        df = pd.DataFrame(rows)
        return df[columns] if columns else df


class GenericUrlSource(BaseSource):
    """Any datastore url; format inferred from the suffix by DataItem.as_df
    (csv/parquet/json)."""

    kind = "url"

    def to_dataframe(self, columns=None, df_module=None, **kwargs):
        from . import store_manager

        df = store_manager.object(url=self.path).as_df(**kwargs)
        df = self.filter_df(df)
        return df[columns] if columns else df


source_kind_to_class = {
    cls.kind: cls for cls in (
        CSVSource, ParquetSource, DataFrameSource, HttpSource, SQLSource,
        BigQuerySource, SnowflakeSource, StreamSource, KafkaSource,
        GenericUrlSource)
}


def get_source_from_dict(struct: dict) -> BaseSource:
    kind = struct.get("kind", "csv")
    cls = source_kind_to_class.get(kind)
    if cls is None:
        raise ValueError(f"unknown source kind '{kind}'")
    return cls.from_dict(struct)


def resolve_source(source) -> BaseSource:
    """Accept a BaseSource, DataFrame, url string, or dict."""
    import pandas as pd

    if isinstance(source, BaseSource):
        return source
    if isinstance(source, pd.DataFrame):
        return DataFrameSource(df=source)
    if isinstance(source, dict):
        return get_source_from_dict(source)
    if isinstance(source, str):
        suffix = source.rsplit(".", 1)[-1].lower()
        if suffix == "csv":
            return CSVSource(path=source)
        if suffix in ("parquet", "pq"):
            return ParquetSource(path=source)
        if source.startswith(("http://", "https://")):
            return HttpSource(path=source)
        return GenericUrlSource(path=source)
    raise ValueError(f"unsupported source {type(source)}")
