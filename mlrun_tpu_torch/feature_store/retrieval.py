"""Offline feature-vector merge engines — the port's copy of
``mlrun_tpu/feature_store/retrieval.py``. An engine name selects a merger
class that loads each feature set, joins on shared entity columns, and
finalizes (drop columns / indexes):

- ``local``: in-memory pandas joins (reference LocalFeatureMerger).
- ``partitioned``: out-of-core hash-partitioned merge — streams parquet in
  row-group batches, buckets rows by entity-key hash into on-disk
  partitions, then joins partitions concurrently. Scales past RAM on one
  host without any extra dependency (the niche dask fills upstream).
- ``dask``: dask.dataframe joins (gated on the dask package).
- ``spark``: pyspark joins (gated on the pyspark package).
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import pandas as pd

from ..utils import logger
from .feature_set import FeatureSet, FeatureVector


class BaseMerger:
    """Template: load each feature set → left-join on shared entity columns
    → finalize. Subclasses override the frame type via _load/_join/_collect.
    """

    engine = "base"
    support_online = False

    def __init__(self, vector: FeatureVector, project: str = ""):
        self.vector = vector
        self.project = project
        self._entity_columns: set[str] = set()

    # -- frame ops (subclass seam) ------------------------------------------
    def _load(self, fset: FeatureSet, columns: Optional[list[str]]):
        """Return the engine's frame for a feature set (all or the listed
        columns)."""
        raise NotImplementedError

    def _join(self, left, right, keys: list[str]):
        raise NotImplementedError

    def _collect(self, frame) -> pd.DataFrame:
        """Materialize the engine frame into pandas."""
        return frame

    def _from_pandas(self, df: pd.DataFrame):
        """Wrap caller-provided entity rows into the engine's frame type."""
        return df

    # -- template -----------------------------------------------------------
    def _resolve(self, name: str) -> FeatureSet:
        from .api import _resolve_feature_set

        return _resolve_feature_set(name, project=self.project)

    def merge(self, entity_rows: pd.DataFrame | None = None,
              drop_columns: list | None = None,
              with_indexes: bool = False) -> pd.DataFrame:
        try:
            return self._merge(entity_rows, drop_columns, with_indexes)
        finally:
            self._cleanup()

    def _cleanup(self):
        pass

    def _merge(self, entity_rows, drop_columns, with_indexes) -> pd.DataFrame:
        merged = None
        if entity_rows is not None:
            merged = self._from_pandas(entity_rows)
        for set_name, feature in self.vector.parse_features():
            fset = self._resolve(set_name)
            entities = fset.entity_names
            self._entity_columns.update(entities)
            columns = None if feature == "*" else entities + [feature]
            frame = self._load(fset, columns)
            if merged is None:
                merged = frame
                continue
            join_keys = [c for c in entities if c in self._columns(merged)]
            if not join_keys:
                raise ValueError(
                    f"no common entity columns to join feature set "
                    f"'{set_name}' (entities={entities})")
            merged = self._join(merged, frame, join_keys)
        if merged is None:
            raise ValueError("feature vector has no features")
        if self.vector.spec.label_feature:
            set_name, feature = self.vector.spec.label_feature.rsplit(".", 1)
            fset = self._resolve(set_name)
            self._entity_columns.update(fset.entity_names)
            frame = self._load(fset, fset.entity_names + [feature])
            join_keys = [c for c in fset.entity_names
                         if c in self._columns(merged)]
            merged = self._join(merged, frame, join_keys)
        result = self._collect(merged)
        if drop_columns:
            result = result.drop(columns=[c for c in drop_columns
                                          if c in result.columns])
        if not (with_indexes or self.vector.spec.with_indexes):
            result = result.drop(columns=[c for c in self._entity_columns
                                          if c in result.columns])
        return result

    def _columns(self, frame) -> list[str]:
        return list(frame.columns)


class LocalFeatureMerger(BaseMerger):
    """In-memory pandas joins (reference retrieval/local_merger.py)."""

    engine = "local"

    def _load(self, fset: FeatureSet, columns):
        df = fset.to_dataframe()
        return df if columns is None else df[columns]

    def _join(self, left, right, keys):
        return left.merge(right, on=keys, how="left")


class PartitionedFeatureMerger(BaseMerger):
    """Out-of-core merge: hash-partition every frame by entity key into
    on-disk buckets (streaming parquet row groups), then join buckets
    concurrently and concatenate. Peak memory is O(rows / partitions),
    so vectors larger than RAM merge on a single host."""

    engine = "partitioned"

    def __init__(self, vector, project: str = "", partitions: int = 8,
                 batch_rows: int = 65536):
        super().__init__(vector, project)
        self.partitions = partitions
        self.batch_rows = batch_rows
        self._tmp = tempfile.mkdtemp(prefix="mlt-merge-")

    def _cleanup(self):
        import shutil

        shutil.rmtree(self._tmp, ignore_errors=True)

    # frame markers: ("__pandas__", df) | ("__fset__", (fset, columns)) |
    # ("__dir__", (dir_path, keys_tuple)) — a partition dir remembers the
    # key set its buckets were hashed on, so a later join on different keys
    # re-buckets instead of silently aligning mismatched buckets
    def _from_pandas(self, df: pd.DataFrame):
        return ("__pandas__", df)

    def _load(self, fset: FeatureSet, columns):
        return ("__fset__", (fset, columns))

    def _hash_bucket(self, keys_frame: pd.DataFrame, keys) -> pd.Series:
        buckets = pd.util.hash_pandas_object(
            keys_frame[keys].astype(str).agg("|".join, axis=1), index=False)
        return (buckets % self.partitions).astype(int)

    def _new_dir(self, prefix: str) -> str:
        return tempfile.mkdtemp(prefix=prefix + "-", dir=self._tmp)

    def _partition_frame(self, df: pd.DataFrame, keys, out_dir: str,
                         seq: int):
        """Write one streamed batch into per-bucket part files. Each batch
        appends a NEW file ({bucket}-{seq}.parquet) — no re-read/rewrite of
        accumulated buckets, so total IO stays linear in the data size."""
        buckets = self._hash_bucket(df, keys)
        for bucket, chunk in df.groupby(buckets):
            chunk.to_parquet(
                os.path.join(out_dir, f"{bucket:04d}-{seq:06d}.parquet"),
                index=False)

    def _bucket_frame(self, dir_path: str, bucket: int
                      ) -> pd.DataFrame | None:
        parts = sorted(p for p in os.listdir(dir_path)
                       if p.startswith(f"{bucket:04d}-"))
        if not parts:
            return None
        return pd.concat(
            [pd.read_parquet(os.path.join(dir_path, p)) for p in parts],
            ignore_index=True)

    def _iter_source_batches(self, frame):
        """Yield pandas batches from any frame marker without loading
        single-file parquet sources whole."""
        kind, payload = frame
        if kind == "__pandas__":
            yield payload
            return
        if kind == "__dir__":
            dir_path, _ = payload
            for bucket in range(self.partitions):
                df = self._bucket_frame(dir_path, bucket)
                if df is not None:
                    yield df
            return
        fset, columns = payload
        path = fset._target_path()
        if os.path.isfile(path):
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(path)
            for batch in pf.iter_batches(batch_size=self.batch_rows):
                df = batch.to_pandas()
                yield df if columns is None else df[columns]
            return
        # directory target (e.g. dask-ingested part files) or non-parquet
        df = fset.to_dataframe()
        yield df if columns is None else df[columns]

    def _materialize(self, frame, keys) -> str:
        """Turn a frame marker into a partition dir bucketed on ``keys``."""
        kind, payload = frame
        if kind == "__dir__" and tuple(payload[1]) == tuple(keys):
            return payload[0]
        out_dir = self._new_dir("part")
        for seq, df in enumerate(self._iter_source_batches(frame)):
            self._partition_frame(df, keys, out_dir, seq)
        return out_dir

    def _join(self, left, right, keys):
        left_dir = self._materialize(left, keys)
        right_dir = self._materialize(right, keys)
        out_dir = self._new_dir("join")

        def join_bucket(bucket: int):
            ldf = self._bucket_frame(left_dir, bucket)
            if ldf is None:
                return
            rdf = self._bucket_frame(right_dir, bucket)
            out = ldf if rdf is None else ldf.merge(rdf, on=keys, how="left")
            out.to_parquet(
                os.path.join(out_dir, f"{bucket:04d}-000000.parquet"),
                index=False)

        with ThreadPoolExecutor(max_workers=min(8, self.partitions)) as pool:
            list(pool.map(join_bucket, range(self.partitions)))
        return ("__dir__", (out_dir, tuple(keys)))

    def _collect(self, frame) -> pd.DataFrame:
        kind, payload = frame
        if kind == "__pandas__":
            return payload
        if kind == "__fset__":
            fset, columns = payload
            df = fset.to_dataframe()
            return df if columns is None else df[columns]
        dir_path, _ = payload
        frames = [df for df in (self._bucket_frame(dir_path, b)
                                for b in range(self.partitions))
                  if df is not None]
        return pd.concat(frames, ignore_index=True) if frames else \
            pd.DataFrame()

    def _columns(self, frame) -> list[str]:
        kind, payload = frame
        if kind == "__pandas__":
            return list(payload.columns)
        if kind == "__fset__":
            fset, columns = payload
            if columns is not None:
                return columns
            return list(fset.to_dataframe().columns)
        dir_path, _ = payload
        for name in sorted(os.listdir(dir_path)):
            return list(pd.read_parquet(
                os.path.join(dir_path, name)).columns)
        return []


class DaskFeatureMerger(BaseMerger):
    """dask.dataframe joins (reference retrieval/dask_merger.py); gated on
    the dask package."""

    engine = "dask"

    def __init__(self, vector, project: str = "", npartitions: int = 4):
        super().__init__(vector, project)
        import dask.dataframe as dd  # gated import

        self._dd = dd
        self.npartitions = npartitions

    def _from_pandas(self, df: pd.DataFrame):
        return self._dd.from_pandas(df, npartitions=self.npartitions)

    def _load(self, fset: FeatureSet, columns):
        path = fset._target_path()
        if os.path.exists(path):
            ddf = self._dd.read_parquet(path)
        else:
            ddf = self._dd.from_pandas(fset.to_dataframe(),
                                       npartitions=self.npartitions)
        return ddf if columns is None else ddf[columns]

    def _join(self, left, right, keys):
        return left.merge(right, on=keys, how="left")

    def _collect(self, frame) -> pd.DataFrame:
        return frame.compute()


class SparkFeatureMerger(BaseMerger):
    """pyspark joins (reference retrieval/spark_merger.py); gated on the
    pyspark package."""

    engine = "spark"

    def __init__(self, vector, project: str = "", spark_session=None):
        super().__init__(vector, project)
        if spark_session is None:
            from pyspark.sql import SparkSession  # gated import

            spark_session = SparkSession.builder \
                .appName("mlrun-tpu-merge").getOrCreate()
        self.spark = spark_session

    def _from_pandas(self, df: pd.DataFrame):
        return self.spark.createDataFrame(df)

    def _load(self, fset: FeatureSet, columns):
        path = fset._target_path()
        if os.path.exists(path):
            sdf = self.spark.read.parquet(path)
        else:
            sdf = self.spark.createDataFrame(fset.to_dataframe())
        return sdf if columns is None else sdf.select(columns)

    def _join(self, left, right, keys):
        return left.join(right, on=keys, how="left")

    def _collect(self, frame) -> pd.DataFrame:
        return frame.toPandas()


_MERGERS = {
    "local": LocalFeatureMerger,
    "partitioned": PartitionedFeatureMerger,
    "dask": DaskFeatureMerger,
    "spark": SparkFeatureMerger,
}


def get_merger(engine: str, vector: FeatureVector, project: str = "",
               **kwargs) -> BaseMerger:
    cls = _MERGERS.get(engine or "local")
    if cls is None:
        raise ValueError(
            f"unknown offline merge engine '{engine}' "
            f"(one of {sorted(_MERGERS)})")
    try:
        return cls(vector, project=project, **kwargs)
    except ImportError as exc:
        raise ImportError(
            f"merge engine '{engine}' needs an optional dependency: {exc}"
        ) from exc
