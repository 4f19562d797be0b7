"""Feature-store operations — the port's copy of ``mlrun_tpu/
feature_store/api.py``: ``ingest`` (the pandas engine; the dask engine
gated on its package), ``preview``, ``get_offline_features`` over the
mergers of ``retrieval.py``, and the key-to-features
``OnlineVectorService`` (``get_online_feature_service``) that the
enrichment routers call.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import pandas as pd

from ..config import run_config
from ..utils import logger
from ..utils.helpers import now_iso
from .feature_set import FeatureSet, FeatureVector


def _resolve_feature_set(ref: Union[str, FeatureSet],
                         project: str = "") -> FeatureSet:
    if isinstance(ref, FeatureSet):
        return ref
    from ..db import get_run_db

    name = ref
    if ref.startswith("store://feature-sets/"):
        body = ref[len("store://feature-sets/"):]
        project, _, name = body.partition("/")
    struct = get_run_db().get_feature_set(name, project=project)
    return FeatureSet.from_dict(struct)


def ingest(featureset: Union[FeatureSet, str], source,
           targets: list | None = None, namespace=None,
           return_df: bool = True, infer_options=None,
           overwrite: bool | None = None) -> pd.DataFrame:
    """Ingest a source into the feature set's targets and register
    stats/schema (reference api.py:450, pandas engine). ``source`` may be a
    DataFrame, url, or a datastore Source object; ``targets`` a list of
    target objects/kind-names (default: offline parquet)."""
    from ..datastore.sources import resolve_source

    fset = _resolve_feature_set(featureset)
    if fset.spec.engine == "dask":
        return _ingest_dask(fset, source, targets=targets,
                            return_df=return_df, overwrite=overwrite)
    source = resolve_source(source).to_dataframe()
    if not isinstance(source, pd.DataFrame):
        raise ValueError("pandas-engine ingest expects a DataFrame or url")

    entities = fset.entity_names
    for entity in entities:
        if entity not in source.columns and source.index.name != entity:
            raise ValueError(f"entity column '{entity}' missing from source")

    # transform graph + windowed aggregations (pandas engine).
    # copy + reset index: never mutate the caller's frame, and rolling
    # assignment needs unique row labels. An entity carried on the index
    # is promoted to a column (the validation above accepted it there).
    keep_index = source.index.name in entities
    source = source.copy().reset_index(drop=not keep_index)
    from .steps import apply_aggregations, apply_transforms

    source = apply_transforms(source, fset.spec.transforms)
    source = apply_aggregations(source, fset.spec.aggregations, entities,
                                fset.spec.timestamp_key)

    # schema inference
    if not fset.spec.features:
        fset.spec.features = [
            {"name": c, "value_type": str(source[c].dtype)}
            for c in source.columns if c not in entities
        ]
    # stats
    try:
        fset.status.stats = {
            c: {
                "count": int(source[c].count()),
                "mean": float(source[c].mean())
                if source[c].dtype.kind in "if" else None,
                "min": source[c].min() if source[c].dtype.kind in "if" else None,
                "max": source[c].max() if source[c].dtype.kind in "if" else None,
            }
            for c in source.columns
        }
    except Exception:  # noqa: BLE001 - stats are best-effort
        pass

    path = fset._target_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if overwrite is False and os.path.isfile(path):
        existing = pd.read_parquet(path)
        source = pd.concat([existing, source], ignore_index=True)
        if entities:
            source = source.drop_duplicates(subset=entities, keep="last")
    source.to_parquet(path, index=False)
    target_records = [{"name": "parquet", "kind": "parquet",
                       "path": path, "updated": now_iso()}]

    # extra targets (nosql/stream/csv/sql/...) via the targets layer
    from ..datastore.targets import resolve_target

    project = getattr(fset.metadata, "project", "") or \
        run_config("default_project")
    for target in (targets if targets is not None
                   else fset.spec.targets or []):
        if isinstance(target, str) and target == "parquet":
            continue
        target_obj = resolve_target(target)
        namespacer = getattr(target_obj, "set_namespace", None)
        if namespacer:
            # always namespaced — a user-supplied shared url (e.g. one
            # redis for the whole cluster) must not collide row keys
            # across feature sets
            namespacer(project, fset.name)
        if not target_obj.path:
            target_obj.path = target_obj.default_path(project, fset.name)
        target_obj.write_dataframe(source, key_columns=entities,
                                   timestamp_key=fset.spec.timestamp_key)
        target_records.append(target_obj.status_record())

    fset.status.targets = target_records
    fset.status.state = "ready"
    fset.save()
    logger.info("ingested feature set", name=fset.name, rows=len(source),
                path=path)
    return source if return_df else None


def _ingest_dask(fset: FeatureSet, source, targets=None,
                 return_df: bool = True, overwrite: bool | None = None):
    """Dask-engine ingest (reference analog: storey/spark ingest engines;
    here dask.dataframe keeps large ParquetSource/CsvSource ingests
    out-of-core). Gated on the dask package; windowed aggregations need the
    pandas engine. Extra (non-parquet) targets materialize the frame."""
    import dask.dataframe as dd  # gated import

    if fset.spec.aggregations:
        raise ValueError(
            "windowed aggregations are not supported by the dask ingest "
            "engine — use engine='pandas' for this feature set")
    from ..datastore.sources import resolve_source

    src = resolve_source(source)
    path = getattr(src, "path", "") or ""
    if isinstance(source, pd.DataFrame):
        ddf = dd.from_pandas(source, npartitions=4)
    elif path.endswith(".parquet") or path.endswith(".pq"):
        ddf = dd.read_parquet(path)
    elif path.endswith(".csv"):
        ddf = dd.read_csv(path)
    else:
        ddf = dd.from_pandas(src.to_dataframe(), npartitions=4)

    from .steps import apply_transforms

    if fset.spec.transforms:
        meta = apply_transforms(ddf.head(10), fset.spec.transforms)
        ddf = ddf.map_partitions(
            lambda part: apply_transforms(part, fset.spec.transforms),
            meta=meta)

    entities = fset.entity_names
    for entity in entities:
        if entity not in ddf.columns:
            raise ValueError(f"entity column '{entity}' missing from source")
    if not fset.spec.features:
        fset.spec.features = [
            {"name": c, "value_type": str(dtype)}
            for c, dtype in ddf.dtypes.items() if c not in entities
        ]
    out_path = fset._target_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    if overwrite is False and os.path.exists(out_path):
        # append + last-wins dedupe per entity, matching the pandas path
        existing = dd.read_parquet(out_path)
        ddf = dd.concat([existing, ddf])
        if entities:
            ddf = ddf.drop_duplicates(subset=entities, keep="last")
        # collect before rewriting the directory being read
        ddf = dd.from_pandas(ddf.compute(), npartitions=4)
    # a directory of part files (pd.read_parquet loads it transparently)
    ddf.to_parquet(out_path, write_index=False)
    target_records = [{"name": "parquet", "kind": "parquet",
                       "path": out_path, "updated": now_iso()}]

    extra_targets = targets if targets is not None else \
        (fset.spec.targets or [])
    if extra_targets:
        from ..datastore.targets import resolve_target

        project = getattr(fset.metadata, "project", "") or \
            run_config("default_project")
        materialized = ddf.compute()
        for target in extra_targets:
            if isinstance(target, str) and target == "parquet":
                continue
            target_obj = resolve_target(target)
            if not target_obj.path:
                target_obj.path = target_obj.default_path(project, fset.name)
            target_obj.write_dataframe(
                materialized, key_columns=entities,
                timestamp_key=fset.spec.timestamp_key)
            target_records.append(target_obj.status_record())

    fset.status.targets = target_records
    fset.status.state = "ready"
    fset.save()
    logger.info("ingested feature set (dask)", name=fset.name,
                path=out_path)
    return ddf.compute() if return_df else None


def preview(featureset: Union[FeatureSet, str], source, limit: int = 20):
    fset = _resolve_feature_set(featureset)
    if isinstance(source, str):
        from ..datastore import store_manager

        source = store_manager.object(url=source).as_df()
    return source.head(limit)


class OfflineVectorResponse:
    """Result of get_offline_features (reference api.py OfflineVectorResponse)."""

    def __init__(self, df: pd.DataFrame, vector: FeatureVector):
        self._df = df
        self.vector = vector
        self.status = "completed"

    def to_dataframe(self) -> pd.DataFrame:
        return self._df

    def to_parquet(self, target_path: str, **kw):
        os.makedirs(os.path.dirname(target_path) or ".", exist_ok=True)
        self._df.to_parquet(target_path, **kw)
        return target_path

    def to_csv(self, target_path: str, **kw):
        os.makedirs(os.path.dirname(target_path) or ".", exist_ok=True)
        self._df.to_csv(target_path, index=False, **kw)
        return target_path


def _resolve_vector(vector: Union[str, FeatureVector],
                    project: str = "") -> FeatureVector:
    if isinstance(vector, FeatureVector):
        return vector
    from ..db import get_run_db

    name = vector
    if vector.startswith("store://feature-vectors/"):
        body = vector[len("store://feature-vectors/"):]
        project, _, name = body.partition("/")
    struct = get_run_db().get_feature_vector(name, project=project)
    return FeatureVector.from_dict(struct)


def get_offline_features(feature_vector: Union[str, FeatureVector],
                         entity_rows: pd.DataFrame | None = None,
                         target=None, drop_columns: list | None = None,
                         with_indexes: bool = False,
                         engine: str = "local",
                         engine_args: dict | None = None
                         ) -> OfflineVectorResponse:
    """Join the vector's feature sets into one offline dataframe
    (reference api.py:99). ``engine`` selects the merger: local (pandas),
    partitioned (out-of-core single host), dask, spark — see
    retrieval.py (reference analog retrieval/base.py:30)."""
    from .retrieval import get_merger

    vector = _resolve_vector(feature_vector)
    project = getattr(vector.metadata, "project", "") or ""
    merger = get_merger(engine, vector, project=project,
                        **(engine_args or {}))
    merged = merger.merge(entity_rows=entity_rows, drop_columns=drop_columns,
                          with_indexes=with_indexes)
    response = OfflineVectorResponse(merged, vector)
    if target:
        path = target if isinstance(target, str) else getattr(
            target, "path", "")
        if path:
            response.to_parquet(path)
    return response


class OnlineVectorService:
    """Key→features lookup service (reference feature_vector.py:910)."""

    def __init__(self, vector: FeatureVector, impute_policy: dict | None = None):
        self.vector = vector
        self.impute_policy = impute_policy or {}
        self._tables: list[tuple[list[str], pd.DataFrame]] = []
        self._targets: list[tuple] = []  # (entities, wanted, columns, target)
        self._initialize()

    def _initialize(self):
        project = getattr(self.vector.metadata, "project", "") or ""
        by_set: dict[str, list[str]] = {}
        for set_name, feature in self.vector.parse_features():
            by_set.setdefault(set_name, []).append(feature)
        for set_name, wanted in by_set.items():
            fset = _resolve_feature_set(set_name, project=project)
            entities = fset.entity_names
            features = ["*"] if "*" in wanted else wanted
            target = self._online_target(fset)
            if target is not None:
                # key-value lookups ride the ingested ONLINE target
                # (sqlite kv single-host; redis for a shared serving
                # fleet) instead of loading the offline frame in memory.
                # ONE target per feature set: multi-feature vectors do a
                # single row fetch, not one per feature. Known columns
                # seed NaN placeholders when a row is missing so the
                # impute policy fires like the in-memory path.
                columns = (features if "*" not in features
                           else [f["name"] if isinstance(f, dict)
                                 else f.name
                                 for f in fset.spec.features or []])
                self._targets.append((entities, features, columns, target))
                continue
            df = fset.to_dataframe()
            if "*" not in features:
                df = df[entities + features]
            self._tables.append((entities, df.set_index(entities)))

    @staticmethod
    def _online_target(fset):
        from ..datastore.targets import resolve_target

        for record in (getattr(fset.status, "targets", None) or []):
            if record.get("kind") in ("nosql", "redisnosql"):
                target = resolve_target(
                    {"kind": record["kind"],
                     "path": record.get("path", "")})
                if record.get("prefix"):
                    target._prefix = record["prefix"]
                return target
        return None

    @property
    def status(self):
        return "ready"

    def get(self, entity_rows: list[dict], as_list: bool = False):
        """entity_rows: [{entity: value, ...}] → feature dicts (or lists)."""
        out = []
        for row in entity_rows:
            features: dict = {}
            for entities, wanted, columns, target in self._targets:
                try:
                    record = target.get([row[e] for e in entities])
                except KeyError:
                    record = None
                if record:
                    if "*" not in wanted:
                        record = {k: v for k, v in record.items()
                                  if k in wanted}
                    features.update({k: v for k, v in record.items()
                                     if k not in entities})
                else:
                    # missing row: NaN placeholders (like the in-memory
                    # path) so the impute policy below can fill them
                    for col in columns:
                        features.setdefault(col, float("nan"))
            for entities, table in self._tables:
                try:
                    key = tuple(row[e] for e in entities)
                    if len(key) == 1:
                        key = key[0]
                    record = table.loc[key]
                    if isinstance(record, pd.DataFrame):
                        record = record.iloc[-1]
                    features.update(record.to_dict())
                except (KeyError, TypeError):
                    # entity missing from this table → NaN placeholders so
                    # the impute policy can fill them
                    for col in table.columns:
                        features.setdefault(col, float("nan"))
            # imputation
            for key, value in list(features.items()):
                if pd.isna(value):
                    policy = self.impute_policy.get(
                        key, self.impute_policy.get("*"))
                    if policy is not None:
                        features[key] = policy
            out.append(list(features.values()) if as_list else features)
        return out

    def close(self):
        self._tables = []
        for _, _, _, target in self._targets:
            closer = getattr(target, "close", None)
            if closer:
                closer()
        self._targets = []


def get_online_feature_service(feature_vector: Union[str, FeatureVector],
                               impute_policy: dict | None = None,
                               **kwargs) -> OnlineVectorService:
    """Create an online lookup service (reference api.py:296)."""
    vector = _resolve_vector(feature_vector)
    return OnlineVectorService(vector, impute_policy=impute_policy)
