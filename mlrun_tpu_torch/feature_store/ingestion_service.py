"""Real-time ingestion service — the port's copy of ``mlrun_tpu/
feature_store/ingestion_service.py``.

Here the ingestion service is a serving-graph step (``FeatureSetIngestStep``)
that applies the feature set's transform graph per event and writes to the
online KV + appends to the offline parquet; ``ingestion_service_function``
builds a serving function around it.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import pandas as pd

from ..config import run_config
from .feature_set import FeatureSet
from .steps import apply_transforms


class FeatureSetIngestStep:
    """Serving-graph step: event body (dict or list of dicts) → ingest."""

    def __init__(self, context=None, name: str | None = None,
                 feature_set: str = "", project: str = "",
                 flush_every: int = 32, **kwargs):
        from ..datastore.targets import NoSqlTarget

        self.context = context
        self.name = name
        if not feature_set:
            raise ValueError("FeatureSetIngestStep needs a feature_set name")
        from ..db import get_run_db

        struct = get_run_db().get_feature_set(feature_set, project=project)
        self.fset = FeatureSet.from_dict(struct)
        self.entities = self.fset.entity_names
        self.flush_every = flush_every
        self._buffer: list[dict] = []
        self._lock = threading.Lock()
        self._kv = NoSqlTarget()
        self._kv.path = self._kv.default_path(
            project or getattr(self.fset.metadata, "project", None)
            or run_config("default_project"), self.fset.name)

    def do(self, body):
        rows = body if isinstance(body, list) else [body]
        frame = pd.DataFrame(rows)
        frame = apply_transforms(frame, self.fset.spec.transforms)
        # online target: immediate per-event upsert
        if self.entities:
            self._kv.write_dataframe(frame, key_columns=self.entities)
        # offline parquet: buffered appends
        with self._lock:
            self._buffer.extend(frame.to_dict("records"))
            if len(self._buffer) >= self.flush_every:
                self._flush_locked()
        return {"ingested": len(rows), "feature_set": self.fset.name}

    def _flush_locked(self):
        if not self._buffer:
            return
        frame = pd.DataFrame(self._buffer)
        self._buffer = []
        path = self.fset._target_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.isfile(path):
            frame = pd.concat([pd.read_parquet(path), frame],
                              ignore_index=True)
        if self.entities:
            frame = frame.drop_duplicates(subset=self.entities, keep="last")
        frame.to_parquet(path, index=False)

    def flush(self):
        with self._lock:
            self._flush_locked()

    def get(self, key_values: list) -> Optional[dict]:
        """Online lookup against the KV this service maintains."""
        return self._kv.get(key_values)


def ingestion_service_function(feature_set: FeatureSet | str,
                               name: str = "", project: str = ""):
    """Build a serving function whose graph ingests posted events into the
    feature set (deploy with fn.deploy() or serve via the asgi gateway)."""
    from ..run import new_function

    if isinstance(feature_set, FeatureSet):
        feature_set.save()
        fset_name = feature_set.name
        project = project or getattr(feature_set.metadata, "project", "") \
            or ""
    else:
        fset_name = feature_set
    fn = new_function(
        name or f"{fset_name}-ingest", kind="serving",
        project=project or run_config("default_project"))
    graph = fn.set_topology("flow")
    graph.to(class_name=FeatureSetIngestStep, name="ingest",
             feature_set=fset_name, project=project).respond()
    return fn
