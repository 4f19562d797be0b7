"""Model artifacts — the port's copy of ``mlrun_tpu/artifacts/model.py``.

A model artifact is a directory-ish artifact: a primary model file plus
``extra_data`` side files (metrics json, tokenizer, a checkpoint dir, ...)
and framework/algorithm metadata used by serving and monitoring.
``get_model`` resolves a ``store://models/...`` uri through the run db to
(local model file, ``ModelArtifact``, extra data), a directory to its
first entry ending in the suffix, anything else through the datastore.
"""

from __future__ import annotations

import os
from typing import Optional

from .base import Artifact


class ModelArtifact(Artifact):
    kind = "model"
    _store_prefix = "models"

    def __init__(self, key=None, body=None, model_file=None, model_dir=None,
                 metrics=None, parameters=None, inputs=None, outputs=None,
                 framework=None, algorithm=None, feature_vector=None,
                 feature_weights=None, extra_data=None, **kwargs):
        super().__init__(key, body=body, **kwargs)
        self.kind = "model"
        self.model_file = model_file
        self.model_dir = model_dir
        self.metrics = metrics or {}
        self.parameters = parameters or {}
        self.inputs = inputs or []      # feature schema
        self.outputs = outputs or []    # label schema
        self.framework = framework
        self.algorithm = algorithm
        self.feature_vector = feature_vector
        self.feature_weights = feature_weights
        self.spec.extra_data = extra_data or {}

    def to_dict(self, exclude=None):
        out = super().to_dict(exclude)
        spec = out.setdefault("spec", {})
        for field in ("model_file", "model_dir", "metrics", "parameters",
                      "inputs", "outputs", "framework", "algorithm",
                      "feature_vector", "feature_weights"):
            value = getattr(self, field, None)
            if value:
                spec[field] = value
        return out

    @classmethod
    def from_dict(cls, struct=None, deprecated_fields=None):
        obj = super().from_dict(struct or {})
        spec = (struct or {}).get("spec", {})
        for field in ("model_file", "model_dir", "metrics", "parameters",
                      "inputs", "outputs", "framework", "algorithm",
                      "feature_vector", "feature_weights"):
            if field in spec:
                setattr(obj, field, spec[field])
        return obj

    def before_log(self):
        if self.model_file:
            self.spec.format = self.spec.format or os.path.splitext(
                self.model_file)[-1].lstrip(".")

    def upload(self, data_item_factory=None):
        """Upload model file/dir + extra_data files under target_path."""
        from ..datastore import store_manager

        target = self.spec.target_path
        if not target:
            raise ValueError("model artifact has no target_path")
        if self.get_body() is not None:
            store, path = store_manager.get_or_create_store(
                os.path.join(target, self.model_file or self.key))
            body = self.get_body()
            store.put(path, body)
            self.spec.size = len(body)
            return
        src_dir = self.model_dir or (
            os.path.dirname(self.model_file) if self.model_file else None)
        if self.model_file and os.path.isfile(self.model_file):
            fname = os.path.basename(self.model_file)
            store, path = store_manager.get_or_create_store(
                os.path.join(target, fname))
            store.upload(path, self.model_file)
            self.spec.size = os.path.getsize(self.model_file)
            self.model_file = fname
        elif src_dir and os.path.isdir(src_dir):
            from .base import upload_directory

            self.spec.size, self.spec.hash = upload_directory(target,
                                                              src_dir)
        # upload extra_data values that are local files
        for key, value in list(self.spec.extra_data.items()):
            if isinstance(value, str) and os.path.isfile(value):
                fname = os.path.basename(value)
                store, path = store_manager.get_or_create_store(
                    os.path.join(target, fname))
                store.upload(path, value)
                self.spec.extra_data[key] = os.path.join(target, fname)


def get_model(model_dir: str, suffix: str = "") -> tuple[str, Optional["ModelArtifact"], dict]:
    """Resolve a model uri/dir to (local_model_file, model_artifact,
    extra_data)."""
    from ..datastore import store_manager

    model_spec = None
    extra_data = {}
    if model_dir.startswith("store://"):
        item = store_manager.object(url=model_dir)
        meta = item.meta or {}
        model_spec = ModelArtifact.from_dict(meta)
        target = model_spec.spec.target_path
        model_file = os.path.join(target, model_spec.model_file or "")
        item = store_manager.object(url=model_file)
        local = item.local()
        extra_data = model_spec.spec.extra_data or {}
        return local, model_spec, extra_data
    if os.path.isdir(model_dir):
        candidates = [f for f in os.listdir(model_dir)
                      if not suffix or f.endswith(suffix)]
        if not candidates:
            raise FileNotFoundError(f"no model file found in {model_dir}")
        return os.path.join(model_dir, candidates[0]), None, {}
    item = store_manager.object(url=model_dir)
    return item.local(), None, {}
