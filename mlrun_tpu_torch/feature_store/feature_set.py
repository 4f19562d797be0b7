"""Feature store objects — the port's copy of ``mlrun_tpu/feature_store/
feature_set.py``: ``Entity``, ``Feature``, ``FeatureSet`` and
``FeatureVector`` on the port's ``model.ModelObj``, stored through the run
db (``store_feature_set`` / ``store_feature_vector``)."""

from __future__ import annotations

import os
from typing import Optional

from ..config import home_dir, run_config
from ..model import ModelObj


class Entity(ModelObj):
    _dict_fields = ["name", "value_type", "labels"]

    def __init__(self, name=None, value_type=None, labels=None):
        self.name = name
        self.value_type = value_type or "str"
        self.labels = labels or {}


class Feature(ModelObj):
    _dict_fields = ["name", "value_type", "labels", "aggregate"]

    def __init__(self, name=None, value_type=None, labels=None, aggregate=None):
        self.name = name
        self.value_type = value_type or "float"
        self.labels = labels or {}
        self.aggregate = aggregate


class FeatureSetSpec(ModelObj):
    _dict_fields = ["entities", "features", "targets", "timestamp_key",
                    "description", "engine", "label_column", "source",
                    "aggregations", "transforms"]

    def __init__(self, entities=None, features=None, targets=None,
                 timestamp_key=None, description=None, engine=None,
                 label_column=None, source=None, aggregations=None,
                 transforms=None):
        self.entities = entities or []
        self.features = features or []
        self.targets = targets or []
        self.timestamp_key = timestamp_key
        self.description = description
        self.engine = engine or "pandas"
        self.label_column = label_column
        self.source = source
        self.aggregations = aggregations or []
        self.transforms = transforms or []


class FeatureSetStatus(ModelObj):
    _dict_fields = ["state", "targets", "stats", "preview"]

    def __init__(self, state=None, targets=None, stats=None, preview=None):
        self.state = state or "created"
        self.targets = targets or []
        self.stats = stats or {}
        self.preview = preview


class FeatureSet(ModelObj):
    kind = "FeatureSet"
    _dict_fields = ["kind", "metadata", "spec", "status"]

    def __init__(self, name: str = "", description: str = "",
                 entities: list | None = None, timestamp_key: str = "",
                 engine: str = "pandas", label_column: str = ""):
        from ..artifacts.base import ArtifactMetadata

        self.metadata = ArtifactMetadata(key=name)
        self.metadata.name = name
        self.spec = FeatureSetSpec(
            entities=[e if isinstance(e, dict) else
                      (e.to_dict() if isinstance(e, Entity)
                       else {"name": e}) for e in (entities or [])],
            timestamp_key=timestamp_key, description=description,
            engine=engine, label_column=label_column)
        self.status = FeatureSetStatus()

    @classmethod
    def from_dict(cls, struct=None, deprecated_fields=None):
        struct = struct or {}
        obj = cls(name=struct.get("metadata", {}).get("name", ""))
        obj.spec = FeatureSetSpec.from_dict(struct.get("spec", {}))
        obj.status = FeatureSetStatus.from_dict(struct.get("status", {}))
        meta = struct.get("metadata", {})
        for key, value in meta.items():
            setattr(obj.metadata, key, value)
        return obj

    def to_dict(self, exclude=None):
        return {
            "kind": self.kind,
            "metadata": {"name": self.name,
                         "project": getattr(self.metadata, "project", None),
                         "tag": getattr(self.metadata, "tag", None),
                         "uid": getattr(self.metadata, "uid", None)},
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @property
    def name(self) -> str:
        return getattr(self.metadata, "name", None) or self.metadata.key

    @property
    def uri(self) -> str:
        project = getattr(self.metadata, "project", None) or \
            run_config("default_project")
        return f"store://feature-sets/{project}/{self.name}"

    @property
    def entity_names(self) -> list[str]:
        return [e.get("name") for e in self.spec.entities]

    def add_entity(self, name: str, value_type: str = "str"):
        self.spec.entities.append({"name": name, "value_type": value_type})
        return self

    def add_feature(self, name: str, value_type: str = "float"):
        self.spec.features.append({"name": name, "value_type": value_type})
        return self

    def set_targets(self, targets: list | None = None,
                    with_defaults: bool = True):
        self.spec.targets = targets if targets is not None else (
            ["parquet"] if with_defaults else [])
        return self

    def add_aggregation(self, column: str, operations: list[str],
                        windows: list[str] | None = None,
                        name: str | None = None):
        """Windowed aggregation (reference FeatureSet.add_aggregation):
        produces <name>_<op>_<window> features at ingest."""
        self.spec.aggregations.append({
            "name": name or column, "column": column,
            "operations": list(operations),
            "windows": list(windows) if windows else []})
        return self

    def add_transform_step(self, step):
        """Append a transform step instance or {class_name, class_args};
        instances are stored in serializable dict form so the feature set
        survives the DB roundtrip."""
        from .steps import step_to_dict

        self.spec.transforms.append(step_to_dict(step))
        return self

    def _target_path(self, project: str | None = None) -> str:
        project = project or getattr(self.metadata, "project", None) or \
            run_config("default_project")
        return os.path.join(home_dir(), "feature-store", project,
                            f"{self.name}.parquet")

    def to_dataframe(self, columns=None):
        import pandas as pd

        path = (self.status.targets[0].get("path")
                if self.status.targets else self._target_path())
        df = pd.read_parquet(path)
        if columns:
            df = df[columns]
        return df

    def save(self, tag: str = "", versioned: bool = True):
        from ..db import get_run_db

        self.metadata.tag = tag or getattr(self.metadata, "tag", None) \
            or "latest"
        get_run_db().store_feature_set(
            self.to_dict(), name=self.name,
            project=getattr(self.metadata, "project", "") or "",
            tag=self.metadata.tag)
        return self


class FeatureVectorSpec(ModelObj):
    _dict_fields = ["features", "label_feature", "description",
                    "with_indexes"]

    def __init__(self, features=None, label_feature=None, description=None,
                 with_indexes=None):
        self.features = features or []  # ["set_name.feature" | "set.*"]
        self.label_feature = label_feature
        self.description = description
        self.with_indexes = with_indexes


class FeatureVector(ModelObj):
    kind = "FeatureVector"
    _dict_fields = ["kind", "metadata", "spec", "status"]

    def __init__(self, name: str = "", features: list | None = None,
                 label_feature: str = "", description: str = "",
                 with_indexes: bool = False):
        from ..artifacts.base import ArtifactMetadata

        self.metadata = ArtifactMetadata(key=name)
        self.metadata.name = name
        self.spec = FeatureVectorSpec(
            features=features or [], label_feature=label_feature,
            description=description, with_indexes=with_indexes)
        self.status = FeatureSetStatus()

    @classmethod
    def from_dict(cls, struct=None, deprecated_fields=None):
        struct = struct or {}
        obj = cls(name=struct.get("metadata", {}).get("name", ""))
        obj.spec = FeatureVectorSpec.from_dict(struct.get("spec", {}))
        meta = struct.get("metadata", {})
        for key, value in meta.items():
            setattr(obj.metadata, key, value)
        return obj

    def to_dict(self, exclude=None):
        return {
            "kind": self.kind,
            "metadata": {"name": self.name,
                         "project": getattr(self.metadata, "project", None),
                         "tag": getattr(self.metadata, "tag", None)},
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @property
    def name(self) -> str:
        return getattr(self.metadata, "name", None) or self.metadata.key

    @property
    def uri(self) -> str:
        project = getattr(self.metadata, "project", None) or \
            run_config("default_project")
        return f"store://feature-vectors/{project}/{self.name}"

    def parse_features(self) -> list[tuple[str, str]]:
        """Return [(feature_set_name, feature_or_star)]."""
        out = []
        for ref in self.spec.features:
            if "." not in ref:
                raise ValueError(
                    f"feature reference '{ref}' must be '<set>.<feature>'")
            set_name, feature = ref.rsplit(".", 1)
            out.append((set_name, feature))
        return out

    def save(self, tag: str = "", versioned: bool = True):
        from ..db import get_run_db

        self.metadata.tag = tag or getattr(self.metadata, "tag", None) \
            or "latest"
        get_run_db().store_feature_vector(
            self.to_dict(), name=self.name,
            project=getattr(self.metadata, "project", "") or "",
            tag=self.metadata.tag)
        return self
