"""Feature-store schemas (reference analog:
mlrun/common/schemas/feature_store.py)."""

from __future__ import annotations

from typing import Optional

import pydantic

from .base import ObjectMetadata


class Entity(pydantic.BaseModel):
    name: str
    value_type: Optional[str] = None
    labels: dict = {}


class Feature(pydantic.BaseModel):
    name: str
    value_type: Optional[str] = None
    labels: dict = {}


class FeatureSetSpec(pydantic.BaseModel):
    entities: list[Entity] = []
    features: list[Feature] = []
    engine: str = "pandas"
    timestamp_key: Optional[str] = None
    targets: list = []


class FeatureSetRecord(pydantic.BaseModel):
    metadata: ObjectMetadata
    spec: FeatureSetSpec = FeatureSetSpec()
    status: dict = {}


class FeatureVectorSpec(pydantic.BaseModel):
    features: list[str] = []
    label_feature: Optional[str] = None
    with_indexes: bool = False


class FeatureVectorRecord(pydantic.BaseModel):
    metadata: ObjectMetadata
    spec: FeatureVectorSpec = FeatureVectorSpec()
    status: dict = {}
