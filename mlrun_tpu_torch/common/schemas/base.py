"""Shared pydantic bases for the client/server API contract
(reference analog: mlrun/common/schemas/object.py)."""

from __future__ import annotations

from datetime import datetime
from typing import Optional

import pydantic


class ObjectMetadata(pydantic.BaseModel):
    name: str
    project: Optional[str] = None
    tag: Optional[str] = None
    uid: Optional[str] = None
    labels: dict = pydantic.Field(default_factory=dict)
    annotations: dict = pydantic.Field(default_factory=dict)
    created: Optional[datetime] = None
    updated: Optional[datetime] = None

    model_config = pydantic.ConfigDict(extra="allow")


class ObjectSpec(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="allow")


class ObjectStatus(pydantic.BaseModel):
    state: Optional[str] = None
    model_config = pydantic.ConfigDict(extra="allow")


class ObjectKind(pydantic.BaseModel):
    kind: str = ""
    metadata: ObjectMetadata
    spec: ObjectSpec = pydantic.Field(default_factory=ObjectSpec)
    status: ObjectStatus = pydantic.Field(default_factory=ObjectStatus)
