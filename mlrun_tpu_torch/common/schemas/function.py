"""Function API schemas (reference analog: mlrun/common/schemas/function.py)."""

from __future__ import annotations

import enum

import pydantic


class FunctionState(str, enum.Enum):
    unknown = "unknown"
    ready = "ready"
    error = "error"
    deploying = "deploying"
    running = "running"
    pending = "pending"
    build = "build"


class FunctionRecord(pydantic.BaseModel):
    kind: str = ""
    metadata: dict = pydantic.Field(default_factory=dict)
    spec: dict = pydantic.Field(default_factory=dict)
    status: dict = pydantic.Field(default_factory=dict)

    model_config = pydantic.ConfigDict(extra="allow")
