"""Artifact API schemas (reference analog: mlrun/common/schemas/artifact.py)."""

from __future__ import annotations

import pydantic


class ArtifactRecord(pydantic.BaseModel):
    kind: str = "artifact"
    metadata: dict = pydantic.Field(default_factory=dict)
    spec: dict = pydantic.Field(default_factory=dict)
    status: dict = pydantic.Field(default_factory=dict)

    model_config = pydantic.ConfigDict(extra="allow")
