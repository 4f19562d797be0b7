"""Project API schemas (reference analog: mlrun/common/schemas/project.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class ProjectState(str, enum.Enum):
    unknown = "unknown"
    creating = "creating"
    online = "online"
    offline = "offline"
    archived = "archived"
    deleting = "deleting"


class ProjectRecord(pydantic.BaseModel):
    kind: str = "project"
    metadata: dict = pydantic.Field(default_factory=dict)
    spec: dict = pydantic.Field(default_factory=dict)
    status: dict = pydantic.Field(default_factory=dict)

    model_config = pydantic.ConfigDict(extra="allow")


class ProjectOut(pydantic.BaseModel):
    name: str
    state: ProjectState = ProjectState.online
    description: Optional[str] = None
