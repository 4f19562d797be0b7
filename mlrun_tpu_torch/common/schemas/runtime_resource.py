"""Runtime resource schemas (reference analog:
mlrun/common/schemas/runtime_resource.py)."""

from __future__ import annotations

from typing import Optional

import pydantic


class RuntimeResource(pydantic.BaseModel):
    """One tracked execution resource (pod / JobSet / local process) —
    the durable row behind service restart recovery."""

    project: str
    uid: str
    kind: Optional[str] = None
    resource_id: Optional[str] = None
    started: Optional[float] = None


class RuntimeResourcesOutput(pydantic.BaseModel):
    resources: list[RuntimeResource] = []
