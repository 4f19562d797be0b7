"""Client-spec pushed from server to SDK on connect
(reference analog: mlrun/common/schemas/client_spec.py,
server/api/api/endpoints/client_spec.py)."""

from __future__ import annotations

from typing import Optional

import pydantic


class ClientSpec(pydantic.BaseModel):
    version: Optional[str] = None
    namespace: Optional[str] = None
    default_project: Optional[str] = None
    artifact_path: Optional[str] = None
    default_image: Optional[str] = None
    gpu_defaults: dict = pydantic.Field(default_factory=dict)
    config_overrides: dict = pydantic.Field(default_factory=dict)
