"""Model-endpoint schemas for monitoring
(reference analog: mlrun/common/schemas/model_monitoring/model_endpoints.py)."""

from __future__ import annotations

from typing import Optional

import pydantic


class ModelEndpoint(pydantic.BaseModel):
    uid: Optional[str] = None
    project: str = ""
    name: str = ""
    function_uri: str = ""
    model_uri: str = ""
    model_class: str = ""
    state: str = "ready"
    feature_names: list = pydantic.Field(default_factory=list)
    label_names: list = pydantic.Field(default_factory=list)
    metrics: dict = pydantic.Field(default_factory=dict)
    first_request: Optional[str] = None
    last_request: Optional[str] = None
    error_count: int = 0
    drift_status: str = ""

    model_config = pydantic.ConfigDict(extra="allow")
