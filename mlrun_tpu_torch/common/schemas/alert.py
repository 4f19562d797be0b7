"""Alert schemas (reference analog: mlrun/common/schemas/alert.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class AlertSeverity(str, enum.Enum):
    low = "low"
    medium = "medium"
    high = "high"


class AlertState(str, enum.Enum):
    inactive = "inactive"
    active = "active"


class AlertConfigRecord(pydantic.BaseModel):
    name: str
    project: str = ""
    summary: str = ""
    severity: AlertSeverity = AlertSeverity.medium
    entity_kind: str = "job"  # job | model-endpoint
    entity_id: str = "*"
    trigger_events: list = pydantic.Field(default_factory=list)
    criteria: dict = pydantic.Field(default_factory=dict)  # {count, period_seconds}
    notifications: list = pydantic.Field(default_factory=list)
    reset_policy: str = "auto"  # auto | manual
    state: AlertState = AlertState.inactive
    count: int = 0
    # silencing window: while now < silence_until (ISO timestamp) the alert
    # evaluates but does NOT fire or notify (maintenance windows, known
    # incidents). Cleared by writing an empty string.
    silence_until: str = ""

    model_config = pydantic.ConfigDict(extra="allow")
