"""Schedule API schemas (reference analog: mlrun/common/schemas/schedule.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class ScheduleKinds(str, enum.Enum):
    job = "job"
    pipeline = "pipeline"


class ScheduleRecord(pydantic.BaseModel):
    name: str
    project: str
    kind: ScheduleKinds = ScheduleKinds.job
    cron_trigger: str  # standard 5-field cron
    scheduled_object: dict = pydantic.Field(default_factory=dict)
    labels: dict = pydantic.Field(default_factory=dict)
    creation_time: Optional[str] = None
    last_run_uri: Optional[str] = None
    next_run_time: Optional[str] = None
    concurrency_limit: int = 1

    model_config = pydantic.ConfigDict(extra="allow")
