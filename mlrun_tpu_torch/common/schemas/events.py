"""Event schemas (reference analog: mlrun/common/schemas/events.py +
alert trigger event kinds)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class EventKind(str, enum.Enum):
    run_failed = "run-failed"
    run_completed = "run-completed"
    drift_detected = "drift-detected"
    drift_suspected = "drift-suspected"
    endpoint_failed = "endpoint-failed"
    custom = "custom"


class Event(pydantic.BaseModel):
    kind: EventKind = EventKind.custom
    project: Optional[str] = None
    entity: Optional[str] = None
    value: Optional[float] = None
    created: Optional[str] = None
    body: dict = {}
