"""Background task schemas (reference analog: mlrun/common/schemas/background_task.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class BackgroundTaskState(str, enum.Enum):
    created = "created"
    running = "running"
    succeeded = "succeeded"
    failed = "failed"

    @staticmethod
    def terminal_states():
        return [BackgroundTaskState.succeeded, BackgroundTaskState.failed]


class BackgroundTask(pydantic.BaseModel):
    name: str
    project: Optional[str] = None
    state: BackgroundTaskState = BackgroundTaskState.created
    created: Optional[str] = None
    updated: Optional[str] = None
    timeout: Optional[int] = None
    error: Optional[str] = None
