"""Workflow schemas (reference analog: mlrun/common/schemas/workflow.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class WorkflowState(str, enum.Enum):
    running = "running"
    completed = "completed"
    error = "error"


class WorkflowSpec(pydantic.BaseModel):
    name: str = ""
    code: Optional[str] = None
    path: Optional[str] = None
    handler: Optional[str] = None
    engine: str = "local"
    arguments: dict = {}


class WorkflowStatusOut(pydantic.BaseModel):
    workflow_id: str
    state: WorkflowState = WorkflowState.running
    error: Optional[str] = None
