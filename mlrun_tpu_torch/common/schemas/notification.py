"""Notification schemas (reference analog:
mlrun/common/schemas/notification.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class NotificationKind(str, enum.Enum):
    console = "console"
    slack = "slack"
    webhook = "webhook"
    mail = "mail"


class NotificationSeverity(str, enum.Enum):
    info = "info"
    warning = "warning"
    error = "error"


class NotificationStatus(str, enum.Enum):
    pending = "pending"
    sent = "sent"
    error = "error"


class Notification(pydantic.BaseModel):
    kind: NotificationKind = NotificationKind.console
    name: str = ""
    message: str = ""
    severity: NotificationSeverity = NotificationSeverity.info
    when: list[str] = ["completed", "error"]
    condition: str = ""
    # either inline params or a {"secret": <key>} reference after
    # server-side masking
    params: dict = {}
    status: Optional[NotificationStatus] = None
    sent_time: Optional[str] = None
