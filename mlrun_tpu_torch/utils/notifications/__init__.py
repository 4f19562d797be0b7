"""Run and alert notifications (console, slack, webhook, mail, ipython,
git) and the pusher."""

from .notification import (  # noqa: F401
    ConsoleNotification,
    MailNotification,
    NotificationBase,
    SlackNotification,
    WebhookNotification,
    notification_types,
)
from .pusher import NotificationPusher  # noqa: F401
