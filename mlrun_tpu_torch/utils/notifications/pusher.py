"""Notification pusher — the port's copy of
``mlrun_tpu/utils/notifications/pusher.py``: pushes a run's notification
specs whose ``when`` holds its state, and records each one's status."""

from __future__ import annotations

from ..helpers import now_iso
from ..logger import logger
from .notification import notification_types


class NotificationPusher:
    def __init__(self, runs: list, secret_resolver=None):
        """``secret_resolver(project, params) -> params`` resolves masked
        (secret-backed) notification params — available server-side only;
        without it masked notifications are skipped (the service pushes
        them when the run reaches a terminal state)."""
        self._runs = runs
        self._secret_resolver = secret_resolver

    def push(self):
        for run in self._runs:
            run_dict = run.to_dict() if hasattr(run, "to_dict") else run
            state = run_dict.get("status", {}).get("state")
            for spec in run_dict.get("spec", {}).get("notifications", []):
                if isinstance(spec, dict):
                    when = spec.get("when") or ["completed", "error"]
                    if state not in when:
                        continue
                    self._push_one(spec, run_dict, state)

    def _push_one(self, spec: dict, run_dict: dict, state: str):
        kind = spec.get("kind", "console")
        cls = notification_types.get(kind)
        if cls is None:
            logger.warning("unknown notification kind", kind=kind)
            return
        meta = run_dict.get("metadata", {})
        params = spec.get("params", {}) or {}
        if params.get("secret"):
            if self._secret_resolver is None:
                logger.debug(
                    "skipping secret-backed notification (pushed "
                    "server-side)", kind=kind)
                return
            try:
                params = self._secret_resolver(meta.get("project", ""),
                                               params)
            except Exception as exc:  # noqa: BLE001
                spec["status"] = "error"
                logger.warning("notification secret resolution failed",
                               kind=kind, error=str(exc))
                return
        message = spec.get("message") or (
            f"run {meta.get('project')}/{meta.get('name')} finished: {state}")
        severity = spec.get("severity", "info")
        try:
            cls(spec.get("name", ""), params).push(
                message, severity, [run_dict])
            spec["status"] = "sent"
            spec["sent_time"] = now_iso()
        except Exception as exc:  # noqa: BLE001 - notification failure non-fatal
            spec["status"] = "error"
            logger.warning("failed to push notification", kind=kind,
                           error=str(exc))
