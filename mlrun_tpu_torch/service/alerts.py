"""Alert and event processing — the port's copy of
``mlrun_tpu/service/alerts.py``: ``process_event`` matches an event against
a project's alert configs in the run db (trigger events, entity, count
within a period, the silence window, the reset policy) and pushes each
firing config's notifications; ``ALERT_TEMPLATES`` are the builtin
configs a project instantiates."""

from __future__ import annotations

from datetime import datetime, timedelta, timezone

from ..utils.helpers import now_iso
from ..utils.logger import logger

# (project, name) pairs already warned about a missing trigger_events
# list — one warning per config, not one per processed event
_warned_no_triggers: set = set()


def process_event(db, project: str, event_kind: str, event: dict) -> list:
    """Evaluate alert configs against an incoming event; fire notifications
    when criteria (count within period) are met. Returns fired alert names."""
    fired = []
    for config in db.list_alert_configs(project):
        # explicit trigger matching: a missing/empty trigger_events list
        # matches NOTHING (it used to silently match every event kind —
        # a config created without triggers would fire on anything);
        # catch-all is opt-in via the explicit "*" wildcard
        triggers = config.get("trigger_events") or []
        if not triggers:
            if (project, config.get("name")) not in _warned_no_triggers:
                _warned_no_triggers.add((project, config.get("name")))
                logger.warning(
                    "alert config has no trigger_events; it will never "
                    "fire (use [\"*\"] for an explicit catch-all)",
                    alert=config.get("name"), project=project)
            continue
        if "*" not in triggers and event_kind not in triggers:
            continue
        entity = config.get("entity_id", "*")
        if entity not in ("*", event.get("entity_id", "*")):
            continue
        criteria = config.get("criteria") or {}
        required = int(criteria.get("count", 1))
        period = float(criteria.get("period_seconds", 3600))
        since = datetime.now(timezone.utc) - timedelta(seconds=period)
        if _silenced(config):
            continue
        events = db.list_events(project, kind=event_kind,
                                since=since.isoformat())
        if len(events) >= required:
            if config.get("state") == "active" and \
                    config.get("reset_policy", "auto") == "manual":
                continue
            config["state"] = "active"
            config["count"] = config.get("count", 0) + 1
            config["last_fired"] = now_iso()
            db.store_alert_config(config.get("name"), config, project)
            _notify(config, event)
            fired.append(config.get("name"))
        elif config.get("reset_policy", "auto") == "auto" and \
                config.get("state") == "active":
            config["state"] = "inactive"
            db.store_alert_config(config.get("name"), config, project)
    return fired


def _silenced(config: dict) -> bool:
    """True while the config's silence window is open (silence_until ISO
    timestamp in the future): criteria still evaluate, nothing fires."""
    until = config.get("silence_until") or ""
    if not until:
        return False
    try:
        parsed = datetime.fromisoformat(until.replace("Z", "+00:00"))
    except ValueError:
        return False
    if parsed.tzinfo is None:
        parsed = parsed.replace(tzinfo=timezone.utc)
    return datetime.now(timezone.utc) < parsed


def _notify(config: dict, event: dict):
    from ..utils.notifications.notification import notification_types

    for spec in config.get("notifications") or [{"kind": "console"}]:
        kind = spec.get("kind", "console")
        cls = notification_types.get(kind)
        if cls is None:
            continue
        try:
            cls(spec.get("name", ""), spec.get("params", {})).push(
                f"alert '{config.get('name')}' fired: "
                f"{config.get('summary', '')}",
                severity=config.get("severity", "medium"))
        except Exception as exc:  # noqa: BLE001
            logger.warning("alert notification failed", error=str(exc))


# -- builtin alert templates (reference alert_templates: JobFailed /
# DataDriftDetected / SystemPerformance pre-baked configs a project
# instantiates with its own entity + notifications) -----------------------
ALERT_TEMPLATES: dict[str, dict] = {
    "JobFailed": {
        "description": "a run failed",
        "trigger_events": ["run_failed", "run_aborted"],
        "severity": "high",
        "criteria": {"count": 1, "period_seconds": 600},
        "reset_policy": "auto",
    },
    "DataDriftDetected": {
        "description": "model monitoring detected data drift",
        "trigger_events": ["data_drift_detected"],
        "severity": "high",
        "criteria": {"count": 1, "period_seconds": 3600},
        "reset_policy": "manual",
    },
    "DataDriftSuspected": {
        "description": "model monitoring suspects data drift",
        "trigger_events": ["data_drift_suspected"],
        "severity": "medium",
        "criteria": {"count": 3, "period_seconds": 3600},
        "reset_policy": "auto",
    },
    "SLOBurnRate": {
        "description": "an SLO is burning error budget on both the fast "
                       "and slow windows (obs/slo.py multi-window "
                       "burn-rate evaluation)",
        "trigger_events": ["slo_burn_rate"],
        "severity": "high",
        "criteria": {"count": 1, "period_seconds": 600},
        "reset_policy": "auto",
    },
    "SystemPerformance": {
        "description": "serving latency over threshold",
        "trigger_events": ["latency_high"],
        "severity": "medium",
        "criteria": {"count": 5, "period_seconds": 600},
        "reset_policy": "auto",
    },
}


def get_alert_template(name: str) -> dict:
    import copy

    template = ALERT_TEMPLATES.get(name)
    if template is None:
        raise KeyError(
            f"unknown alert template {name!r} "
            f"(available: {sorted(ALERT_TEMPLATES)})")
    # deep copy: nested criteria/trigger_events must not alias the
    # module-global registry (a caller mutation would corrupt every
    # later instantiation process-wide)
    return copy.deepcopy(template)


def list_alert_templates() -> list[dict]:
    import copy

    return [{"name": name, **copy.deepcopy(template)}
            for name, template in ALERT_TEMPLATES.items()]
