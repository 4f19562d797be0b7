"""Server-side secrets helpers — notification-param masking and runtime
injection; the port's copy of ``mlrun_tpu/service/secrets.py``.

Reference analog: server/api/api/utils.py:221-300 (mask_notification_params
stores notification secret-params in the project secret store and replaces
them with a secret reference) and the per-runtime secret env projection.
Secret VALUES live in the DB-backed project-secret store (db/sqlitedb.py)
and never cross the REST list surface.
"""

from __future__ import annotations

import json

from ..utils import logger

NOTIFICATION_SECRET_PREFIX = "mlrun.notifications."
SECRET_ENV_PREFIX = "MLT_SECRET_"


def mask_notification_params(db, run) -> None:
    """Move each notification's params into a project secret and replace
    them with ``{"secret": <key>}`` before the run spec is stored or
    shipped to a resource."""
    store = getattr(db, "store_project_secrets", None)
    if store is None:
        return
    notifications = run.spec.notifications or []
    project = run.metadata.project
    for index, notification in enumerate(notifications):
        params = (notification.get("params") if isinstance(notification,
                                                           dict)
                  else getattr(notification, "params", None))
        if not params or "secret" in params:
            continue
        secret_key = (f"{NOTIFICATION_SECRET_PREFIX}"
                      f"{run.metadata.uid}.{index}")
        try:
            store(project, {secret_key: json.dumps(params)})
        except Exception as exc:  # noqa: BLE001 - leave unmasked rather
            # than lose the notification entirely
            logger.warning("notification param masking failed",
                           error=str(exc))
            continue
        masked = {"secret": secret_key}
        if isinstance(notification, dict):
            notification["params"] = masked
        else:
            notification.params = masked


def resolve_notification_params(db, project: str, params: dict) -> dict:
    """Inverse of masking: fetch the stored params for a secret reference
    (server-side only — db must expose get_project_secrets)."""
    secret_key = (params or {}).get("secret")
    if not secret_key:
        return params or {}
    getter = getattr(db, "get_project_secrets", None)
    if getter is None:
        raise ValueError("secret-backed notification params need a "
                         "server-side db")
    values = getter(project, keys=[secret_key])
    raw = values.get(secret_key)
    if raw is None:
        raise KeyError(f"notification secret '{secret_key}' not found")
    return json.loads(raw)


def project_secret_env(db, project: str) -> dict:
    """Project secrets as MLT_SECRET_* env entries for resource injection
    (the client-side SecretsStore env source picks the prefix up, so
    ``context.get_secret(name)`` works inside the run)."""
    getter = getattr(db, "get_project_secrets", None)
    if getter is None:
        return {}
    try:
        secrets = getter(project)
    except Exception as exc:  # noqa: BLE001
        logger.warning("project secret fetch failed", error=str(exc))
        return {}
    # masked notification params are per-run server-side material — they
    # must never ride into resource envs
    return {SECRET_ENV_PREFIX + name: value
            for name, value in secrets.items()
            if not name.startswith(NOTIFICATION_SECRET_PREFIX)}
