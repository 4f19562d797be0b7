"""Per-resource API modules (reference analog: the router-per-resource
layout of server/api/api/endpoints/ + server/api/crud/ — each module
registers its routes on the shared route table; app.py keeps only
routing, middleware, state, and the periodic loops). Each module is the
port's copy of its namesake in ``mlrun_tpu/service/api``."""

from . import (  # noqa: F401
    alerts,
    artifacts,
    feature_store,
    files,
    functions,
    hub,
    monitoring,
    operations,
    projects,
    runs,
    schedules,
    workflows,
)

REGISTRARS = [
    operations.register,
    runs.register,
    artifacts.register,
    files.register,
    functions.register,
    schedules.register,
    projects.register,
    feature_store.register,
    monitoring.register,
    alerts.register,
    workflows.register,
    hub.register,
]
