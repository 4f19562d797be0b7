"""Multi-tenant LoRA adapters — the typed errors, copied from
``mlrun_tpu/serving/adapters.py`` (same names, same ``status_code``
classes). The adapter bank and registry are not ported yet (ROADMAP.md,
modules still to port, item 3), so every port engine has no registry and
fails a request that names an adapter with :class:`UnknownAdapterError`
(404) rather than serving it the base model's tokens."""

from __future__ import annotations

from .resilience import ResilienceError


class AdapterError(ResilienceError):
    """Base for adapter-registry failures (per-request, never fatal to
    the engine)."""


class UnknownAdapterError(AdapterError):
    """The request names an adapter no source can provide — a client
    error (404), rejected at submit() before any queueing."""

    status_code = 404
