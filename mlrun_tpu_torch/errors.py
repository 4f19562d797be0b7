"""Error hierarchy — the port's copy of ``mlrun_tpu/errors.py``, with the
same base classes (``MLRunNotFoundError`` is a ``KeyError``, ...); the
HTTP status each maps to is the reference's convention."""

from __future__ import annotations


class MLRunBaseError(Exception):
    """Root of the framework's error hierarchy."""


class MLRunInvalidArgumentError(MLRunBaseError, ValueError):
    """Bad user input (maps to HTTP 400)."""


class MLRunNotFoundError(MLRunBaseError, KeyError):
    """Requested object does not exist (maps to HTTP 404)."""


class MLRunConflictError(MLRunBaseError):
    """State conflict, e.g. resource already exists (HTTP 409)."""


class MLRunTimeoutError(MLRunBaseError, TimeoutError):
    """Deadline exceeded waiting on a run/deploy/build."""


class MLRunRuntimeError(MLRunBaseError, RuntimeError):
    """Execution-side failure."""
