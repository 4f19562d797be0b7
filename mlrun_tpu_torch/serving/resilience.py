"""Typed serving errors the port's engines raise — a copy of the
corresponding classes of ``mlrun_tpu/serving/resilience.py`` (same names,
same ``status_code`` classes), without the admission controller, breaker
and degradation ladder, which the port does not have yet."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base for fast-failure rejections; ``status_code`` maps the error to
    an HTTP response class, ``retry_after_s`` is an optional backoff
    hint."""

    status_code = 503

    def __init__(self, message: str = "",
                 retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class AdmissionRejected(ResilienceError):
    """Admission denied — retry later."""

    status_code = 429


class QueueFullError(AdmissionRejected):
    """A bounded queue shed the newest request (reject-newest policy)."""

    status_code = 429


class PromptTooLongError(ResilienceError, ValueError):
    """prompt + max_new_tokens exceed the engine's max_len — a client
    error rejected at submit() before any queueing or prefill."""

    status_code = 400


class ModelNotReadyError(ResilienceError):
    """The model behind a serving step failed to load or has not finished
    loading (503-class: retry on another replica)."""

    status_code = 503


class EngineStoppedError(ResilienceError):
    """The LLM engine stopped or crashed; pending requests fail promptly
    instead of hanging until their own timeout."""

    status_code = 503


# ROADMAP.md "Modules still to port", by item number (1, 3, 5 and 8
# landed)
PORT_QUEUE = {
    2: "request expiry, the degradation ladder and the request ledger",
    4: "KV handoff and the host KV tier",
    6: "the serving graph and engine fleet",
    7: "training on many GPUs and elastic training",
    9: "other model families",
    10: "glue",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error for a feature of the reference engines the port does not
    have yet; ``item`` is its number in ROADMAP.md's port queue."""
    return NotImplementedError(
        f"{what} is not ported to mlrun_tpu_torch yet (ROADMAP.md, "
        f"modules still to port, item {item}: {PORT_QUEUE[item]})")
