"""Typed serving errors and the degradation ladder of the port's engines —
copies of the corresponding parts of ``mlrun_tpu/serving/resilience.py``
(same names, same ``status_code`` classes, same ladder). The admission
controller, circuit breaker and ``StepResilience`` wrap steps of the
serving graph, which the port does not have yet (ROADMAP.md item 6)."""

from __future__ import annotations

from typing import Optional

# the reference's retry-after schedule: its fleet router's re-dispatch
# backoff (``serving.fleet.backoff``), doubling per attempt up to 1 s
_RETRY_BACKOFF_S = 0.05
_RETRY_BACKOFF_MAX_S = 1.0


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
    """Admission denied — retry later. 429-class rejections always carry a
    ``Retry-After`` hint (:func:`retry_after_hint`): admission pressure is
    transient by definition."""

    status_code = 429

    def __init__(self, message: str = "",
                 retry_after_s: float | None = None):
        if retry_after_s is None:
            retry_after_s = retry_after_hint()
        super().__init__(message, retry_after_s=retry_after_s)


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


class DeadlineExceeded(ResilienceError):
    """The request's deadline (an engine's ``max_wait`` queue-time budget)
    expired before it was served."""

    status_code = 504


class CircuitOpenError(ResilienceError):
    """A step's circuit breaker is open — dependency presumed down."""

    status_code = 503


class EngineStoppedError(ResilienceError):
    """The LLM engine stopped or crashed; pending requests fail promptly
    instead of hanging until their own timeout."""

    status_code = 503


class ServerDrainingError(ResilienceError):
    """The replica is draining (preemption) and not admitting requests."""

    status_code = 503


def retry_after_hint(attempt: int = 0) -> float:
    """Backoff hint (seconds) for 429/503-class rejections: the
    reference's fleet re-dispatch schedule (0.05 s doubling per attempt,
    at most 1 s), without jitter so every replica quotes the same hint
    for the same attempt."""
    return max(0.0, min(_RETRY_BACKOFF_S * (2.0 ** attempt),
                        _RETRY_BACKOFF_MAX_S))


class DegradationLadder:
    """Maps engine pressure to a degradation level for the LLM path.

    Levels (each includes the previous):
      0 — normal operation.
      1 — degraded: disable speculative decoding, clamp ``max_new_tokens``
          to ``max_new_tokens`` (requests still complete, just cheaper).
      2 — shedding: the engine's bounded queue rejects new work.

    Pressure signals: queue depth (vs ``queue_depth``) and, on the paged
    engine, the free-KV-page fraction (vs ``min_free_page_frac``).
    """

    SPEC_KEYS = {"queue_depth", "max_new_tokens", "min_free_page_frac"}

    def __init__(self, queue_depth: int | None = None,
                 max_new_tokens: int | None = None,
                 min_free_page_frac: float | None = None):
        if queue_depth is not None and queue_depth <= 0:
            raise ValueError("degradation queue_depth must be > 0")
        if max_new_tokens is not None and max_new_tokens <= 0:
            raise ValueError("degradation max_new_tokens must be > 0")
        if min_free_page_frac is not None \
                and not 0 <= min_free_page_frac <= 1:
            raise ValueError("min_free_page_frac must be in [0, 1]")
        self.queue_depth = queue_depth
        self.max_new_tokens = max_new_tokens
        self.min_free_page_frac = min_free_page_frac

    @classmethod
    def from_spec(cls, spec: dict | None) -> Optional["DegradationLadder"]:
        if not spec:
            return None
        unknown = set(spec) - cls.SPEC_KEYS
        if unknown:
            raise ValueError(
                f"unknown degradation keys {sorted(unknown)} "
                f"(allowed: {sorted(cls.SPEC_KEYS)})")
        return cls(**spec)

    def level(self, queue_depth: int, max_queue_size: int = 0,
              free_page_frac: float | None = None) -> int:
        if max_queue_size and queue_depth >= max_queue_size:
            return 2
        if self.queue_depth is not None and queue_depth >= self.queue_depth:
            return 1
        if self.min_free_page_frac is not None \
                and free_page_frac is not None \
                and free_page_frac < self.min_free_page_frac:
            return 1
        return 0

    def clamp_max_new(self, max_new_tokens: int, level: int) -> int:
        if level >= 1 and self.max_new_tokens is not None:
            return min(max_new_tokens, self.max_new_tokens)
        return max_new_tokens


# ROADMAP.md "Modules still to port", by item number (1, 2, 3, 4, 5 and
# 8 landed)
PORT_QUEUE = {
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
