"""Serving-path resilience primitives — the port's copy of
``mlrun_tpu/serving/resilience.py`` (same names, same ``status_code``
classes, same state machines):

- the typed errors every engine and the fleet raise;
- deadline propagation (:func:`deadline_from_headers`,
  :func:`check_deadline`);
- :class:`AdmissionController` (token bucket + concurrency ceiling) and
  :class:`CircuitBreaker` (closed -> open -> half-open), bound to one
  step by :class:`StepResilience`;
- the LLM :class:`DegradationLadder`.

Pure host-side Python; every class takes an injectable ``clock`` so the
tests run them on a fake clock with zero sleeps.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from ..obs.flight import record as flight_record
from ..utils import logger

# headers a serving front end understands (case-insensitive):
#   X-MLT-Timeout:  remaining budget in seconds (relative)
#   X-MLT-Deadline: absolute unix-epoch seconds (wall clock)
TIMEOUT_HEADER = "x-mlt-timeout"
DEADLINE_HEADER = "x-mlt-deadline"


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


class ReplicaUnavailableError(ResilienceError):
    """Every fleet replica eligible for a request is stopped, draining, or
    already failed it — the router exhausted its re-dispatch budget
    (serving/fleet.py)."""

    status_code = 503


class ReplicaPreemptedError(ServerDrainingError):
    """The replica hosting a request was preempted mid-request. 503-class
    via :class:`ServerDrainingError`, so ``fleet.redispatchable()`` holds;
    when the dying replica exported the decode state, ``handoff`` carries
    the :class:`~.llm_batch.KVHandoff`, and the fleet resumes the request
    on a survivor via ``submit_prefilled`` instead of re-prefilling."""

    def __init__(self, message: str = "", handoff=None,
                 retry_after_s: float | None = None):
        super().__init__(message, retry_after_s=retry_after_s)
        self.handoff = handoff


def retry_after_hint(attempt: int = 0) -> float:
    """Backoff hint (seconds) for 429/503-class rejections, from the same
    ``serving.fleet`` schedule the fleet router re-dispatches on, without
    jitter, so every replica quotes the same hint for the same attempt."""
    from ..common.retry import RetryPolicy, compute_backoff
    from ..config import SERVING_FLEET_DEFAULTS

    policy = RetryPolicy(
        max_retries=int(SERVING_FLEET_DEFAULTS["max_dispatch_attempts"]),
        backoff=float(SERVING_FLEET_DEFAULTS["backoff"]),
        backoff_factor=2.0, backoff_max=1.0, jitter=0.0)
    return compute_backoff(attempt, policy, seed="retry-after")


# -- deadline propagation ----------------------------------------------------
def deadline_from_headers(headers: dict | None,
                          clock: Callable[[], float] = time.monotonic
                          ) -> Optional[float]:
    """Parse an absolute deadline (on the ``clock`` timebase) from request
    headers. ``X-MLT-Timeout`` (relative seconds) wins over
    ``X-MLT-Deadline`` (absolute epoch seconds) when both are present."""
    if not headers:
        return None
    lowered = {str(k).lower(): v for k, v in headers.items()}
    timeout = lowered.get(TIMEOUT_HEADER)
    if timeout is not None:
        try:
            return clock() + float(timeout)
        except (TypeError, ValueError):
            # a valid absolute-deadline header must still be honored when
            # the relative one is garbage
            logger.warning("ignoring malformed timeout header",
                           value=timeout)
    epoch = lowered.get(DEADLINE_HEADER)
    if epoch is not None:
        try:
            return clock() + (float(epoch) - time.time())
        except (TypeError, ValueError):
            logger.warning("ignoring malformed deadline header", value=epoch)
    return None


def deadline_remaining(event,
                       clock: Callable[[], float] = time.monotonic
                       ) -> Optional[float]:
    """Seconds of budget left on the event, or None when no deadline."""
    deadline = getattr(event, "deadline", None)
    if deadline is None:
        return None
    return deadline - clock()


def check_deadline(event, step_name: str = "",
                   clock: Callable[[], float] = time.monotonic):
    """Raise :class:`DeadlineExceeded` when the event's budget is spent."""
    remaining = deadline_remaining(event, clock)
    if remaining is not None and remaining <= 0:
        raise DeadlineExceeded(
            f"deadline exceeded before step '{step_name}' "
            f"({-remaining:.3f}s past budget)")


# -- admission control -------------------------------------------------------
class AdmissionController:
    """Token-bucket rate limit plus a concurrency ceiling.

    ``rate`` is sustained requests/second refilled continuously up to
    ``burst`` tokens; ``max_concurrent`` caps in-flight executions. Either
    may be omitted. ``try_acquire`` never blocks: the caller rejects with
    :class:`AdmissionRejected` rather than queueing.
    """

    SPEC_KEYS = {"rate", "burst", "max_concurrent"}

    def __init__(self, rate: float | None = None, burst: float | None = None,
                 max_concurrent: int | None = None,
                 clock: Callable[[], float] | None = None):
        if rate is not None and rate <= 0:
            raise ValueError(f"admission rate must be > 0, got {rate}")
        if max_concurrent is not None and max_concurrent <= 0:
            raise ValueError(
                f"max_concurrent must be > 0, got {max_concurrent}")
        self.rate = float(rate) if rate is not None else None
        # the bucket holds at least one whole token, or a sub-1.0 rate
        # would reject all traffic
        self.burst = max(1.0, float(burst if burst is not None
                                    else (rate or 1)))
        self.max_concurrent = (
            int(max_concurrent) if max_concurrent is not None else None)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = self._clock()
        self._inflight = 0
        self.rejected = 0

    @property
    def inflight(self) -> int:
        return self._inflight

    def try_acquire(self) -> bool:
        with self._lock:
            if self.max_concurrent is not None \
                    and self._inflight >= self.max_concurrent:
                self.rejected += 1
                return False
            if self.rate is not None:
                now = self._clock()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.rate)
                self._last = now
                if self._tokens < 1.0:
                    self.rejected += 1
                    return False
                self._tokens -= 1.0
            self._inflight += 1
            return True

    def release(self):
        with self._lock:
            self._inflight = max(0, self._inflight - 1)


# -- circuit breaker ---------------------------------------------------------
class CircuitBreaker:
    """Closed -> open -> half-open state machine, one instance per step.

    Trips open on ``failure_threshold`` consecutive failures OR when the
    failure rate over the last ``window`` outcomes reaches
    ``failure_rate_threshold`` (only once the window is full). After
    ``recovery_timeout`` seconds open, the next ``allow()`` goes half-open
    and admits up to ``half_open_max_calls`` concurrent probes;
    ``success_threshold`` probe successes close the breaker, any probe
    failure re-opens it.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    SPEC_KEYS = {"failure_threshold", "failure_rate_threshold", "window",
                 "recovery_timeout", "half_open_max_calls",
                 "success_threshold"}

    def __init__(self, name: str = "", failure_threshold: int = 5,
                 failure_rate_threshold: float | None = None,
                 window: int = 20, recovery_timeout: float = 30.0,
                 half_open_max_calls: int = 1, success_threshold: int = 1,
                 clock: Callable[[], float] | None = None):
        if failure_threshold <= 0:
            raise ValueError("failure_threshold must be > 0")
        if failure_rate_threshold is not None \
                and not 0 < failure_rate_threshold <= 1:
            raise ValueError("failure_rate_threshold must be in (0, 1]")
        if recovery_timeout < 0:
            raise ValueError("recovery_timeout must be >= 0")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.failure_rate_threshold = failure_rate_threshold
        self.window = int(window)
        self.recovery_timeout = float(recovery_timeout)
        self.half_open_max_calls = int(half_open_max_calls)
        self.success_threshold = int(success_threshold)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._outcomes: deque = deque(maxlen=self.window)
        self._opened_at = 0.0
        self._probes = 0
        self._probe_successes = 0
        self.rejected = 0
        self.opened_total = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _trip_open(self):
        self._state = self.OPEN
        self._opened_at = self._clock()
        self.opened_total += 1
        flight_record("breaker.open", breaker=self.name,
                      consecutive_failures=self._consecutive_failures,
                      opened_total=self.opened_total)
        logger.warning("circuit breaker opened", breaker=self.name,
                       consecutive_failures=self._consecutive_failures,
                       opened_total=self.opened_total)

    def allow(self):
        """Admit one call or raise :class:`CircuitOpenError`."""
        with self._lock:
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.recovery_timeout:
                    self._state = self.HALF_OPEN
                    self._probes = 0
                    self._probe_successes = 0
                    logger.info("circuit breaker half-open",
                                breaker=self.name)
                else:
                    self.rejected += 1
                    retry_in = self.recovery_timeout - (
                        self._clock() - self._opened_at)
                    raise CircuitOpenError(
                        f"circuit '{self.name}' is open "
                        f"(retry in {max(0.0, retry_in):.2f}s)")
            if self._state == self.HALF_OPEN:
                if self._probes >= self.half_open_max_calls:
                    self.rejected += 1
                    raise CircuitOpenError(
                        f"circuit '{self.name}' is half-open and probe "
                        f"slots are taken")
                self._probes += 1

    def record_success(self):
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes = max(0, self._probes - 1)
                self._probe_successes += 1
                if self._probe_successes >= self.success_threshold:
                    self._state = self.CLOSED
                    self._consecutive_failures = 0
                    self._outcomes.clear()
                    flight_record("breaker.closed", breaker=self.name)
                    logger.info("circuit breaker closed (recovered)",
                                breaker=self.name)
            else:
                self._consecutive_failures = 0
                self._outcomes.append(1)

    def record_failure(self):
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probes = max(0, self._probes - 1)
                self._trip_open()
                return
            if self._state != self.CLOSED:
                return  # in-flight stragglers after the trip
            self._consecutive_failures += 1
            self._outcomes.append(0)
            rate_tripped = (
                self.failure_rate_threshold is not None
                and len(self._outcomes) == self.window
                and (self._outcomes.count(0) / self.window
                     >= self.failure_rate_threshold))
            if self._consecutive_failures >= self.failure_threshold \
                    or rate_tripped:
                self._trip_open()


# -- step-level wrapper ------------------------------------------------------
class StepResilience:
    """Admission controller + circuit breaker bound to one serving step,
    built from its validated ``resilience`` spec dict::

        StepResilience.from_spec({
            "circuit_breaker": {"failure_threshold": 3,
                                "recovery_timeout": 5.0},
            "admission": {"max_concurrent": 8, "rate": 100, "burst": 20},
        }, name="llm")
    """

    SPEC_KEYS = {"circuit_breaker", "admission"}

    def __init__(self, name: str = "",
                 breaker: CircuitBreaker | None = None,
                 admission: AdmissionController | None = None):
        self.name = name
        self.breaker = breaker
        self.admission = admission

    @classmethod
    def from_spec(cls, spec: dict | None, name: str = "",
                  clock: Callable[[], float] | None = None
                  ) -> Optional["StepResilience"]:
        if not spec:
            return None
        validate_resilience_spec(spec, name)
        breaker = None
        if spec.get("circuit_breaker"):
            breaker = CircuitBreaker(name=name, clock=clock,
                                     **spec["circuit_breaker"])
        admission = None
        if spec.get("admission"):
            admission = AdmissionController(clock=clock, **spec["admission"])
        return cls(name=name, breaker=breaker, admission=admission)

    def call(self, fn: Callable, context=None):
        """Run ``fn`` under admission + breaker; every shed/trip decision
        is counted on the context's metrics (``context.incr``)."""
        if self.admission is not None and not self.admission.try_acquire():
            _incr(context, f"step.{self.name}.admission_rejected")
            raise AdmissionRejected(
                f"step '{self.name}' rejected by admission control "
                f"(rate/concurrency limit)")
        try:
            try:
                self.breaker.allow() if self.breaker is not None else None
            except CircuitOpenError:
                _incr(context, f"step.{self.name}.breaker_rejected")
                raise
            try:
                result = fn()
            except Exception:
                if self.breaker is not None:
                    self.breaker.record_failure()
                    _incr(context, f"step.{self.name}.breaker_failures")
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return result
        finally:
            if self.admission is not None:
                self.admission.release()


def validate_resilience_spec(spec: dict, name: str = ""):
    """Schema check for a step's ``resilience`` dict: unknown keys fail at
    construction, not when the knob silently never applies."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"step '{name}': resilience spec must be a dict, "
            f"got {type(spec).__name__}")
    unknown = set(spec) - StepResilience.SPEC_KEYS
    if unknown:
        raise ValueError(
            f"step '{name}': unknown resilience keys {sorted(unknown)} "
            f"(allowed: {sorted(StepResilience.SPEC_KEYS)})")
    breaker = spec.get("circuit_breaker") or {}
    unknown = set(breaker) - CircuitBreaker.SPEC_KEYS
    if unknown:
        raise ValueError(
            f"step '{name}': unknown circuit_breaker keys "
            f"{sorted(unknown)} (allowed: "
            f"{sorted(CircuitBreaker.SPEC_KEYS)})")
    admission = spec.get("admission") or {}
    unknown = set(admission) - AdmissionController.SPEC_KEYS
    if unknown:
        raise ValueError(
            f"step '{name}': unknown admission keys {sorted(unknown)} "
            f"(allowed: {sorted(AdmissionController.SPEC_KEYS)})")


def _incr(context, name: str, value: int = 1):
    incr = getattr(context, "incr", None)
    if callable(incr):
        incr(name, value)


# -- degradation ladder ------------------------------------------------------
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


# ROADMAP.md "Modules still to port", by item number: items 1-15 have
# all landed (item 14's last part, 14d, is the port's static lint,
# analysis/), so no module is queued
PORT_QUEUE: dict[int, str] = {}
