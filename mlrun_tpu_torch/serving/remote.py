"""Remote http steps — the port's copy of ``mlrun_tpu/serving/remote.py``
(``RemoteStep``, ``BatchHttpRequests``, ``RemoteCallError``) on the
standard library's HTTP client (``urllib.request``): the card's machine
has no ``requests``.

Resilience semantics, as the reference's:

- retries apply ONLY to retryable failures — connection errors, timeouts,
  429 and 5xx responses. Other 4xx responses are the caller's bug and
  fail immediately instead of hammering the endpoint in a tight loop.
- backoff between attempts is exponential with deterministic jitter
  (``common/retry.py compute_backoff`` keyed on step+event), so a chaos
  test's retry timeline is reproducible.
- the raised :class:`RemoteCallError` preserves the original exception as
  ``__cause__`` and carries ``status_code``. An HTTP failure is an
  :class:`HTTPError` with ``response.status_code`` and requests' message
  form (``"503 Server Error: Service Unavailable for url: ..."``).
- the per-attempt HTTP timeout is clamped to the event's remaining
  deadline budget (``X-MLT-Timeout`` propagation — serving/resilience.py).
- ``chaos`` hook: every attempt fires ``serving.remote`` first, so tests
  inject connection errors / HTTP statuses without a live endpoint.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from ..chaos import FaultPoints, fire
from ..common.retry import RetryPolicy, compute_backoff
from ..obs import format_trace_header
from ..utils import logger
from ..utils.safe_eval import safe_eval
from .resilience import DeadlineExceeded, deadline_remaining

# patch point for tests (deterministic backoff assertions without sleeping)
_sleep = time.sleep


class HTTPResponse:
    """One HTTP answer: status, reason, headers and body bytes."""

    def __init__(self, url: str, status_code: int, reason: str,
                 headers: dict, content: bytes):
        self.url = url
        self.status_code = status_code
        self.reason = reason
        self.headers = headers
        self.content = content

    def json(self):
        return json.loads(self.content)

    def raise_for_status(self):
        """:class:`HTTPError` for a 4xx / 5xx status, with requests'
        message (``"<status> Client|Server Error: <reason> for url:
        <url>"``)."""
        if 400 <= self.status_code < 600:
            side = "Client" if self.status_code < 500 else "Server"
            raise HTTPError(
                f"{self.status_code} {side} Error: {self.reason} for url: "
                f"{self.url}", response=self)


class HTTPError(OSError):
    """An HTTP error status; ``response`` is the :class:`HTTPResponse`."""

    def __init__(self, message: str, response: HTTPResponse):
        super().__init__(message)
        self.response = response


def http_request(method: str, url: str, headers: dict | None = None,
                 timeout: float | None = None, json_body=None,
                 data=None) -> HTTPResponse:
    """One HTTP request through ``urllib.request``. An error status comes
    back as an :class:`HTTPResponse` (``raise_for_status`` raises it); a
    connection failure or a timeout raises ``OSError`` (``URLError``,
    ``ConnectionError``, ``TimeoutError``) or
    ``http.client.HTTPException``."""
    parts = urllib.parse.urlsplit(url)
    if not parts.path:
        # a bare host url is sent for "/", as requests prepares it
        url = urllib.parse.urlunsplit(parts._replace(path="/"))
    headers = dict(headers or {})
    if json_body is not None:
        data = json.dumps(json_body, allow_nan=False).encode()
        headers.setdefault("Content-Type", "application/json")
    elif isinstance(data, str):
        data = data.encode()
    request = urllib.request.Request(url, data=data, headers=headers,
                                     method=method.upper())
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return HTTPResponse(url, resp.status, resp.reason,
                            dict(resp.headers), resp.read())
    except urllib.error.HTTPError as exc:
        with exc:
            return HTTPResponse(url, exc.code, exc.reason, dict(exc.headers),
                            exc.read())


def _attribute_network(body, hop_s: float):
    """Fold the HTTP hop into a v2 response's phase-ledger timing: every
    item's caller-visible wall IS the hop wall (the batch returns
    together), so each item's ``network`` gap is the hop wall minus THAT item's
    server-side attributed wall — transfer, retries, and queueing
    behind the batch's slowest sibling — keeping each item's timing
    summing to the caller-visible wall. No-op for bodies without an
    opt-in ``timing`` field."""
    if not isinstance(body, dict):
        return
    timings = body.get("timing")
    if not isinstance(timings, list):
        return
    for timing in timings:
        if not isinstance(timing, dict):
            continue
        gap = hop_s - timing.get("wall_s", 0.0)
        if gap <= 0:
            continue
        phases = timing.setdefault("phases", {})
        phases["network"] = phases.get("network", 0.0) + gap
        timing["wall_s"] = timing.get("wall_s", 0.0) + gap


class RemoteCallError(RuntimeError):
    """A remote step exhausted its retries (or hit a permanent failure).
    ``status_code`` is the last HTTP status (None for transport errors);
    the original exception is chained as ``__cause__``."""

    def __init__(self, message: str, status_code: int | None = None):
        super().__init__(message)
        self.status_code = status_code


def _failure_status(exc: Exception) -> Optional[int]:
    response = getattr(exc, "response", None)
    return getattr(response, "status_code", None)


def _is_retryable(exc: Exception) -> bool:
    """Connection errors, timeouts, 429 and 5xx are transient; any other
    HTTP error (401, 404, 422, ...) is permanent."""
    if isinstance(exc, HTTPError):
        status = _failure_status(exc)
        return status is not None and (status == 429 or status >= 500)
    return isinstance(exc, (OSError, http.client.HTTPException))


class RemoteStep:
    """Call an external http endpoint as a graph step."""

    def __init__(self, context=None, name: str | None = None, url: str = "",
                 subpath: str = "", method: str = "POST",
                 headers: dict | None = None, return_json: bool = True,
                 timeout: int = 30, retries: int = 2, url_expression: str = "",
                 body_expression: str = "", backoff: float = 0.2,
                 backoff_factor: float = 2.0, backoff_max: float = 10.0,
                 **kwargs):
        self.context = context
        self.name = name
        self.url = url
        self.subpath = subpath
        self.method = method
        self.headers = headers or {}
        self.return_json = return_json
        self.timeout = timeout
        self.retries = retries
        self.url_expression = url_expression
        self.body_expression = body_expression
        self._retry_policy = RetryPolicy(
            max_retries=retries, backoff=backoff,
            backoff_factor=backoff_factor, backoff_max=backoff_max)

    def post_init(self, mode: str = "sync"):
        pass

    def _resolve_url(self, event) -> str:
        if self.url_expression:
            return safe_eval(self.url_expression, {"event": event})
        url = self.url.rstrip("/")
        if self.subpath:
            url += "/" + self.subpath.lstrip("/")
        return url

    def _outbound_span(self, event, url: str):
        """(span, headers) for one outbound call: a child span of the
        current step span, with ``X-MLT-Trace`` injected so the callee's
        server joins this trace. Without an active trace the step's configured headers pass
        through untouched."""
        tracer = getattr(self.context, "tracer", None)
        trace_id = getattr(event, "trace_id", None)
        if tracer is None or not trace_id:
            return None, self.headers
        current = tracer.current()
        parent_id = (current.span_id
                     if current is not None and current.trace_id == trace_id
                     else getattr(event, "span_id", None))
        span = tracer.start_span(
            f"remote.{self.name}", trace_id=trace_id, parent_id=parent_id,
            attrs={"url": url}, activate=True)
        headers = dict(self.headers)
        headers["X-MLT-Trace"] = format_trace_header(trace_id, span.span_id)
        return span, headers

    def _finish_span(self, span, status: str = "ok"):
        if span is not None:
            self.context.tracer.end_span(span, status=status)

    def _clamped_timeout(self, event) -> float:
        """HTTP timeout clamped to the event's remaining deadline budget —
        a remote call must never outlive the request it serves."""
        remaining = deadline_remaining(event)
        if remaining is None:
            return self.timeout
        if remaining <= 0:
            raise DeadlineExceeded(
                f"remote step '{self.name}' has no deadline budget left")
        return min(self.timeout, remaining)

    def _call_with_retries(self, call, event, item_id: str = ""):
        """Shared attempt loop: classify, back off (deterministic jitter
        keyed on step+event+item), preserve the original failure."""
        last_exc: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                fire(FaultPoints.serving_remote, step=self.name,
                     attempt=attempt, event=event)
                return call(self._clamped_timeout(event))
            except DeadlineExceeded:
                raise
            except Exception as exc:  # noqa: BLE001 - classified below
                last_exc = exc
                if not _is_retryable(exc) or attempt >= self.retries:
                    break
                delay = compute_backoff(
                    attempt, self._retry_policy,
                    seed=f"{self.name}:{getattr(event, 'id', '')}:{item_id}")
                remaining = deadline_remaining(event)
                if remaining is not None and delay >= remaining:
                    break  # no budget for another attempt
                logger.warning("remote step retrying", step=self.name,
                               attempt=attempt + 1, delay=round(delay, 3),
                               error=str(exc))
                if delay > 0:
                    _sleep(delay)
        status = _failure_status(last_exc)
        raise RemoteCallError(
            f"remote step {self.name} failed: "
            f"{type(last_exc).__name__}: {last_exc}",
            status_code=status) from last_exc

    def do_event(self, event):
        url = self._resolve_url(event)
        body = event.body
        if self.body_expression:
            body = safe_eval(self.body_expression, {"event": event})
        kwargs = {}
        if self.method.upper() != "GET" and body is not None:
            if isinstance(body, (dict, list)):
                kwargs["json_body"] = body
            else:
                kwargs["data"] = body
        span, headers = self._outbound_span(event, url)

        def call(timeout):
            resp = http_request(self.method.upper(), url, headers=headers,
                                timeout=timeout, **kwargs)
            resp.raise_for_status()
            return resp.json() if self.return_json else resp.content

        hop_started = time.perf_counter()
        try:
            event.body = self._call_with_retries(call, event)
        except Exception:
            self._finish_span(span, "error")
            raise
        self._finish_span(span)
        _attribute_network(event.body,
                           time.perf_counter() - hop_started)
        return event


class BatchHttpRequests(RemoteStep):
    """Issue one request per list item concurrently.

    Per-item isolation: one failing item no longer aborts the whole batch
    and loses every other result — each item resolves independently to a
    ``{"result": ...}`` or ``{"error": ..., "status_code": ...}`` envelope
    (order preserved), and each item gets the parent class's full
    retry/backoff treatment.
    """

    def __init__(self, *args, max_in_flight: int = 8, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_in_flight = max_in_flight

    def do_event(self, event):
        items = event.body if isinstance(event.body, list) else [event.body]
        url = self._resolve_url(event)
        # one span covers the whole batch; every item's request carries
        # the same injected trace header so callee spans parent onto it
        span, headers = self._outbound_span(event, url)

        def call_item(index_item):
            index, item = index_item

            def call(timeout):
                resp = http_request(
                    self.method.upper(), url, headers=headers,
                    timeout=timeout,
                    json_body=item if isinstance(item, (dict, list))
                    else None)
                resp.raise_for_status()
                return resp.json() if self.return_json else resp.content

            try:
                return {"result": self._call_with_retries(
                    call, event, item_id=str(index))}
            except DeadlineExceeded:
                # not a per-item failure: the whole request's budget is
                # spent — propagate so the server answers with a fast 504
                raise
            except Exception as exc:  # noqa: BLE001 - per-item envelope
                envelope = {"error": str(exc)}
                status = getattr(exc, "status_code", None)
                if status is not None:
                    envelope["status_code"] = status
                return envelope

        try:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.max_in_flight) as pool:
                event.body = list(pool.map(call_item, enumerate(items)))
        except Exception:
            self._finish_span(span, "error")
            raise
        self._finish_span(span)
        return event
