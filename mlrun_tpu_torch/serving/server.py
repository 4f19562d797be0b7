"""Graph server — the port's copy of ``mlrun_tpu/serving/server.py``:
``GraphServer`` hosts a serving graph in-process (``run`` with drain
admission, deadlines, typed resilience statuses and error envelopes;
warmup-gated ``readyz``, ``healthz``, ``drain``, ``drain_on_preemption``
and a scrape-time breaker gauge), ``MockEvent`` / ``Response`` /
``GraphContext``, and the ``SERVING_SPEC_ENV`` entry points
``v2_serving_init`` / ``v2_serving_handler``.

The HTTP gateway (``serving/asgi.py``) wraps a server; offline tests call
``server.test(...)``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
import uuid
from typing import Union

from ..config import SERVING_RESILIENCE_DEFAULTS
from ..model import ModelObj
from ..obs import (
    BREAKER_STATE,
    REGISTRY,
    REQUEST_LATENCY,
    SERVER_INFLIGHT,
    SERVING_EVENTS,
    get_tracer,
    parse_trace_header,
)
from ..secrets import SecretsStore
from ..utils import logger
from ..utils.helpers import now_iso
from .resilience import (
    ResilienceError,
    ServerDrainingError,
    deadline_from_headers,
    retry_after_hint,
)
from .states import RootFlowStep, RouterStep, graph_root_setter


class MockEvent:
    """Event object used offline and by the HTTP gateway."""

    def __init__(self, body=None, content_type=None, headers=None, method=None,
                 path=None, event_id=None, trigger=None, error=None,
                 deadline: float | None = None):
        self.id = event_id or uuid.uuid4().hex
        # trace context stamped by GraphServer.run: steps, remote calls
        # and engines hang their child spans off these
        self.trace_id = None
        self.span_id = None
        self.key = ""
        self.body = body
        self.time = now_iso()
        self.content_type = content_type
        self.headers = headers or {}
        self.method = method or ("POST" if body is not None else "GET")
        self.path = path or "/"
        self.trigger = trigger
        self.error = error
        # absolute deadline on the time.monotonic() timebase; steps check
        # the remaining budget before executing (serving/resilience.py)
        self.deadline = deadline

    def __str__(self):
        return f"Event(id={self.id}, path={self.path}, body={self.body})"


Event = MockEvent


class MockTrigger:
    def __init__(self, kind: str = "", name: str = ""):
        self.kind = kind
        self.name = name


class Response:
    def __init__(self, headers=None, body=None, content_type=None,
                 status_code=200):
        self.headers = headers or {}
        self.body = body
        self.content_type = content_type or "text/plain"
        self.status_code = status_code


class GraphContext:
    """Context passed to graph step classes."""

    def __init__(self, level="info", logger_=None, server=None):
        self.state = None
        self.logger = logger_ or logger
        self.worker_id = 0
        self.server = server
        self.project = ""
        self.current_function = ""
        self.stream = None
        self.root = None
        self._secrets = SecretsStore()
        self.is_mock = False
        self.monitoring_stream = None
        # resilience observability: breaker trips, sheds, rejections.
        # The dict stays the compat view; every increment is mirrored
        # into the process-wide registry (mlt_serving_events_total) so
        # /metrics carries the same series with labels
        self.metrics: dict[str, int] = {}
        self._metrics_lock = threading.Lock()
        self.tracer = None  # set by GraphServer.init_states

    def incr(self, name: str, value: int = 1):
        with self._metrics_lock:
            self.metrics[name] = self.metrics.get(name, 0) + value
        SERVING_EVENTS.inc(value, event=name)

    def get_param(self, key: str, default=None):
        if self.server and self.server.parameters:
            return self.server.parameters.get(key, default)
        return default

    def get_secret(self, key: str, default=None):
        return self._secrets.get(key, default)

    def get_store_resource(self, uri: str):
        from ..datastore import store_manager

        return store_manager.object(url=uri)

    def get_remote_endpoint(self, name: str, external: bool = True) -> str:
        """A deployed function's address from the run db; the port has no
        run db (ROADMAP.md item 10), so no name resolves — ``""``, the
        reference's answer for a name it cannot resolve."""
        return ""

    def push_error(self, event, message: str, source=None, **kwargs):
        self.logger.error(
            "graph error", error=message, source=source, event_id=getattr(
                event, "id", None))


class GraphServer(ModelObj):
    kind = "server"
    _dict_fields = ["graph", "parameters", "verbose", "load_mode",
                    "function_uri", "graph_initializer", "error_stream",
                    "track_models", "secret_sources", "default_content_type"]

    def __init__(self, graph=None, parameters=None, load_mode=None,
                 function_uri=None, verbose=False, version=None,
                 functions=None, graph_initializer=None, error_stream=None,
                 track_models=None, secret_sources=None,
                 default_content_type=None):
        self._graph = None
        self.graph = graph
        self.function_uri = function_uri
        self.parameters = parameters or {}
        self.verbose = verbose
        self.load_mode = load_mode or "sync"
        self.version = version or "v2"
        self.context = None
        self.graph_initializer = graph_initializer
        self.error_stream = error_stream
        self.track_models = track_models
        self.secret_sources = secret_sources or []
        self.default_content_type = default_content_type
        self._namespace = {}
        self._current_function = None
        # serving-path resilience state (not serialized)
        self._inflight = 0
        self._state_lock = threading.Lock()
        self._draining = False
        # ready-means-warm: True by default so embedded/test servers stay
        # ready; the HTTP gateway
        # calls begin_warmup() before its warmup pass, flipping readyz
        # false until finish_warmup() — the ring never routes to a pod
        # whose engines would compile/fetch on the first request
        self._warm = True
        self.step_errors: dict[str, int] = {}
        # span factory (not serialized); assign a dedicated Tracer before
        # init_states to isolate this server's spans (tests do), else the
        # process-wide tracer is used
        self.tracer = None

    @property
    def graph(self) -> Union[RootFlowStep, RouterStep]:
        return self._graph

    @graph.setter
    def graph(self, graph):
        if graph is None:
            self._graph = None
            return
        self._graph = graph_root_setter(self, graph)

    def set_current_function(self, function):
        self._current_function = function

    def init_states(self, context, namespace: dict | None = None,
                    logger_=None, is_mock: bool = False,
                    monitoring_mode: str | None = None):
        """Initialize graph steps."""
        self.context = context or GraphContext(server=self)
        if isinstance(self.context, GraphContext):
            self.context.server = self
            self.context.is_mock = is_mock
            if self.function_uri:
                self.context.project = self.function_uri.split("/")[0]
        if self.secret_sources:
            self.context._secrets = SecretsStore.from_list(self.secret_sources)
        if self.graph_initializer:
            initializer = self.graph_initializer
            if isinstance(initializer, str):
                from .states import get_function

                initializer = get_function(initializer, namespace or {})
            initializer(self)
        if self.track_models and isinstance(self.context, GraphContext):
            from ..config import run_config
            from ..model_monitoring.stream_processing import (
                get_monitoring_stream,
            )

            self.context.monitoring_stream = get_monitoring_stream(
                self.context.project or run_config("default_project"))
        self._namespace = namespace or {}
        if self.tracer is None:
            self.tracer = get_tracer()
        if isinstance(self.context, GraphContext):
            self.context.tracer = self.tracer
        self.graph.init_object(self.context, self._namespace, self.load_mode)
        self._register_breaker_collector()
        return self

    def init_object(self, namespace: dict | None = None):
        self.graph.init_object(self.context, namespace or self._namespace,
                               self.load_mode)

    def run(self, event: MockEvent, context=None, get_body: bool = False):
        """Process one event through the graph.

        Resilience semantics: a draining replica rejects with 503 before
        touching the graph; a deadline/timeout header becomes an absolute
        event deadline every step checks; resilience rejections
        (429/503/504 — see serving/resilience.py) come back as fast
        typed responses, not 500s with tracebacks.
        """
        server_context = self.context
        # header parsing happens BEFORE the inflight increment: a parse
        # exception here must not leak the gauge (the decrement lives in
        # the finally of the graph.run block below)
        if getattr(event, "deadline", None) is None:
            event.deadline = deadline_from_headers(
                getattr(event, "headers", None))
        # admission vs drain must be ATOMIC: checked and incremented under
        # one lock hold, or a request could slip between the drain-flag
        # read and the inflight increment and still be executing after
        # drain() observed inflight == 0 and reported drained
        with self._state_lock:
            admitted = not self._draining
            if admitted:
                self._inflight += 1
        if not admitted:
            self._incr_metric("server.draining_rejected")
            exc = ServerDrainingError("server is draining, not admitting "
                                      "new events",
                                      retry_after_s=retry_after_hint())
            # the hint rides both the body and the Retry-After header so
            # blind-retry clients and header-aware routers both back off
            # on the fleet's schedule
            return Response(body={"error": str(exc),
                                  "retry_after_s": exc.retry_after_s},
                            status_code=exc.status_code,
                            headers={"Retry-After":
                                     f"{exc.retry_after_s:.3f}"})
        SERVER_INFLIGHT.inc()
        # root span: an incoming X-MLT-Trace header joins the caller's
        # trace; otherwise a fresh trace starts here. Steps, remote calls,
        # and engine phases hang their child spans off event.trace_id
        span = None
        tracer = self.tracer
        if tracer is not None:
            trace_id, parent_id = parse_trace_header(
                getattr(event, "headers", None))
            span = tracer.start_span(
                "server.run", trace_id=trace_id, parent_id=parent_id,
                attrs={"path": getattr(event, "path", ""),
                       "event_id": getattr(event, "id", None)},
                activate=True)
            event.trace_id = span.trace_id
            event.span_id = span.span_id
        started = time.perf_counter()
        span_status = "ok"
        try:
            try:
                response = self.graph.run(event)
            except ResilienceError as exc:
                # fast failure: typed status, compact log, no traceback spam
                span_status = "error"
                self._incr_metric(
                    f"server.{type(exc).__name__}")
                logger.warning("serving resilience rejection",
                               error=str(exc), kind=type(exc).__name__,
                               event_id=getattr(event, "id", None),
                               trace_id=getattr(event, "trace_id", None))
                envelope = self._error_envelope(exc, event)
                headers = None
                hint = getattr(exc, "retry_after_s", None)
                if hint is not None:
                    envelope["retry_after_s"] = hint
                    headers = {"Retry-After": f"{hint:.3f}"}
                return Response(
                    body=envelope, headers=headers,
                    status_code=exc.status_code)
            except Exception as exc:  # noqa: BLE001
                span_status = "error"
                message = f"{exc}\n{traceback.format_exc()}"
                if server_context:
                    server_context.push_error(event, message, source="graph")
                if self.error_stream:
                    from .streams import get_stream_pusher

                    get_stream_pusher(self.error_stream).push(
                        {"error": str(exc), "event": str(event.body)})
                status = getattr(exc, "status_code", None)
                if not isinstance(status, int) or status < 400:
                    status = 500
                return Response(body=self._error_envelope(exc, event),
                                status_code=status)
        finally:
            with self._state_lock:
                self._inflight -= 1
            SERVER_INFLIGHT.dec()
            # the request's trace id rides the latency histogram as its
            # bucket exemplar — a latency SLO breach names it, and
            # GET /debug/trace/<id> turns it into a waterfall
            REQUEST_LATENCY.observe(
                time.perf_counter() - started,
                exemplar=span.trace_id if span is not None else None)
            if span is not None:
                tracer.end_span(span, status=span_status)
        if isinstance(response, MockEvent):
            body = response.body
            if get_body:
                return body
            return response
        return response

    def test(self, path: str = "/", body=None, method: str = "",
             headers: dict | None = None, content_type: str | None = None,
             silent: bool = False, get_body: bool = True,
             event_id: str | None = None, trigger: MockTrigger | None = None):
        """Offline graph test entry."""
        if not self.graph:
            raise ValueError("no graph topology was set")
        event = MockEvent(body=body, path=path, method=method,
                          content_type=content_type, headers=headers,
                          event_id=event_id, trigger=trigger)
        result = self.run(event, get_body=get_body)
        if isinstance(result, Response) and result.status_code >= 400 \
                and not silent:
            raise RuntimeError(f"error invoking graph: {result.body}")
        return result

    def wait_for_completion(self):
        """Drain async branches."""
        if self.graph and hasattr(self.graph, "_flush"):
            self.graph._flush()

    # -- observability -------------------------------------------------------
    @staticmethod
    def _error_envelope(exc: Exception, event) -> dict:
        """Error body with the trace id stamped in so a client can hand
        support the exact span timeline of its failed request."""
        envelope = {"error": str(exc)}
        trace_id = getattr(event, "trace_id", None)
        if trace_id:
            envelope["trace_id"] = trace_id
        return envelope

    def _register_breaker_collector(self):
        """Scrape-time gauge of every configured breaker's state
        (0 closed, 1 half-open, 2 open). Weakly bound: the collector
        retires itself once this server is gone."""
        if getattr(self, "_breaker_collector", None) is not None:
            return
        import weakref

        ref = weakref.ref(self)
        state_levels = {"closed": 0, "half_open": 1, "open": 2}

        def collect():
            server = ref()
            if server is None:
                return False
            graph = server.graph
            steps = []
            if graph is not None:
                # a bare RouterStep root keeps children in .routes only
                steps.extend(getattr(graph, "routes", {}).values())
                for step in (getattr(graph, "steps", {}) or {}).values():
                    steps.append(step)
                    steps.extend(getattr(step, "routes", {}).values())
            for step in steps:
                resilience = getattr(step, "_resilience", None)
                breaker = getattr(resilience, "breaker", None)
                if breaker is not None:
                    BREAKER_STATE.set(state_levels.get(breaker.state, 0),
                                      step=step.name or "")
            return None

        self._breaker_collector = collect
        REGISTRY.add_collector(collect)

    # -- resilience: health / readiness / drain ------------------------------
    def _incr_metric(self, name: str, value: int = 1):
        if isinstance(self.context, GraphContext):
            self.context.incr(name, value)

    def record_step_error(self, step: str):
        """Async-branch error counter (QueueStep workers report here, so a
        swallowed exception is still counted)."""
        with self._state_lock:
            self.step_errors[step] = self.step_errors.get(step, 0) + 1

    @property
    def inflight(self) -> int:
        with self._state_lock:
            return self._inflight

    @property
    def draining(self) -> bool:
        return self._draining

    def healthz(self) -> dict:
        """Liveness: the process serves, even while draining."""
        return {"status": "ok", "inflight": self.inflight,
                "draining": self._draining}

    def readyz(self) -> dict:
        """Readiness: flips false the moment drain starts so the load
        balancer stops routing before in-flight events finish — and
        stays false until WARMTH (engine warmup + adapter working-set
        prefetch) completes, so ready means warm, not merely alive
        (the fleet's ring join gates on this probe)."""
        ready = (self.graph is not None and self.context is not None
                 and not self._draining and self._warm)
        return {"ready": ready, "draining": self._draining,
                "warm": self._warm, "inflight": self.inflight}

    def begin_warmup(self):
        """Flip readyz false until :meth:`finish_warmup`: the gateway
        calls this before its warmup pass so a cold replica is never
        routed to."""
        self._warm = False

    def finish_warmup(self):
        self._warm = True

    def warmup(self):
        """Warm every graph step that supports it (engine compile +
        first-dispatch, adapter prefetch), then flip ready. One failed
        step logs and continues — a partially warm replica still beats a
        replica that never reports ready (the pre-warm contract:
        failures degrade to cold, never strand capacity)."""
        graph = self.graph
        steps = []
        if graph is not None:
            steps.extend((getattr(graph, "routes", {}) or {}).values())
            for step in (getattr(graph, "steps", {}) or {}).values():
                steps.append(step)
                steps.extend((getattr(step, "routes", {}) or {}).values())
        for step in steps:
            target = getattr(step, "_object", None) or step
            warm = getattr(target, "warmup", None)
            if not callable(warm):
                continue
            try:
                warm()
            except Exception as exc:  # noqa: BLE001 - degrade to cold
                logger.warning("step warmup failed",
                               step=getattr(step, "name", ""),
                               error=str(exc))
        self.finish_warmup()

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful drain: stop admission (readyz → not ready), wait for
        in-flight events, then flush async queue branches — all bounded by
        ``timeout``. Returns True when everything completed in time.

        Wired to the preemption signal via ``drain_on_preemption``: a
        preempted serving replica finishes its in-flight requests inside
        the eviction grace period instead of dropping them.
        """
        if timeout is None:
            timeout = float(SERVING_RESILIENCE_DEFAULTS["drain_timeout_s"])
        self._draining = True
        logger.info("serving drain started", inflight=self.inflight,
                    timeout=timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.inflight == 0:
                break
            time.sleep(0.005)
        drained = self.inflight == 0
        if self.graph is not None and hasattr(self.graph, "_flush"):
            remaining = max(0.0, deadline - time.monotonic())
            drained = self.graph._flush(remaining) and drained
        logger.info("serving drain finished", drained=drained,
                    inflight=self.inflight)
        return drained

    def drain_on_preemption(self, guard, timeout: float | None = None):
        """Arm a watcher that drains this server when the
        ``PreemptionGuard`` latches (SIGTERM on a preemptible slice). The
        watcher blocks on the guard's event — no polling — so readyz
        flips not-ready well before the guard's second-signal escalation
        fires. Returns the watcher thread."""
        return guard.on_preempted(lambda: self.drain(timeout),
                                  name="serving-drain-on-preemption")


def create_graph_server(parameters=None, load_mode=None, graph=None,
                        verbose=False, current_function=None,
                        **kwargs) -> GraphServer:
    """Create a standalone graph server for testing/embedding."""
    server = GraphServer(graph=graph, parameters=parameters,
                         load_mode=load_mode, verbose=verbose, **kwargs)
    server.set_current_function(
        current_function or os.environ.get("SERVING_CURRENT_FUNCTION", ""))
    return server


def v2_serving_init(context, namespace: dict | None = None):
    """Process-start entrypoint: build the server from the serialized spec
    in ``SERVING_SPEC_ENV``."""
    spec_env = os.environ.get("SERVING_SPEC_ENV", "")
    if not spec_env:
        raise ValueError("SERVING_SPEC_ENV is not set")
    spec = json.loads(spec_env)
    server = GraphServer.from_dict(spec)
    server.init_states(context, namespace or get_caller_globals())
    setattr(context, "mlrun_handler", v2_serving_handler)
    setattr(context, "_server", server)
    return server


def v2_serving_handler(context, event, get_body: bool = False):
    """Per-event entrypoint."""
    server: GraphServer = getattr(context, "_server")
    return server.run(event, context, get_body=get_body)


def get_caller_globals(stack_depth: int = 2) -> dict:
    import inspect

    try:
        frame = inspect.stack()[stack_depth][0]
        return frame.f_globals
    except Exception:  # noqa: BLE001
        return {}
