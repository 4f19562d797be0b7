"""Serving-graph step DAG — the port's copy of
``mlrun_tpu/serving/states.py``: ``TaskStep`` (a class instance or a
handler), ``RouterStep`` (routes dispatched by a router class,
``ModelRouter`` by default), ``QueueStep`` (a stream push and/or an async
boundary whose downstream runs on worker threads, bounded by
``max_queue_size`` / ``max_wait``), ``JoinStep``, ``FlowStep`` and
``RootFlowStep``, with the same dict form, so a graph spec the reference
serializes loads here.

Request/response graphs run synchronously in the caller's thread; every
step run is timed on ``mlt_step_latency_seconds`` and, when the event
carries a trace id, spanned. Model steps are the port's V2 servers, whose
forwards run on the card (``v2_serving``, ``llm``).
"""

from __future__ import annotations

import copy
import importlib
import inspect
import time
from typing import Any, Callable, Optional, Union

from ..chaos import FaultPoints, fire
from ..model import ModelObj
from ..obs import STEP_LATENCY
from ..utils import logger
from ..utils.helpers import get_in, update_in
from .resilience import (
    DeadlineExceeded,
    QueueFullError,
    StepResilience,
    check_deadline,
    validate_resilience_spec,
)

callable_prefix = "_"
path_splitter = "/"


class GraphError(Exception):
    pass


def get_class(class_name: str, namespace: dict | None = None):
    """Resolve 'module.sub.Class' or a bare name from the namespace."""
    if isinstance(class_name, type):
        return class_name
    namespace = namespace or {}
    if class_name in namespace:
        return namespace[class_name]
    if "." in class_name:
        module_path, name = class_name.rsplit(".", 1)
        module = importlib.import_module(module_path)
        return getattr(module, name)
    # well-known serving classes
    from . import routers, v2_serving

    for module in (v2_serving, routers):
        if hasattr(module, class_name):
            return getattr(module, class_name)
    raise GraphError(f"class '{class_name}' not found in namespace")


def get_function(handler: Union[str, Callable], namespace: dict | None = None):
    if callable(handler):
        return handler
    namespace = namespace or {}
    if handler in namespace:
        return namespace[handler]
    if "." in handler:
        module_path, name = handler.rsplit(".", 1)
        module = importlib.import_module(module_path)
        return getattr(module, name)
    raise GraphError(f"handler '{handler}' not found in namespace")


class BaseStep(ModelObj):
    kind = "BaseStep"
    _dict_fields = ["kind", "name", "class_name", "class_args", "handler",
                    "after", "function", "comment", "shape", "full_event",
                    "input_path", "result_path", "on_error", "responder",
                    "resilience"]

    def __init__(self, name: str | None = None, after: list | None = None,
                 shape: str | None = None):
        self.name = name
        self.after = after or []
        self.shape = shape
        self.comment = None
        self.class_name = None
        self.class_args = {}
        self.handler = None
        self.function = None
        self.full_event = False
        self.input_path = None
        self.result_path = None
        self.on_error = None
        self.responder = False
        self.resilience = None
        self._resilience: Optional[StepResilience] = None
        self._parent: Optional["FlowStep"] = None
        self._next: list[str] = []

    @property
    def next_steps(self) -> list[str]:
        return self._next

    def set_parent(self, parent: "FlowStep"):
        self._parent = parent

    def after_step(self, *after):
        self.after = [a if isinstance(a, str) else a.name for a in after]
        return self

    def error_handler(self, name: str):
        self.on_error = name
        return self

    def with_resilience(self, circuit_breaker: dict | None = None,
                        admission: dict | None = None):
        """Attach an admission controller and/or circuit breaker to this
        step (validated at graph init — see serving/resilience.py)."""
        spec = {}
        if circuit_breaker is not None:
            spec["circuit_breaker"] = circuit_breaker
        if admission is not None:
            spec["admission"] = admission
        validate_resilience_spec(spec, self.name or "")
        self.resilience = spec or None
        return self

    def _init_resilience(self, clock=None):
        try:
            self._resilience = StepResilience.from_spec(
                self.resilience, name=self.name or "", clock=clock)
        except ValueError as exc:
            raise GraphError(str(exc)) from exc

    def respond(self):
        self.responder = True
        return self

    def to(self, class_name=None, name: str | None = None, handler=None,
           model_path: str | None = None, function: str | None = None,
           full_event: bool | None = None, input_path: str | None = None,
           result_path: str | None = None, **class_args) -> "BaseStep":
        """Chain a new downstream step and return it."""
        if self._parent is None:
            raise GraphError(
                f"step '{self.name}' is not attached to a flow graph")
        step = self._parent.add_step(
            class_name=class_name, name=name, handler=handler,
            model_path=model_path, function=function, after=[self.name],
            full_event=full_event, input_path=input_path,
            result_path=result_path, **class_args)
        self._next.append(step.name)
        return step

    def init_object(self, context, namespace: dict, mode: str = "sync"):
        pass

    def run(self, event, *args, **kwargs):
        return event

    def _extract_input(self, event):
        if self.full_event:
            return event
        if self.input_path:
            return get_in(event.body, self.input_path)
        return event.body

    def _apply_result(self, event, result):
        if self.full_event:
            return result if result is not None else event
        if self.result_path:
            if not isinstance(event.body, dict):
                raise GraphError(
                    f"step '{self.name}' has result_path="
                    f"'{self.result_path}' but the event body is "
                    f"{type(event.body).__name__}, not a dict")
            update_in(event.body, self.result_path, result)
        else:
            event.body = result
        return event


class TaskStep(BaseStep):
    """A step running a class instance or a handler fn."""

    kind = "task"

    def __init__(self, class_name=None, class_args: dict | None = None,
                 handler=None, name: str | None = None, after: list | None = None,
                 full_event: bool | None = None, function=None,
                 input_path: str | None = None, result_path: str | None = None):
        super().__init__(name, after)
        self.class_name = (
            class_name if isinstance(class_name, (str, type(None)))
            else class_name.__name__)
        self._class_object = class_name if isinstance(class_name, type) else None
        self.class_args = class_args or {}
        self.handler = handler
        self.function = function
        self.full_event = bool(full_event)
        self.input_path = input_path
        self.result_path = result_path
        self._object = None
        self._handler_fn: Optional[Callable] = None
        self.context = None

    def init_object(self, context, namespace: dict, mode: str = "sync"):
        self.context = context
        self._init_resilience()
        if self.class_name or self._class_object:
            cls = self._class_object or get_class(self.class_name, namespace)
            # NOTE: no deepcopy — routers receive live route step objects
            args = dict(self.class_args)
            init_sig = inspect.signature(cls.__init__)
            kwargs = {}
            if "context" in init_sig.parameters:
                kwargs["context"] = context
            if "name" in init_sig.parameters:
                kwargs["name"] = self.name
            self._object = cls(**kwargs, **args)
            if hasattr(self._object, "post_init"):
                self._object.post_init(mode)
            handler_name = self.handler or "do"
            if not hasattr(self._object, handler_name) and hasattr(
                    self._object, "do_event"):
                handler_name = "do_event"
            self._handler_fn = getattr(self._object, handler_name)
        elif self.handler:
            self._handler_fn = get_function(self.handler, namespace)
        else:
            self._handler_fn = lambda x: x

    @property
    def object(self):
        return self._object

    def run(self, event, *args, **kwargs):
        if self._handler_fn is None:
            raise GraphError(f"step '{self.name}' was not initialized")
        check_deadline(event, self.name)
        fire(FaultPoints.serving_step, step=self.name, event=event)
        if self._resilience is not None:
            return self._resilience.call(lambda: self._execute(event),
                                         context=self.context)
        return self._execute(event)

    def _execute(self, event):
        needs_event = self.full_event or getattr(
            self._object, "_needs_event", False) or (
            self._object is not None
            and getattr(self._handler_fn, "__name__", "") in ("do_event",))
        if needs_event:
            result = self._handler_fn(event)
            return result if result is not None else event
        data = self._extract_input(event)
        result = self._handler_fn(data)
        return self._apply_result(event, result)


class ErrorStep(TaskStep):
    kind = "error_step"


class RouterStep(TaskStep):
    """Step holding routes and dispatching events to them."""

    kind = "router"
    _dict_fields = BaseStep._dict_fields + ["routes"]

    def __init__(self, class_name=None, class_args=None, handler=None,
                 name=None, after=None, routes: dict | None = None):
        super().__init__(class_name or "ModelRouter", class_args, handler,
                         name, after)
        self.routes: dict[str, TaskStep] = routes or {}

    def to_dict(self, exclude=None):
        # routes hold live step objects — serialize them
        out = super().to_dict(exclude=(exclude or []) + ["routes"])
        out["routes"] = {key: route.to_dict()
                         for key, route in self.routes.items()}
        return out

    def add_route(self, key: str, route: "TaskStep | None" = None,
                  class_name=None, handler=None, function=None,
                  **class_args) -> TaskStep:
        if route is None:
            route = TaskStep(class_name, class_args, handler, name=key,
                             function=function)
        route.name = key
        route.set_parent(self._parent)
        self.routes[key] = route
        return route

    def add_replica_routes(self, count: int, class_name=None,
                           key_prefix: str = "replica",
                           **class_args) -> list["TaskStep"]:
        """Declare ``count`` identical replica routes
        (``<key_prefix>-0`` … ``<key_prefix>-N-1``) — the fleet topology
        behind ``PrefixAffinityRouter``, where every route is an
        interchangeable model replica rather than a distinct model."""
        if count < 1:
            raise GraphError(
                f"router '{self.name}': replica count must be >= 1, "
                f"got {count}")
        return [self.add_route(f"{key_prefix}-{i}", class_name=class_name,
                               **dict(class_args))
                for i in range(count)]

    def clear_children(self, routes: list[str] | None = None):
        if routes is None:
            self.routes = {}
        else:
            for key in routes:
                self.routes.pop(key, None)

    def init_object(self, context, namespace: dict, mode: str = "sync"):
        self.class_args = dict(self.class_args)
        self.class_args["routes"] = self.routes
        super().init_object(context, namespace, mode)
        for route in self.routes.values():
            route.init_object(context, namespace, mode)

    def run(self, event, *args, **kwargs):
        check_deadline(event, self.name)
        fire(FaultPoints.serving_step, step=self.name, event=event)

        def _dispatch():
            result = self._handler_fn(event)
            return result if result is not None else event

        if self._resilience is not None:
            return self._resilience.call(_dispatch, context=self.context)
        return _dispatch()


class QueueStep(BaseStep):
    """Stream/queue boundary. With a stream path the event is pushed to the
    stream (monitoring pipeline); in an async flow the downstream steps
    consume on worker threads."""

    kind = "queue"
    _dict_fields = BaseStep._dict_fields + [
        "path", "shards", "retention_in_hours", "max_queue_size", "max_wait"]

    def __init__(self, name=None, path: str = "", after=None, shards=None,
                 retention_in_hours=None, max_queue_size: int | None = None,
                 max_wait: float | None = None, **options):
        super().__init__(name, after)
        self.path = path
        self.shards = shards
        self.retention_in_hours = retention_in_hours
        self.max_queue_size = max_queue_size
        self.max_wait = max_wait
        self.options = options
        self._stream = None
        self._queue = None
        self._workers = None
        self._pending = 0
        self._lock = None
        self._shed = 0
        self._errors = 0

    def _validate_bounds(self):
        if self.max_queue_size is not None:
            if not isinstance(self.max_queue_size, int) \
                    or self.max_queue_size <= 0:
                raise GraphError(
                    f"queue '{self.name}': max_queue_size must be a "
                    f"positive int, got {self.max_queue_size!r}")
        if self.max_wait is not None:
            if not isinstance(self.max_wait, (int, float)) \
                    or self.max_wait <= 0:
                raise GraphError(
                    f"queue '{self.name}': max_wait must be a positive "
                    f"number of seconds, got {self.max_wait!r}")

    def init_object(self, context, namespace, mode="sync"):
        self._validate_bounds()
        self.context = context
        if self.path:
            from .streams import get_stream_pusher

            self._stream = get_stream_pusher(self.path, **self.options)
        if mode == "async" and self._parent is not None:
            import queue as queue_mod
            import threading

            self._queue = queue_mod.Queue()
            self._lock = threading.Lock()
            self._workers = [
                threading.Thread(target=self._consume, daemon=True)
                for _ in range(int(self.shards or 1))
            ]
            for worker in self._workers:
                worker.start()

    def _consume(self):
        """Worker loop: pop events, run the downstream subgraph."""
        import time as time_mod

        while True:
            event, enqueued = self._queue.get()
            try:
                waited = time_mod.monotonic() - enqueued
                if self.max_wait is not None and waited > self.max_wait:
                    # queue-time budget spent: shed instead of burning
                    # device time on a request the caller has given up on
                    self._record_shed("max_wait", waited=round(waited, 3))
                    continue
                try:
                    check_deadline(event, self.name)
                except DeadlineExceeded:
                    self._record_shed("deadline", waited=round(waited, 3))
                    continue
                self._parent._run_downstream(self, event)
            except Exception as exc:  # noqa: BLE001 - async branch errors
                self._handle_async_error(event, exc)
            finally:
                with self._lock:
                    self._pending -= 1
                self._queue.task_done()

    def _record_shed(self, reason: str, **fields):
        self._shed += 1
        logger.warning("queue shed event", step=self.name, reason=reason,
                       shed_total=self._shed, **fields)
        incr = getattr(self.context, "incr", None)
        if callable(incr):
            incr(f"queue.{self.name}.shed")

    def _handle_async_error(self, event, exc: Exception):
        """Async-branch failure: count it on the server, surface it in
        metrics, and route through ``on_error`` when one is set (a log
        and swallow would hide every async failure)."""
        self._errors += 1
        server = getattr(self.context, "server", None)
        if server is not None and hasattr(server, "record_step_error"):
            server.record_step_error(self.name)
        incr = getattr(self.context, "incr", None)
        if callable(incr):
            incr(f"queue.{self.name}.errors")
        handler = None
        if self.on_error and self._parent is not None:
            handler = self._parent._steps.get(self.on_error)
        if handler is not None:
            error_event = copy.copy(event)
            error_event.error = str(exc)
            try:
                # observed like any step: the error handler is often
                # the slowest hop of a failing request and must show
                # in the latency histogram and the span tree
                self._parent._observed_run(handler, error_event)
                return
            except Exception as handler_exc:  # noqa: BLE001
                logger.error("queue on_error handler failed",
                             step=self.name, handler=self.on_error,
                             error=str(handler_exc))
        logger.error("async queue branch failed", step=self.name,
                     error=str(exc))

    def run(self, event, *args, **kwargs):
        if self._stream is not None:
            body = event.body if not self.full_event else event.__dict__
            self._stream.push(body)
        if self._queue is not None:
            import time as time_mod

            check_deadline(event, self.name)
            fire(FaultPoints.serving_queue, step=self.name, event=event)
            if self.max_queue_size is not None \
                    and self._queue.qsize() >= self.max_queue_size:
                # reject-newest load shedding: answer in microseconds
                # instead of growing an unbounded backlog
                self._record_shed("queue_full",
                                  max_queue_size=self.max_queue_size)
                raise QueueFullError(
                    f"queue '{self.name}' is full "
                    f"(max_queue_size={self.max_queue_size})")
            with self._lock:
                self._pending += 1
            self._queue.put((copy.deepcopy(event), time_mod.monotonic()))
            return None  # downstream continues on a worker thread
        return event

    @property
    def shed_count(self) -> int:
        """Events shed by this queue (full / max_wait / deadline)."""
        return self._shed

    @property
    def error_count(self) -> int:
        """Async branch errors observed below this queue."""
        return self._errors

    def wait_empty(self, timeout: float = 30.0) -> bool:
        """Drain; True when empty, False on timeout (callers must not treat
        a timeout as completion)."""
        if self._queue is None:
            return True
        import time as time_mod

        deadline = time_mod.monotonic() + timeout
        while time_mod.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time_mod.sleep(0.01)
        return False


class JoinStep(BaseStep):
    """Merge fan-out branches: buffers the event per id until all parent
    branches delivered, then emits one merged event (dict bodies are
    union-merged; non-dict bodies are collected into a list)."""

    kind = "join"

    def __init__(self, name=None, after=None, expected: int | None = None):
        super().__init__(name, after)
        self.expected = expected
        self._pending: dict = {}
        self._lock = None

    def init_object(self, context, namespace, mode="sync"):
        import threading

        self._lock = threading.Lock()
        self._pending = {}

    def run(self, event, *args, **kwargs):
        expected = self.expected or max(len(self.after or []), 1)
        key = getattr(event, "id", None) or id(event)
        with self._lock:
            bucket = self._pending.setdefault(key, [])
            bucket.append(event.body)
            if len(bucket) < expected:
                return None  # wait for the remaining branches
            bodies = self._pending.pop(key)
        if all(isinstance(b, dict) for b in bodies):
            merged: dict = {}
            for body in bodies:
                merged.update(body)
        else:
            merged = bodies
        event.body = merged
        return event


class FlowStep(BaseStep):
    """A container of steps forming a DAG."""

    kind = "flow"
    _dict_fields = BaseStep._dict_fields + ["steps", "engine"]

    def __init__(self, name=None, steps: dict | None = None, after=None,
                 engine: str | None = None):
        super().__init__(name, after)
        self._steps: dict[str, BaseStep] = {}
        self.engine = engine or "sync"
        self._start_steps: list[BaseStep] = []
        self.context = None
        if steps:
            for step_name, step in steps.items():
                self._add_existing(step_name, step)

    # -- construction ------------------------------------------------------
    @property
    def steps(self) -> dict:
        return self._steps

    @steps.setter
    def steps(self, steps: dict):
        self._steps = {}
        for name, step in (steps or {}).items():
            self._add_existing(name, step)

    def _add_existing(self, name: str, step):
        if isinstance(step, dict):
            step = step_from_dict(step)
        step.name = name
        step.set_parent(self)
        self._steps[name] = step

    def add_step(self, class_name=None, name=None, handler=None,
                 model_path: str | None = None, after=None, function=None,
                 full_event=None, input_path=None, result_path=None,
                 graph_shape=None, resilience: dict | None = None,
                 **class_args) -> BaseStep:
        if class_name == "$queue" or (isinstance(class_name, str)
                                      and class_name == "queue"):
            step = QueueStep(name=name, path=class_args.pop("path", ""),
                             **class_args)
        elif isinstance(class_name, str) and class_name in ("$join", "join"):
            step = JoinStep(name=name,
                            expected=class_args.pop("expected", None))
        elif isinstance(class_name, str) and class_name == "$router":
            step = RouterStep(name=name, class_args=class_args)
        elif isinstance(class_name, RouterStep):
            step = class_name
            step.name = name or step.name
        else:
            if model_path is not None:
                class_args["model_path"] = model_path
            step = TaskStep(class_name, class_args, handler, name=name,
                            function=function, full_event=full_event,
                            input_path=input_path, result_path=result_path)
        step.name = step.name or f"step{len(self._steps)}"
        if after:
            step.after = [a if isinstance(a, str) else a.name for a in after]
        if resilience:
            validate_resilience_spec(resilience, step.name)
            step.resilience = resilience
        step.set_parent(self)
        self._steps[step.name] = step
        return step

    def to(self, class_name=None, name=None, handler=None, model_path=None,
           function=None, full_event=None, input_path=None, result_path=None,
           **class_args) -> BaseStep:
        """First step in the flow (or chain from the flow itself)."""
        return self.add_step(
            class_name=class_name, name=name, handler=handler,
            model_path=model_path, function=function, after=[],
            full_event=full_event, input_path=input_path,
            result_path=result_path, **class_args)

    def add_route(self, *args, **kwargs):
        raise GraphError("add_route is valid on router topology graphs only")

    # -- init / run --------------------------------------------------------
    def init_object(self, context, namespace, mode="sync"):
        self.context = context
        if self.engine == "async":
            mode = "async"
        for step in self._steps.values():
            step.init_object(context, namespace, mode)
        self._start_steps = [
            s for s in self._steps.values() if not s.after
        ] or list(self._steps.values())[:1]
        self.check_and_process_graph()

    def check_and_process_graph(self, allow_empty: bool = False):
        """Validate the DAG: unknown after-references and cycles."""
        for step in self._steps.values():
            for parent in step.after or []:
                if parent not in self._steps:
                    raise GraphError(
                        f"step '{step.name}' is after unknown step '{parent}'")
        # cycle check via DFS
        visiting: set[str] = set()
        done: set[str] = set()

        def visit(name: str):
            if name in done:
                return
            if name in visiting:
                raise GraphError(f"graph has a cycle through '{name}'")
            visiting.add(name)
            for child in self._children(name):
                visit(child.name)
            visiting.discard(name)
            done.add(name)

        for step in self._start_steps:
            visit(step.name)

    def _children(self, name: str) -> list[BaseStep]:
        return [s for s in self._steps.values() if name in (s.after or [])]

    def _observed_run(self, step: BaseStep, event):
        """One step execution wrapped in telemetry: the per-step latency
        histogram always, plus a child span (parented on the server's
        root span) when the event carries a trace id."""
        tracer = getattr(self.context, "tracer", None)
        trace_id = getattr(event, "trace_id", None)
        span = None
        if tracer is not None and trace_id:
            span = tracer.start_span(
                f"step.{step.name}", trace_id=trace_id,
                parent_id=getattr(event, "span_id", None),
                attrs={"kind": step.kind}, activate=True)
        started = time.perf_counter()
        try:
            result = step.run(event)
        except Exception:
            STEP_LATENCY.observe(time.perf_counter() - started,
                                 step=step.name or "")
            if span is not None:
                tracer.end_span(span, status="error")
            raise
        STEP_LATENCY.observe(time.perf_counter() - started,
                             step=step.name or "")
        if span is not None:
            tracer.end_span(span)
        return result

    def run(self, event, *args, **kwargs):
        """Execute the DAG synchronously: follow after-links from the start
        steps; the responder step's (or last) result becomes the response."""
        response = None
        queue: list[tuple[BaseStep, Any]] = [
            (step, event) for step in self._start_steps]
        while queue:
            step, current = queue.pop(0)
            try:
                result = self._observed_run(step, current)
            except DeadlineExceeded:
                # no budget left — a fallback handler would still miss the
                # deadline, so always propagate as a fast 504
                raise
            except Exception as exc:  # noqa: BLE001 - route to error handler
                if step.on_error and step.on_error in self._steps:
                    error_event = copy.copy(current)
                    error_event.error = str(exc)
                    result = self._observed_run(
                        self._steps[step.on_error], error_event)
                else:
                    raise
            if result is None and isinstance(step, (QueueStep, JoinStep)):
                # queue: downstream continues on workers; join: waiting for
                # the remaining branches
                continue
            if getattr(step, "responder", False):
                response = result
            children = self._children(step.name)
            if not children and response is None:
                response = result
            for index, child in enumerate(children):
                # fan-out: siblings beyond the first get their own event copy
                # so one branch's output never leaks into another
                queue.append(
                    (child, result if index == 0 else copy.deepcopy(result)))
        return response

    def _run_downstream(self, from_step: BaseStep, event):
        """Run the subgraph below ``from_step`` (async queue workers)."""
        queue: list[tuple[BaseStep, Any]] = [
            (child, event) for child in self._children(from_step.name)]
        while queue:
            step, current = queue.pop(0)
            try:
                result = self._observed_run(step, current)
            except DeadlineExceeded:
                raise
            except Exception as exc:  # noqa: BLE001
                if step.on_error and step.on_error in self._steps:
                    error_event = copy.copy(current)
                    error_event.error = str(exc)
                    result = self._observed_run(
                        self._steps[step.on_error], error_event)
                else:
                    raise
            if result is None and isinstance(step, (QueueStep, JoinStep)):
                continue
            for index, child in enumerate(self._children(step.name)):
                queue.append(
                    (child, result if index == 0 else copy.deepcopy(result)))

    def _flush(self, timeout: float = 30.0) -> bool:
        drained = True
        for step in self._steps.values():
            if isinstance(step, QueueStep):
                if not step.wait_empty(timeout):
                    logger.warning("async queue did not drain within timeout",
                                   step=step.name, timeout=timeout)
                    drained = False
        return drained

    def plot(self, filename=None, format=None, **kw):
        """Render the graph as mermaid text (graphviz-free)."""
        lines = ["graph LR"]
        for step in self._steps.values():
            for parent in step.after or []:
                lines.append(f"  {parent} --> {step.name}")
            if isinstance(step, RouterStep):
                for route in step.routes:
                    lines.append(f"  {step.name} -.-> {route}")
        text = "\n".join(lines)
        if filename:
            with open(filename, "w") as fp:
                fp.write(text)
        return text

    def to_dict(self, exclude=None):
        out = super().to_dict(exclude=["steps"])
        out["steps"] = {name: step.to_dict()
                        for name, step in self._steps.items()}
        return out


class RootFlowStep(FlowStep):
    """Top-level graph."""

    kind = "flow"


def step_from_dict(struct: dict) -> BaseStep:
    kind = struct.get("kind", "task")
    cls = {"task": TaskStep, "router": RouterStep, "queue": QueueStep,
           "flow": FlowStep, "error_step": ErrorStep,
           "join": JoinStep}.get(kind, TaskStep)
    step = cls.from_dict(struct)
    if kind == "router" and isinstance(step.routes, dict):
        step.routes = {
            key: (step_from_dict(r) if isinstance(r, dict) else r)
            for key, r in step.routes.items()
        }
    if kind == "flow":
        inner = struct.get("steps", {})
        step._steps = {}
        for name, sub in inner.items():
            step._add_existing(name, sub)
    return step


def graph_root_setter(server, graph):
    """Set a graph object or build one from a topology string/dict."""
    if isinstance(graph, dict):
        graph = step_from_dict(graph)
    if isinstance(graph, str):
        if graph == "router":
            graph = RouterStep()
        elif graph == "flow":
            graph = RootFlowStep()
        else:
            raise GraphError(f"unsupported topology '{graph}'")
    if isinstance(graph, RouterStep):
        root = RootFlowStep()
        graph.name = graph.name or "router"
        root._add_existing(graph.name, graph)
        root._router = graph
        return root
    if not isinstance(graph, FlowStep):
        raise GraphError("graph must be a router or flow step")
    return graph
