"""In-process tracer of the port's engines — the span ring of
``mlrun_tpu/obs/tracing.py`` (same ``Span`` fields and ``Tracer`` calls:
``current()``, ``span()``, ``start_span()``/``end_span()``, ``emit()``,
``spans()``).

A request's submitting thread may hold an active span; the engines read
it at submit (``get_tracer().current()``) and, from the scheduler thread,
emit their ``llm.prefill`` / ``llm.decode`` phases as finished child
spans. Spans land in a bounded in-memory ring only: the reference's JSONL
export and its ``X-MLT-Trace`` header plumbing belong to the serving
graph, which the port does not have yet. Stdlib only.
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str = field(default_factory=new_span_id)
    parent_id: Optional[str] = None
    start: float = field(default_factory=time.time)
    end: Optional[float] = None
    status: str = "ok"
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_s": (self.end - self.start)
            if self.end is not None else None,
            "status": self.status,
            "attrs": self.attrs,
        }


class Tracer:
    """Span factory over a bounded ring. One process-wide instance
    (:func:`get_tracer`); tests may build isolated ones."""

    def __init__(self, ring: int = 2048):
        self._ring: deque[Span] = deque(maxlen=max(1, int(ring)))
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """Innermost active span on THIS thread (None off-request)."""
        stack = self._stack()
        return stack[-1] if stack else None

    def start_span(self, name: str, trace_id: str | None = None,
                   parent_id: str | None = None, attrs: dict | None = None,
                   activate: bool = False) -> Span:
        """Open a span, parented on the thread's current span unless a
        trace is given; ``activate`` makes it the thread's current span."""
        if trace_id is None:
            current = self.current()
            if current is not None:
                trace_id = current.trace_id
                if parent_id is None:
                    parent_id = current.span_id
            else:
                trace_id = new_trace_id()
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    attrs=dict(attrs or {}))
        if activate:
            self._stack().append(span)
        return span

    def end_span(self, span: Span, status: str | None = None):
        if span.end is not None:
            return
        span.end = time.time()
        if status:
            span.status = status
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        self._export(span)

    @contextlib.contextmanager
    def span(self, name: str, trace_id: str | None = None,
             parent_id: str | None = None, attrs: dict | None = None):
        """Context-managed activated span; errors mark status and
        propagate."""
        span = self.start_span(name, trace_id=trace_id, parent_id=parent_id,
                               attrs=attrs, activate=True)
        try:
            yield span
        except BaseException:
            self.end_span(span, status="error")
            raise
        self.end_span(span)

    def emit(self, name: str, trace_id: str, parent_id: str | None = None,
             start: float | None = None, end: float | None = None,
             status: str = "ok", attrs: dict | None = None) -> Span:
        """Record an already-finished span (scheduler phases resolve their
        start and end after the fact)."""
        now = time.time()
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    start=start if start is not None else now,
                    status=status, attrs=dict(attrs or {}))
        span.end = end if end is not None else now
        self._export(span)
        return span

    def _export(self, span: Span):
        with self._lock:
            self._ring.append(span)

    def spans(self, trace_id: str | None = None,
              name: str | None = None) -> list[Span]:
        with self._lock:
            snapshot = list(self._ring)
        return [s for s in snapshot
                if (trace_id is None or s.trace_id == trace_id)
                and (name is None or s.name == name)]

    def clear(self):
        with self._lock:
            self._ring.clear()


# process-wide tracer the engines emit into
tracer = Tracer()


def get_tracer() -> Tracer:
    return tracer
