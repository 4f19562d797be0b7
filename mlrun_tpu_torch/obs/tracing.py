"""Tracer of the port's serving path — the port's copy of
``mlrun_tpu/obs/tracing.py`` (same ``Span`` fields and ``Tracer`` calls:
``current()``, ``span()``, ``start_span()``/``end_span()``, ``emit()``,
``inject()``, ``spans()``; the same ``X-MLT-Trace`` header contract).

A request's submitting thread may hold an active span; the engines read
it at submit (``get_tracer().current()``) and, from the scheduler thread,
emit their ``llm.prefill`` / ``llm.decode`` phases as finished child
spans. The trace id rides the ``X-MLT-Trace: <trace_id>-<parent_span_id>``
header across hops (:func:`parse_trace_header`, :func:`format_trace_header`,
``span(trace_id=..., parent_id=...)`` joins a caller's trace). Spans land
in a bounded in-memory ring and, when a path is configured, in a JSONL
file (one span object a line, size-capped rotation with one ``.1``
predecessor). A span may be emitted with a ``resolve`` callable for
attrs that are known only later (a training phase's device time): it
enters the ring at once, and its JSONL line waits until ``resolve``
reports it final (:meth:`Tracer.settle`). Stdlib only.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


# header the serving layers understand (case-insensitive):
#   X-MLT-Trace: <32-hex trace id>-<16-hex parent span id>
# (a bare trace id with no span part is accepted too)
TRACE_HEADER = "x-mlt-trace"

_HEX = set("0123456789abcdef")


def _is_hex(value: str) -> bool:
    return bool(value) and set(value) <= _HEX


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def trace_id_for(seed: str) -> str:
    """Deterministic trace id for an out-of-band correlation key (run
    uid): every lifecycle span of one run shares a trace without any
    header plumbing through k8s manifests."""
    return hashlib.md5(str(seed).encode()).hexdigest()  # noqa: S324


def _header_text(value) -> str:
    """Header keys/values may arrive as bytes from raw ASGI/WSGI layers;
    decode rather than str(), which would mangle them."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value).decode("latin-1", "replace")
    return str(value)


def parse_trace_header(headers: dict | None
                       ) -> tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) from request headers; (None, None) when
    absent or malformed — a garbage header never fails a request."""
    if not headers:
        return None, None
    value = None
    for key, candidate in headers.items():
        if _header_text(key).lower() == TRACE_HEADER:
            value = _header_text(candidate)
            break
    if not value:
        return None, None
    trace_id, _, parent = value.strip().lower().partition("-")
    if not _is_hex(trace_id) or len(trace_id) > 64:
        return None, None
    if parent and (not _is_hex(parent) or len(parent) > 32):
        parent = ""
    return trace_id, parent or None


def format_trace_header(trace_id: str, span_id: str | None = None) -> str:
    return f"{trace_id}-{span_id}" if span_id else trace_id


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
    """Span factory and exporter. One process-wide instance
    (:func:`get_tracer`); tests may build isolated ones."""

    # JSONL rotation default: one predecessor kept, so the on-disk span
    # footprint is bounded at ~2x this
    DEFAULT_MAX_BYTES = 64 * 1024 * 1024

    def __init__(self, ring: int = 2048, path: str | None = None,
                 max_bytes: int | None = None):
        self._ring: deque[Span] = deque(maxlen=max(1, int(ring)))
        self._path = path or None
        self._max_bytes = int(max_bytes if max_bytes is not None
                              else self.DEFAULT_MAX_BYTES)
        self._size: Optional[int] = None  # bytes in the active file
        self._file_lock = threading.Lock()
        self._local = threading.local()
        self._lock = threading.Lock()
        # spans whose attrs await their ``resolve`` callable, oldest first
        self._pending: deque = deque()
        self._pending_lock = threading.Lock()
        # the training phases' switch (utils/profiler.phase): on, they
        # record with no torch.profiler session too
        self.phases = False

    def configure(self, path: str | None = None, ring: int | None = None,
                  max_bytes: int | None = None,
                  phases: bool | None = None):
        """Set the JSONL path (``""`` turns the file export off), the
        ring size and the rotation cap.

        ``phases=True`` turns on the training step's phase capture
        (``utils.profiler.phase``) without a profiler: every step of
        ``Trainer.fit`` then lands in the ring (and the JSONL file) as
        ``train.step`` with its ``train.forward`` / ``train.backward`` /
        ``train.optimizer`` children, the ``moe.*`` spans of an MoE
        model, and ``train.data_wait`` / ``train.h2d`` /
        ``train.callbacks`` / ``train.metric_flush``, each with
        ``host_ns`` and, on a card, ``device_ms`` from CUDA events read
        after the fact (never a synchronise). ``False`` leaves capture to
        torch.profiler sessions alone (the default)."""
        if phases is not None:
            self.phases = bool(phases)
        if ring is not None:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(1, int(ring)))
        if path is not None:
            with self._file_lock:
                self._path = path or None
                self._size = None  # re-measured on the next export
        if max_bytes is not None:
            self._max_bytes = int(max_bytes)
        return self

    @property
    def path(self) -> Optional[str]:
        return self._path

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
             status: str = "ok", attrs: dict | None = None,
             span_id: str | None = None, resolve=None) -> Span:
        """Record an already-finished span (scheduler phases resolve their
        start and end after the fact). ``resolve(span) -> bool`` fills
        attrs known only later: the span is in the ring at once, and its
        JSONL line is written once ``resolve`` returns True."""
        now = time.time()
        span = Span(name=name, trace_id=trace_id, parent_id=parent_id,
                    start=start if start is not None else now,
                    status=status, attrs=dict(attrs or {}))
        if span_id is not None:
            span.span_id = span_id
        span.end = end if end is not None else now
        self._export(span, resolve)
        return span

    def inject(self, headers: dict | None = None,
               span: Span | None = None) -> dict:
        """A copy of ``headers`` carrying the trace context of ``span`` (or
        the thread's current span); absent context leaves them as they
        are."""
        headers = dict(headers or {})
        span = span or self.current()
        if span is not None:
            headers["X-MLT-Trace"] = format_trace_header(
                span.trace_id, span.span_id)
        return headers

    def _export(self, span: Span, resolve=None):
        with self._lock:
            self._ring.append(span)
        if resolve is not None:
            with self._pending_lock:
                self._pending.append((span, resolve))
        if self._pending:
            self.settle()
        if resolve is None:
            self._write(span)

    def settle(self) -> int:
        """Run the pending spans' ``resolve`` in emission order until one
        is not final yet, writing each final one's JSONL line; returns
        how many still wait. Never blocks. More pending spans than the
        ring holds are written as they are."""
        done = []
        with self._pending_lock:
            while self._pending:
                span, resolve = self._pending[0]
                try:
                    final = resolve(span)
                except Exception:  # noqa: BLE001 - a failed read is final
                    final = True
                if not final and len(self._pending) <= self._ring.maxlen:
                    break
                self._pending.popleft()
                done.append(span)
            left = len(self._pending)
        for span in done:
            self._write(span)
        return left

    def _write(self, span: Span):
        path = self._path
        if not path:
            return
        try:
            line = json.dumps(span.to_dict(), default=str) + "\n"
            with self._file_lock:
                directory = os.path.dirname(path)
                if directory:
                    os.makedirs(directory, exist_ok=True)
                if self._size is None:
                    try:
                        self._size = os.path.getsize(path)
                    except OSError:
                        self._size = 0
                # rotate BEFORE the write that would cross the cap,
                # keeping exactly one ``.1`` predecessor
                if self._max_bytes > 0 and self._size \
                        and self._size + len(line) > self._max_bytes:
                    os.replace(path, path + ".1")
                    self._size = 0
                with open(path, "a") as fp:
                    fp.write(line)
                self._size += len(line)
        except OSError:
            pass  # span export never fails the traced operation

    def spans(self, trace_id: str | None = None,
              name: str | None = None) -> list[Span]:
        """The ring's spans (pending ones settled first, as far as they
        can be)."""
        if self._pending:
            self.settle()
        with self._lock:
            snapshot = list(self._ring)
        return [s for s in snapshot
                if (trace_id is None or s.trace_id == trace_id)
                and (name is None or s.name == name)]

    def clear(self):
        with self._lock:
            self._ring.clear()
        with self._pending_lock:
            self._pending.clear()


# process-wide tracer the engines emit into
tracer = Tracer()


def get_tracer() -> Tracer:
    return tracer


def configure_from_mlconf():
    """Apply ``config.OBSERVABILITY_DEFAULTS`` (trace ring, JSONL path and
    rotation cap) to the process tracer; the config import is lazy so
    this module stays bottom-layer."""
    try:
        from ..config import OBSERVABILITY_DEFAULTS as obs_conf

        path = str(obs_conf.get("trace_path") or "") or None
        ring = obs_conf.get("trace_ring")
        max_bytes = obs_conf.get("trace_max_bytes")
        tracer.configure(path=path, ring=int(ring) if ring else None,
                         max_bytes=(int(max_bytes)
                                    if max_bytes is not None else None))
    except Exception:  # noqa: BLE001 - observability must not block startup
        pass
    return tracer
