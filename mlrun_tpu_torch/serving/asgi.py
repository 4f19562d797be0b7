"""HTTP gateway hosting a serving graph — the port's copy of
``mlrun_tpu/serving/asgi.py`` on the standard library (``http.server``):
the card's machine has no ``aiohttp``.

The reference's aiohttp app and this one answer the same routes with the
same statuses, JSON bodies, ``Content-Type`` and ``Retry-After``:

- every other path and method runs ``GraphServer.run`` on ONE worker
  thread, as the reference's single executor thread does: concurrent
  requests are served one after another, and an engine batches the
  prompts of one request's ``inputs``;
- ``/healthz``, ``/readyz`` (503 while warming or draining), ``/metrics``
  (Prometheus text 0.0.4, or OpenMetrics by ``Accept``), ``/__stats__``
  and the ``/debug`` routes count themselves on
  ``mlt_probe_requests_total`` and never allocate spans;
- ``POST /__drain__`` drains in the request's own thread.

``build_serving_app(server)`` returns a :class:`ServingApp`;
``app.bind(host, port)`` gives a ``ThreadingHTTPServer`` (one thread per
connection) and ``serve(...)`` runs one until the process ends. The graph
comes from a spec dict or the ``SERVING_SPEC_ENV`` contract
(``server_from_env``); SIGTERM belongs to the ``PreemptionGuard``, whose
watcher drains the server, never to the HTTP server.
"""

from __future__ import annotations

import concurrent.futures
import http.server
import json
import os
import re
import threading
import time
import urllib.parse

from ..config import EXEC_CODE_ENV, OBSERVABILITY_DEFAULTS
from ..obs import (
    CONTENT_TYPE,
    OPENMETRICS_CONTENT_TYPE,
    PROBE_REQUESTS,
    REGISTRY,
    wants_openmetrics,
)
from ..utils import logger
from .server import GraphContext, GraphServer, MockEvent, Response

# the reference app's client_max_size
MAX_BODY_BYTES = 64 * 1024 * 1024
JSON_CONTENT_TYPE = "application/json; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; charset=utf-8"
# aiohttp's type for a bytes body without one
BYTES_CONTENT_TYPE = "application/octet-stream"
_TRACE_ROUTE = re.compile(r"^/debug/trace/([^{}/]+)$")


def _json(payload, status: int = 200, headers: dict | None = None,
          default=None) -> tuple:
    body = json.dumps(payload, default=default).encode()
    return status, {"Content-Type": JSON_CONTENT_TYPE, **(headers or {})}, \
        body


def _text(text: str, status: int) -> tuple:
    return status, {"Content-Type": TEXT_CONTENT_TYPE}, text.encode()


class ServingApp:
    """The gateway's routes over one :class:`GraphServer`.

    :meth:`respond` maps one request (method, path with query, headers,
    raw body) to ``(status, headers, body bytes)``; :meth:`bind` serves it
    over HTTP/1.1."""

    def __init__(self, server: GraphServer):
        self.server = server
        self.latencies: list[float] = []
        # handler threads append concurrently
        self._latency_lock = threading.Lock()
        # single worker thread: device work serializes anyway, and the
        # reference runs every graph call on one executor thread
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-graph")
        self._get_routes = {
            "/healthz": self._healthz, "/readyz": self._readyz,
            "/metrics": self._metrics, "/debug/flight": self._debug_flight,
            "/debug/profile": self._debug_profile_get,
            "/__stats__": self._stats,
        }
        self._post_routes = {"/debug/profile": self._debug_profile_post,
                             "/__drain__": self._drain}

    # -- dispatch ------------------------------------------------------------
    def respond(self, method: str, target: str, headers: dict,
                raw: bytes) -> tuple:
        parsed = urllib.parse.urlsplit(target)
        path = urllib.parse.unquote(parsed.path) or "/"
        query = {k: v[0] for k, v in urllib.parse.parse_qs(
            parsed.query, keep_blank_values=True).items()}
        request = {"method": method, "path": path, "query": query,
                   "headers": headers, "raw": raw}
        # a GET route answers HEAD too; another method on its path falls
        # through to the graph, as the reference's catch-all route takes it
        routes = self._get_routes if method in ("GET", "HEAD") \
            else self._post_routes if method == "POST" else {}
        route = routes.get(path)
        trace = _TRACE_ROUTE.match(path)
        if route is None and trace and method in ("GET", "HEAD"):
            request["trace_id"] = trace.group(1)
            route = self._debug_trace
        return (route or self._handle)(request)

    def _handle(self, request) -> tuple:
        started = time.perf_counter()
        body = None
        raw = request["raw"]
        if raw:
            content_type = _header(request["headers"], "Content-Type")
            if "json" in content_type or raw[:1] in (b"{", b"["):
                try:
                    body = json.loads(raw)
                except ValueError:
                    body = raw
            else:
                body = raw
        event = MockEvent(body=body, path=request["path"],
                          method=request["method"],
                          headers=dict(request["headers"]))
        result = self._executor.submit(
            lambda: self.server.run(event, get_body=True)).result()
        with self._latency_lock:
            self.latencies.append(time.perf_counter() - started)
            if len(self.latencies) > 10000:
                del self.latencies[:5000]
        headers = {}
        if isinstance(result, Response):
            payload = result.body
            status = result.status_code
            # server-set response headers (the 503 drain rejection's
            # Retry-After backoff hint) go through
            headers = {str(k): str(v)
                       for k, v in (result.headers or {}).items()}
        else:
            payload = result
            status = 200
        if isinstance(payload, (bytes, str)):
            return status, {"Content-Type": BYTES_CONTENT_TYPE, **headers}, \
                payload if isinstance(payload, bytes) else payload.encode()
        return _json(payload, status, headers, default=str)

    # -- probes: counted on one low-cost counter, never spanned ---------------
    def _stats(self, request) -> tuple:
        PROBE_REQUESTS.inc(path="/__stats__")
        with self._latency_lock:
            lat = sorted(self.latencies)
        n = len(lat)
        return _json({
            "requests": n,
            "p50_ms": round(lat[n // 2] * 1000, 2) if n else None,
            "p99_ms": round(lat[int(n * 0.99)] * 1000, 2) if n else None,
        })

    def _healthz(self, request) -> tuple:
        # liveness: 200 while the process serves, even mid-drain
        PROBE_REQUESTS.inc(path="/healthz")
        return _json(self.server.healthz())

    def _readyz(self, request) -> tuple:
        # readiness: 503 while the replica warms and from the moment drain
        # starts, with a Retry-After hint so the prober backs off on
        # schedule
        PROBE_REQUESTS.inc(path="/readyz")
        payload = self.server.readyz()
        if payload["ready"]:
            return _json(payload)
        from .resilience import retry_after_hint

        return _json(payload, 503,
                     {"Retry-After": f"{retry_after_hint():.3f}"})

    def _drain(self, request) -> tuple:
        # operational drain hook (the preemption path uses
        # GraphServer.drain_on_preemption instead)
        drained = self.server.drain()
        return _json({"drained": drained, "inflight": self.server.inflight})

    def _metrics(self, request) -> tuple:
        # the process-wide registry; an Accept header naming
        # application/openmetrics-text negotiates the OpenMetrics variant,
        # whose histogram buckets carry trace-id exemplars
        PROBE_REQUESTS.inc(path="/metrics")
        if not bool(OBSERVABILITY_DEFAULTS["metrics_enabled"]):
            return _text("metrics exposition is disabled "
                         "(observability.metrics_enabled)", 404)
        om = wants_openmetrics(_header(request["headers"], "Accept"))
        return 200, {"Content-Type": OPENMETRICS_CONTENT_TYPE if om
                     else CONTENT_TYPE}, \
            REGISTRY.render(openmetrics=om).encode()

    # -- debug: live reads of the flight ring and traces, on-demand capture ---
    def _debug_flight(self, request) -> tuple:
        from ..obs.debug import flight_snapshot

        PROBE_REQUESTS.inc(path="/debug/flight")
        query = request["query"]
        try:
            payload = flight_snapshot(query.get("kind", ""),
                                      query.get("limit", 0))
        except ValueError as exc:
            return _json({"error": str(exc)}, 400)
        return _json(payload, default=str)

    def _debug_trace(self, request) -> tuple:
        # an exemplar's trace id resolves into one waterfall with the
        # blocking critical path; ?local=1 answers from this process's
        # ring only (the leaf read peers serve each other)
        from ..obs.debug import trace_snapshot

        PROBE_REQUESTS.inc(path="/debug/trace")
        local_only = request["query"].get("local", "") in ("1", "true")
        try:
            payload = trace_snapshot(request["trace_id"],
                                     local_only=local_only)
        except ValueError as exc:
            return _json({"error": str(exc)}, 400)
        return _json(payload, default=str)

    def _debug_profile_get(self, request) -> tuple:
        from ..utils.profiler import profile_status

        PROBE_REQUESTS.inc(path="/debug/profile")
        return _json(profile_status())

    def _debug_profile_post(self, request) -> tuple:
        # arm utils/profiler for the next N steps/seconds on the live
        # engine ticking in this process — a production hot loop gets
        # profiled without a restart
        from ..obs.debug import profile_request

        body = {}
        if request["raw"]:
            try:
                body = json.loads(request["raw"])
            except ValueError:
                return _json({"error": "body must be JSON"}, 400)
        try:
            out = profile_request(body)
        except ValueError as exc:
            return _json({"error": str(exc)}, 400)
        return _json(out)

    # -- HTTP ----------------------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0
             ) -> http.server.ThreadingHTTPServer:
        """A ``ThreadingHTTPServer`` bound to (host, port) serving this
        app; run its ``serve_forever`` and end it with ``shutdown`` and
        ``server_close``. Port 0 takes a free port
        (``server_address[1]``)."""
        handler = type("Handler", (_Handler,), {"app": self})
        httpd = http.server.ThreadingHTTPServer((host, port), handler)
        httpd.daemon_threads = True
        return httpd

    def close(self):
        self._executor.shutdown(wait=False, cancel_futures=True)


def _header(headers: dict, name: str) -> str:
    lowered = name.lower()
    for key, value in headers.items():
        if key.lower() == lowered:
            return value
    return ""


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # an idle keep-alive connection is closed after this many seconds
    timeout = 120
    app: ServingApp

    def _serve(self):
        try:
            raw = self._read_body()
        except ValueError as exc:
            status, headers, body = _text(str(exc), 413)
        else:
            try:
                status, headers, body = self.app.respond(
                    self.command, self.path, dict(self.headers.items()), raw)
            except Exception as exc:  # noqa: BLE001 - the connection's
                # boundary: answer 500 as the reference's server does
                logger.error("gateway route failed", path=self.path,
                             error=f"{type(exc).__name__}: {exc}")
                status, headers, body = _text(
                    "500 Internal Server Error\n\n"
                    "Server got itself in trouble", 500)
        self.send_response(status)
        for key, value in headers.items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _read_body(self) -> bytes:
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            chunks, total = [], 0
            while True:
                size = int(self.rfile.readline().split(b";")[0], 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    return b"".join(chunks)
                total += size
                if total > MAX_BODY_BYTES:
                    self.close_connection = True
                    raise ValueError(
                        f"Maximum request body size {MAX_BODY_BYTES} "
                        "exceeded")
                chunks.append(self.rfile.read(size))
                self.rfile.readline()
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            raise ValueError(
                f"Maximum request body size {MAX_BODY_BYTES} exceeded, "
                f"actual body size {length}")
        return self.rfile.read(length) if length else b""

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_HEAD = \
        do_OPTIONS = _serve

    def log_message(self, format, *args):
        logger.debug("gateway request " + format % args)


def build_serving_app(server: GraphServer) -> ServingApp:
    return ServingApp(server)


def server_from_env(namespace: dict | None = None) -> GraphServer:
    """The graph server of the ``SERVING_SPEC_ENV`` spec, its classes and
    handlers resolved from ``namespace`` and from the base64 user code in
    ``MLT_EXEC_CODE`` (``config.EXEC_CODE_ENV``)."""
    spec_env = os.environ.get("SERVING_SPEC_ENV", "")
    if not spec_env:
        raise ValueError("SERVING_SPEC_ENV is not set")
    spec = json.loads(spec_env)
    server = GraphServer.from_dict(spec)
    context = GraphContext(server=server)
    full_namespace = dict(namespace or {})
    code = os.environ.get(EXEC_CODE_ENV, "")
    if code:
        import base64

        module_ns: dict = {}
        exec(compile(base64.b64decode(code).decode(),  # noqa: S102
                     "<serving-code>", "exec"), module_ns)
        full_namespace = {**module_ns, **full_namespace}
    server.init_states(context, full_namespace)
    return server


def serve(function=None, spec: dict | None = None, host: str = "0.0.0.0",
          port: int = 8080, namespace: dict | None = None):
    """Run the gateway until the process ends, for an object with
    ``to_mock_server`` (a serving function), a serialized spec, or the
    ``SERVING_SPEC_ENV`` contract."""
    if function is not None:
        server = function.to_mock_server(namespace=namespace)
        server.context.is_mock = False
    elif spec is not None:
        server = GraphServer.from_dict(spec)
        server.init_states(GraphContext(server=server), namespace or {})
    else:
        server = server_from_env(namespace)
    # preemptible replica: SIGTERM latches the guard, the watcher drains
    # in-flight events and flips /readyz before the grace period ends,
    # then stops the server (below)
    from ..training.preemption import PreemptionGuard

    guard = PreemptionGuard().install()
    # ready-means-warm: /readyz answers 503 until the warmup pass
    # finishes in the background — the pod serves probes immediately but
    # takes traffic only warm
    server.begin_warmup()
    threading.Thread(target=server.warmup, name="serving-warmup",
                     daemon=True).start()
    logger.info("serving graph gateway starting", host=host, port=port)
    # http.server installs no signal handler: the guard keeps SIGTERM, so
    # the first signal drains (readyz flips, in-flight finishes) and then
    # ends serve_forever — the process exits 0 with no request lost (the
    # reference's gateway stays up drained until a second signal, which
    # escalates to the default terminate here too)
    app = build_serving_app(server)
    httpd = app.bind(host, port)

    def drain_and_stop():
        server.drain()
        httpd.shutdown()

    guard.on_preempted(drain_and_stop, name="serving-drain-on-preemption")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        # SIGINT ends the gateway and returns, as the reference's
        # run_app does
        pass
    finally:
        httpd.server_close()
        app.close()
