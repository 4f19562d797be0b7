"""The port's serving graph (mlrun_tpu_torch.serving: states, server,
routers, remote, streams, v1_serving; obs.debug / obs.traceview;
PreemptionGuard.on_preempted) against mlrun_tpu's on the CPU.

Every scenario builds one graph spec with the reference's ServingRuntime
(``new_function(kind="serving")``, ``set_topology``, ``add_model``,
``_get_serving_spec()``), passes it through JSON, loads it into each
package's ``GraphServer.from_dict`` with that package's classes in the
namespace, runs the same events and compares what comes back: statuses,
bodies (trace ids masked), counters and the steps that ran. These are the
reference's graph contracts (``tests/test_serving_resilience.py``,
``tests/test_observability.py``, ``tests/test_serving_fleet.py``'s
affinity router) run on both packages. Remote steps call a scripted
standard-library HTTP server on 127.0.0.1 (port 0); backoff sleeps are
recorded, not slept.

Bounds: everything compared is equal; the only masked fields are trace
ids, event ids and the text of transport errors, whose wording is the
HTTP client's (``requests`` in the reference, ``urllib`` in the port).
"""

import base64
import copy
import http.server
import json
import re
import socket
import threading
import time
import types

import pytest
import requests

import mlrun_tpu
from mlrun_tpu import chaos as jchaos
from mlrun_tpu.obs import debug as jdebug
from mlrun_tpu.obs import traceview as jtraceview
from mlrun_tpu.obs.tracing import Tracer as JTracer
from mlrun_tpu.serving import asgi as jasgi
from mlrun_tpu.serving import remote as jremote
from mlrun_tpu.serving import resilience as jres
from mlrun_tpu.serving import server as jserver
from mlrun_tpu.serving import states as jstates
from mlrun_tpu.serving import v1_serving as jv1
from mlrun_tpu.serving import v2_serving as jv2
from mlrun_tpu.training import preemption as jpre
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch.obs import debug as tdebug
from mlrun_tpu_torch.obs import traceview as ttraceview
from mlrun_tpu_torch.obs.tracing import Tracer as TTracer
from mlrun_tpu_torch.serving import asgi as tasgi
from mlrun_tpu_torch.serving import fleet as tfleet
from mlrun_tpu_torch.serving import remote as tremote
from mlrun_tpu_torch.serving import resilience as tres
from mlrun_tpu_torch.serving import server as tserver
from mlrun_tpu_torch.serving import states as tstates
from mlrun_tpu_torch.serving import streams as tstreams
from mlrun_tpu_torch.serving import v1_serving as tv1
from mlrun_tpu_torch.serving import v2_serving as tv2
from mlrun_tpu_torch.training import preemption as tpre
from tests.torch_registries import registries_left_as_found  # noqa: F401

REF = types.SimpleNamespace(
    name="ref", server=jserver, states=jstates, remote=jremote, res=jres,
    chaos=jchaos, pre=jpre, v1=jv1, v2=jv2, debug=jdebug, tv=jtraceview,
    asgi=jasgi, Tracer=JTracer,
    refused=requests.exceptions.ConnectionError,
    HTTPError=requests.exceptions.HTTPError)
PORT = types.SimpleNamespace(
    name="port", server=tserver, states=tstates, remote=tremote, res=tres,
    chaos=tchaos, pre=tpre, v1=tv1, v2=tv2, debug=tdebug, tv=ttraceview,
    asgi=tasgi, Tracer=TTracer, refused=ConnectionRefusedError,
    HTTPError=tremote.HTTPError)
PKGS = (REF, PORT)


# -- helpers ------------------------------------------------------------------

def _spec(topology="flow", build=None, engine=None, **router_args) -> dict:
    """A graph spec as the reference's ServingRuntime writes it, through
    JSON (the ``SERVING_SPEC_ENV`` form)."""
    fn = mlrun_tpu.new_function("s", kind="serving")
    if topology == "flow":
        graph = fn.set_topology("flow", engine=engine)
    else:
        graph = fn.set_topology("router", **router_args)
    if build is not None:
        build(fn, graph)
    return json.loads(json.dumps(fn._get_serving_spec(), default=str))


def _server(pkg, spec, namespace=None, tracer=None):
    server = pkg.server.GraphServer.from_dict(copy.deepcopy(spec))
    if tracer is not None:
        server.tracer = tracer
    server.init_states(pkg.server.GraphContext(server=server),
                       dict(namespace or {}))
    return server


def _mask(value):
    """Trace ids and event ids masked: they are random per request; so
    are the seconds a deadline error quotes."""
    if isinstance(value, dict):
        return {k: ("<masked>" if k in ("trace_id", "id") else _mask(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    if isinstance(value, str):
        return re.sub(r"\d+\.\d+s past budget", "<t>s past budget", value)
    return value


def _out(result):
    """(status, masked body) of a ``GraphServer.test`` result."""
    if isinstance(result, (jserver.Response, tserver.Response)):
        return result.status_code, _mask(result.body)
    return 200, _mask(getattr(result, "body", result))


def _both(run):
    """``run(pkg)`` on the reference then on the port; both results."""
    return run(REF), run(PORT)


def _models(pkg, log=None):
    """The namespace of model classes on ``pkg``'s V2ModelServer."""
    log = [] if log is None else log

    class Doubler(pkg.v2.V2ModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            log.append((self.name, request["inputs"]))
            return [x * 2 for x in request["inputs"]]

    class Scorer(pkg.v2.V2ModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            bias = float(self.class_args.get("bias", 0.0))
            return [x + bias for x in request["inputs"]]

    class Labeler(pkg.v2.V2ModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            shift = int(self.class_args.get("shift", 0))
            return [(x + shift) % 3 for x in request["inputs"]]

    class Keyed(pkg.v2.V2ModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            return {self.name: sum(request["inputs"])}

    class Legacy(pkg.v1.MLModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            return [x - 1 for x in request["inputs"]]

    return {"Doubler": Doubler, "Scorer": Scorer, "Labeler": Labeler,
            "Keyed": Keyed, "Legacy": Legacy}


class _Scripted:
    """A scripted HTTP endpoint on 127.0.0.1: ``respond(method, path,
    body)`` gives (status, json payload); every request is recorded."""

    def __init__(self):
        self.calls = []
        self.respond = lambda method, path, body: (200, {"ok": True})
        scripted = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                body = json.loads(raw) if raw else None
                scripted.calls.append((self.command, self.path,
                                       dict(self.headers.items()), body))
                status, payload = scripted.respond(self.command, self.path,
                                                   body)
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = _serve

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.02},
            daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


@pytest.fixture()
def endpoint():
    scripted = _Scripted()
    yield scripted
    scripted.close()


def _script(endpoint, statuses):
    """Answer the next requests with ``statuses`` in turn, then 200."""
    pending = list(statuses)

    def respond(method, path, body):
        status = pending.pop(0) if pending else 200
        return status, ({"v": 2} if status == 200 else {"error": status})

    endpoint.respond = respond


def _closed_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# -- spec compatibility ----------------------------------------------------

def _router_graph(fn, graph):
    fn.add_model("m", class_name="Doubler", model_path="")
    fn.add_model("old", class_name="Legacy", model_path="")


def _flow_graph(fn, graph):
    graph.to(name="a", handler="inc", resilience={
        "circuit_breaker": {"failure_threshold": 7}}) \
        .to("$queue", name="q", path="memory://graph-spec-test") \
        .to(name="b", handler="inc").respond()


def _handlers():
    return {"inc": lambda x: x + 1}


@pytest.mark.parametrize("topology,build", [("router", _router_graph),
                                            ("flow", _flow_graph)])
def test_reference_spec_loads_serves_and_serializes_back(topology, build):
    """The reference's ServingRuntime spec, through JSON, loads in the
    port's GraphServer.from_dict: the port's to_dict gives the reference's
    dict (before and after init) and both serve the same answers."""
    spec = _spec(topology, build)
    ref = jserver.GraphServer.from_dict(copy.deepcopy(spec))
    port = tserver.GraphServer.from_dict(copy.deepcopy(spec))
    assert port.to_dict() == ref.to_dict()
    assert port.to_dict()["graph"] == spec["graph"]
    servers = [_server(pkg, spec, {**_models(pkg), **_handlers()})
               for pkg in PKGS]
    if topology == "router":
        events = [("/v2/models/m/infer", {"inputs": [1, 2]}),
                  ("/v2/models/old/infer", {"instances": [5]}),
                  ("/v2/models/", None)]
    else:
        events = [("/", 1), ("/", 41)]
    for path, body in events:
        want, got = (_out(s.test(path, body=body, get_body=True))
                     for s in servers)
        assert got == want
    assert json.loads(json.dumps(servers[1].to_dict(), default=str)) == \
        json.loads(json.dumps(servers[0].to_dict(), default=str))
    if topology == "flow":
        assert servers[1].graph.steps["a"]._resilience.breaker \
            .failure_threshold == 7
        assert tstreams.get_in_memory_stream("graph-spec-test").pull() == \
            [2, 42]


def test_server_from_env_with_exec_code(monkeypatch):
    """``SERVING_SPEC_ENV`` plus base64 user code in ``MLT_EXEC_CODE``:
    both packages' ``server_from_env`` resolve the graph's class from
    that code and serve the same body."""
    spec = _spec("router", lambda fn, g: fn.add_model(
        "m", class_name="Tripler", model_path=""))
    monkeypatch.setenv("SERVING_SPEC_ENV", json.dumps(spec))

    def run(pkg):
        code = ("from {}.serving.v2_serving import V2ModelServer\n"
                "class Tripler(V2ModelServer):\n"
                "    def load(self):\n"
                "        self.model = True\n"
                "    def predict(self, request):\n"
                "        return [3 * x for x in request['inputs']]\n"
                ).format("mlrun_tpu" if pkg is REF else "mlrun_tpu_torch")
        monkeypatch.setenv("MLT_EXEC_CODE",
                           base64.b64encode(code.encode()).decode())
        server = pkg.asgi.server_from_env()
        return _out(server.test("/v2/models/m/infer",
                                body={"inputs": [1, 2]}))

    want, got = _both(run)
    assert got == want and got[1]["outputs"] == [3, 6]
    monkeypatch.delenv("SERVING_SPEC_ENV")
    for pkg in PKGS:
        with pytest.raises(ValueError, match="SERVING_SPEC_ENV"):
            pkg.asgi.server_from_env()


def test_v2_serving_init_and_handler_like_reference(monkeypatch):
    spec = _spec("flow", lambda fn, g: g.to(name="a", handler="inc")
                 .respond())
    monkeypatch.setenv("SERVING_SPEC_ENV", json.dumps(spec))

    def run(pkg):
        context = types.SimpleNamespace()
        server = pkg.server.v2_serving_init(context, _handlers())
        assert context._server is server
        event = pkg.server.MockEvent(body=4)
        return context.mlrun_handler(context, event, get_body=True)

    assert _both(run) == (5, 5)


# -- deadlines, admission, breakers -------------------------------------------

def test_deadline_expires_mid_graph_returns_504():
    spec = _spec("flow", lambda fn, g: g.to(name="slow", handler="ident")
                 .to(name="after", handler="record").respond())

    def run(pkg):
        ran = []
        server = _server(pkg, spec, {"ident": lambda x: x,
                                     "record": lambda x: ran.append(x) or x})
        with pkg.chaos.chaos.inject(
                pkg.chaos.FaultPoints.serving_step, delay=0.05,
                match=lambda ctx: ctx.get("step") == "slow"):
            out = server.test(body=1, headers={"X-MLT-Timeout": "0.01"},
                              silent=True, get_body=False)
        return (_out(out), ran,
                server.context.metrics.get("server.DeadlineExceeded"))

    want, got = _both(run)
    assert got == want
    assert got[0][0] == 504 and got[1] == [] and got[2] == 1


@pytest.mark.parametrize("topology", ["router", "flow"])
def test_expired_event_is_rejected_before_any_step(topology):
    """A request whose budget is spent on arrival: the router rejects it
    before the model; a flow before its first step."""
    if topology == "router":
        spec = _spec("router", lambda fn, g: fn.add_model(
            "m1", class_name="Doubler", model_path=""))
        path, body = "/v2/models/m1/infer", {"inputs": [1]}
    else:
        spec = _spec("flow", lambda fn, g: g.to(name="a", handler="record")
                     .respond())
        path, body = "/", 1

    def run(pkg):
        ran = []
        server = _server(pkg, spec, {**_models(pkg, ran),
                                     "record": lambda x: ran.append(x) or x})
        out = server.test(path, body=body, headers={"X-MLT-Timeout": "-1"},
                          silent=True, get_body=False)
        return _out(out), ran

    want, got = _both(run)
    assert got == want and got[0][0] == 504 and got[1] == []


def test_step_admission_rejects_with_429():
    spec = _spec("flow", lambda fn, g: g.to(
        name="a", handler="ident",
        resilience={"admission": {"rate": 0.001, "burst": 2}}).respond())

    def run(pkg):
        server = _server(pkg, spec, {"ident": lambda x: x})
        outs = [_out(server.test(body=1, silent=True, get_body=False))
                for _ in range(3)]
        return outs, server.context.metrics["step.a.admission_rejected"]

    want, got = _both(run)
    assert got == want
    assert [s for s, _ in got[0]] == [200, 200, 429] and got[1] == 1


def test_breaker_stops_calling_failed_endpoint_and_recovers(endpoint):
    """A breaker-wrapped RemoteStep with chaos-injected connection errors
    stops calling the endpoint after the threshold (503s), then recovers
    through a half-open probe against the live endpoint."""
    spec = _spec("flow", lambda fn, g: g.to(
        class_name="RemoteStep", name="dep", url=endpoint.url, retries=0)
        .respond().with_resilience(circuit_breaker={
            "failure_threshold": 2, "recovery_timeout": 30.0}))

    def run(pkg):
        server = _server(pkg, spec, {"RemoteStep": pkg.remote.RemoteStep})
        injection = pkg.chaos.chaos.inject(
            pkg.chaos.FaultPoints.serving_remote,
            error=pkg.refused("injected refusal"),
            match=lambda ctx: ctx.get("step") == "dep")
        try:
            statuses = [server.test(body={"q": 1}, silent=True,
                                    get_body=False).status_code
                        for _ in range(5)]
            calls = injection.calls
        finally:
            injection.remove()
        breaker = server.graph.steps["dep"]._resilience.breaker
        state, rejected = breaker.state, breaker.rejected
        breaker._opened_at = breaker._clock() - breaker.recovery_timeout - 1
        recovered = server.test(body={"q": 1})
        return (statuses, calls, state, rejected,
                server.context.metrics["step.dep.breaker_rejected"],
                recovered, breaker.state)

    want, got = _both(run)
    assert got == want
    assert got[0] == [500, 500, 503, 503, 503] and got[1] == 2
    assert got[2] == "open" and got[3] == 3 and got[5] == {"ok": True}
    assert got[6] == "closed"


def test_resilience_spec_validation_rejects_unknown_keys():
    def run(pkg):
        graph = pkg.states.RootFlowStep()
        errors = []
        for resilience in ({"bogus": {}},
                           {"circuit_breaker": {"treshold": 3}}):
            with pytest.raises(ValueError) as err:
                graph.add_step(name="bad", handler=lambda x: x,
                               resilience=resilience)
            errors.append(str(err.value))
        with pytest.raises(ValueError) as err:
            graph.to(name="a", handler=lambda x: x).with_resilience(
                admission={"rps": 5})
        return errors + [str(err.value)]

    want, got = _both(run)
    assert got == want
    assert "unknown resilience keys" in got[0]
    assert "unknown circuit_breaker keys" in got[1]
    assert "unknown admission keys" in got[2]


# -- queues ------------------------------------------------------------------

def _queue_spec(**queue_args):
    return _spec("flow", lambda fn, g: g.to("$queue", name="q", shards=1,
                                            **queue_args)
                 .to(name="work", handler="slow"), engine="async")


def test_queue_sheds_newest_when_full():
    spec = _queue_spec(max_queue_size=2)

    def run(pkg):
        release, entered = threading.Event(), threading.Event()

        def slow(x):
            entered.set()
            assert release.wait(5)
            return x

        server = _server(pkg, spec, {"slow": slow})
        try:
            outs = [_out(server.test(body=1, silent=True, get_body=False))]
            assert entered.wait(5)
            outs += [_out(server.test(body=b, silent=True, get_body=False))
                     for b in (2, 3, 4)]
            shed = (server.graph.steps["q"].shed_count,
                    server.context.metrics["queue.q.shed"])
        finally:
            release.set()
        server.wait_for_completion()
        return outs, shed

    want, got = _both(run)
    assert got == want
    assert [s for s, _ in got[0]] == [200, 200, 200, 429]
    assert got[1] == (1, 1)


def test_queue_max_wait_sheds_stale_events():
    spec = _queue_spec(max_wait=0.02)

    def run(pkg):
        release, entered = threading.Event(), threading.Event()
        processed = []

        def slow(x):
            if not entered.is_set():
                entered.set()
                assert release.wait(5)
            processed.append(x)
            return x

        server = _server(pkg, spec, {"slow": slow})
        server.test(body=1)
        assert entered.wait(5)
        server.test(body=2)
        time.sleep(0.05)
        release.set()
        server.wait_for_completion()
        return processed, server.graph.steps["q"].shed_count

    want, got = _both(run)
    assert got == want == ([1], 1)


def test_queue_async_error_routes_on_error_and_counts():
    def build(fn, graph):
        queue = graph.to("$queue", name="q", shards=1)
        queue.to(name="boom", handler="boom")
        graph.add_step(name="catcher", handler="catcher", full_event=True,
                       after=["boom"])
        queue.error_handler("catcher")

    spec = _spec("flow", build, engine="async")

    def run(pkg):
        caught = []

        def boom(x):
            raise ValueError("async boom")

        def catcher(event):
            caught.append(event.error)
            return event

        server = _server(pkg, spec, {"boom": boom, "catcher": catcher})
        server.test(body=7, silent=True)
        server.wait_for_completion()
        return (server.step_errors.get("q"),
                server.graph.steps["q"].error_count, caught)

    want, got = _both(run)
    assert got == want == (1, 1, ["async boom"])


def test_sync_error_handler_path_still_routes():
    def build(fn, graph):
        step = graph.to(name="boom", handler="boom")
        graph.add_step(name="catcher", handler="catcher", full_event=True,
                       after=[])
        step.error_handler("catcher")

    spec = _spec("flow", build)

    def boom(x):
        raise ValueError("sync boom")

    def run(pkg):
        server = _server(pkg, spec, {
            "boom": boom, "catcher": lambda e: {"caught": e.error}})
        return server.test(body=1)

    assert _both(run) == ({"caught": "sync boom"},) * 2


@pytest.mark.parametrize("bad", [{"max_queue_size": -1},
                                 {"max_wait": 0}])
def test_queue_spec_validation(bad):
    spec = _queue_spec(**bad)
    errors = []
    for pkg in PKGS:
        with pytest.raises(pkg.states.GraphError) as err:
            _server(pkg, spec, {"slow": lambda x: x})
        errors.append(str(err.value))
    assert errors[0] == errors[1] and next(iter(bad)) in errors[0]


# -- drain and preemption -------------------------------------------------------

def test_drain_completes_inflight_and_flips_readyz_before_escalation():
    spec = _spec("flow", lambda fn, g: g.to(name="work", handler="slow")
                 .respond())

    def run(pkg):
        release, entered = threading.Event(), threading.Event()

        def slow(x):
            entered.set()
            assert release.wait(5)
            return {"done": x}

        server = _server(pkg, spec, {"slow": slow})
        before = server.readyz()
        guard = pkg.pre.PreemptionGuard()  # not installed: no signals
        watcher = server.drain_on_preemption(guard, timeout=5)
        result = {}
        worker = threading.Thread(
            target=lambda: result.update(out=server.test(body=1)))
        worker.start()
        assert entered.wait(5)
        guard.request()
        deadline = time.monotonic() + 2
        while server.readyz()["ready"] and time.monotonic() < deadline:
            time.sleep(0.005)
        during = server.readyz()
        rejected = server.run(pkg.server.MockEvent(body=2))
        release.set()
        worker.join(timeout=5)
        watcher.join(timeout=5)
        return (before, during, rejected.status_code, rejected.body,
                rejected.headers, result["out"], server.inflight,
                watcher.is_alive(), server.healthz())

    want, got = _both(run)
    assert got == want
    before, during, status = got[:3]
    assert before["ready"] and not during["ready"] and during["draining"]
    assert during["inflight"] == 1 and status == 503
    assert "Retry-After" in got[4] and got[5] == {"done": 1}
    assert got[6] == 0 and not got[7] and got[8]["status"] == "ok"


def test_preemption_callback_runs_once_on_latch():
    def run(pkg):
        fired = []
        guard = pkg.pre.PreemptionGuard()
        thread = guard.on_preempted(lambda: fired.append(1))
        before = list(fired)
        guard.request()
        thread.join(timeout=2)
        return before, fired, thread.is_alive()

    assert _both(run) == (([], [1], False),) * 2


def test_warmup_gates_readyz():
    spec = _spec("router", _router_graph)

    def run(pkg):
        server = _server(pkg, spec, _models(pkg))
        server.begin_warmup()
        cold = server.readyz()
        server.warmup()
        return cold, server.readyz()

    want, got = _both(run)
    assert got == want
    assert not got[0]["ready"] and not got[0]["warm"] and got[1]["ready"]


# -- telemetry ---------------------------------------------------------------

def test_server_run_spans_and_context_metrics():
    spec = _spec("flow", lambda fn, g: g.to(name="echo", handler="ident")
                 .respond())

    def run(pkg):
        tracer = pkg.Tracer()
        server = _server(pkg, spec, {"ident": lambda x: x}, tracer=tracer)
        result = server.test(body={"a": 1}, headers={
            "X-MLT-Trace": "feed" * 8 + "-" + "ab" * 8})
        spans = {s.name: s for s in tracer.spans(trace_id="feed" * 8)}
        server.context.incr("custom.metric", 3)
        return (result, sorted(spans),
                spans["server.run"].parent_id,
                spans["step.echo"].parent_id == spans["server.run"].span_id,
                server.context.metrics)

    want, got = _both(run)
    assert got == want
    assert got[1] == ["server.run", "step.echo"] and got[2] == "ab" * 8
    assert got[3] and got[4] == {"custom.metric": 3}


# -- routers -------------------------------------------------------------------

def test_model_router_v1_and_listing_like_reference():
    spec = _spec("router", _router_graph)
    events = [("/v2/models/m/infer", {"inputs": [1, 2]}, ""),
              ("/v2/models/old/infer", {"instances": [4, 5]}, ""),
              ("/v2/models/", None, "GET"), ("/", None, "GET"),
              ("/v2/health", None, "GET"),
              ("/v2/models/m/ready", None, "GET"),
              ("/v2/models/nope/infer", {"inputs": [1]}, ""),
              ("/v2/models/m/infer", [3], "")]

    def run(pkg):
        server = _server(pkg, spec, _models(pkg))
        return [_out(server.test(p, body=b, method=m, silent=True,
                                 get_body=False)) for p, b, m in events]

    want, got = _both(run)
    assert got == want
    assert got[0] == (200, {"id": "<masked>", "model_name": "m",
                            "outputs": [2, 4]})
    assert got[6][0] == 500


def test_parallel_run_and_voting_ensemble_like_reference():
    def parallel(fn, graph):
        fn.add_model("x", class_name="Keyed", model_path="")
        fn.add_model("y", class_name="Keyed", model_path="")

    def voting(vote_type):
        def build(fn, graph):
            for i, (cls, arg) in enumerate(
                    (("Labeler", {"shift": 0}), ("Labeler", {"shift": 1}),
                     ("Labeler", {"shift": 0}))
                    if vote_type == "classification" else
                    (("Scorer", {"bias": 0.5}), ("Scorer", {"bias": 1.0}),
                     ("Scorer", {"bias": 3.0}))):
                fn.add_model(f"v{i}", class_name=cls, model_path="", **arg)
        return build

    cases = [(_spec("router", parallel, class_name="ParallelRun"),
              {"inputs": [1, 2, 3]}),
             (_spec("router", voting("classification"),
                    class_name="VotingEnsemble"), {"inputs": [0, 1, 2, 5]}),
             (_spec("router", voting("regression"),
                    class_name="VotingEnsemble",
                    weights={"v0": 2.0, "v1": 1.0, "v2": 1.0}),
              {"inputs": [0.25, 1.5]})]

    def run(pkg):
        outs = []
        for spec, body in cases:
            server = _server(pkg, spec, _models(pkg))
            outs.append(_out(server.test("/", body=body, get_body=False)))
        outs.append(_out(server.test("/v2/models/", method="GET",
                                     get_body=False)))
        return outs

    want, got = _both(run)
    assert got == want
    assert got[0][0] == 200 and got[0][1]["outputs"] == {"y": 6}
    assert got[1][1]["outputs"] == [0, 1, 2, 2]
    assert got[3][1]["models"] == ["v0", "v1", "v2"]


@pytest.mark.parametrize("router", ["EnrichmentModelRouter",
                                    "EnrichmentVotingEnsemble"])
def test_enrichment_routers_without_a_vector_route_as_their_base(router):
    spec = _spec("router", lambda fn, g: fn.add_model(
        "m", class_name="Doubler", model_path=""), class_name=router)

    def run(pkg):
        server = _server(pkg, spec, _models(pkg))
        return _out(server.test("/v2/models/m/infer",
                                body={"inputs": [1, 2]}, get_body=False))

    want, got = _both(run)
    assert got == want and got[1]["outputs"] == [2, 4]
    with_vector = _spec("router", lambda fn, g: fn.add_model(
        "m", class_name="Doubler", model_path=""), class_name=router,
        feature_vector_uri="store://feature-vectors/p/v")
    # a vector the run db does not hold: both packages' online feature
    # service refuses it at post_init with the db's own error
    errors = []
    for pkg in PKGS:
        with pytest.raises(Exception) as info:
            _server(pkg, with_vector, _models(pkg))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[1] == errors[0]


def _affinity_spec():
    def build(fn, router):
        router.add_replica_routes(3, class_name="Replica")

    return _spec("router", build, class_name="PrefixAffinityRouter",
                 route_block_tokens=4, route_blocks=2, backoff=0.001)


def _replica_class(pkg, failing: dict):
    class Replica(pkg.v2.V2ModelServer):
        def load(self):
            self.model = True

        def predict(self, request):
            error = failing.get(self.name)
            if error is not None:
                raise error
            return [self.name]

    return Replica


PROMPTS = [[7, 1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9, 9, 1, 1, 1, 1],
           [7, 1, 2, 3, 4, 5, 6, 7, 0], [1, 2, 3, 4, 5, 6, 7, 8],
           [2, 2, 2, 2, 2, 2, 2, 2], [3, 1, 4, 1, 5, 9, 2, 6],
           [9, 9, 9, 9, 1, 1, 1, 2], [5, 5, 5, 5, 6, 6, 6, 6]]


def test_prefix_affinity_router_routes_and_redispatches_like_reference():
    """The same prompts land on the same replicas in both packages; a
    replica answering ServerDrainingError or a 503 RemoteCallError is
    skipped for the next ring node (a 500 RemoteCallError is not), with
    the same counters."""
    spec = _affinity_spec()

    def run(pkg):
        failing = {}
        server = _server(pkg, spec,
                         {"Replica": _replica_class(pkg, failing)})

        def route(prompt):
            out = server.test("/", body={"inputs": [prompt]}, silent=True,
                              get_body=False)
            return _out(out)

        placed = [route(p) for p in PROMPTS]
        owner = placed[0][1]["outputs"][0]
        outs = {}
        for kind, error in (
                ("draining", pkg.res.ServerDrainingError("draining")),
                ("remote503", pkg.remote.RemoteCallError("down", 503)),
                ("remote500", pkg.remote.RemoteCallError("boom", 500))):
            failing.clear()
            failing[owner] = error
            outs[kind] = route(PROMPTS[0])
        failing.clear()
        router = server.graph.steps["router"]._object
        return (placed, outs, router.redispatches,
                server.context.metrics.get("router.router.redispatched"),
                _out(server.test("/v2/models/replica-1/infer",
                                 body={"inputs": [[1]]}, get_body=False)))

    want, got = _both(run)
    assert got == want
    placed, outs = got[0], got[1]
    assert len({p[1]["outputs"][0] for p in placed}) > 1
    assert placed[0] == placed[2]           # a shared leading block chain
    owner = placed[0][1]["outputs"][0]
    for kind in ("draining", "remote503"):
        assert outs[kind][0] == 200 and outs[kind][1]["outputs"][0] != owner
    assert outs["remote500"][0] == 500
    # the router's __init__ takes no explicit ``context``, so neither
    # package hands it one and the context counter stays unset
    assert got[2] == 2 and got[3] is None


def test_redispatchable_takes_remote_call_error_like_reference():
    from mlrun_tpu.serving import fleet as jfleet

    for status in (None, 400, 429, 500, 502, 503, 504):
        assert tfleet.redispatchable(tremote.RemoteCallError("x", status)) \
            == jfleet.redispatchable(jremote.RemoteCallError("x", status))


# -- remote steps --------------------------------------------------------------

def _remote_run(pkg, monkeypatch, make_step, event_kw=None):
    """(result or error, sleeps, status, cause class name) of one
    do_event on ``pkg``."""
    delays = []
    monkeypatch.setattr(pkg.remote, "_sleep", delays.append)
    step = make_step(pkg)
    event = pkg.server.MockEvent(body={"a": 1}, event_id="fixed",
                                 **(event_kw or {}))
    try:
        return ("ok", step.do_event(event).body, delays)
    except pkg.remote.RemoteCallError as exc:
        return ("error", exc.status_code, delays, exc.__cause__)


def test_remote_retries_5xx_then_succeeds(endpoint, monkeypatch):
    def run(pkg):
        _script(endpoint, [503, 502])
        return _remote_run(pkg, monkeypatch, lambda p: p.remote.RemoteStep(
            name="r", url=endpoint.url, retries=3, backoff=0.2))

    want, got = _both(run)
    assert got == want
    assert got[1] == {"v": 2} and len(got[2]) == 2 and got[2][1] > got[2][0]
    assert len(endpoint.calls) == 6


def test_remote_does_not_retry_4xx_and_preserves_cause(endpoint,
                                                       monkeypatch):
    def run(pkg):
        _script(endpoint, [404])
        out = _remote_run(pkg, monkeypatch, lambda p: p.remote.RemoteStep(
            name="r", url=endpoint.url, retries=5))
        assert isinstance(out[3], pkg.HTTPError)
        assert out[3].response.status_code == 404
        return out[:3] + (str(out[3]),)

    want, got = _both(run)
    assert got == want
    assert got[:3] == ("error", 404, [])
    assert got[3] == \
        f"404 Client Error: Not Found for url: {endpoint.url}/"
    assert len(endpoint.calls) == 2


def test_remote_5xx_backoff_is_deterministic(endpoint, monkeypatch):
    def run(pkg):
        endpoint.respond = lambda *a: (503, {})
        runs = [_remote_run(pkg, monkeypatch, lambda p: p.remote.RemoteStep(
            name="r", url=endpoint.url, retries=2, backoff=0.2))[:3]
            for _ in range(2)]
        assert runs[0] == runs[1]
        return runs[0]

    want, got = _both(run)
    assert got == want
    assert got[1] == 503 and len(got[2]) == 2 and got[2][1] > got[2][0]


def test_remote_connection_errors_retry_and_keep_no_status(monkeypatch):
    url = f"http://127.0.0.1:{_closed_port()}"

    def run(pkg):
        out = _remote_run(pkg, monkeypatch, lambda p: p.remote.RemoteStep(
            name="r", url=url, retries=2, backoff=0.01))
        assert pkg.remote._is_retryable(out[3])
        return out[:3]

    want, got = _both(run)
    assert got == want and got[:2] == ("error", None) and len(got[2]) == 2


def test_remote_chaos_connection_errors_then_success(endpoint, monkeypatch):
    def run(pkg):
        endpoint.respond = lambda *a: (200, {"v": 2})
        with pkg.chaos.chaos.inject(
                pkg.chaos.FaultPoints.serving_remote,
                pkg.chaos.fail_first(2),
                error=pkg.refused("refused")) as injection:
            out = _remote_run(pkg, monkeypatch,
                              lambda p: p.remote.RemoteStep(
                                  name="r", url=endpoint.url, retries=3,
                                  backoff=0.01))
        return out + (injection.calls,)

    want, got = _both(run)
    assert got == want and got[1] == {"v": 2} and got[3] == 3


def test_remote_clamps_http_timeout_to_deadline(endpoint, monkeypatch):
    seen = {}
    real_requests, real_port = requests.request, tremote.http_request

    def spy(real):
        def call(*args, **kwargs):
            seen.setdefault("timeouts", []).append(kwargs["timeout"])
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(requests, "request", spy(real_requests))
    monkeypatch.setattr(tremote, "http_request", spy(real_port))

    def run(pkg):
        step = pkg.remote.RemoteStep(name="r", url=endpoint.url, timeout=30)
        step.do_event(pkg.server.MockEvent(
            body={"a": 1}, deadline=time.monotonic() + 5.0))
        with pytest.raises(pkg.res.DeadlineExceeded):
            step.do_event(pkg.server.MockEvent(
                body={"a": 1}, deadline=time.monotonic() - 1))
        return len(endpoint.calls)

    assert _both(run) == (1, 2)
    assert len(seen["timeouts"]) == 2
    assert all(0 < t <= 5.0 for t in seen["timeouts"])  # not the 30 s


def test_batch_http_per_item_envelopes_and_retries(endpoint, monkeypatch):
    def respond(method, path, body):
        if body.get("boom"):
            return 500, {"error": "boom"}
        return 200, {"ok": body["i"]}

    endpoint.respond = respond
    items = [{"i": 0}, {"boom": True, "i": 1}, {"i": 2}]

    def run(pkg):
        monkeypatch.setattr(pkg.remote, "_sleep", lambda s: None)
        del endpoint.calls[:]
        step = pkg.remote.BatchHttpRequests(name="b", url=endpoint.url,
                                            retries=1, backoff=0.01)
        body = step.do_event(pkg.server.MockEvent(body=list(items))).body
        attempts = sum(1 for c in endpoint.calls if c[3].get("boom"))
        return body, attempts

    want, got = _both(run)
    assert got == want
    body, attempts = got
    assert body[0] == {"result": {"ok": 0}}
    assert body[2] == {"result": {"ok": 2}}
    assert body[1]["status_code"] == 500 and attempts == 2
    assert body[1]["error"] == (
        "remote step b failed: HTTPError: 500 Server Error: Internal "
        f"Server Error for url: {endpoint.url}/")


def test_batch_http_expired_deadline_is_fast_504(endpoint):
    def run(pkg):
        step = pkg.remote.BatchHttpRequests(name="b", url=endpoint.url)
        with pytest.raises(pkg.res.DeadlineExceeded) as err:
            step.do_event(pkg.server.MockEvent(
                body=[{"i": 0}, {"i": 1}], deadline=time.monotonic() - 1))
        return err.value.status_code

    assert _both(run) == (504, 504) and endpoint.calls == []


def test_remote_step_carries_the_trace_header(endpoint):
    """An outbound call inside a traced request carries ``X-MLT-Trace``
    with the remote span's id, under the step span, in both packages."""
    spec = _spec("flow", lambda fn, g: g.to(
        class_name="RemoteStep", name="hop", url=endpoint.url).respond())

    def run(pkg):
        del endpoint.calls[:]
        tracer = pkg.Tracer()
        server = _server(pkg, spec, {"RemoteStep": pkg.remote.RemoteStep},
                         tracer=tracer)
        trace_id = "cafe" * 8
        result = server.test(body={"inputs": [1]}, headers={
            "X-MLT-Trace": f"{trace_id}-1234567890abcdef"})
        spans = {s.name: s for s in tracer.spans(trace_id=trace_id)}
        sent = {k.lower(): v for k, v in endpoint.calls[0][2].items()}[
            "x-mlt-trace"]
        return (result, sorted(spans),
                spans["remote.hop"].parent_id == spans["step.hop"].span_id,
                sent == f"{trace_id}-{spans['remote.hop'].span_id}")

    want, got = _both(run)
    assert got == want
    assert got[1] == ["remote.hop", "server.run", "step.hop"]
    assert got[2] and got[3]


# -- obs/debug and obs/traceview -------------------------------------------------

def _spans(trace_id="ab" * 8):
    def span(name, span_id, parent, start, end, **attrs):
        return {"name": name, "trace_id": trace_id, "span_id": span_id,
                "parent_id": parent, "start": start, "end": end,
                "duration_s": end - start, "status": "ok", "attrs": attrs}

    return [span("server.run", "s1", "p0", 0.0, 1.0),
            span("step.router", "s2", "s1", 0.05, 0.95),
            span("remote.hop", "s3", "s2", 0.1, 0.6, replica="r1"),
            span("llm.prefill", "s4", "s3", 0.15, 0.3, replica="r1"),
            span("llm.decode", "s5", "s3", 0.3, 0.55, replica="r1",
                 timing={"wall_s": 0.4, "phases": {
                     "prefill": 0.15, "decode_active": 0.25}}),
            span("step.side", "s6", "s2", 0.2, 0.4),
            dict(span("server.run", "s7", None, 2.0, 2.0), end=None,
                 duration_s=None)]


def test_traceview_assembles_the_same_waterfall():
    spans = _spans()
    want = jtraceview.assemble("ab" * 8, jtraceview.merge_spans(
        spans, spans[:3]))
    got = ttraceview.assemble("ab" * 8, ttraceview.merge_spans(
        spans, spans[:3]))
    assert got == want
    assert got["root"] == "server.run" and got["replicas"] == ["r1"]
    assert abs(got["critical_path_s"] - 1.0) < 1e-12
    assert "reconciliation" in got


@pytest.mark.parametrize("body", [
    {"output_dir": "/tmp/x", "steps": 1}, {"key": "..", "steps": 1},
    {"key": "a/b", "steps": 1}, {"steps": "many"}, {"steps": 0},
    {"key": "k" * 65, "steps": 1}])
def test_profile_request_rejects_the_same_bodies(body):
    errors = []
    for debug in (jdebug, tdebug):
        with pytest.raises(ValueError) as err:
            debug.profile_request(dict(body))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_profile_request_arms_and_disarms_like_reference():
    outs = []
    for debug in (jdebug, tdebug):
        armed = debug.profile_request({"steps": 2, "key": "k1"})
        outs.append(({k: v for k, v in armed.items() if k != "armed_at"},
                     debug.profile_request({"disarm": True})))
    assert outs[0] == outs[1]
    assert outs[1][0]["armed"] and outs[1][1] == {"disarmed": True}


def test_flight_snapshot_parses_like_reference():
    for debug in (jdebug, tdebug):
        with pytest.raises(ValueError, match="limit must be an int"):
            debug.flight_snapshot("", "x")
    want = jdebug.flight_snapshot("nothing.here", 3)
    got = tdebug.flight_snapshot("nothing.here", 3)
    assert got["events"] == want["events"] == []
    assert set(got) == set(want)


def test_trace_snapshot_fans_out_and_degrades_like_reference(endpoint):
    """The local ring's spans merged with a live peer's over HTTP; a dead
    peer lands in ``sources`` and flips ``partial``, never failing the
    read; a bad id is refused."""
    peer_spans = [s for s in _spans("cd" * 8) if s["end"] is not None]
    endpoint.respond = lambda *a: (200, {"spans": peer_spans[1:]})
    dead = f"http://127.0.0.1:{_closed_port()}"

    def run(pkg):
        from importlib import import_module

        tracer = import_module(pkg.debug.__name__.rsplit(".", 1)[0]
                               + ".tracing").get_tracer()
        root = tracer.start_span("server.run", trace_id="cd" * 8)
        tracer.end_span(root)
        out = pkg.debug.trace_snapshot("cd" * 8,
                                       peers=[endpoint.url, dead],
                                       timeout=2.0)
        with pytest.raises(ValueError, match="hex"):
            pkg.debug.trace_snapshot("not-hex")
        assert out["sources"][dead]["ok"] is False
        out["sources"][dead]["error"] = "<masked>"
        out["spans"] = [s["name"] for s in out["spans"]]
        return ({k: v for k, v in out.items()
                 if k not in ("critical_path", "critical_path_s",
                              "phase_totals")},
                [s["name"] for s in out["critical_path"]])

    want, got = _both(run)
    assert got == want
    assert got[0]["partial"] and got[0]["sources"][endpoint.url]["ok"]
    assert got[0]["span_count"] == 6
