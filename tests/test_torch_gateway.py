"""The port's HTTP gateway (mlrun_tpu_torch.serving.asgi, on the standard
library's ``http.server``) against the reference's aiohttp app, over real
localhost HTTP on the CPU.

Both apps serve the same graph spec (the reference's ServingRuntime spec,
through JSON) on 127.0.0.1 port 0, and the same requests, sent with
``urllib``, must give the same status, JSON body (ids, trace ids and
latencies masked), ``Content-Type`` and ``Retry-After`` on
``/v2/models/m/infer``, the model listing, the error payload, a raw body,
``/__stats__``, ``/healthz``, ``/readyz`` (warming and draining),
``/__drain__``, ``/metrics`` (text and OpenMetrics) and the ``/debug``
routes. A front graph with a ``RemoteStep`` carries a request's trace id
into the model gateway, whose ``/debug/trace/<id>`` shows it. Last, a
tiny paged ``LLMModelServer`` route on the converted reference weights
answers the same tokens over HTTP in both packages (margin rule of
``tests/test_torch_serving.py``).
"""

import asyncio
import copy
import json
import threading
import urllib.error
import urllib.request

import pytest

from mlrun_tpu.obs import REGISTRY as JREGISTRY
from mlrun_tpu.serving import asgi as jasgi
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.obs import REGISTRY as TREGISTRY
from mlrun_tpu_torch.serving import asgi as tasgi
from mlrun_tpu_torch.serving import llm as tllm
from tests.test_torch_graph import PORT, REF, _mask, _models, _server, _spec
from tests.test_torch_serving import PAGE, _min_margin, _tokens  # noqa: F401
from tests.test_torch_serving import models  # noqa: F401  (fixture)
from tests.torch_registries import registries_left_as_found  # noqa: F401


# -- serving both apps ---------------------------------------------------------

class _RefGateway:
    """The reference's aiohttp app on its own event loop thread."""

    def __init__(self, server):
        from aiohttp import web

        self.server = server
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        self.stop_event = None

        async def serve():
            runner = web.AppRunner(jasgi.build_serving_app(server))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.url = "http://127.0.0.1:%d" % runner.addresses[0][1]
            self.stop_event = asyncio.Event()
            started.set()
            await self.stop_event.wait()
            await runner.cleanup()

        self.thread = threading.Thread(
            target=lambda: self.loop.run_until_complete(serve()),
            daemon=True)
        self.thread.start()
        assert started.wait(10)

    def close(self):
        self.loop.call_soon_threadsafe(self.stop_event.set)
        self.thread.join(timeout=5)
        self.loop.close()


class _PortGateway:
    def __init__(self, server):
        self.server = server
        self.app = tasgi.build_serving_app(server)
        self.httpd = self.app.bind("127.0.0.1", 0)
        self.url = "http://127.0.0.1:%d" % self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, kwargs={"poll_interval": 0.02},
            daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)
        self.app.close()


def _open(pkg, server):
    return (_RefGateway if pkg is REF else _PortGateway)(server)


@pytest.fixture()
def pair():
    """(reference gateway, port gateway) over the same Doubler router."""
    spec = _spec("router", lambda fn, g: fn.add_model(
        "m", class_name="Doubler", model_path=""))
    gateways = [_open(pkg, _server(pkg, spec, _models(pkg)))
                for pkg in (REF, PORT)]
    yield gateways
    for gateway in gateways:
        gateway.close()


def _call(url, path, method="GET", body=None, data=None, headers=None):
    """(status, lower-cased headers, body bytes) of one request."""
    headers = dict(headers or {})
    if body is not None:
        data = json.dumps(body).encode()
        headers.setdefault("Content-Type", "application/json")
    request = urllib.request.Request(url + path, data=data, headers=headers,
                                     method=method)
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, {k.lower(): v for k, v in
                                 resp.headers.items()}, resp.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, {k.lower(): v for k, v in
                              exc.headers.items()}, exc.read()


def _view(response, mask_keys=()):
    """What both gateways must agree on: status, Content-Type,
    Retry-After and the body (JSON masked, or raw bytes)."""
    status, headers, raw = response
    try:
        body = _mask(json.loads(raw))
        for key in mask_keys:
            if key in body:
                body[key] = "<masked>"
    except ValueError:
        body = raw
    return (status, headers.get("content-type"), headers.get("retry-after"),
            body)


def _same(pair, path, mask_keys=(), **kwargs):
    want, got = (_view(_call(g.url, path, **kwargs), mask_keys)
                 for g in pair)
    assert got == want
    return got


# -- routes ------------------------------------------------------------------

CASES = [
    ("infer", "/v2/models/m/infer", dict(method="POST",
                                         body={"inputs": [1, 2, 3]})),
    ("listing", "/v2/models/", {}),
    ("root listing", "/", {}),
    ("error payload", "/v2/models/missing/infer",
     dict(method="POST", body={"inputs": [1]})),
    ("raw json body", "/v2/models/m/infer",
     dict(method="POST", data=json.dumps({"inputs": [5]}).encode(),
          headers={"Content-Type": "application/json"})),
    ("raw text body", "/v2/models/m/infer",
     dict(method="POST", data=b"hi", headers={"Content-Type":
                                              "text/plain"})),
    ("bad json body", "/v2/models/m/infer",
     dict(method="POST", data=b"{not json",
          headers={"Content-Type": "application/json"})),
    ("model ready", "/v2/models/m/ready", {}),
    ("post to a probe path", "/healthz", dict(method="POST",
                                              body={"inputs": [2]})),
    ("healthz", "/healthz", {}),
    ("readyz", "/readyz", {}),
    ("flight bad limit", "/debug/flight?limit=x", {}),
    ("profile status", "/debug/profile", {}),
    ("profile bad json", "/debug/profile", dict(method="POST", data=b"{x",
                                                headers={})),
    ("profile output_dir", "/debug/profile",
     dict(method="POST", body={"output_dir": "/tmp/x", "steps": 1})),
    ("profile bad key", "/debug/profile",
     dict(method="POST", body={"key": "..", "steps": 1})),
    ("trace bad id", "/debug/trace/not-hex", {}),
    ("trace bad path", "/debug/trace/", {}),
]


@pytest.mark.parametrize("name,path,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_route_answers_like_reference(pair, name, path, kwargs):
    status = _same(pair, path, **kwargs)[0]
    assert status in {"infer": (200,), "error payload": (500,),
                      "flight bad limit": (400,), "trace bad id": (400,),
                      "profile bad json": (400,)}.get(name, (status,))


def test_chunked_body_like_reference(pair):
    """A chunked request body (no Content-Length) reaches the graph whole
    in both gateways."""
    import http.client
    import urllib.parse

    answers = []
    for gateway in pair:
        address = urllib.parse.urlsplit(gateway.url)
        conn = http.client.HTTPConnection(address.hostname, address.port,
                                          timeout=30)
        try:
            conn.request("POST", "/v2/models/m/infer",
                         body=iter([b'{"inputs"', b": [1, ", b"2]}"]),
                         headers={"Content-Type": "application/json"},
                         encode_chunked=True)
            resp = conn.getresponse()
            answers.append(_view((resp.status, {
                k.lower(): v for k, v in resp.getheaders()}, resp.read())))
        finally:
            conn.close()
    assert answers[1] == answers[0]
    assert answers[1][3]["outputs"] == [2, 4]


def test_port_refuses_a_body_above_the_size_limit(pair):
    """A declared body above the reference app's client_max_size (64 MiB)
    gets 413 before any byte of it is read."""
    import socket
    import urllib.parse

    address = urllib.parse.urlsplit(pair[1].url)
    with socket.create_connection((address.hostname, address.port),
                                  timeout=30) as sock:
        sock.sendall(b"POST /v2/models/m/infer HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: %d\r\n\r\n"
                     % (tasgi.MAX_BODY_BYTES + 1))
        head = sock.recv(4096)
    assert head.startswith(b"HTTP/1.1 413")


def test_stats_and_flight_like_reference(pair):
    for _ in range(3):
        _same(pair, "/v2/models/m/infer", method="POST",
              body={"inputs": [1]})
    stats = _same(pair, "/__stats__", mask_keys=("p50_ms", "p99_ms"))
    assert stats[3]["requests"] == 3
    for gateway in pair:
        body = json.loads(_call(gateway.url, "/__stats__")[2])
        assert body["p50_ms"] > 0 and body["p99_ms"] >= body["p50_ms"]
    flight = [json.loads(_call(g.url, "/debug/flight?kind=none.*&limit=2")[2])
              for g in pair]
    assert set(flight[1]) == set(flight[0])
    assert flight[1]["events"] == flight[0]["events"] == []


def test_warming_and_drain_over_http(pair):
    """readyz answers 503 with Retry-After while warming; after
    /__drain__ it answers 503 again and a request gets the
    ServerDrainingError envelope (503, Retry-After); healthz stays 200."""
    for gateway in pair:
        gateway.server.begin_warmup()
    warming = _same(pair, "/readyz")
    assert warming[0] == 503 and warming[2] is not None
    for gateway in pair:
        gateway.server.warmup()
    assert _same(pair, "/readyz")[0] == 200
    drained = _same(pair, "/__drain__", method="POST")
    assert drained[:2] == (200, "application/json; charset=utf-8")
    assert drained[3] == {"drained": True, "inflight": 0}
    ready = _same(pair, "/readyz")
    assert ready[0] == 503 and ready[3]["draining"]
    rejected = _same(pair, "/v2/models/m/infer", method="POST",
                     body={"inputs": [1]})
    assert rejected[0] == 503 and rejected[2] == "%.3f" % \
        rejected[3]["retry_after_s"]
    assert "draining" in rejected[3]["error"]
    assert _same(pair, "/healthz")[3]["draining"]


def test_concurrent_clients_are_all_counted(pair):
    """16 client threads x 5 requests at a short switch interval: every
    request answers 200 and the port's /__stats__ counts all 80 (the
    handler threads share one latency list)."""
    import sys

    gateway = pair[1]
    statuses = []

    def client():
        for i in range(5):
            statuses.append(_call(gateway.url, "/v2/models/m/infer",
                                  "POST", {"inputs": [i]})[0])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert statuses == [200] * 80
    assert json.loads(_call(gateway.url, "/__stats__")[2])["requests"] == 80


def test_metrics_like_reference(pair):
    counts = []
    for gateway, registry in zip(pair, (JREGISTRY, TREGISTRY)):
        latency = registry.get("mlt_request_latency_seconds")
        probes = registry.get("mlt_probe_requests_total")
        before = (latency.value()["count"], probes.value(path="/healthz"),
                  probes.value(path="/metrics"))
        for body in ({"inputs": [1]}, {"inputs": [2]}):
            _call(gateway.url, "/v2/models/m/infer", "POST", body)
        _call(gateway.url, "/healthz")
        text = _call(gateway.url, "/metrics")
        om = _call(gateway.url, "/metrics", headers={
            "Accept": "application/openmetrics-text; version=1.0.0"})
        after = (latency.value()["count"], probes.value(path="/healthz"),
                 probes.value(path="/metrics"))
        counts.append((tuple(a - b for a, b in zip(after, before)),
                       text[0], text[1]["content-type"], om[0],
                       om[1]["content-type"], om[2].endswith(b"# EOF\n"),
                       b"mlt_request_latency_seconds_count" in text[2],
                       b"mlt_probe_requests_total" in text[2]))
    assert counts[1] == counts[0]
    assert counts[1][0] == (2, 1, 2) and counts[1][1] == 200
    assert counts[1][2] == "text/plain; version=0.0.4; charset=utf-8"
    assert counts[1][4].startswith("application/openmetrics-text")
    assert all(counts[1][5:])


def test_front_gateway_carries_the_trace_into_the_model_gateway(pair):
    """A front graph's RemoteStep calls the model gateway over HTTP: the
    same body as a direct call, and the trace id of the front request
    shows in the model gateway's ``/debug/trace/<id>``."""
    results = []
    for pkg, gateway in zip((REF, PORT), pair):
        spec = _spec("flow", lambda fn, g: g.to(
            class_name="RemoteStep", name="hop",
            url=gateway.url + "/v2/models/m/infer").respond())
        front = _server(pkg, spec, {"RemoteStep": pkg.remote.RemoteStep})
        trace_id = ("beef" if pkg is REF else "f00d") * 8
        out = front.test(body={"inputs": [4, 5]}, headers={
            "X-MLT-Trace": f"{trace_id}-1234567890abcdef"})
        status, _, raw = _call(gateway.url, f"/debug/trace/{trace_id}")
        trace = json.loads(raw)
        results.append((_mask(out), status, sorted(
            s["name"] for s in trace["spans"]), trace["root"],
            trace["partial"], [s["name"] for s in trace["critical_path"]]))
    assert results[1] == results[0]
    assert results[1][0]["outputs"] == [8, 10]
    assert {"remote.hop", "step.router", "step.hop"} <= set(results[1][2])
    assert results[1][2].count("server.run") == 2


# -- the engine behind the graph ---------------------------------------------

def test_paged_llm_route_serves_the_same_tokens_over_http(models,
                                                          monkeypatch):
    """A tiny paged LLMModelServer route, on the reference's float32
    weights converted for the port, behind each package's gateway: the
    same greedy tokens for a two-prompt request and a prefix-hit rerun,
    every generated position with a top-2 margin above 1e-3."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto

    jcfg, _, tcfg, tparams = models
    monkeypatch.setitem(jauto.MODEL_PRESETS, "tiny", lambda: jcfg)
    monkeypatch.setitem(tllama.MODEL_PRESETS, "tiny", lambda: tcfg)
    monkeypatch.setattr(tllama, "init_params",
                        lambda config, generator, device: tparams)
    spec = _spec("router", lambda fn, g: fn.add_model(
        "llm", class_name="LLMModelServer", model_preset="tiny",
        continuous_batching=True, paged=True, slots=2, max_len=64,
        page_size=PAGE, max_new_tokens=4, warmup=False))
    port_spec = copy.deepcopy(spec)
    port_spec["graph"]["steps"]["router"]["routes"]["llm"]["class_args"][
        "device"] = "cpu"
    prompts = [_tokens(41, 20).tolist(), _tokens(42, 9).tolist()]
    outs = []
    for pkg, graph_spec, cls in ((REF, spec, jllm.LLMModelServer),
                                 (PORT, port_spec, tllm.LLMModelServer)):
        server = _server(pkg, graph_spec, {"LLMModelServer": cls})
        gateway = _open(pkg, server)
        try:
            answers = [_view(_call(gateway.url, "/v2/models/llm/infer",
                                   "POST", {"inputs": batch}))
                       for batch in (prompts, prompts[:1])]
        finally:
            gateway.close()
            route = server.graph.steps["router"].routes["llm"]._object
            route.engine.stop()
        outs.append(answers)
    assert outs[1] == outs[0]
    tokens = [o[3]["outputs"] for o in outs[1]]
    assert tokens[1][0] == tokens[0][0]        # the prefix-hit rerun
    for prompt, generated in zip(prompts, tokens[0]):
        assert len(generated) == 4
        assert _min_margin(tcfg, tparams, prompt, generated) > 1e-3
