"""mlrun_tpu_torch's serving-step primitives against mlrun_tpu's on the CPU:
``AdmissionController``, ``CircuitBreaker`` and ``StepResilience`` give the
same allow / deny / state sequence on a fake clock; the spec validation,
the deadline helpers, ``compute_backoff`` / ``retry_after_hint``, the
``X-MLT-Trace`` header, the tracer's JSONL export and the request
ledger's out-of-band ``attribute`` / ``merge_timing`` behave as the
reference's; ``TpuModelServer.do_event`` over a linear forward with the
same weights is within 1e-6 of the JAX server's output; ``_ModelLogPusher``
pushes records with the reference's keys to a fake stream.
"""

import json

import numpy as np
import pytest

from mlrun_tpu.common import retry as jretry
from mlrun_tpu.obs import reqledger as jledger
from mlrun_tpu.obs import tracing as jtracing
from mlrun_tpu.serving import resilience as jres
from mlrun_tpu.serving import v2_serving as jv2
from mlrun_tpu_torch.common import retry as tretry
from mlrun_tpu_torch.obs import reqledger as tledger
from mlrun_tpu_torch.obs import tracing as ttracing
from mlrun_tpu_torch.serving import resilience as tres
from mlrun_tpu_torch.serving import v2_serving as tv2

RES = (jres, tres)


class _Clock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now


def _admission_script(module):
    clock = _Clock()
    ctl = module.AdmissionController(rate=2.0, burst=3.0, max_concurrent=2,
                                     clock=clock)
    out = []
    for step in range(24):
        clock.now += (0.0, 0.1, 0.35, 1.0)[step % 4]
        ok = ctl.try_acquire()
        out.append((ok, ctl.inflight, ctl.rejected))
        if ok and step % 3:
            ctl.release()
    small = module.AdmissionController(rate=0.5, clock=clock)
    out.append((small.burst, small.try_acquire(), small.try_acquire()))
    return out


def test_admission_controller_sequence_like_reference():
    got = [_admission_script(module) for module in RES]
    assert got[1] == got[0]
    assert any(not ok for ok, _, _ in got[1][:-1])
    for module in RES:
        with pytest.raises(ValueError):
            module.AdmissionController(rate=0)
        with pytest.raises(ValueError):
            module.AdmissionController(max_concurrent=0)


def _breaker_script(module, **kw):
    clock = _Clock()
    breaker = module.CircuitBreaker(name="s", clock=clock, **kw)
    outcomes = ([False] * 3 + [True] + [False] * 4 + [True] * 3
                + [False, True, False, False, True, True, True, False] * 2)
    out = []
    for i, failed in enumerate(outcomes):
        clock.now += 0.7 * (i % 5)
        try:
            breaker.allow()
            allowed = True
        except module.CircuitOpenError:
            allowed = False
        admitted_in = breaker.state
        if allowed:
            if failed:
                breaker.record_failure()
            else:
                breaker.record_success()
        out.append((allowed, admitted_in, breaker.state, breaker.rejected,
                    breaker.opened_total))
    return out


@pytest.mark.parametrize("kw", [
    dict(failure_threshold=3, recovery_timeout=2.0),
    dict(failure_threshold=10, failure_rate_threshold=0.5, window=4,
         recovery_timeout=1.0, half_open_max_calls=2, success_threshold=2),
], ids=["consecutive", "rate"])
def test_circuit_breaker_sequence_like_reference(kw):
    got = [_breaker_script(module, **kw) for module in RES]
    assert got[1] == got[0]
    states = {state for row in got[1] for state in row[1:3]}
    assert states >= {"closed", "open", "half_open"}


def _step_script(module):
    clock = _Clock()
    step = module.StepResilience.from_spec({
        "circuit_breaker": {"failure_threshold": 2, "recovery_timeout": 1.0},
        "admission": {"max_concurrent": 1, "rate": 5.0, "burst": 2},
    }, name="llm", clock=clock)
    counts: dict = {}

    class _Context:
        def incr(self, name, value=1):
            counts[name] = counts.get(name, 0) + value

    def boom():
        raise RuntimeError("down")

    out = []
    for i, fn in enumerate([lambda: 1, boom, boom, lambda: 2, lambda: 3,
                            boom, lambda: 4, lambda: 5]):
        clock.now += 0.3 if i % 2 else 0.6
        try:
            out.append(step.call(fn, context=_Context()))
        except Exception as exc:  # noqa: BLE001 - the outcome compared
            out.append((type(exc).__name__, getattr(exc, "status_code", 0)))
    out.append(step.breaker.state)
    out.append(sorted(counts.items()))
    assert module.StepResilience.from_spec(None) is None
    return out


def test_step_resilience_sequence_like_reference():
    got = [_step_script(module) for module in RES]
    assert got[1] == got[0]
    assert ("CircuitOpenError", 503) in got[1]


@pytest.mark.parametrize("spec", [
    "nope", {"breaker": {}}, {"circuit_breaker": {"threshold": 1}},
    {"admission": {"qps": 1}},
    {"circuit_breaker": {"failure_threshold": 1}, "admission": {"rate": 1}},
])
def test_resilience_spec_validation_like_reference(spec):
    outcomes = []
    for module in RES:
        try:
            module.validate_resilience_spec(spec, "s")
            outcomes.append(None)
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[1] == outcomes[0]


class _Event:
    def __init__(self, deadline=None, body=None, path="/"):
        self.deadline = deadline
        self.body = body
        self.path = path


def test_deadline_helpers_like_reference():
    clock = _Clock(50.0)
    for headers in ({"X-MLT-Timeout": "2.5"}, {"x-mlt-timeout": "bad"},
                    None, {}, {"other": 1}):
        got = [module.deadline_from_headers(headers, clock=clock)
               for module in RES]
        assert got[1] == got[0]
    assert tres.deadline_from_headers({"X-MLT-Timeout": 2}, clock) == 52.0
    for deadline in (None, 49.0, 51.0):
        event = _Event(deadline)
        got = []
        for module in RES:
            remaining = module.deadline_remaining(event, clock=clock)
            try:
                module.check_deadline(event, "s", clock=clock)
                raised = None
            except module.DeadlineExceeded as exc:
                raised = (str(exc), exc.status_code)
            got.append((remaining, raised))
        assert got[1] == got[0]


def test_replica_errors_like_reference():
    for name in ("ReplicaUnavailableError", "ReplicaPreemptedError"):
        jerr, terr = getattr(jres, name)("x"), getattr(tres, name)("x")
        assert terr.status_code == jerr.status_code == 503
    handoff = object()
    err = tres.ReplicaPreemptedError("gone", handoff=handoff)
    assert err.handoff is handoff and isinstance(err, tres.ServerDrainingError)


@pytest.mark.parametrize("attempt", range(6))
def test_backoff_and_retry_after_like_reference(attempt):
    for jitter, seed in ((0.0, ""), (0.1, "fleet:123"), (0.3, "x")):
        policies = [module.RetryPolicy(max_retries=3, backoff=0.05,
                                       backoff_factor=2.0, backoff_max=1.0,
                                       jitter=jitter)
                    for module in (jretry, tretry)]
        assert tretry.compute_backoff(attempt, policies[1], seed=seed) == \
            jretry.compute_backoff(attempt, policies[0], seed=seed)
    assert tres.retry_after_hint(attempt) == jres.retry_after_hint(attempt)
    assert tretry.compute_backoff(attempt, tretry.RetryPolicy(backoff=0)) \
        == 0.0


# -- tracing -------------------------------------------------------------------

@pytest.mark.parametrize("headers", [
    None, {}, {"X-MLT-Trace": "abc123-00ff"}, {"x-mlt-trace": "ABC"},
    {b"X-MLT-Trace": b"abcd-12"}, {"X-MLT-Trace": "zz-12"},
    {"X-MLT-Trace": "ab-" + "f" * 40}, {"X-MLT-Trace": "ab-xyz"},
    {"X-MLT-Trace": ""}, {"X-MLT-Trace": "f" * 65},
])
def test_trace_header_like_reference(headers):
    assert ttracing.parse_trace_header(headers) == \
        jtracing.parse_trace_header(headers)
    assert ttracing.format_trace_header("ab", "cd") == \
        jtracing.format_trace_header("ab", "cd")
    assert ttracing.format_trace_header("ab") == "ab"


def test_tracer_joins_a_caller_trace_and_exports_jsonl(tmp_path):
    """A span opened with the header's trace id joins the caller's trace;
    ``inject`` carries it on; spans land in the JSONL file, rotated at
    the cap with one predecessor kept."""
    path = tmp_path / "spans" / "trace.jsonl"
    tracer = ttracing.Tracer(ring=8).configure(path=str(path))
    trace_id, parent = ttracing.parse_trace_header(
        {"X-MLT-Trace": "0123abcd-89ef"})
    with tracer.span("server", trace_id=trace_id, parent_id=parent) as span:
        headers = tracer.inject({"a": 1})
        with tracer.span("child"):
            pass
    assert headers == {"a": 1, "X-MLT-Trace": f"0123abcd-{span.span_id}"}
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [s["name"] for s in lines] == ["child", "server"]
    assert {s["trace_id"] for s in lines} == {"0123abcd"}
    assert lines[1]["parent_id"] == "89ef"
    assert lines[0]["parent_id"] == span.span_id
    size = path.stat().st_size
    tracer.configure(max_bytes=size + 10)
    tracer.emit("late", trace_id="0123abcd")
    assert (tmp_path / "spans" / "trace.jsonl.1").exists()
    assert [json.loads(x)["name"] for x in
            path.read_text().splitlines()] == ["late"]
    tracer.configure(path="")
    tracer.emit("dark", trace_id="0123abcd")
    assert tracer.path is None and len(tracer.spans(name="dark")) == 1


# -- the ledger's out-of-band attribution ----------------------------------------

def _ledger_script(module):
    ticks = iter(range(0, 100, 2))
    ledger = module.RequestLedger(clock=lambda: float(next(ticks)))
    ledger.enter("queue_wait")
    ledger.attribute("redispatch_backoff", 0.25)
    ledger.attribute("fetch", 0.0)
    ledger.enter("prefill")
    prefill_side = ledger.close("handoff")
    other = module.RequestLedger(clock=lambda: float(next(ticks)))
    other.note("cached_prefix", 8)
    other.enter("decode_active")
    decode_side = other.close()
    merged = module.merge_timing(dict(decode_side, phases=dict(
        decode_side["phases"])), prefill_side)
    return prefill_side, decode_side, merged, module.merge_timing({}, None)


def test_ledger_attribute_and_merge_timing_like_reference():
    got = [_ledger_script(module) for module in (jledger, tledger)]
    assert got[1] == got[0]
    prefill_side, _, merged, empty = got[1]
    assert prefill_side["attribution_closed"]
    assert prefill_side["phases"]["redispatch_backoff"] == 0.25
    assert merged["wall_s"] == pytest.approx(sum(merged["phases"].values()))
    assert empty == {}


# -- TpuModelServer and the monitoring pusher ------------------------------------

class _Stream:
    def __init__(self, fail=False):
        self.records = []
        self.fail = fail

    def push(self, data):
        if self.fail:
            raise OSError("stream down")
        self.records.append(data)


class _Context:
    def __init__(self, stream):
        self.monitoring_stream = stream
        self.logger = _Logger()


class _Logger:
    def info(self, *a, **kw):
        pass

    def error(self, *a, **kw):
        pass


def _linear_servers(stream_of, **kw):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)

    import jax.numpy as jnp
    import torch

    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tparams = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    jserver = jv2.TpuModelServer(
        context=_Context(stream_of()), name="lin:v1",
        forward_fn=lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
        params=jparams, warmup_shapes=[(2, 6)], **kw)
    tserver = tv2.TpuModelServer(
        context=_Context(stream_of()), name="lin:v1",
        forward_fn=lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
        params=tparams, warmup_shapes=[(2, 6)], device="cpu", **kw)
    return jserver, tserver


def test_tpu_model_server_do_event_like_reference():
    """load warms each shape once; do_event answers a v2 body with the
    JAX server's outputs within 1e-6; metrics, ready and the model
    version ride the same envelope."""
    jserver, tserver = _linear_servers(lambda: None)
    body = {"inputs": np.random.default_rng(1).standard_normal(
        (4, 6)).tolist(), "id": "r1"}
    replies = []
    for server in (jserver, tserver):
        server.post_init()
        assert server.ready, server.error
        replies.append(server.do_event(_Event(body=dict(
            body), path="/v2/models/lin/infer")).body)
    want, got = replies
    assert set(got) == set(want) == {"id", "model_name", "outputs",
                                     "model_version"}
    assert (got["id"], got["model_name"], got["model_version"]) == \
        ("r1", "lin", "v1")
    np.testing.assert_allclose(np.asarray(got["outputs"]),
                               np.asarray(want["outputs"]), rtol=0,
                               atol=1e-6)
    ready = tserver.do_event(_Event(path="/v2/models/lin/ready")).body
    assert ready == {"name": "lin", "ready": True}
    assert tserver.metrics["requests"] == 1


def test_tpu_model_server_without_forward_fails_to_load():
    server = tv2.TpuModelServer(name="m", device="cpu")
    server.post_init()
    assert not server.ready and "forward_fn" in server.error
    with pytest.raises(tres.ModelNotReadyError):
        server.do_event(_Event(body={"inputs": [[1.0]]}))


def test_model_log_pusher_pushes_reference_keys():
    """One record a request with the reference pusher's keys (an error
    record on a failed predict), and a failing stream never breaks
    serving."""
    jserver, tserver = _linear_servers(_Stream)
    body = {"inputs": [[0.5] * 6]}
    for server in (jserver, tserver):
        server.post_init()
        server.labels["team"] = "x"
        server.do_event(_Event(body=dict(body)))
        with pytest.raises(Exception):
            server.do_event(_Event(body={"inputs": [[1.0, 2.0]]}))
    jrecords = jserver.context.monitoring_stream.records
    trecords = tserver.context.monitoring_stream.records
    assert len(trecords) == len(jrecords) == 2
    for want, got in zip(jrecords, trecords):
        assert set(got) == set(want)
    ok = trecords[0]
    assert ok["request"]["inputs"] == body["inputs"]
    assert ok["op"] == "infer" and ok["model"] == "lin"
    assert ok["version"] == "v1" and ok["labels"] == {"team": "x"}
    assert ok["class"] == "TpuModelServer" and ok["microsec"] >= 0
    assert set(ok["metrics"]) == set(jrecords[0]["metrics"])
    assert "error" in trecords[1]
    _, failing = _linear_servers(lambda: _Stream(fail=True))
    failing.post_init()
    reply = failing.do_event(_Event(body=dict(body))).body
    assert len(reply["outputs"]) == 1
    quiet = tv2.TpuModelServer(name="q", device="cpu",
                               forward_fn=lambda p, x: x, params={})
    quiet.post_init()
    assert quiet._model_logger is None
