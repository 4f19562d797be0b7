"""mlrun_tpu_torch's chaos and observability copies (chaos/, obs/) against
mlrun_tpu's on the CPU: the fault registry (scoping, schedules, wildcards,
``match``, seeded ``fail_with_prob``), the request ledger's closure under a
fake clock, the metrics registry's text render and exemplars, the
nearest-rank percentile, the flight recorder and the tracer ring, and
the memory collector.

Every comparison is exact: both packages run the same pure-Python logic
on the same inputs, so the fire sequences, the ledger summaries and the
rendered exposition text must be identical (exemplar timestamps are
pinned by patching ``time.time``). No wall clock is compared. The port's
process-wide chaos registry, metrics, flight recorder and tracer are
reset around every test, so xdist workers that run other files after
this one inherit no state.
"""

import itertools
import json
import time

import pytest

from mlrun_tpu import chaos as jchaos
from mlrun_tpu.obs import flight as jflight
from mlrun_tpu.obs import metrics as jmetrics
from mlrun_tpu.obs import reqledger as jreqledger
from mlrun_tpu.obs import stats as jstats
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.obs import flight as tflight
from mlrun_tpu_torch.obs import metrics as tmetrics
from mlrun_tpu_torch.obs import reqledger as treqledger
from mlrun_tpu_torch.obs import stats as tstats
from mlrun_tpu_torch.obs import tracing as ttracing
from tests.torch_registries import registries_left_as_found  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        tchaos.chaos.clear()
        tobs.REGISTRY.reset()
        tobs.get_flight_recorder().clear()
        tobs.get_tracer().clear()

    reset()
    yield
    reset()


# -- chaos -------------------------------------------------------------------

def _fire_pattern(registry, point, n):
    """Which of n fires of ``point`` raised."""
    out = []
    for _ in range(n):
        try:
            registry.fire(point)
            out.append(False)
        except RuntimeError:
            out.append(True)
    return out


@pytest.mark.parametrize("schedule", [
    ("fail_nth", 3), ("fail_first", 2), ("fail_after", 4),
    ("always",), ("fail_with_prob", 0.3, 7), ("fail_with_prob", 0.5, 11)])
def test_chaos_schedules_fire_like_reference(schedule):
    """The same schedule on a fresh registry of each package fires on the
    same calls; ``fail_with_prob`` draws from its own seeded RNG, so a
    seed gives one sequence in both."""
    name, *args = schedule
    patterns = []
    for module in (jchaos, tchaos):
        registry = module.ChaosRegistry()
        registry.inject("llm.submit", getattr(module, name)(*args),
                        error=RuntimeError("injected"))
        patterns.append(_fire_pattern(registry, "llm.submit", 40))
    assert patterns[0] == patterns[1]
    assert any(patterns[1])


def test_chaos_scoping_wildcards_and_match():
    registry = tchaos.ChaosRegistry()
    assert not registry.enabled
    registry.fire("llm.submit")                      # dark: a no-op
    with registry.inject("llm.*", tchaos.always(),
                         error=RuntimeError("any llm point")) as inj:
        assert registry.enabled
        with pytest.raises(RuntimeError):
            registry.fire("llm.kv_promote")
        registry.fire("fleet.degrade")               # not under llm.*
        assert (inj.calls, inj.fired) == (1, 1)
    assert not registry.enabled and registry.injections() == []
    seen = []
    with registry.inject("llm.prefix_evict", tchaos.always(),
                         action=lambda point, ctx: seen.append(ctx),
                         match=lambda ctx: ctx["page_id"] == 2):
        for page in range(4):
            registry.fire("llm.prefix_evict", page_id=page)
    assert seen == [{"page_id": 2}]
    assert "llm.spec_verify" in tchaos.FaultPoints.all()
    assert set(tchaos.FaultPoints.all()) <= set(jchaos.FaultPoints.all())


def test_port_chaos_registry_is_not_the_reference_registry():
    """Arming the port's process-wide registry never arms the
    reference's, and the reverse."""
    assert tchaos.chaos is not jchaos.chaos
    with tchaos.chaos.inject("llm.submit", error=RuntimeError("port")):
        assert not jchaos.chaos.enabled
        jchaos.fire("llm.submit")
        with pytest.raises(RuntimeError, match="port"):
            tchaos.fire("llm.submit")
    with jchaos.chaos.inject("llm.submit", error=RuntimeError("ref")):
        assert not tchaos.chaos.enabled
        tchaos.fire("llm.submit")


def test_chaos_fire_observer_counts_and_records():
    """A fired injection lands on mlt_chaos_fired_total and the flight
    ring (the reference's observer); a dark or unfired point does not."""
    with tchaos.chaos.inject("llm.kv_demote", tchaos.fail_nth(2),
                             error=RuntimeError("torn")):
        tchaos.fire("llm.kv_demote")
        with pytest.raises(RuntimeError):
            tchaos.fire("llm.kv_demote")
        tchaos.fire("llm.kv_demote")
    assert tobs.CHAOS_FIRED.value(point="llm.kv_demote") == 1
    events = tobs.get_flight_recorder().events("chaos.*")
    assert [e["point"] for e in events] == ["llm.kv_demote"]


# -- request ledger ----------------------------------------------------------

LEDGER_SEQUENCE = ("rate_limit_wait", "admission", "queue_wait",
                   "adapter_load_wait", "admission", "promote", "admission",
                   "prefill", "decode_active", "decode_stall",
                   "decode_active", "decode_stall", "decode_active")


@pytest.mark.parametrize("final", [None, "handoff"])
def test_ledger_fake_clock_closure_matches_reference(final):
    """An engine request's transition sequence under an integer fake
    clock: Σ phases == wall exactly, and the summary (notes and trace id
    included) equals the reference's."""
    summaries = []
    for module in (jreqledger, treqledger):
        ledger = module.RequestLedger(trace_id="ab" * 16,
                                      clock=itertools.count(0).__next__)
        for phase in LEDGER_SEQUENCE:
            ledger.enter(phase)
        ledger.note("cached_prefix", 32)
        timing = ledger.close(final)
        assert ledger.close() == timing           # idempotent
        assert ledger.enter("prefill") == 0.0     # closed: no-op
        summaries.append(timing)
    jt, tt = summaries
    assert tt == jt
    assert tt["attribution_closed"]
    # 14 clock reads: 13 transitions and the close; the trailing interval
    # goes to ``final``
    assert tt["wall_s"] == sum(tt["phases"].values()) == 14
    assert tt["phases"]["decode_active"] == (3 if final is None else 2)


def test_export_and_retire_phases_match_reference(monkeypatch):
    """A finished request's phases land on mlt_request_phase_seconds under
    its adapter (an unknown phase folds into "other"), its trace id rides
    as the exemplar — the reference's render of the same export, byte for
    byte — and retiring the adapter drops its series, not the base's."""
    timing = {"wall_s": 3.5, "phases": {"prefill": 2.0, "handoff": 1.25,
                                        "queue_wait": 0.25, "bogus": 0.0},
              "attribution_closed": True, "trace_id": "cd" * 16}
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    renders = []
    for module in (jreqledger, treqledger):
        module.REQUEST_PHASE_SECONDS.clear()
        module.export_phases(timing, adapter="t1")
        module.export_phases(timing, adapter="")
        family = module.REQUEST_PHASE_SECONDS
        renders.append("\n".join(family.render(openmetrics=True)))
        module.retire_adapter_phases("t1")
        assert family.value(phase="handoff", adapter="t1")["count"] == 0
        assert family.value(phase="handoff", adapter="")["count"] == 1
        renders.append("\n".join(family.render()))
        family.clear()
    assert renders[2:] == renders[:2]
    assert 'phase="other",adapter="t1"' in renders[2]
    assert f'trace_id="{"cd" * 16}"' in renders[2]
    assert 'adapter="t1"' not in renders[3]


def test_ledger_enabled_reads_the_port_config(monkeypatch):
    from mlrun_tpu_torch.config import SERVING_LLM_DEFAULTS

    assert SERVING_LLM_DEFAULTS["request_ledger"] is True
    assert treqledger.ledger_enabled()
    monkeypatch.setitem(SERVING_LLM_DEFAULTS, "request_ledger", False)
    assert not treqledger.ledger_enabled()


# -- metrics -----------------------------------------------------------------

def _drive_registry(module):
    registry = module.MetricsRegistry()
    c = registry.counter("mlt_llm_events_total", "events",
                         labels=("engine", "event"))
    c.inc(engine="e1", event="requests")
    c.inc(2, engine="e1", event="requests")
    c.set_total(7, engine="e1", event="completed")
    c.set_total(5, engine="e1", event="completed")   # never backwards
    g = registry.gauge("mlt_llm_queue_depth", "depth \\ with\nnewline",
                       labels=("adapter",))
    g.set(3, adapter='quo"te')
    g.dec(0.5, adapter='quo"te')
    h = registry.histogram("mlt_llm_ttft_seconds", "ttft",
                           labels=("replica", "adapter"),
                           buckets=(0.01, 0.1, 1.0))
    for value, trace in ((0.005, "aa"), (0.05, None), (0.5, "bb"),
                         (5.0, {"trace_id": "cc", "span": "1"})):
        h.observe(value, exemplar=trace, replica="", adapter="t1")
    h.observe(0.2, replica="r1", adapter="")
    drop = registry.gauge("mlt_drop", "bounded", labels=("k",),
                          max_label_sets=2, overflow="drop")
    for key in "abc":
        drop.set(1, k=key)
    registry.add_collector(lambda: False)            # retires itself
    return registry, drop


def test_metrics_render_and_exemplars_match_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.125)
    jreg, jdrop = _drive_registry(jmetrics)
    treg, tdrop = _drive_registry(tmetrics)
    assert treg.render() == jreg.render()
    om = treg.render(openmetrics=True)
    assert om == jreg.render(openmetrics=True)
    assert om.endswith("# EOF\n")
    assert ('mlt_llm_ttft_seconds_bucket{replica="",adapter="t1",'
            'le="+Inf"} 4 # {span="1",trace_id="cc"} 5 1700000000.125') in om
    assert ('mlt_llm_ttft_seconds_bucket{replica="",adapter="t1",'
            'le="0.01"} 1 # {trace_id="aa"} 0.005 1700000000.125') in om
    assert tdrop.dropped == jdrop.dropped == 1


def test_metrics_misuse_raises_like_reference():
    for module in (jmetrics, tmetrics):
        registry = module.MetricsRegistry()
        registry.counter("mlt_x_total", labels=("a",), max_label_sets=1)
        with pytest.raises(module.MetricError):
            registry.gauge("mlt_x_total")
        with pytest.raises(module.CardinalityError):
            counter = registry.counter("mlt_x_total")
            counter.inc(a="1")
            counter.inc(a="2")
        with pytest.raises(module.MetricError):
            registry.counter("mlt_x_total").inc(-1, a="1")


def test_engine_families_share_the_reference_schema():
    """The port publishes the engine families under the reference's names,
    types and label sets, so one scrape config reads both packages."""
    from mlrun_tpu import obs as jobs

    names = ("LLM_TTFT", "LLM_ITL", "LLM_DECODE_TICK", "LLM_QUEUE_DEPTH",
             "LLM_FREE_PAGE_FRAC", "LLM_EVENTS", "LLM_SPEC_ROUNDS",
             "LLM_SPEC_TOKENS", "KV_TIER_BYTES", "KV_TIER_HITS",
             "KV_TIER_EVENTS", "ADAPTER_LIVE", "ADAPTER_LOADS",
             "CHAOS_FIRED", "DEVICE_MEM", "HOST_RSS",
             "REQUEST_PHASE_SECONDS")
    for name in names:
        jf, tf = getattr(jobs, name), getattr(tobs, name)
        assert (tf.name, tf.type_name, tf.labelnames) == \
            (jf.name, jf.type_name, jf.labelnames), name
        if isinstance(tf, tmetrics.Histogram):
            assert tf.buckets == jf.buckets, name


@pytest.mark.parametrize("n", [1, 2, 19, 20, 100, 101])
@pytest.mark.parametrize("q", [0.5, 0.95, 0.99, 1.0])
def test_nearest_rank_matches_reference(n, q):
    samples = sorted((i * 7919) % 1000 / 10.0 for i in range(n))
    assert tstats.nearest_rank(samples, q) == jstats.nearest_rank(samples, q)


# -- flight recorder, tracer, memory collector -------------------------------

def test_flight_recorder_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.0)
    rings = []
    for module in (jflight, tflight):
        recorder = module.FlightRecorder(ring=16)
        for i in range(20):
            recorder.record("engine.admit" if i % 2 else "chaos.fire", i=i)
        rings.append(recorder)
    jrec, trec = rings
    strip = [{k: v for k, v in e.items() if k != "seq"}
             for e in trec.events("engine.*", limit=3)]
    assert strip == [{k: v for k, v in e.items() if k != "seq"}
                     for e in jrec.events("engine.*", limit=3)]
    assert len(trec) == 16 and [e["i"] for e in strip] == [15, 17, 19]
    path = trec.dump("engine-crash", path=str(tmp_path / "f.jsonl"),
                     extra={"engine": "e1"})
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["flight_dump"] and lines[0]["events"] == 16
    assert lines[0]["engine"] == "e1" and len(lines) == 17
    assert trec.dumps == 1 and trec.last_dump_path == path


def test_tracer_ring_parents_and_emits():
    tracer = ttracing.Tracer(ring=4)
    assert tracer.current() is None
    with tracer.span("request") as root:
        assert tracer.current() is root
        child = tracer.start_span("step")
        assert (child.trace_id, child.parent_id) == (root.trace_id,
                                                     root.span_id)
        tracer.end_span(child)
    assert tracer.current() is None
    done = tracer.emit("llm.decode", root.trace_id, root.span_id,
                       start=1.0, end=3.0, attrs={"generated": 4})
    assert done.to_dict()["duration_s"] == 2.0
    assert [s.name for s in tracer.spans(trace_id=root.trace_id)] == [
        "step", "request", "llm.decode"]
    with pytest.raises(ValueError):
        with tracer.span("failing"):
            raise ValueError("x")
    assert tracer.spans(name="failing")[0].status == "error"


def test_memory_collector_reads_host_rss_on_cpu_and_retires():
    class Owner:
        pass

    owner = Owner()
    tobs.register_memory_collector(owner)
    text = tobs.REGISTRY.render()
    assert any(line.startswith("mlt_host_rss_bytes ")
               for line in text.splitlines())
    # no CUDA context here: no device series
    assert not any(line.startswith("mlt_device_mem_bytes{")
                   for line in text.splitlines())
    del owner
    text = tobs.REGISTRY.render()
    assert not any(line.startswith("mlt_host_rss_bytes ")
                   for line in text.splitlines())
