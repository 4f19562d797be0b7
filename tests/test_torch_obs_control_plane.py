"""mlrun_tpu_torch's fleet observability control plane (obs/federation.py,
obs/timeseries.py, obs/slo.py, service/autoscaler.py) against mlrun_tpu's:
the federation, store, Grafana-target and SLO cases of
tests/test_obs_control_plane.py and its autoscaler cases, the probated
victim of tests/test_replica_health.py and the two autoscaler restarts of
tests/test_control_recovery.py.

The same exposition text, stats feeds and sample streams go into both
packages; merged views, quantiles, rates, ``fraction_over`` and burn rates
are float64 host arithmetic and must agree exactly. The autoscalers run
over each package's real ``EngineFleet`` of the reference tests' scripted
fake engines, driven with the same ``(now, signals)`` sequence: the same
action, reason, recommendation, desired count, victim and removal at
every tick. Left out: the Grafana HTTP proxy (the service's).
``SLOEvaluator.process`` and the alert cases are
tests/test_torch_alerts.py's.
"""

import itertools
import math
import types

import pytest

from mlrun_tpu import chaos as jchaos
from mlrun_tpu import obs as jobs
from mlrun_tpu.common import journal as jjournal
from mlrun_tpu.obs import metrics as jmetrics
from mlrun_tpu.obs import slo as jslo
from mlrun_tpu.obs import timeseries as jts
from mlrun_tpu.serving import fleet as jfleet
from mlrun_tpu.service import autoscaler as jautoscaler
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch import config as tconfig
from mlrun_tpu_torch import obs as tobs
from mlrun_tpu_torch.common import journal as tjournal
from mlrun_tpu_torch.obs import metrics as tmetrics
from mlrun_tpu_torch.obs import slo as tslo
from mlrun_tpu_torch.obs import timeseries as tts
from mlrun_tpu_torch.serving import fleet as tfleet
from mlrun_tpu_torch.service import autoscaler as tautoscaler

from .test_obs_control_plane import _feed_histogram, _ScalableEngine
from .test_replica_health import _InstantEngine

PKGS = {
    "jax": types.SimpleNamespace(
        obs=jobs, metrics=jmetrics, ts=jts, slo=jslo, fleet=jfleet,
        autoscaler=jautoscaler, chaos=jchaos, journal=jjournal),
    "port": types.SimpleNamespace(
        obs=tobs, metrics=tmetrics, ts=tts, slo=tslo, fleet=tfleet,
        autoscaler=tautoscaler, chaos=tchaos, journal=tjournal),
}


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for module in (jfleet, tfleet):
        monkeypatch.setattr(module, "_FLEET_SEQUENCE", itertools.count(1))
    for pkg in PKGS.values():
        pkg.chaos.chaos.clear()
        pkg.obs.REGISTRY.reset()
    yield
    for pkg in PKGS.values():
        pkg.chaos.chaos.clear()


def _alike(scenario, *args):
    """``scenario(pkg, *args)`` on both packages: equal results, returned
    once."""
    got = {}
    for name, pkg in PKGS.items():
        for module in (jfleet, tfleet):
            module._FLEET_SEQUENCE = itertools.count(1)
        got[name] = scenario(pkg, *args)
    assert got["port"] == got["jax"]
    return got["port"]


# -- federation ---------------------------------------------------------------

def _replica_registry(pkg, rid: str, queue: float, requests: float = 5.0):
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("mlt_llm_events_total", "events",
                labels=("engine", "replica", "event")).inc(
        requests, engine="e", replica=rid, event="requests")
    hist = reg.histogram("mlt_llm_ttft_seconds", "ttft",
                         labels=("replica",), buckets=(0.01, 0.1, 1.0))
    hist.observe(0.05, replica=rid, exemplar={"trace_id": f"t-{rid}-a"})
    hist.observe(0.5, replica=rid, exemplar={"trace_id": f"t-{rid}-b"})
    reg.gauge("mlt_llm_queue_depth", "queue",
              labels=("engine", "replica")).set(
        queue, engine="e", replica=rid)
    reg.gauge("mlt_server_inflight", "inflight").set(queue)
    return reg


def _merge(pkg):
    agg = pkg.obs.MetricsAggregator(stale_after=60)
    agg.ingest_text("rep0", _replica_registry(pkg, "r0", 3).render(),
                    at=100.0)
    agg.ingest_text("rep1", _replica_registry(pkg, "r1", 7).render(),
                    at=105.0)
    samples, types_ = agg.merged(106.0)
    pkg.obs.check_histogram_consistency(samples, "mlt_llm_ttft_seconds")
    agg_sum = pkg.obs.MetricsAggregator(
        gauge_merge={"mlt_server_inflight": "sum"})
    agg_sum.ingest_text("rep0", _replica_registry(pkg, "r0", 3).render(),
                        at=100.0)
    agg_sum.ingest_text("rep1", _replica_registry(pkg, "r1", 7).render(),
                        at=105.0)
    return (samples, types_,
            agg.label_values("mlt_llm_queue_depth", "replica", 106.0),
            agg.sum_family("mlt_llm_queue_depth", 106.0),
            agg.value("mlt_server_inflight", 106.0),
            agg_sum.value("mlt_server_inflight", 106.0),
            _replica_registry(pkg, "r0", 3).render(openmetrics=False))


def test_federation_merge_semantics_like_reference():
    samples, _, replicas, total, last, summed, _ = _alike(_merge)
    assert replicas == {"r0", "r1"} and total == 10.0
    assert last == 7.0 and summed == 10.0
    assert samples[("mlt_llm_ttft_seconds_count",
                    frozenset({("replica", "r0")}))] == 2.0


def _counters_and_staleness(pkg):
    agg = pkg.obs.MetricsAggregator()
    text = _replica_registry(pkg, "r0", 1).render()
    agg.ingest_text("a", text, at=1.0)
    agg.ingest_text("b", text, at=2.0)
    key = dict(engine="e", replica="r0", event="requests")
    out = [agg.value("mlt_llm_events_total", 3.0, **key),
           agg.series_count(3.0)]
    agg.ingest_text("b", text, at=3.0)
    out += [agg.value("mlt_llm_events_total", 4.0, **key),
            agg.series_count(4.0)]
    stale = pkg.obs.MetricsAggregator(stale_after=10)
    stale.ingest_text("rep0", _replica_registry(pkg, "r0", 3).render(),
                      at=100.0)
    stale.ingest_text("rep1", _replica_registry(pkg, "r1", 7).render(),
                      at=105.0)
    out += [stale.label_values("mlt_llm_queue_depth", "replica", 112.0),
            stale.sources(112.0)]
    stale.forget("rep1")
    out.append(stale.series_count(112.0))
    budget = pkg.obs.MetricsAggregator(stale_after=10, max_series=12)
    budget.ingest_text("dead", _replica_registry(pkg, "r0", 1).render(),
                       at=0.0)
    budget.ingest_text("live", _replica_registry(pkg, "r1", 1).render(),
                       at=100.0)
    out += [sorted(budget.sources(100.0)), budget.dropped_series]
    return out


def test_federation_counters_staleness_and_forget_like_reference():
    (twice, count, again, count2, fresh, sources, left, names,
     dropped) = _alike(_counters_and_staleness)
    assert twice == again == 10.0 and count == count2
    assert fresh == {"r1"} and sources["rep0"]["fresh"] is False
    assert left == 0 and names == ["live"] and dropped == 0


def _cardinality(pkg):
    reg = pkg.metrics.MetricsRegistry()
    counter = reg.counter("mlt_x_total", "x", labels=("k",))
    for i in range(30):
        counter.inc(1, k=f"v{i:02d}")
    agg = pkg.obs.MetricsAggregator(max_series=10)
    agg.ingest_text("big", reg.render(), at=1.0)
    first = (agg.dropped_series, agg.series_count(2.0),
             sorted(dict(labels)["k"]
                    for labels in agg.family("mlt_x_total", 2.0)))
    agg.ingest_text("big", reg.render(), at=3.0)
    with pytest.raises(pkg.obs.PromParseError):
        pkg.obs.MetricsAggregator().ingest_text(
            "bad", "# TYPE x counter\nx 1", at=1.0)
    return first, (agg.series_count(4.0), sorted(
        dict(labels)["k"] for labels in agg.family("mlt_x_total", 4.0)))


def test_federation_cardinality_budget_and_malformed_like_reference():
    (dropped, count, kept), (count2, kept2) = _alike(_cardinality)
    assert dropped == 20 and count == count2 == 10 and kept == kept2


FLEET_STATS = {
    "dispatches": 90, "redispatches": 3, "failed": 2, "no_replica": 1,
    "ttft_p50_s": 0.01, "ttft_p95_s": 0.2,
    "per_replica": {
        "f1-u0": {"queue_depth": 4, "free_page_frac": 0.5,
                  "requests": 50, "completed": 48},
        "f1-u1": {"queue_depth": 2, "free_page_frac": 0.25,
                  "requests": 40, "completed": 40},
    },
}


def _ingest_stats(pkg):
    agg = pkg.obs.MetricsAggregator()
    agg.ingest_stats("fleet", FLEET_STATS, at=10.0)
    return (agg.merged(11.0), agg.sum_family("mlt_llm_queue_depth", 11.0),
            agg.min_family("mlt_llm_free_page_frac", 11.0),
            agg.value("mlt_fleet_dispatches_total", 11.0, replica="",
                      outcome="failed"),
            agg.value("mlt_fleet_ttft_seconds", 11.0, quantile="0.95"))


def test_federation_ingest_stats_maps_fleet_feed_like_reference():
    _, queue, frac, failed, p95 = _alike(_ingest_stats)
    assert (queue, frac, failed, p95) == (6.0, 0.25, 2.0, 0.2)


def _snapshot(pkg):
    agg = pkg.obs.MetricsAggregator(stale_after=60)
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    for at, feeds in ((0.0, {"a": 100, "b": 50}), (10.0, {"a": 110, "b": 60}),
                      (20.0, {"a": 120})):
        if at == 20.0:
            agg.forget("b")
        for source, requests in feeds.items():
            agg.ingest_text(source, _replica_registry(
                pkg, "r0", 1, requests=requests).render(), at=at)
        agg.snapshot_to(store, at)
    return (store.increase("mlt_llm_events_total", 25.0, 20.0),
            store.series())


def test_snapshot_to_survives_source_loss_like_reference():
    increase, series = _alike(_snapshot)
    assert increase == pytest.approx(30.0)
    assert any(s["labels"].get("source") == "b" for s in series)


def _exemplars(pkg):
    agg = pkg.obs.MetricsAggregator()
    for source, rid in (("rep0", "r0"), ("rep1", "r1")):
        agg.ingest_text(source, _replica_registry(pkg, rid, 1).render(
            openmetrics=True), at=1.0)
    found = sorted(agg.exemplars("mlt_llm_ttft_seconds", 2.0),
                   key=lambda e: (e["source"], e["le"]))
    worst = agg.breach_exemplars("mlt_llm_ttft_seconds", {"replica": "r1"},
                                 0.1, 3, now=2.0)
    reg = pkg.metrics.MetricsRegistry()
    hist = reg.histogram("mlt_llm_ttft_seconds", "ttft",
                         labels=("replica",), buckets=(0.01, 0.1, 1.0))
    for value, trace in ((0.05, "t1"), (0.4, "t2"), (2.0, "t3")):
        hist.observe(value, replica="r0", exemplar={"trace_id": trace})
    local = [{k: e[k] for k in ("series", "le", "value", "labels")}
             for e in hist.exemplars(match={"replica": "r0"})]
    return ([{k: e[k] for k in ("source", "series", "le", "value",
                                "labels")} for e in found],
            [(e["value"], e["labels"]) for e in worst], local)


def test_federated_and_registry_exemplars_like_reference():
    """OpenMetrics exemplars ride the federated scrape; the breach lookup
    and the registry histogram's exemplar read name the same trace ids."""
    found, worst, local = _alike(_exemplars)
    assert len(found) == 4
    assert worst == [(0.5, {"trace_id": "t-r1-b"})]
    assert [e["le"] for e in local] == [0.1, 1.0, math.inf]


# -- the time-series store ----------------------------------------------------

def _store_bounds(pkg):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0, capacity=5)
    for t in range(10):
        store.record("c_total", float(t * 2), at=t, kind="counter")
    out = [store.points("c_total", 0, 9), store.rate("c_total", 4.0, 9.0)]
    store.record("c_total", 1.0, at=10, kind="counter")
    out.append(store.increase("c_total", 2.0, 10.0))
    store.record("c_total", 100.0, at=1000, kind="counter")
    out.append(store.points("c_total", 0, 1000))
    small = pkg.obs.TimeSeriesStore(resolution_s=1.0, capacity=4,
                                    max_series=3)
    for i in range(5):
        small.record("g", float(i), at=1.0, labels={"k": str(i)})
    out += [len(small.series()), small.dropped_series]
    drop = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    drop.record("a", 1.0, at=0, labels={"replica": "x"})
    drop.record("b_total", 2.0, at=0, labels={"replica": "x"},
                kind="counter")
    drop.record("a", 3.0, at=0, labels={"replica": "y"})
    drop.drop_series(labels={"replica": "x"})
    out += [drop.search('replica="x"'), drop.series()]
    return out


def test_store_rings_resets_bounds_and_drops_like_reference():
    (points, rate, increase, lapped, kept, dropped, search,
     series) = _alike(_store_bounds)
    assert [t for t, _ in points] == [5.0, 6.0, 7.0, 8.0, 9.0]
    assert rate == 2.0 and increase == 3.0
    assert lapped == [(1000.0, 100.0)]
    assert (kept, dropped) == (3, 2) and search == [] and len(series) == 1


def _windowed(pkg):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    _feed_histogram(store, [(0, 50, 10, 0), (50, 100, 10, 10)])
    family = "mlt_llm_ttft_seconds"
    return [store.quantile(family, q, 30, at)
            for q in (0.5, 0.9, 0.95, 0.99) for at in (40, 70, 99, 500)] + [
        store.fraction_over(family, thr, 30, at)
        for thr in (0.01, 0.05, 0.1, 0.25, 5.0) for at in (40, 70, 99, 500)]


def test_store_windowed_quantile_and_fraction_like_reference():
    """Every quantile and ``fraction_over`` the same float, exactly."""
    values = _alike(_windowed)
    assert values[1 * 4 + 0] <= 0.05 and values[2 * 4 + 2] == 0.25
    assert values[16 + 3 * 4 + 2] == pytest.approx(0.5, abs=0.02)
    assert values[16 + 4 * 4 + 2] == pytest.approx(0.5, abs=0.02)
    assert values[3] is None and values[16 + 3] is None


def _grafana(pkg):
    targets = [pkg.ts.parse_target(spec) for spec in (
        "mlt_llm_queue_depth", 'x{replica="r0",engine="e"}[30]',
        "rate(mlt_fleet_dispatches_total)[10]", "p95(mlt_llm_ttft_seconds)")]
    with pytest.raises(ValueError):
        pkg.ts.parse_target("not a target!!")
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    for t in range(20):
        store.record("mlt_llm_queue_depth", float(t), at=t,
                     labels={"replica": "r0"})
        store.record("mlt_fleet_dispatches_total", float(t * 3), at=t,
                     kind="counter")
    _feed_histogram(store, [(0, 20, 5, 1)])
    queries = [pkg.ts.grafana_query(store, spec, start, end)
               for spec, start, end in (
                   ('mlt_llm_queue_depth{replica="r0"}', 5, 8),
                   ("rate(mlt_fleet_dispatches_total)[4]", 10, 12),
                   ("p95(mlt_llm_ttft_seconds)[5]", 5, 19),
                   ("rate(mlt_nope_total)[4]", 0, 19))]
    with pytest.raises(ValueError, match="before start"):
        pkg.ts.grafana_query(store, "rate(mlt_fleet_dispatches_total)[4]",
                             100, 50)
    wide = pkg.ts.grafana_query(store, "rate(mlt_fleet_dispatches_total)[4]",
                                0, 10_000_000)
    return (targets, queries, store.search("queue"),
            len(wide["datapoints"]), pkg.ts.GRAFANA_MAX_POINTS)


def test_grafana_target_parse_and_query_like_reference():
    targets, queries, search, wide, cap = _alike(_grafana)
    assert targets[0] == (None, "mlt_llm_queue_depth", {}, 60.0)
    assert targets[2] == ("rate", "mlt_fleet_dispatches_total", {}, 10.0)
    assert queries[0]["datapoints"] == [[5.0, 5000.0], [6.0, 6000.0],
                                        [7.0, 7000.0], [8.0, 8000.0]]
    assert all(v == pytest.approx(3.0) for v, _ in queries[1]["datapoints"])
    assert queries[3]["datapoints"] == []
    assert search == ['mlt_llm_queue_depth{replica="r0"}'] and wide <= cap


def test_store_from_config_and_process_wide_store():
    """``from_mlconf`` reads the port's OBSERVABILITY_DEFAULTS, and the
    process-wide store is swappable as the reference's."""
    store = tts.TimeSeriesStore.from_mlconf(capacity=10)
    conf = tconfig.OBSERVABILITY_DEFAULTS["timeseries"]
    assert (store.resolution_s, store.capacity, store.max_series) == (
        conf["resolution_s"], 10, conf["max_series"])
    agg = tobs.MetricsAggregator.from_mlconf()
    fed = tconfig.OBSERVABILITY_DEFAULTS["federation"]
    assert (agg.stale_after, agg.max_series) == (fed["stale_after_s"],
                                                 fed["max_series"])
    tts.set_store(store)
    try:
        assert tts.get_store() is store
    finally:
        tts.set_store(None)
    assert tts.get_store() is not store
    tts.set_store(None)


# -- SLOs ---------------------------------------------------------------------

def _latency_burn(pkg):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    _feed_histogram(store, [(0, 90, 10, 0), (90, 120, 0, 10)])
    slo = pkg.obs.SLO("ttft", "latency", target=0.25, q=0.95)
    ev = pkg.obs.SLOEvaluator(store, [slo], fast_window=10, slow_window=60,
                              fast_burn=5.0, slow_burn=6.0)
    out = [dict(ev.evaluate(at)[0]) for at in (101, 119, 80)]
    out.append(dict(ev.status()[0]))
    lines = sorted(line for line in pkg.obs.REGISTRY.render().splitlines()
                   if line.startswith("mlt_slo_"))
    return out, lines


def test_latency_slo_multiwindow_burn_like_reference():
    (early, late, ok, last), lines = _alike(_latency_burn)
    assert early["burning"] and not early["breaching"]
    assert early["burn"]["fast"] == pytest.approx(20.0, rel=0.05)
    assert early["burn"]["slow"] == pytest.approx(4.0, rel=0.1)
    assert late["breaching"] and not ok["burning"] and last == ok
    assert 'mlt_slo_status{slo="ttft"} 0' in lines


def _error_rate(pkg):
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    ok = bad = 0.0
    for t in range(100):
        ok += 10
        bad += 2 if t >= 60 else 0
        store.record("mlt_fleet_dispatches_total", ok, at=t,
                     labels={"outcome": "ok"}, kind="counter")
        store.record("mlt_fleet_dispatches_total", bad, at=t,
                     labels={"outcome": "failed"}, kind="counter")
        store.record("mlt_drift_stat", 0.1 if t < 50 else 0.35, at=t,
                     labels={"adapter": "t@v2", "stat": "token_psi"})
        store.record("mlt_drift_stat", 0.1, at=t,
                     labels={"adapter": "t", "stat": "token_psi"})
    slos = [
        pkg.obs.SLO("dispatch-errors", "error_rate", target=0.05,
                    bad_labels={"outcome": "failed"}),
        pkg.obs.SLO("avail", "availability", target=0.99,
                    bad_labels={"outcome": "failed"}),
        pkg.obs.SLO("canary", "quality_delta", target=0.1,
                    labels={"adapter": "t", "stat": "token_psi"},
                    canary_labels={"adapter": "t@v2", "stat": "token_psi"}),
    ]
    ev = pkg.obs.SLOEvaluator(store, slos, fast_window=10, slow_window=30,
                              fast_burn=2.0, slow_burn=1.5)
    return [[dict(s) for s in ev.evaluate(at)] for at in (50, 99)]


def test_error_rate_availability_and_quality_delta_slos_like_reference():
    early, late = _alike(_error_rate)
    assert not early[0]["breaching"] and late[0]["breaching"]
    assert late[0]["burn"]["fast"] == pytest.approx((2 / 12) / 0.05,
                                                    rel=0.1)
    assert late[2]["breaching"] and late[2]["burn"]["fast"] == \
        pytest.approx(2.5)


def test_slo_config_validation_like_reference():
    for pkg in PKGS.values():
        SLO = pkg.obs.SLO
        with pytest.raises(ValueError, match="unknown SLO kind"):
            SLO("x", "latency_p95", target=0.1)
        with pytest.raises(ValueError, match="fraction"):
            SLO("x", "error_rate", target=5.0)
        with pytest.raises(ValueError, match="unknown SLO objective keys"):
            SLO.from_config({"name": "x", "kind": "latency", "target": 0.1,
                             "threshold": 1})
        with pytest.raises(ValueError, match="bad_labels"):
            SLO("x", "error_rate", target=0.05)
        with pytest.raises(ValueError, match="latency-only"):
            SLO("x", "error_rate", target=0.05, adapter="t1",
                bad_labels={"outcome": "failed"})
        SLO("x", "error_rate", target=0.05, bad_labels={"outcome": "failed"})
        SLO("x", "availability", target=0.99, bad="mlt_other_total")
    configs = [{"name": "g", "kind": "goodput", "target": 0.9, "run": "r1"},
               {"name": "l", "kind": "latency", "target": 0.2, "q": 0.99,
                "adapter": "t1"}]
    assert [tobs.SLO.from_config(dict(c)).describe() for c in configs] == \
        [jobs.SLO.from_config(dict(c)).describe() for c in configs]


def test_slo_process_is_not_ported_and_from_config(monkeypatch, tmp_path):
    """``process`` runs over the port's run db since the run stack landed
    (its alert cases are tests/test_torch_alerts.py): an objective with no
    samples does not breach, so nothing fires and no event is written;
    ``from_mlconf`` reads the port's objectives and windows."""
    from mlrun_tpu_torch.db.sqlitedb import SQLiteRunDB

    monkeypatch.setitem(tconfig.OBSERVABILITY_DEFAULTS["slo"], "objectives",
                        [{"name": "ttft", "kind": "latency",
                          "target": 0.25}])
    store = tobs.TimeSeriesStore(resolution_s=1.0)
    ev = tobs.SLOEvaluator.from_mlconf(store)
    assert [s.name for s in ev.slos] == ["ttft"]
    assert (ev.fast_window, ev.slow_window) == (60.0, 300.0)
    db = SQLiteRunDB(str(tmp_path / "slo.db"),
                     logs_dir=str(tmp_path / "logs"))
    assert ev.process(db, at=1.0) == []
    assert db.list_events(kind="slo_burn_rate") == []


def test_configure_from_mlconf_applies_tracer_and_flight(monkeypatch,
                                                         tmp_path):
    flight = tobs.get_flight_recorder()
    tracer = tobs.get_tracer()
    monkeypatch.setitem(tconfig.OBSERVABILITY_DEFAULTS, "trace_ring", 64)
    monkeypatch.setitem(tconfig.OBSERVABILITY_DEFAULTS, "flight",
                        {"ring": 32, "dir": str(tmp_path)})
    try:
        assert tobs.configure_from_mlconf() is tracer
        assert tracer._ring.maxlen == 64 and flight._ring.maxlen == 32
        flight.record("probe.event")
        path = flight.dump("configured")
        assert path and path.startswith(str(tmp_path))
    finally:
        tracer.configure(ring=2048)
        flight.configure(ring=4096, directory="")


# -- the autoscaler -----------------------------------------------------------

def _scalable_fleet(pkg, replicas=1, engine=_ScalableEngine):
    engines = []

    def factory(role):
        engines.append(engine())
        return engines[-1]

    return pkg.fleet.EngineFleet(factory, replicas=replicas,
                                 route_block_tokens=8), engines


def _scaler(pkg, fleet, **overrides):
    kwargs = dict(dry_run=False, min_replicas=1, max_replicas=3,
                  hysteresis_ticks=1, cooldown_up_s=0.0,
                  cooldown_down_s=0.0, drain_grace_s=100.0,
                  queue_high=4.0, queue_low=1.0, free_page_frac_low=0.1,
                  ttft_p95_high_s=0.0, failure_rate_high=0.5)
    kwargs.update(overrides)
    return pkg.autoscaler.FleetAutoscaler(fleet, **kwargs)


def _row(decision) -> tuple:
    return (decision["action"], decision["reason"], decision["recommended"],
            decision["desired"], decision["current"], decision["acted"],
            decision["removed"], decision["forced"], decision["signals"],
            decision["dry_run"])


def _live(fleet):
    return [r for r in fleet.replicas if not r.draining]


def _autoscaler_lines(pkg) -> list:
    return sorted(line for line in pkg.obs.REGISTRY.render().splitlines()
                  if line.startswith("mlt_autoscaler_"))


def _hysteresis(pkg):
    fleet, engines = _scalable_fleet(pkg)
    scaler = _scaler(pkg, fleet, hysteresis_ticks=2, cooldown_up_s=10.0)
    rows = []
    engines[0].queue = 20
    for now in (0.0, 1.0):
        rows.append((_row(scaler.tick(now=now)), len(_live(fleet))))
    engines[0].queue = engines[1].queue = 20
    for now in (2.0, 3.0, 12.0):
        rows.append((_row(scaler.tick(now=now)), len(_live(fleet))))
    dry_fleet, dry_engines = _scalable_fleet(pkg)
    dry = _scaler(pkg, dry_fleet, dry_run=True)
    dry_engines[0].queue = 20
    rows.append((_row(dry.tick(now=0.0)), len(_live(dry_fleet))))
    fleet.stop()
    dry_fleet.stop()
    return rows, _autoscaler_lines(pkg)


def test_autoscaler_hysteresis_cooldown_and_dry_run_like_reference():
    rows, lines = _alike(_hysteresis)
    assert [(r[0][0], bool(r[0][5]), r[1]) for r in rows] == [
        ("up", False, 1), ("up", True, 2), ("up", False, 2),
        ("up", False, 2), ("up", True, 3), ("up", False, 1)]
    assert rows[3][0][2] and rows[5][0][9]
    assert ('mlt_autoscaler_recommendations_total{action="up",'
            'reason="queue_depth"} 4') in lines


def _bounds_and_victims(pkg):
    out = []
    fleet, engines = _scalable_fleet(pkg, replicas=3)
    scaler = _scaler(pkg, fleet, max_replicas=3)
    for engine in engines:
        engine.queue = 20
        engine.free_frac = 0.05
    out.append(_row(scaler.tick(now=0.0)))
    floor_fleet, _ = _scalable_fleet(pkg)
    out.append(_row(_scaler(pkg, floor_fleet).tick(now=0.0)))
    # the least-loaded victim, and its windowed series retired
    victims, v_engines = _scalable_fleet(pkg, replicas=3)
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    v_scaler = _scaler(pkg, victims, store=store, queue_low=2.0)
    v_engines[0].queue = v_engines[2].queue = 1
    for replica in victims.replicas:
        store.record("mlt_llm_queue_depth", 1.0, at=0.0,
                     labels={"replica": replica.id})
    out.append(_row(v_scaler.tick(now=0.0)))
    out.append(store.series())
    # drain grace: busy within grace stays, expired grace is removed
    grace, g_engines = _scalable_fleet(pkg, replicas=2)
    g_scaler = _scaler(pkg, grace, drain_grace_s=50.0, queue_low=5.0)
    g_engines[0].queue = g_engines[1].queue = 1
    decision = g_scaler.tick(now=0.0)
    out.append(_row(decision))
    next(r.engine for r in grace.replicas
         if r.id == decision["acted"]["replica"]).queue = 2
    out += [_row(g_scaler.tick(now=10.0)), _row(g_scaler.tick(now=60.0))]
    for each in (fleet, floor_fleet, victims, grace):
        each.stop()
    return out, _autoscaler_lines(pkg)


def test_autoscaler_bounds_victim_and_drain_grace_like_reference():
    (at_bound, floor, victim, series, drain, busy,
     expired), _ = _alike(_bounds_and_victims)
    assert at_bound[0] == "up" and at_bound[5] is None and at_bound[3] == 3
    assert "queue_depth" in at_bound[1] and "kv_pressure" in at_bound[1]
    assert floor[0] == "down" and floor[5] is None
    assert victim[5] == {"action": "drain", "replica": "f3-u1"}
    assert victim[6] == ["f3-u1"] and len(series) == 2
    assert busy[6] == [] and expired[6] == [drain[5]["replica"]]


def _chaos_forced(pkg):
    fleet, _ = _scalable_fleet(pkg)
    scaler = _scaler(pkg, fleet, hysteresis_ticks=5, queue_low=0.0)

    def force_up(point, context):
        context["box"].update(action="up", reason="injected", force=True)

    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=force_up):
        forced = _row(scaler.tick(now=0.0))
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                error=RuntimeError("scale eval boom")):
        with pytest.raises(RuntimeError, match="scale eval boom"):
            scaler.tick(now=1.0)
    fired = pkg.obs.CHAOS_FIRED.value(point="obs.autoscale")
    fleet.stop()
    return forced, len(_live(fleet)), fired


@pytest.mark.chaos
def test_autoscaler_chaos_forced_scale_and_failure_like_reference():
    forced, live, fired = _alike(_chaos_forced)
    assert forced[7] and forced[5]["action"] == "add"
    assert forced[1] == "injected" and live == 2 and fired == 2


def _aggregated(pkg):
    out = []
    fleet, _ = _scalable_fleet(pkg)
    agg = pkg.obs.MetricsAggregator()
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    scaler = _scaler(pkg, fleet, aggregator=agg, store=store,
                     ttft_p95_high_s=0.2, queue_high=100.0)
    agg.ingest_stats("fleet", {"per_replica": {
        "remote-0": {"queue_depth": 0, "free_page_frac": 0.02}}}, at=10.0)
    _feed_histogram(store, [(0, 11, 0, 10)])
    out += [scaler.signals(11.0), _row(scaler.tick(now=11.0))]
    remote, _ = _scalable_fleet(pkg)
    agg2 = pkg.obs.MetricsAggregator()
    agg2.ingest_stats("fleet", {"per_replica": {
        f"remote-{i}": {"queue_depth": 2} for i in range(4)}}, at=10.0)
    scaler2 = _scaler(pkg, remote, aggregator=agg2, queue_high=4.0,
                      queue_low=0.0)
    out += [scaler2.signals(10.0), _row(scaler2.tick(now=10.0))]
    draining, _ = _scalable_fleet(pkg, replicas=2)
    agg3 = pkg.obs.MetricsAggregator()
    drained = draining.replicas[1].id
    draining.drain_replica(drained)
    agg3.ingest_stats("fleet", {"per_replica": {
        draining.replicas[0].id: {"queue_depth": 1, "free_page_frac": 0.9},
        drained: {"queue_depth": 50, "free_page_frac": 0.01}}}, at=10.0)
    scaler3 = _scaler(pkg, draining, aggregator=agg3, queue_high=4.0,
                      free_page_frac_low=0.1)
    out += [scaler3.signals(10.0), _row(scaler3.tick(now=10.0))]
    for each in (fleet, remote, draining):
        each.stop()
    return out


def test_autoscaler_aggregated_and_remote_signals_like_reference():
    (sig, up, remote_sig, remote, drain_sig, drain) = _alike(_aggregated)
    assert sig["free_page_frac_min"] == 0.02 and sig["ttft_p95_s"] >= 0.25
    assert up[0] == "up" and "kv_pressure" in up[1] and "ttft_slo" in up[1]
    assert remote_sig["load_per_replica"] == pytest.approx(2.0)
    assert remote[0] != "up"
    assert drain_sig["load_per_replica"] <= 1.0
    assert drain_sig["free_page_frac_min"] == 0.9 and drain[0] != "up"


def _closed_loop(pkg):
    fleet, engines = _scalable_fleet(pkg)
    store = pkg.obs.TimeSeriesStore(resolution_s=1.0)
    slo = pkg.obs.SLO("ttft", "latency", target=0.1, q=0.95)
    evaluator = pkg.obs.SLOEvaluator(store, [slo], fast_window=5,
                                     slow_window=20, fast_burn=1.0,
                                     slow_burn=1.0)
    scaler = _scaler(pkg, fleet, store=store, max_replicas=3,
                     ttft_p95_high_s=0.1, queue_high=4.0, queue_low=1.0,
                     ttft_window=5.0)
    offered = [12] * 30 + [0] * 6
    trajectory, breaching, rows = [], [], []
    cum = {"0.05": 0.0, "0.25": 0.0, "+Inf": 0.0}
    for t, load in enumerate(offered):
        live = _live(fleet)
        per_replica = load // len(live) if load else 0
        for replica in live:
            replica.engine.queue = per_replica
        good = per_replica <= 4
        cum["0.05"] += load if good else 0
        cum["0.25"] += load if good else 0
        cum["+Inf"] += load
        for le in ("0.05", "0.25", "+Inf"):
            store.record("mlt_llm_ttft_seconds_bucket", cum[le], at=t,
                         labels={"le": le}, kind="counter")
        store.record("mlt_llm_ttft_seconds_count", cum["+Inf"], at=t,
                     kind="counter")
        status = evaluator.evaluate(float(t))[0]
        breaching.append((status.breaching, status.burn_fast,
                          status.burn_slow))
        rows.append(_row(scaler.tick(now=float(t))))
        trajectory.append(len(_live(fleet)))
    p95 = store.quantile("mlt_llm_ttft_seconds", 0.95, 5, len(offered) - 8)
    out = (trajectory, breaching, rows, p95, len(fleet.replicas))
    fleet.stop()
    return out


def test_closed_loop_ramp_scale_up_down_with_slo_burn_like_reference():
    """The reference's closed loop, with the burn read by ``evaluate``
    (the port's ``process`` needs the alerts): a breach during the
    overload, 3 replicas absorb it, the windowed p95 falls back under
    target, and the ramp's end drains the fleet back to 1."""
    trajectory, breaching, _, p95, replicas = _alike(_closed_loop)
    first = next(t for t, b in enumerate(breaching) if b[0])
    assert first <= 3 and max(trajectory) == 3 and trajectory[3] == 3
    assert p95 <= 0.1 and not breaching[-1][0]
    assert trajectory[-1] == 1 and replicas == 1


def _probated_victim(pkg):
    fleet, engines = _scalable_fleet(pkg, replicas=3, engine=_InstantEngine)
    scaler = pkg.autoscaler.FleetAutoscaler(fleet, dry_run=True,
                                            min_replicas=1, max_replicas=4)
    fleet.replicas[2].health_state = "probation"
    engines[2].depth = 50
    sick = scaler._scale_down_victim().id
    fleet.replicas[2].health_state = "healthy"
    healthy = scaler._scale_down_victim().id
    fleet.stop()
    return sick, healthy, fleet.replicas[2].id


def test_scale_down_prefers_probated_replica_like_reference():
    sick, healthy, third = _alike(_probated_victim)
    assert sick == third and healthy != third


def _restart_cooldown(pkg, tmp_path):
    path = str(tmp_path / f"{pkg.fleet.__name__}-autoscaler.jsonl")
    fleet, _ = _scalable_fleet(pkg, replicas=2)
    scaler1 = _scaler(pkg, fleet, journal=pkg.journal.IntentJournal(path),
                      cooldown_up_s=100.0, max_replicas=4)

    def push_up(point, context):
        context["box"].update(action="up", reason="injected")

    rows = []
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=push_up):
        rows.append(_row(scaler1.tick(now=0.0)))
    scaler1._journal.close()
    journaled = [dict(r) for r in pkg.journal.IntentJournal(path).replay()]
    scaler2 = _scaler(pkg, fleet, journal=pkg.journal.IntentJournal(path),
                      cooldown_up_s=100.0, max_replicas=4)
    booted = [r["op"] for r in scaler2._journal.replay()]
    with pkg.chaos.chaos.inject("obs.autoscale", pkg.chaos.always(),
                                action=push_up):
        for now in (1000.0, 1050.0, 1101.0):
            rows.append(_row(scaler2.tick(now=now)))
    scaler2._journal.close()
    fleet.stop()
    # below the floor after a restart: the repair stays forced
    path2 = str(tmp_path / f"{pkg.fleet.__name__}-floor.jsonl")
    fleet1, _ = _scalable_fleet(pkg, replicas=2)
    first = _scaler(pkg, fleet1, journal=pkg.journal.IntentJournal(path2),
                    cooldown_up_s=1e9)
    first.tick(now=0.0)
    first._journal.close()
    fleet1.stop()
    fleet2, _ = _scalable_fleet(pkg, replicas=1)
    second = _scaler(pkg, fleet2, journal=pkg.journal.IntentJournal(path2),
                     min_replicas=2, cooldown_up_s=1e9)
    rows.append(_row(second.tick(now=5.0)))
    second._journal.close()
    fleet2.stop()
    lines = sorted(line for line in pkg.obs.REGISTRY.render().splitlines()
                   if line.startswith(("mlt_reconcile_actions",
                                       "mlt_journal_writes")))
    return rows, [{k: v for k, v in r.items() if k != "at"}
                  for r in journaled], booted, lines


@pytest.mark.chaos
def test_autoscaler_restart_arms_cooldown_and_repairs_floor_like_reference(
        tmp_path):
    rows, journaled, booted, lines = _alike(_restart_cooldown, tmp_path)
    acted = [r[5] for r in rows]
    assert acted[0]["action"] == "add"
    assert [r["op"] for r in journaled] == ["boot", "act"]
    assert booted == ["boot"]
    assert rows[1][2] and acted[1] is None and acted[2] is None
    assert acted[3] is not None
    assert rows[4][1] == "below_min" and rows[4][7]
    assert acted[4]["action"] == "add"
    assert ('mlt_reconcile_actions_total{controller="autoscaler",'
            'action="cooldown_armed"} 2') in lines
