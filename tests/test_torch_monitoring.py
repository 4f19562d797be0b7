"""mlrun_tpu_torch's endpoint monitoring pipeline (model_monitoring/:
the monitoring stream, ``EventStreamProcessor``, the applications,
``MonitoringApplicationController``, ``ModelMonitoringWriter`` and
``MetricsTSDB``) against mlrun_tpu's on the CPU.

The contracts are tests/test_monitoring.py's. Each scenario serves the
same requests through a graph with ``track_models`` set — the spec written
by the reference's ServingRuntime, loaded into each package's
``GraphServer`` (the port's ``kind="serving"`` runtime is item 14's) —
then drains each package's stream under its own ``MLT_HOME`` and compares
endpoint records, parquet windows, application results and metric series.
Bounds: every compared field is equal once wall-clock fields are masked
(timestamps and the measured latencies); drift scores agree to 1e-12
(the same float64 numpy arithmetic).
"""

import json
import os

import numpy as np
import pandas as pd
import pytest

import mlrun_tpu
from mlrun_tpu.model_monitoring import applications as japps
from mlrun_tpu.model_monitoring import controller as jctl
from mlrun_tpu.model_monitoring import metrics as jmetrics
from mlrun_tpu.model_monitoring import stream_processing as jsp
from mlrun_tpu.model_monitoring import tsdb as jtsdb
from mlrun_tpu.serving import llm as jllm
from mlrun_tpu.serving import server as jserver
from mlrun_tpu.serving import streams as jstreams
from mlrun_tpu.serving import v2_serving as jv2
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch.datastore import store_manager as tstore_manager
from mlrun_tpu_torch.model_monitoring import applications as tapps
from mlrun_tpu_torch.model_monitoring import controller as tctl
from mlrun_tpu_torch.model_monitoring import metrics as tmetrics
from mlrun_tpu_torch.model_monitoring import stream_processing as tsp
from mlrun_tpu_torch.model_monitoring import tsdb as ttsdb
from mlrun_tpu_torch.serving import llm as tllm
from mlrun_tpu_torch.serving import server as tserver
from mlrun_tpu_torch.serving import streams as tstreams
from mlrun_tpu_torch.serving import v2_serving as tv2
from tests.torch_registries import registries_left_as_found  # noqa: F401

JAX = dict(name="jax", server=jserver, v2=jv2, sp=jsp, ctl=jctl, apps=japps,
           metrics=jmetrics, tsdb=jtsdb, db=mlrun_tpu, llm=jllm)
PORT = dict(name="port", server=tserver, v2=tv2, sp=tsp, ctl=tctl,
            apps=tapps, metrics=tmetrics, tsdb=ttsdb, db=tdb, llm=tllm)
PKGS = (JAX, PORT)
WALL = {"when", "first_request", "last_request", "last_analyzed", "updated",
        "avg_latency_microsec", "max_latency_microsec",
        "latency_p50_microsec", "latency_p95_microsec", "microsec"}


@pytest.fixture(autouse=True)
def _fresh_port_db():
    tdb.set_run_db(None)
    tstore_manager._db = None
    for streams in (jstreams, tstreams):
        streams._inmem_streams.clear()
    yield
    tdb.set_run_db(None)
    tstore_manager._db = None


def _model_class(pkg):
    class M(pkg["v2"].V2ModelServer):
        def load(self):
            pass

        def predict(self, request):
            if request["inputs"] == ["explode"]:
                raise ValueError("bad")
            return [sum(request["inputs"])]
    return M


def _spec():
    fn = mlrun_tpu.new_function("msrv", kind="serving", project="monproj")
    fn.set_topology("router")
    fn.add_model("m", class_name="M", model_path="")
    spec = json.loads(json.dumps(fn._get_serving_spec(), default=str))
    spec["track_models"] = True
    return spec


def _home(pkg, tmp_path, monkeypatch):
    """Each package runs under its own MLT_HOME (run db, parquet, series)."""
    home = tmp_path / pkg["name"]
    monkeypatch.setenv("MLT_HOME", str(home))
    if pkg is JAX:
        mlrun_tpu.db.set_run_db(None)
    else:
        tdb.set_run_db(None)


def _serve(pkg, inputs):
    server = pkg["server"].GraphServer.from_dict(_spec())
    server.init_states(pkg["server"].GraphContext(server=server),
                       {"M": _model_class(pkg)}, is_mock=True)
    for body in inputs:
        server.test("/v2/models/m/infer", body={"inputs": body},
                    silent=body == ["explode"])
    return server


def _mask(value):
    if isinstance(value, dict):
        return {k: "<t>" if k in WALL else _mask(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    return value


def _serve_and_process(pkg, tmp_path, monkeypatch, inputs):
    _home(pkg, tmp_path, monkeypatch)
    _serve(pkg, inputs)
    processed = pkg["sp"].EventStreamProcessor("monproj").run_once()
    endpoints = pkg["db"].get_run_db().list_model_endpoints("monproj")
    parquet_dir = pkg["sp"].get_monitoring_parquet_dir("monproj")
    frames = {}
    for name in sorted(os.listdir(parquet_dir)):
        frame = pd.read_parquet(f"{parquet_dir}/{name}")
        frames[name] = frame.drop(columns=["when", "microsec"])
    return processed, endpoints, frames


def test_stream_to_endpoint_metrics_and_parquet(tmp_path, monkeypatch):
    """Three good requests and one error: four events processed, one
    endpoint record with the same counts, and the same parquet window."""
    inputs = [[1, 2], [3, 4], [5, 6], ["explode"]]
    got = [_serve_and_process(pkg, tmp_path, monkeypatch, inputs)
           for pkg in PKGS]
    (j_n, j_eps, j_frames), (t_n, t_eps, t_frames) = got
    assert t_n == j_n == 4
    assert len(t_eps) == 1
    assert _mask(t_eps) == _mask(j_eps)
    ep = t_eps[0]
    assert ep["uid"] == "monproj-msrv:latest.m"
    assert ep["metrics"]["requests"] == 3 and ep["error_count"] == 1
    assert ep["metrics"]["avg_latency_microsec"] > 0
    assert list(t_frames) == list(j_frames) == ["monproj-msrv:latest.m.parquet"]
    for name in t_frames:
        pd.testing.assert_frame_equal(t_frames[name], j_frames[name])
    assert t_frames[name]["inputs"].tolist() == ["[1, 2]", "[3, 4]",
                                                 "[5, 6]"]


def test_drift_app_on_frames_and_sketches(tmp_path):
    """HistogramDataDriftApplication on a drifted window, a same
    distribution window, and streamed sketches of a window too large to
    materialize: the same results in both packages."""
    rng = np.random.default_rng(0)
    reference = pd.DataFrame({"f0": rng.normal(0, 1, 500),
                              "f1": rng.normal(5, 1, 500)})
    drifted = pd.DataFrame({"f0": rng.normal(4, 1, 200),
                            "f1": rng.normal(5, 1, 200)})
    same = reference.sample(100, random_state=1)
    shifted = rng.normal(4.0, 1.0, 3000)
    outs = []
    for pkg in PKGS:
        apps = pkg["apps"]
        app = apps.HistogramDataDriftApplication(potential_threshold=0.2,
                                                 detected_threshold=0.4)
        ctx = apps.MonitoringContext(
            project="p", endpoint_id="e", model_name="m", sample_df=drifted,
            reference_df=reference, start="", end="")
        first = app.do_tracking(ctx)
        ctx.sample_df = same
        second = app.do_tracking(ctx)
        hist = pkg["metrics"].StreamingHistogram(bins=20, warmup=200)
        hist.update(shifted)
        ctx = apps.MonitoringContext(
            project="p", endpoint_id="e", model_name="m",
            sample_df=pd.DataFrame(), reference_df=reference[["f0"]],
            start="", end="", sample_histograms={"f0": hist})
        third = apps.HistogramDataDriftApplication().do_tracking(ctx)
        none = app.do_tracking(apps.MonitoringContext(
            project="p", endpoint_id="e", model_name="m",
            sample_df=drifted, reference_df=None, start="", end=""))
        latency = apps.LatencyApplication(p95_threshold_microsec=150.0)
        lat = latency.do_tracking(apps.MonitoringContext(
            project="p", endpoint_id="e", model_name="m",
            sample_df=pd.DataFrame(), reference_df=None, start="", end="",
            latencies_microsec=list(range(100, 200))))
        outs.append([[(r.name, r.value, r.kind, r.status, r.extra)
                      for r in rs] for rs in (first, second, third, none,
                                              lat)])
    assert outs[1] == outs[0]
    statuses = [{name: status for name, _, _, status, _ in rs}
                for rs in outs[1]]
    assert statuses[0]["data_drift_score"] in ("potential", "detected")
    assert statuses[1]["data_drift_score"] == "no_detection"
    assert statuses[2]["data_drift_score"] == "detected"
    assert outs[1][3] == []
    assert statuses[4]["latency_p95_microsec"] == "detected"


def _controller_pass(pkg, tmp_path, monkeypatch, inputs, passes=1):
    _home(pkg, tmp_path, monkeypatch)
    _serve(pkg, inputs)
    controller = pkg["ctl"].MonitoringApplicationController("monproj")
    results = [controller.run_once() for _ in range(passes)]
    endpoint_id = next(iter(results[0]))
    record = pkg["db"].get_run_db().get_model_endpoint("monproj",
                                                       endpoint_id)
    series = pkg["tsdb"].get_metrics_tsdb().query("monproj", endpoint_id)
    return ([{k: [(r.name, r.kind, r.status) for r in v]
              for k, v in res.items()} for res in results],
            _mask(record), sorted(s["metric"] for s in series))


def test_controller_end_to_end_writes_endpoint_and_series(tmp_path,
                                                          monkeypatch):
    """stream → parquet → a controller window → application results on
    the endpoint record and in the metric series; a second pass over no
    new rows analyzes nothing."""
    inputs = [[1, 2], [2, 3], [3, 4], [4, 5]]
    got = [_controller_pass(pkg, tmp_path, monkeypatch, inputs, passes=2)
           for pkg in PKGS]
    assert got[1] == got[0]
    results, record, series = got[1]
    assert [list(r) for r in results] == [["monproj-msrv:latest.m"], []]
    assert "latency_p50_microsec" in record["metrics"]
    assert "latency_p50_microsec" in series


def test_writer_emits_detected_events(tmp_path, monkeypatch):
    """A detected drift result sets the record's drift status and measures
    and emits ``model_drift_detected``; an anomaly emits
    ``model_anomaly``."""
    outs = []
    for pkg in PKGS:
        _home(pkg, tmp_path, monkeypatch)
        apps = pkg["apps"]
        db = pkg["db"].get_run_db()
        events = []
        db.emit_event = lambda kind, event, project="": events.append(
            (kind, event, project))
        writer = pkg["ctl"].ModelMonitoringWriter("monproj", db=db)
        writer.write("ep1", [
            apps.ApplicationResult("data_drift_score", 0.8, kind="drift",
                                   status="detected",
                                   extra={"per_feature": {"f0": {"tvd": 1}}}),
            apps.ApplicationResult("latency_p95_microsec", 9e5,
                                   kind="anomaly", status="detected"),
            apps.ApplicationResult("kld_mean", 0.3)])
        outs.append((_mask(db.get_model_endpoint("monproj", "ep1")), events,
                     [s["metric"] for s in pkg["tsdb"].get_metrics_tsdb()
                      .query("monproj", "ep1")]))
    assert outs[1] == outs[0]
    record, events, series = outs[1]
    assert record["drift_status"] == "detected"
    assert [e[0] for e in events] == ["model_drift_detected", "model_anomaly"]
    assert sorted(series) == ["data_drift_score", "kld_mean",
                              "latency_p95_microsec"]


def test_metrics_tsdb_roundtrip_and_files_cross(tmp_path):
    """The TSDB contract (ranges, names, endpoint isolation, stride
    downsampling that keeps the newest point, retention) on both packages,
    and each package reads the other's file."""
    outs = []
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg['name']}.db")
        tsdb = pkg["tsdb"].MetricsTSDB(path)
        for i in range(10):
            tsdb.write("p", "ep1", {"drift": i / 10, "latency": 100 + i,
                                    "label": "skip"}, ts=1000.0 + i)
        tsdb.write("p", "ep2", {"drift": 0.9}, ts=1005.0)
        outs.append((tsdb.query("p", "ep1", metric="drift", end=2000.0),
                     tsdb.query("p", "ep1", metric="drift", start=1003,
                                end=1006),
                     tsdb.query("p", "ep1", end=2000.0),
                     tsdb.list_metrics("p", "ep1"),
                     tsdb.list_metrics("p", "ep2"),
                     tsdb.query("p", "ep1", metric="drift", max_points=4,
                                end=2000.0)))
        tsdb.close()
    assert outs[1] == outs[0]
    assert [pt["ts"] for pt in outs[1][1][0]["points"]] == [1003, 1004,
                                                            1005, 1006]
    assert outs[1][3] == ["drift", "latency"]
    assert outs[1][5][0]["points"][-1]["ts"] == 1009.0
    crossed = [ttsdb.MetricsTSDB(str(tmp_path / "jax.db")),
               jtsdb.MetricsTSDB(str(tmp_path / "port.db"))]
    for tsdb in crossed:
        assert tsdb.query("p", "ep1", end=2000.0) == outs[0][2]
        tsdb.prune(older_than_s=1.0)
        assert tsdb.query("p", "ep1") == []
        tsdb.close()


def test_monitoring_stream_kinds(tmp_path, monkeypatch):
    """The stream is the project's in-memory stream (the one the graph
    pushes to), the reference's default kind; the parquet windows go under
    MLT_HOME at the reference's path."""
    monkeypatch.setenv("MLT_HOME", str(tmp_path))
    assert tsp.get_monitoring_stream("px") is \
        tstreams.get_in_memory_stream("monitoring-px")
    assert jsp.get_monitoring_stream("px") is \
        jstreams.get_in_memory_stream("monitoring-px")
    event = {"model": "m", "function_uri": "px/f", "microsec": 5}
    tsp.get_monitoring_stream("px").push(event)
    assert tsp.EventStreamProcessor("px")._pull() == [event]
    assert tsp.get_monitoring_parquet_dir("px") == str(
        tmp_path / "monitoring" / "px" / "parquet") == \
        jsp.get_monitoring_parquet_dir("px")


def _llm_with_context(pkg):
    """User code: a step class whose ``__init__`` names ``context`` gets
    the graph context, and hands it to the ``LLMModelServer`` it wraps.
    Both packages' step reads the bare ``LLMModelServer``'s
    ``object.__init__`` and passes it none (ROADMAP §3)."""
    llm = pkg["llm"].LLMModelServer

    class LLMWithContext:
        def __init__(self, context=None, **class_args):
            self.server = llm(context=context, **class_args)

        def __getattr__(self, name):
            if name == "server":
                raise AttributeError(name)
            return getattr(self.server, name)
    return LLMWithContext


def test_tracked_llm_route_reaches_the_endpoint_series(tmp_path,
                                                       monkeypatch):
    """A tracked graph over the tiny paged ``LLMModelServer``, in each
    package: the bare route gets no graph context and pushes no event (a
    gap both packages share); the route wrapped to take the context
    pushes one event a request, and the stream processor and the
    application controller turn them into the same endpoint record and
    latency series in both packages."""
    spec = _spec()
    route_spec = spec["graph"]["steps"]["router"]["routes"]["m"]
    route_spec.update(class_args={
        "name": "m", "model_preset": "tiny", "continuous_batching": True,
        "paged": True, "max_len": 64, "page_size": 8, "max_new_tokens": 3,
        "warmup": False})
    got = []
    for pkg in PKGS:
        _home(pkg, tmp_path, monkeypatch)
        if pkg is PORT:
            route_spec["class_args"]["device"] = "cpu"
        namespace = {"LLMModelServer": pkg["llm"].LLMModelServer,
                     "LLMWithContext": _llm_with_context(pkg)}
        pushed = []
        for class_name in ("LLMModelServer", "LLMWithContext"):
            route_spec["class_name"] = class_name
            server = pkg["server"].GraphServer.from_dict(spec)
            server.init_states(pkg["server"].GraphContext(server=server),
                               namespace, is_mock=True)
            route = server.graph.steps["router"].routes["m"]._object
            try:
                for prompt in ([1, 2, 3, 4], [5, 6, 7]):
                    server.test("/v2/models/m/infer",
                                body={"inputs": [prompt]})
            finally:
                route.engine.stop()
            pushed.append(
                pkg["sp"].EventStreamProcessor("monproj").run_once())
        results = pkg["ctl"].MonitoringApplicationController(
            "monproj").run_once()
        endpoint = "monproj-msrv:latest.m"
        record = pkg["db"].get_run_db().get_model_endpoint("monproj",
                                                           endpoint)
        series = pkg["tsdb"].get_metrics_tsdb().query("monproj", endpoint)
        got.append((pushed,
                    {k: [r.name for r in v] for k, v in results.items()},
                    record["metrics"]["requests"],
                    sorted({s["metric"] for s in series})))
    assert got[0] == got[1] == (
        [0, 2],
        {"monproj-msrv:latest.m": ["latency_p50_microsec",
                                   "latency_p95_microsec"]},
        2, ["latency_p50_microsec", "latency_p95_microsec"])
