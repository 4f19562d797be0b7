"""mlrun_tpu_torch's feature store (feature_store/, datastore/sources.py,
datastore/targets.py) against mlrun_tpu's on the CPU.

The contracts are tests/test_feature_store.py's: schema inference and
stats at ingest, the offline join through the local and the partitioned
mergers (entity rows, a label feature, more rows than a partition, a
re-bucketing on a key change), the online feature service with its impute
policy, the sources and targets (CSV, Parquet with a time filter, the
sqlite KV and SQL targets, Stream, DF, TSDB), the transform steps and
windowed aggregations, the validator, the real-time ingestion step, and
an entity on the index. Each scenario runs in each package under its own
``MLT_HOME`` and run db; frames are compared with
``pandas.testing.assert_frame_equal`` (exact), records once the
``updated`` stamps, the db's uids and the home directories are masked. Then an online
vector through each package's ``EnrichmentModelRouter`` and
``EnrichmentVotingEnsemble`` in a graph the reference's ServingRuntime
wrote.
"""

import json
import sqlite3
import sys

import numpy as np
import pandas as pd
import pytest

import mlrun_tpu
import mlrun_tpu.datastore as jds
import mlrun_tpu_torch.datastore as tds
import mlrun_tpu.feature_store as jfs
from mlrun_tpu.feature_store import steps as jsteps
from mlrun_tpu.serving import server as jserver
from mlrun_tpu.serving import v2_serving as jv2
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch import feature_store as tfs
from mlrun_tpu_torch.datastore import store_manager as tstore_manager
from mlrun_tpu_torch.feature_store import steps as tsteps
from mlrun_tpu_torch.serving import server as tserver
from mlrun_tpu_torch.serving import v2_serving as tv2
from tests.torch_registries import registries_left_as_found  # noqa: F401

JAX = dict(name="jax", fs=jfs, ds=jds, steps=jsteps, server=jserver, v2=jv2)
PORT = dict(name="port", fs=tfs, ds=tds, steps=tsteps, server=tserver,
            v2=tv2)
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_port_db():
    tdb.set_run_db(None)
    tstore_manager._db = None
    yield
    tdb.set_run_db(None)
    tstore_manager._db = None


def _both(scenario, tmp_path, monkeypatch):
    """``scenario(pkg, home)`` in each package under its own MLT_HOME and
    run db; the results with each home masked."""
    out = []
    for pkg in PKGS:
        home = tmp_path / pkg["name"]
        home.mkdir()
        monkeypatch.setenv("MLT_HOME", str(home))
        mlrun_tpu.db.set_run_db(None)
        tdb.set_run_db(None)
        out.append(_mask(scenario(pkg, home), str(home)))
    return out


def _mask(value, home):
    if isinstance(value, dict):
        return {k: "<v>" if k in ("updated", "uid") else _mask(v, home)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mask(v, home) for v in value]
    if isinstance(value, str):
        return value.replace(home, "<home>")
    return value


def _frames_equal(a, b):
    pd.testing.assert_frame_equal(a.reset_index(drop=True),
                                  b.reset_index(drop=True))


def _sorted(df):
    key = df.columns.tolist()
    return df.sort_values(key).reset_index(drop=True)


def _stocks(pkg):
    fs = pkg["fs"].FeatureSet("stocks", entities=["ticker"])
    fs.metadata.project = "fsproj"
    pkg["fs"].ingest(fs, pd.DataFrame({"ticker": ["A", "B", "C"],
                                       "price": [10.0, 20.0, 30.0]}))
    fs2 = pkg["fs"].FeatureSet("quotes", entities=["ticker"])
    fs2.metadata.project = "fsproj"
    pkg["fs"].ingest(fs2, pd.DataFrame({"ticker": ["A", "B"],
                                        "vol": [0.1, 0.2]}))
    return fs, fs2


def _vector(pkg, name, features, label=""):
    fv = pkg["fs"].FeatureVector(name, features=features)
    fv.metadata.project = "fsproj"
    if label:
        fv.spec.label_feature = label
    fv.save()
    return fv


def test_ingest_schema_stats_and_stored_set(tmp_path, monkeypatch):
    """Ingest infers the same schema and stats, writes the same parquet,
    and stores the same feature-set record in the run db."""
    def scenario(pkg, home):
        fs, _ = _stocks(pkg)
        db = (mlrun_tpu if pkg is JAX else tdb).get_run_db()
        return (fs.to_dict(), db.get_feature_set("stocks", project="fsproj"),
                fs.to_dataframe().to_dict("list"))

    want, got = _both(scenario, tmp_path, monkeypatch)
    assert got == want
    record = got[0]
    assert [f["name"] for f in record["spec"]["features"]] == ["price"]
    assert record["status"]["state"] == "ready"
    assert record["status"]["stats"]["price"]["mean"] == 20.0


@pytest.mark.parametrize("engine,engine_args", [
    ("local", {}), ("partitioned", {"partitions": 3, "batch_rows": 2})])
def test_offline_join_like_reference(engine, engine_args, tmp_path,
                                     monkeypatch):
    """The vector's offline frame, without and with entity rows and a
    label feature; the partitioned merger equals the local one."""
    def scenario(pkg, home):
        _stocks(pkg)
        fv = _vector(pkg, "v1", ["stocks.price", "quotes.vol"])
        plain = pkg["fs"].get_offline_features(
            fv, engine=engine, engine_args=engine_args).to_dataframe()
        fv2 = _vector(pkg, "v4", ["stocks.price"], label="quotes.vol")
        rows = pd.DataFrame({"ticker": ["B", "C", "A", "A"]})
        labelled = pkg["fs"].get_offline_features(
            fv2, entity_rows=rows, engine=engine,
            engine_args=engine_args).to_dataframe()
        kept = pkg["fs"].get_offline_features(
            fv, engine=engine, with_indexes=True,
            engine_args=engine_args).to_dataframe()
        return plain, labelled, kept

    (want, got) = [[_sorted(df) for df in r] for r in _both(
        scenario, tmp_path, monkeypatch)]
    for a, b in zip(want, got):
        _frames_equal(b[a.columns.tolist()], a)
    assert list(got[0].columns) == ["price", "vol"]
    assert len(got[0]) == 3 and got[0]["vol"].isna().sum() == 1
    assert set(got[2].columns) == {"ticker", "price", "vol"}


def test_partitioned_merges_large_and_rekeyed_like_reference(tmp_path,
                                                             monkeypatch):
    """1000 rows through 4 partitions in 64-row batches, and a join on
    [user, day] followed by a label join on [user] that must re-bucket:
    both equal the local merge and the reference's frames."""
    rng = np.random.default_rng(0)
    n = 1000
    left = pd.DataFrame({"uid": np.arange(n), "a": rng.normal(size=n)})
    right = pd.DataFrame({"uid": rng.permutation(n)[:700],
                          "b": rng.normal(size=700)})
    users, days = rng.integers(0, 20, 200), rng.integers(0, 5, 200)
    base = pd.DataFrame({"user": users, "day": days}).drop_duplicates()
    a_col, b_col = rng.normal(size=len(base)), rng.normal(size=len(base))
    labels = pd.DataFrame({"user": np.arange(20), "y": rng.normal(size=20)})

    def scenario(pkg, home):
        fs = pkg["fs"]
        for name, frame, entities in (
                ("big1", left, ["uid"]), ("big2", right, ["uid"]),
                ("ud1", base.assign(a=a_col), ["user", "day"]),
                ("ud2", base.assign(b=b_col), ["user", "day"]),
                ("ulabel", labels, ["user"])):
            fset = fs.FeatureSet(name, entities=entities)
            fset.metadata.project = "fsproj"
            fs.ingest(fset, frame)
        big = _vector(pkg, "vbig", ["big1.a", "big2.b"])
        keys = _vector(pkg, "vkeys", ["ud1.a", "ud2.b"], label="ulabel.y")
        out = []
        for fv, args in ((big, {"partitions": 4, "batch_rows": 64}),
                         (keys, {"partitions": 4, "batch_rows": 16})):
            local = fs.get_offline_features(fv).to_dataframe()
            part = fs.get_offline_features(
                fv, engine="partitioned", engine_args=args).to_dataframe()
            out += [_sorted(local), _sorted(part[local.columns.tolist()])]
        with pytest.raises(ValueError, match="unknown offline merge engine"):
            fs.get_offline_features(big, engine="nope")
        return out

    want, got = _both(scenario, tmp_path, monkeypatch)
    for a, b in zip(want, got):
        _frames_equal(b, a)
    _frames_equal(got[1], got[0])
    _frames_equal(got[3], got[2])
    assert len(got[0]) == n and got[3]["y"].notna().all()


def test_online_service_with_imputation_like_reference(tmp_path,
                                                       monkeypatch):
    """Key lookups from the offline frames and from an ingested nosql
    target, with the impute policy filling a missing entity's features."""
    def scenario(pkg, home):
        _stocks(pkg)
        fv = _vector(pkg, "v2", ["stocks.price", "quotes.vol"])
        svc = pkg["fs"].get_online_feature_service(
            fv, impute_policy={"vol": 0.0})
        rows = svc.get([{"ticker": "A"}, {"ticker": "C"}])
        listed = svc.get([{"ticker": "B"}], as_list=True)
        svc.close()
        online = pkg["fs"].FeatureSet("online", entities=["ticker"])
        online.metadata.project = "fsproj"
        pkg["fs"].ingest(online, pd.DataFrame(
            {"ticker": ["A", "B"], "score": [1.5, 2.5]}), targets=["nosql"])
        fv2 = _vector(pkg, "v7", ["online.*"])
        svc2 = pkg["fs"].get_online_feature_service(
            fv2, impute_policy={"*": -1.0})
        kv = svc2.get([{"ticker": "B"}, {"ticker": "Z"}])
        svc2.close()
        return rows, listed, kv, svc.status

    want, got = _both(scenario, tmp_path, monkeypatch)
    assert got == want
    rows, listed, kv, status = got
    assert rows == [{"price": 10.0, "vol": 0.1}, {"price": 30.0, "vol": 0.0}]
    assert listed == [[20.0, 0.2]]
    assert kv == [{"score": 2.5}, {"score": -1.0}] and status == "ready"


def test_sources_and_targets_like_reference(tmp_path, monkeypatch):
    """A CSV source into the offline parquet, the sqlite KV and an SQL
    table; a Parquet source's time filter; the Stream, DF, CSV, Parquet and
    TSDB targets and the sources that read them back."""
    def scenario(pkg, home):
        ds = pkg["ds"]
        csv = home / "src.csv"
        pd.DataFrame({"id": ["a", "b"], "v": [1.0, 2.0]}).to_csv(
            csv, index=False)
        fs = pkg["fs"].FeatureSet("multi", entities=["id"])
        fs.metadata.project = "fsproj2"
        nosql = ds.NoSqlTarget(path=str(home / "kv.sqlite"))
        sql = ds.SQLTarget(name="tbl", attributes={
            "db_url": f"sqlite://{home}/sql.sqlite", "table": "tbl"})
        pkg["fs"].ingest(fs, ds.CSVSource(path=str(csv)),
                         targets=[nosql, sql])
        with sqlite3.connect(str(home / "sql.sqlite")) as conn:
            sql_rows = conn.execute("SELECT * FROM tbl").fetchall()
        table = ds.SQLSource(path="tbl", attributes={
            "db_url": f"sqlite://{home}/sql.sqlite"}).to_dataframe()
        pq = home / "t.parquet"
        pd.DataFrame({"ts": pd.to_datetime(
            ["2026-01-01", "2026-02-01", "2026-03-01"]), "v": [1, 2, 3]}
        ).to_parquet(pq, index=False)
        filtered = ds.ParquetSource(
            path=str(pq), time_field="ts", start_time="2026-01-15",
            end_time="2026-02-15").to_dataframe()
        frame = pd.DataFrame({"k": ["x", "y"], "n": [1, 2]})
        stream = ds.StreamTarget(path=f"memory://fs-{pkg['name']}")
        stream.write_dataframe(frame)
        streamed = ds.StreamSource(
            path=f"memory://fs-{pkg['name']}").to_dataframe()
        df_target = ds.DFTarget()
        df_target.write_dataframe(frame)
        written = {}
        for cls in (ds.CSVTarget, ds.ParquetTarget):
            target = cls()
            target.path = target.default_path("p", "s")
            target.write_dataframe(frame)
            written[target.kind] = (target.path,
                                    target.as_df().to_dict("list"))
        tsdb = ds.TSDBTarget()
        tsdb.path = tsdb.default_path("p", "s")
        for _ in range(2):      # appends
            tsdb.write_dataframe(frame)
        written["tsdb"] = (tsdb.path,
                           pd.read_parquet(tsdb.path).to_dict("list"))
        return (fs.to_dataframe().to_dict("list"), nosql.get(["a"]),
                nosql.get(["zz"]), sql_rows, table.to_dict("list"),
                filtered.to_dict("list"),
                sorted(t["kind"] for t in fs.status.targets),
                streamed.to_dict("list"),
                df_target.as_df(["n"]).to_dict("list"), written)

    want, got = _both(scenario, tmp_path, monkeypatch)
    assert got == want
    assert got[1] == {"id": "a", "v": 1.0} and got[2] is None
    assert got[3] == [["a", 1.0], ["b", 2.0]]   # rows, masked to lists
    assert got[5] == {"ts": [pd.Timestamp("2026-02-01")], "v": [2]}
    assert got[6] == ["nosql", "parquet", "sql"]
    assert got[9]["tsdb"][1]["n"] == [1, 2, 1, 2]


def test_resolvers_and_gated_sources(monkeypatch):
    """``resolve_source`` / ``resolve_target`` pick the same classes from
    frames, urls, dicts and kind names; the gated sources and targets
    raise ImportError without their client packages, as the reference's
    do; the http source raises ``not_ported`` item 10."""
    from mlrun_tpu.datastore import sources as jsources
    from mlrun_tpu.datastore import targets as jtargets
    from mlrun_tpu_torch.datastore import sources as tsources
    from mlrun_tpu_torch.datastore import targets as ttargets

    inputs = [pd.DataFrame({"a": [1]}), "x.csv", "x.parquet", "x.pq",
              "file:///x.json", {"kind": "stream", "path": "memory://s"}]
    for item in inputs:
        assert type(tsources.resolve_source(item)).__name__ == \
            type(jsources.resolve_source(item)).__name__
    assert type(tsources.resolve_source("https://h/x.json")).__name__ == \
        "HttpSource"
    for kind in ttargets.target_kind_to_class:
        assert type(ttargets.resolve_target(kind)).__name__ == \
            type(jtargets.resolve_target(kind)).__name__
        assert ttargets.resolve_target({"kind": kind, "path": "p"}).path \
            == "p"
    for module in (tsources, ttargets):
        with pytest.raises(ValueError, match="unknown"):
            (module.resolve_source if module is tsources
             else module.resolve_target)({"kind": "nope"})
    # the client packages hidden (never called: no client may reach out)
    for module in ("google.cloud.bigquery", "snowflake.connector", "kafka",
                   "redis"):
        monkeypatch.setitem(sys.modules, module, None)
    gated = [(tsources.BigQuerySource(path="t"), "google-cloud-bigquery"),
             (tsources.SnowflakeSource(path="t"), "snowflake"),
             (tsources.KafkaSource(path="t"), "kafka-python")]
    for source, package in gated:
        with pytest.raises(ImportError, match=package):
            source.to_dataframe()
    with pytest.raises(ImportError, match="redis-py"):
        ttargets.RedisNoSqlTarget(path="redis://h:1").get(["a"])
    with pytest.raises(NotImplementedError, match="item 10"):
        tsources.HttpSource(path="https://h/x.csv").to_dataframe()
    snow = tsources.SnowflakeSource(attributes={"account": "acc",
                                                "user": "u"})
    assert snow.connection_kwargs() == jsources.SnowflakeSource(
        attributes={"account": "acc", "user": "u"}).connection_kwargs()


def test_transforms_aggregations_and_validation_like_reference(
        tmp_path, monkeypatch):
    """An imputer, a value map and 1h windowed sums and means per entity;
    a row filter and a validator that passes; one that raises; an entity
    carried on the index; a missing entity column refused."""
    df = pd.DataFrame({
        "user": ["a", "a", "a", "b"],
        "ts": pd.to_datetime(["2026-01-01 10:00", "2026-01-01 10:30",
                              "2026-01-01 12:00", "2026-01-01 10:15"]),
        "amount": [10.0, None, 40.0, 5.0],
        "tier": ["gold", "silver", "bronze", "gold"],
    })

    def scenario(pkg, home):
        fs_mod, steps = pkg["fs"], pkg["steps"]
        fs = fs_mod.FeatureSet("events", entities=["user"],
                               timestamp_key="ts")
        fs.add_transform_step(steps.Imputer(method="avg"))
        fs.add_transform_step(steps.MapValues(
            {"tier": {"gold": 3, "silver": 2, "default": 1}}, suffix="_n"))
        fs.add_transform_step(steps.OneHotEncoder({"tier": ["gold"]}))
        fs.add_aggregation("amount", ["sum", "avg"], windows=["1h"])
        events = fs_mod.ingest(fs, df)
        clean = fs_mod.FeatureSet("clean", entities=["id"])
        clean.add_transform_step(steps.FilterRows("value >= 0"))
        clean.add_transform_step(steps.FeaturesetValidator(
            {"value": {"max": 100}}, raise_on_fail=True))
        kept = fs_mod.ingest(clean, pd.DataFrame(
            {"id": ["a", "b", "c"], "value": [1.0, -5.0, 50.0]}))
        bad = fs_mod.FeatureSet("bad", entities=["id"])
        bad.add_transform_step(steps.FeaturesetValidator(
            {"value": {"max": 10}}, raise_on_fail=True))
        with pytest.raises(ValueError, match="validation failed"):
            fs_mod.ingest(bad, pd.DataFrame({"id": ["a"], "value": [99.0]}))
        with pytest.raises(ValueError, match="entity column"):
            fs_mod.ingest(fs_mod.FeatureSet("x", entities=["missing"]),
                          pd.DataFrame({"x": [1]}))
        idx = fs_mod.FeatureSet("idx", entities=["ticker"])
        indexed = fs_mod.ingest(idx, pd.DataFrame(
            {"price": [1.0, 2.0]}, index=pd.Index(["A", "B"],
                                                  name="ticker")))
        return events, kept, indexed, json.dumps(fs.to_dict()["spec"],
                                                 default=str)

    want, got = _both(scenario, tmp_path, monkeypatch)
    for a, b in zip(want[:3], got[:3]):
        _frames_equal(b, a)
    assert got[3] == want[3]
    events = got[0]
    row_12 = events[(events["user"] == "a") & (
        events["ts"] == pd.Timestamp("2026-01-01 12:00"))]
    assert float(row_12["amount_sum_1h"].iloc[0]) == 40.0
    assert "tier_n" in events and "tier_gold" in events
    assert not events["amount"].isna().any()
    assert len(got[1]) == 2 and sorted(got[2]["ticker"]) == ["A", "B"]


def test_realtime_ingestion_step_like_reference(tmp_path, monkeypatch):
    """Events posted through a graph of the reference's ingestion service
    spec, loaded into each package's GraphServer with that package's
    ``FeatureSetIngestStep``: the online KV holds the latest event per
    entity and the offline parquet the deduped rows. The port's
    ``ingestion_service_function`` waits for its serving runtime."""
    def scenario(pkg, home):
        fs_mod = pkg["fs"]
        fs = jfs.FeatureSet("live-events", entities=["user"])
        fs.metadata.project = "rtproj"
        fs.add_transform_step(jsteps.MapValues(
            {"tier": {"gold": 2, "default": 1}}, suffix="_n"))
        spec = json.loads(json.dumps(
            jfs.ingestion_service_function(fs, project="rtproj")
            ._get_serving_spec(), default=str))
        if pkg is PORT:
            tdb.get_run_db().store_feature_set(
                mlrun_tpu.get_run_db().get_feature_set(
                    "live-events", project="rtproj"),
                name="live-events", project="rtproj")
        server = pkg["server"].GraphServer.from_dict(spec)
        server.init_states(pkg["server"].GraphContext(server=server), {
            "FeatureSetIngestStep": fs_mod.FeatureSetIngestStep},
            is_mock=True)
        first = server.test(body={"user": "a", "v": 1.0, "tier": "gold"})
        server.test(body=[{"user": "b", "v": 2.0, "tier": "silver"},
                          {"user": "a", "v": 3.0, "tier": "gold"}])
        step = server.graph.steps["ingest"]._object
        online = [step.get(["a"]), step.get(["b"])]
        step.flush()
        offline = pd.read_parquet(step.fset._target_path())
        return first, online, offline.to_dict("list")

    want, got = _both(scenario, tmp_path, monkeypatch)
    assert got == want
    first, online, offline = got
    assert first == {"ingested": 1, "feature_set": "live-events"}
    assert online[0]["v"] == 3.0 and online[0]["tier_n"] == 2
    assert online[1]["tier_n"] == 1
    assert sorted(offline["user"]) == ["a", "b"]
    with pytest.raises(NotImplementedError, match="item 14"):
        tfs.ingestion_service_function("live-events", project="rtproj")


@pytest.mark.parametrize("router", ["EnrichmentModelRouter",
                                    "EnrichmentVotingEnsemble"])
def test_enrichment_router_serves_the_online_vector(router, tmp_path,
                                                    monkeypatch):
    """A router graph with ``feature_vector_uri``: each input entity
    becomes its feature list from the online service (imputed where the
    entity is missing) before the model sees it, in both packages."""
    fn = mlrun_tpu.new_function("enrich", kind="serving")
    fn.set_topology("router", class_name=router,
                    feature_vector_uri="store://feature-vectors/fsproj/v2",
                    impute_policy={"vol": 0.0})
    fn.add_model("m", class_name="Summer", model_path="")
    spec = json.loads(json.dumps(fn._get_serving_spec(), default=str))

    def scenario(pkg, home):
        _stocks(pkg)
        _vector(pkg, "v2", ["stocks.price", "quotes.vol"])

        class Summer(pkg["v2"].V2ModelServer):
            def load(self):
                pass

            def predict(self, request):
                return [sum(row) for row in request["inputs"]]

        server = pkg["server"].GraphServer.from_dict(spec)
        server.init_states(pkg["server"].GraphContext(server=server),
                           {"Summer": Summer}, is_mock=True)
        body = server.test("/v2/models/m/infer", body={
            "inputs": [{"ticker": "A"}, {"ticker": "C"}, {"ticker": "B"}]})
        return body["outputs"]

    want, got = _both(scenario, tmp_path, monkeypatch)
    assert got == want
    assert got == [10.0 + 0.1, 30.0 + 0.0, 20.0 + 0.2]
