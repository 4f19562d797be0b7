"""mlrun_tpu_torch's object stores (``datastore/stores.py`` ``FsspecStore``
and ``HttpStore``, ``datastore/redis.py`` ``RedisStore``,
``register_store``, ``datastore/sources.py`` ``HttpSource``) against
mlrun_tpu's, on local stand-ins only:

- the redis cases of ``tests/test_redis_store.py`` over
  ``tests/fake_redis.py`` (the store's round trip, its import gate, and
  the feature store's redis online path);
- ``tests/test_datastore.py::test_s3_storage_options_mapping``, and the
  s3 / gs / az stores over fsspec's ``memory`` filesystem (each package's
  ``fsspec.filesystem`` answers it whatever the protocol), reached by url,
  by a ``ds://`` profile and by a ``store://`` artifact;
- ``http(s)://`` items and the http source against a ``http.server`` on
  127.0.0.1.

Both packages run each scenario with the same inputs; what each returns
is compared.
"""

import functools
import http.server
import threading
import types

import pandas as pd
import pytest

import mlrun_tpu
import mlrun_tpu.datastore as jds
import mlrun_tpu_torch
import mlrun_tpu_torch.datastore as tds
from mlrun_tpu.datastore import sources as jsources
from mlrun_tpu.datastore import stores as jstores
from mlrun_tpu_torch.datastore import sources as tsources
from mlrun_tpu_torch.datastore import stores as tstores

from . import fake_redis

PKGS = {
    "jax": types.SimpleNamespace(name="jax", top=mlrun_tpu, ds=jds,
                                 stores=jstores, sources=jsources,
                                 module="mlrun_tpu"),
    "port": types.SimpleNamespace(name="port", top=mlrun_tpu_torch, ds=tds,
                                  stores=tstores, sources=tsources,
                                  module="mlrun_tpu_torch"),
}


@pytest.fixture()
def each(tmp_path, monkeypatch):
    """``each(scenario)`` runs ``scenario(pkg)`` once per package, each
    under its own MLT_HOME with a fresh run db and store manager."""
    from mlrun_tpu.config import mlconf

    def run(scenario):
        out = {}
        for name, pkg in PKGS.items():
            monkeypatch.setenv("MLT_HOME", str(tmp_path / f"home-{name}"))
            mlconf.reload()
            db_mod = __import__(f"{pkg.module}.db", fromlist=["set_run_db"])
            db_mod.set_run_db(None)
            pkg.ds.store_manager._db = None
            pkg.ds.store_manager._stores.clear()
            try:
                out[name] = scenario(pkg)
            finally:
                db_mod.set_run_db(None)
                pkg.ds.store_manager._db = None
                pkg.ds.store_manager._stores.clear()
        return out

    return run


# -- tests/test_redis_store.py --------------------------------------------------

@pytest.fixture()
def redis_mod(monkeypatch):
    return fake_redis.install(monkeypatch)


def test_redis_store_roundtrip(redis_mod, each):
    def scenario(pkg):
        manager = pkg.ds.store_manager
        item = manager.object(url="redis://cache:6379/models/weights.bin")
        item.put(b"\x00\x01\x02")
        out = [item.get(), item.exists(), item.stat().size,
               item.stat().modified is not None]
        item.put(b"\x03", append=True)
        out += [item.get(), item.get(size=2, offset=1)]
        manager.object(url="redis://cache:6379/models/extra.txt").put("x")
        out.append(manager.object(url="redis://cache:6379/models").ls())
        item.delete()
        out.append(item.exists())
        with pytest.raises(FileNotFoundError):
            item.get()
        out.append(type(item.store).__name__)
        return out

    got = each(scenario)
    assert got["port"] == got["jax"] == [
        b"\x00\x01\x02", True, 3, True, b"\x00\x01\x02\x03", b"\x01\x02",
        ["extra.txt", "weights.bin"], False, "RedisStore"]


def test_redis_store_gated_without_package(monkeypatch, each):
    import builtins
    import sys

    monkeypatch.setitem(sys.modules, "redis", None)
    real_import = builtins.__import__

    def no_redis(name, *args, **kwargs):
        if name == "redis":
            raise ImportError("nope")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_redis)

    def scenario(pkg):
        item = pkg.ds.store_manager.object(url="redis://elsewhere:6379/k")
        with pytest.raises(ImportError, match="redis") as err:
            item.get()
        return str(err.value)

    got = each(scenario)
    assert got["port"] == got["jax"]


def _fstore(pkg):
    return __import__(f"{pkg.module}.feature_store", fromlist=["ingest"])


def _redis_target(pkg):
    return __import__(f"{pkg.module}.datastore.targets",
                      fromlist=["RedisNoSqlTarget"])


def test_redis_online_feature_path(redis_mod, each):
    """Ingest with RedisNoSqlTarget -> the online service reads its rows
    from redis hashes, namespaced per project and feature set."""
    df = pd.DataFrame({"ticker": ["GOOG", "MSFT"], "price": [100.0, 200.0],
                       "volume": [10, 20]})

    def scenario(pkg):
        fstore, targets = _fstore(pkg), _redis_target(pkg)
        fset = fstore.FeatureSet("stocks-redis", entities=["ticker"])
        fset.metadata.project = "rds"
        fstore.ingest(fset, df, targets=["parquet",
                                         targets.RedisNoSqlTarget()])
        target = [t for t in fset.status.targets
                  if t["kind"] == "redisnosql"][0]
        vector = fstore.FeatureVector("v", features=["stocks-redis.*"])
        vector.metadata.project = "rds"
        service = fstore.get_online_feature_service(vector)
        try:
            backed = bool(service._targets) and not service._tables
            rows = service.get([{"ticker": "GOOG"}, {"ticker": "MSFT"}])
        finally:
            service.close()
        keys = sorted(k for client in redis_mod._clients.values()
                      for k in client.hashes)
        redis_mod._clients.clear()
        return (sorted(t["kind"] for t in fset.status.targets),
                target["prefix"], backed, rows, keys)

    got = each(scenario)
    assert got["port"] == got["jax"]
    kinds, prefix, backed, rows, keys = got["port"]
    assert "redisnosql" in kinds and prefix == "mlt:rds:stocks-redis"
    assert backed and rows[0]["price"] == 100.0 and rows[0]["volume"] == 10
    assert all(k.startswith("mlt:rds:stocks-redis:") for k in keys)


def test_redis_online_missing_row_imputes(redis_mod, each):
    def scenario(pkg):
        fstore, targets = _fstore(pkg), _redis_target(pkg)
        fset = fstore.FeatureSet("scores", entities=["user"])
        fset.metadata.project = "rds2"
        fstore.ingest(fset, pd.DataFrame({"user": ["a"], "score": [5.0]}),
                      targets=[targets.RedisNoSqlTarget()])
        vector = fstore.FeatureVector("v2", features=["scores.*"])
        vector.metadata.project = "rds2"
        service = fstore.get_online_feature_service(
            vector, impute_policy={"*": -1})
        try:
            rows = service.get([{"user": "a"}, {"user": "missing"}])
        finally:
            service.close()
        redis_mod._clients.clear()
        return rows

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0]["score"] == 5.0 and got["port"][1]["score"] == -1


def test_redis_targets_namespaced_with_explicit_path(redis_mod, each):
    url = "redis://shared:6379"

    def scenario(pkg):
        fstore, targets = _fstore(pkg), _redis_target(pkg)
        sets = []
        for name, frame in (("one", pd.DataFrame({"k": ["x"], "a": [1]})),
                            ("two", pd.DataFrame({"k": ["x"], "b": [2]}))):
            fset = fstore.FeatureSet(name, entities=["k"])
            fset.metadata.project = "np"
            fstore.ingest(fset, frame,
                          targets=[targets.RedisNoSqlTarget(path=url)])
            sets.append(fset)
        keys = sorted(redis_mod._clients[url].hashes)
        t1 = [t for t in sets[0].status.targets
              if t["kind"] == "redisnosql"][0]
        target = targets.resolve_target({"kind": "redisnosql",
                                         "path": t1["path"]})
        target._prefix = t1["prefix"]
        row = target.get(["x"])
        redis_mod._clients.clear()
        return keys, row

    got = each(scenario)
    assert got["port"] == got["jax"]
    keys, row = got["port"]
    assert {"mlt:np:one:x", "mlt:np:two:x"} <= set(keys)
    assert row["a"] == 1 and "b" not in row


# -- the fsspec object stores ----------------------------------------------------

def test_s3_storage_options_mapping():
    """Per-store credentials become fsspec storage options."""
    for stores in (jstores, tstores):
        store = stores.FsspecStore(None, "s3://x", "s3", "bkt", secrets={
            "AWS_ACCESS_KEY_ID": "AK", "AWS_SECRET_ACCESS_KEY": "SK",
            "S3_ENDPOINT_URL": "http://minio:9000",
            "AWS_REGION": "us-east-1", "S3_ANONYMOUS": "yes"})
        assert store.storage_options() == {
            "key": "AK", "secret": "SK", "endpoint_url": "http://minio:9000",
            "client_kwargs": {"region_name": "us-east-1"}, "anon": True}
        az = stores.FsspecStore(None, "az://c", "az", "cont", secrets={
            "AZURE_STORAGE_CONNECTION_STRING": "cs",
            "AZURE_STORAGE_ACCOUNT_NAME": "acct",
            "AZURE_STORAGE_CLIENT_ID": "cid"})
        assert az.storage_options() == {"connection_string": "cs",
                                        "account_name": "acct",
                                        "client_id": "cid"}
        gs = stores.FsspecStore(None, "gs://b", "gs", "b", secrets={
            "GCP_CREDENTIALS": '{"type": "service_account"}'})
        assert gs.storage_options() == {
            "token": {"type": "service_account"}}


@pytest.fixture()
def memory_fs(monkeypatch):
    """fsspec's ``memory`` filesystem for every protocol a store asks for;
    records (protocol, storage options) of each filesystem built."""
    import sys

    import fsspec
    from fsspec.implementations.memory import MemoryFileSystem

    # no real protocol package is ever loaded (nothing may be fetched)
    for module in ("s3fs", "gcsfs", "adlfs"):
        monkeypatch.setitem(sys.modules, module, None)
    built = []
    real = fsspec.filesystem

    def filesystem(protocol, **options):
        built.append((protocol, options))
        return real("memory")

    monkeypatch.setattr(fsspec, "filesystem", filesystem)
    yield built
    MemoryFileSystem.store.clear()
    MemoryFileSystem.pseudo_dirs.clear()
    MemoryFileSystem.pseudo_dirs.append("")


@pytest.mark.parametrize("scheme", ["s3", "gs", "az"])
def test_object_store_roundtrip_over_memory_fs(scheme, memory_fs, each,
                                               monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SK")

    def scenario(pkg):
        from fsspec.implementations.memory import MemoryFileSystem

        MemoryFileSystem.store.clear()
        manager = pkg.ds.store_manager
        item = manager.object(url=f"{scheme}://bucket/dir/blob.bin")
        item.put(b"abcdef")
        manager.object(url=f"{scheme}://bucket/dir/other.txt").put("xy")
        out = [item.get(), item.get(size=3, offset=1), item.stat().size,
               item.exists(), type(item.store).__name__]
        with pytest.raises(ValueError, match="append"):
            item.put(b"z", append=True)
        if pkg.name == "port":
            # the reference slices fsspec's detailed listing (dicts) and
            # fails on the memory filesystem; the port asks for names
            out.append(sorted(manager.object(
                url=f"{scheme}://bucket/dir").ls()))
        item.delete()
        out.append(item.exists())
        return out

    got = each(scenario)
    assert got["port"] == got["jax"][:5] + [["blob.bin", "other.txt"]] + \
        got["jax"][5:]
    assert got["jax"] == [b"abcdef", b"bcd", 6, True, "FsspecStore", False]
    protocols = {p for p, _ in memory_fs}
    assert protocols == {{"gs": "gcs", "az": "abfs"}.get(scheme, scheme)}
    if scheme == "s3":
        assert all(o == {"key": "AK", "secret": "SK"} for _, o in memory_fs)


def test_profiles_and_artifacts_reach_the_object_store(memory_fs, each,
                                                       tmp_path):
    """A ``ds://`` profile on s3 and a ``store://`` artifact whose target
    is on s3 resolve to the fsspec store with the profile's secrets."""
    def scenario(pkg):
        from fsspec.implementations.memory import MemoryFileSystem

        MemoryFileSystem.store.clear()
        db = __import__(f"{pkg.module}.db.sqlitedb",
                        fromlist=["SQLiteRunDB"]).SQLiteRunDB(
            str(tmp_path / f"{pkg.name}.sqlite"),
            logs_dir=str(tmp_path / f"logs-{pkg.name}"))
        manager = pkg.ds.StoreManager().set(db=db)
        db.store_datastore_profile({"name": "bucket", "type": "s3",
                                    "fields": {"bucket": "b"}})
        profile_item = manager.object(url="ds://bucket/x.bin")
        profile_item.put(b"via-profile")
        db.store_artifact("m", {"kind": "model", "spec": {
            "target_path": "s3://b/x.bin"}}, project="p")
        artifact = manager.object(url="store://models/p/m")
        return (type(profile_item.store).__name__, profile_item.url,
                artifact.get(), artifact.artifact_url)

    got = each(scenario)
    assert got["port"] == got["jax"] == (
        "FsspecStore", "ds://bucket/x.bin", b"via-profile",
        "store://models/p/m")


def test_register_store_adds_a_scheme(each, tmp_path):
    def scenario(pkg):
        pkg.ds.register_store("mydisk", pkg.stores.FileStore)
        try:
            path = tmp_path / f"{pkg.name}.txt"
            path.write_text("on disk")
            item = pkg.ds.StoreManager().object(url=f"mydisk://{path}")
            return item.get(), type(item.store).__name__
        finally:
            pkg.ds.schema_to_store.pop("mydisk", None)

    got = each(scenario)
    assert got["port"] == got["jax"] == (b"on disk", "FileStore")


# -- http(s):// against a local server ------------------------------------------

@pytest.fixture()
def http_root(tmp_path):
    """A ``http.server`` on 127.0.0.1 serving ``tmp_path / "www"``."""
    root = tmp_path / "www"
    root.mkdir()
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(root))
    handler.log_message = lambda *args: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_http_store_reads_and_refuses_writes(http_root, each):
    root, url = http_root
    (root / "blob.bin").write_bytes(b"0123456789")

    def scenario(pkg):
        item = pkg.ds.store_manager.object(url=f"{url}/blob.bin")
        out = [item.get(), item.get(size=4, offset=2), item.stat().size,
               type(item.store).__name__]
        for call in (lambda: item.put(b"x"), lambda: item.delete(),
                     lambda: item.store.listdir("/")):
            with pytest.raises(ValueError) as err:
                call()
            out.append(str(err.value))
        missing = pkg.ds.store_manager.object(url=f"{url}/missing.bin")
        with pytest.raises(Exception) as err:
            missing.get()
        out.append(type(err.value).__name__)
        return out

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:4] == [b"0123456789", b"2345", 10, "HttpStore"]
    assert got["port"][-1] == "HTTPError"


@pytest.mark.parametrize("fmt", ["csv", "json", "parquet"])
def test_http_source_reads_a_frame(http_root, fmt):
    root, url = http_root
    frame = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    path = root / f"data.{fmt}"
    {"csv": lambda: frame.to_csv(path, index=False),
     "json": lambda: frame.to_json(path),
     "parquet": lambda: frame.to_parquet(path, index=False)}[fmt]()
    got = [sources.HttpSource(path=f"{url}/data.{fmt}").to_dataframe(
        columns=["a"] if fmt == "csv" else None)
        for sources in (jsources, tsources)]
    pd.testing.assert_frame_equal(got[1], got[0])
    assert got[1]["a"].tolist() == [1, 2, 3]
