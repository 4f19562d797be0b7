"""mlrun_tpu_torch's run db (db/sqlitedb.py) against mlrun_tpu's: the same
operations on each package's ``SQLiteRunDB`` give equal answers, the two
schemas are identical, a db file either package writes reads the same in
the other, and the contracts of tests/test_sqlitedb.py hold on both.

Every comparison is exact once the volatile fields are masked: wall-clock
stamps (``start_time`` a row was stored without, ``last_update``,
``created``, ``updated``) and page tokens (random). Nothing else is
loosened.
"""

import sqlite3
import sys

import pytest

import mlrun_tpu.db as jdb_pkg
import mlrun_tpu_torch.db as tdb_pkg
from mlrun_tpu.db import sqlitedb as jsqlite
from mlrun_tpu_torch.db import sqlitedb as tsqlite

PKGS = {"jax": jsqlite, "port": tsqlite}
VOLATILE = {"last_update", "start_time", "created", "updated"}


def _db(module, tmp_path, name="db.sqlite"):
    return module.SQLiteRunDB(str(tmp_path / name),
                              logs_dir=str(tmp_path / "logs"))


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "<t>" if k in VOLATILE else _mask(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_mask(v) for v in obj]
    return obj


def _error(call) -> str:
    try:
        call()
    except Exception as exc:  # noqa: BLE001 - the error itself is compared
        return f"{type(exc).__name__}: {exc}"
    return "no error"


def _write(db) -> list:
    """Every table's writes, with what each call returns."""
    out = []
    for i, state in enumerate(["completed", "error", "running"]):
        db.store_run({"kind": "run", "metadata": {
            "name": f"train-{i}", "uid": f"u{i}", "project": "p1",
            "labels": {"kind": "job", "i": str(i)}},
            "spec": {"parameters": {"lr": 0.1 * (i + 1)}},
            "status": {"state": state,
                       "start_time": f"2026-01-0{i + 1}T00:00:00+00:00"}},
            f"u{i}", "p1")
    for it in (1, 2):
        db.store_run({"metadata": {"name": "train-0", "uid": "u0",
                                   "iteration": it},
                      "status": {"state": "completed",
                                 "results": {"loss": 1.0 / it}}},
                     "u0", "p1", iter=it)
    out.append(db.update_run({"status.results.loss": 0.25,
                              "status.state": "completed"}, "u0", "p1"))
    for uid, spec in (("a1", {"v": 1}), ("a2", {"v": 2})):
        db.store_artifact("model", {"kind": "model", "metadata": {
            "key": "model", "tree": "u0", "iter": 0}, "spec": spec},
            uid=uid, tag="latest", project="p1", tree="u0")
    db.store_artifact("data", {"kind": "dataset", "metadata": {
        "key": "data", "labels": {"split": "train"}}}, uid="d1", iter=2,
        project="p1", tree="u0")
    out.append(db.tag_artifacts("p1", "prod", [{"key": "model",
                                                "uid": "a1"}]))
    out.append(db.store_function({"kind": "job", "metadata": {
        "name": "f", "labels": {"team": "a"}}, "spec": {"image": "i:1"}},
        "f", "p1", tag="v1", versioned=True))
    db.store_log("u0", "p1", b"hello ")
    db.store_log("u0", "p1", "world")
    db.store_project("p1", {"metadata": {"name": "p1",
                                         "created": "2026-01-01"},
                            "spec": {"description": "d"}})
    db.store_schedule("p1", "nightly", {"kind": "job",
                                        "cron_trigger": "0 1 * * *"})
    db.store_feature_set({"metadata": {"name": "fs"}}, project="p1",
                         uid="fs1")
    db.store_feature_vector({"metadata": {"name": "fv"}}, project="p1",
                            uid="fv1")
    db.store_model_endpoint("p1", "ep1", {"model_uri": "store://m",
                                          "function_uri": "p1/f"})
    db.store_background_task("bt", "running", "p1", body={"kind": "build"})
    db.store_alert_config("a", {"name": "a", "trigger_events": ["x"]}, "p1")
    db.emit_event("x", {"entity_id": "e", "n": 1}, "p1")
    db.store_hub_source("default", {"url": "http://hub"})
    db.store_hub_source("extra", {"url": "http://other"})
    db.store_runtime_resource("u0", "p1", "tpujob", "jobset/x", 12.5, "t")
    db.store_project_secrets("p1", {"K": "v"})
    db.store_datastore_profile({"name": "prof", "type": "s3",
                                "fields": {"bucket": "b"}}, "p1",
                               private={"secret_key": "s"})
    return out


def _read(db) -> list:
    """Every table's reads (the runs, artifacts, functions, logs, alert
    configs and events a db file holds, among the rest)."""
    out = [db.schema_version, db.read_run("u0", "p1"),
           db.read_run("u0", "p1", iter=2)]
    out += [db.list_runs(project="p1", **kw) for kw in (
        {}, {"state": "completed"}, {"labels": {"kind": "job"}},
        {"labels": ["i=2"]}, {"iter": True}, {"name": "train-1"},
        {"uid": ["u1", "u2"]}, {"last": 1},
        {"start_time_from": "2026-01-02"})]
    out += [db.read_artifact("model", project="p1"),
            db.read_artifact("model", tag="prod", project="p1"),
            db.read_artifact("model", uid="a1", project="p1"),
            db.read_artifact("data", iter=2, project="p1"),
            db.read_artifact("model", tree="u0", project="p1"),
            db.list_artifacts(project="p1"),
            db.list_artifacts(project="p1", tag="prod"),
            db.list_artifacts(project="p1", kind="dataset"),
            db.list_artifacts(project="p1", labels={"split": "train"})]
    hash_key = db.get_function("f", "p1", tag="v1")["metadata"]["hash"]
    out += [hash_key, db.get_function("f", "p1", hash_key=hash_key),
            db.list_functions(project="p1", labels={"team": "a"}),
            db.get_log("u0", "p1"), db.get_log("u0", "p1", offset=6),
            db.get_log("u0", "p1", offset=2, size=3),
            db.get_log_size("u0", "p1"),
            db.get_project("p1"), db.list_projects(),
            db.get_schedule("p1", "nightly"), db.list_schedules("p1"),
            db.get_feature_set("fs", "p1"), db.list_feature_vectors("p1"),
            db.get_model_endpoint("p1", "ep1"),
            db.list_model_endpoints("p1", model="store"),
            db.get_background_task("bt", "p1"),
            db.list_background_tasks("p1"),
            db.get_alert_config("a", "p1"), db.list_alert_configs("p1"),
            db.list_events("p1", kind="x"), db.list_hub_sources(),
            db.get_hub_source("extra"), db.list_runtime_resources("tpujob"),
            db.list_project_secret_keys("p1"),
            db.get_project_secrets("p1"),
            db.get_datastore_profile("prof", "p1"),
            db.list_datastore_profiles("p1")]
    out += [_error(lambda: db.read_artifact("nope", project="p1")),
            _error(lambda: db.get_function("nope", "p1")),
            _error(lambda: db.get_alert_config("nope", "p1")),
            _error(lambda: db.update_run({"a": 1}, "nope", "p1"))]
    return out


def _mutate(db) -> list:
    """Deletes, untagging and paging after the reads."""
    out = [db.untag_artifacts("p1", "prod", [{"key": "model"}])]
    page, token = db.paginated_list("list_runs", page_size=2, project="p1")
    out.append((page, bool(token)))
    page, token = db.paginated_list("list_runs", page_size=2,
                                    page_token=token)
    out.append((page, token))
    db.del_artifact("model", uid="a2", project="p1")
    out.append(db.read_artifact("model", uid="a1", project="p1"))
    db.del_run("u2", "p1")
    db.delete_function("f", "p1")
    db.delete_schedule("p1", "nightly")
    db.delete_hub_source("default")
    db.del_runtime_resource("u0", "p1")
    db.delete_datastore_profile("prof", "p1")
    db.abort_run("u1", "p1", status_text="stop")
    out += [db.list_runs(project="p1", iter=True), db.list_functions(
        project="p1"), db.list_hub_sources(), db.list_runtime_resources(),
        db.list_project_secret_keys("p1"),
        _error(lambda: db.delete_project("p1"))]
    db.delete_project("p1", deletion_strategy="cascade")
    out += [db.get_project("p1"), db.list_runs(project="p1"),
            db.list_artifacts(project="p1")]
    return out


def test_same_operations_give_equal_answers(tmp_path):
    got = {}
    for name, module in PKGS.items():
        (tmp_path / name).mkdir()
        db = _db(module, tmp_path / name)
        got[name] = _mask([_write(db), _read(db), _mutate(db)])
    assert got["port"] == got["jax"]
    reads = got["port"][1]
    assert reads[0] == jsqlite.SCHEMA_VERSION == tsqlite.SCHEMA_VERSION
    assert reads[1]["status"]["results"]["loss"] == 0.25


def _schema(path) -> list:
    conn = sqlite3.connect(path)
    try:
        rows = conn.execute("SELECT type, name, tbl_name, sql FROM "
                            "sqlite_master ORDER BY type, name").fetchall()
        return rows + [conn.execute("PRAGMA user_version").fetchone()]
    finally:
        conn.close()


def test_schemas_are_identical(tmp_path):
    for name, module in PKGS.items():
        _db(module, tmp_path, f"{name}.sqlite")
    jax_schema = _schema(str(tmp_path / "jax.sqlite"))
    assert _schema(str(tmp_path / "port.sqlite")) == jax_schema
    assert len(jax_schema) > 20
    assert tsqlite._SCHEMA == jsqlite._SCHEMA
    assert tsqlite._MIGRATIONS == jsqlite._MIGRATIONS


@pytest.mark.parametrize("writer", list(PKGS))
def test_a_db_file_reads_the_same_in_the_other_package(writer, tmp_path):
    """A file one package writes (every table) reads the same through both
    packages, and a write through the reader lands where the writer sees
    it."""
    _write(_db(PKGS[writer], tmp_path))
    reader = "port" if writer == "jax" else "jax"
    by_writer = _mask(_read(_db(PKGS[writer], tmp_path)))
    by_reader = _mask(_read(_db(PKGS[reader], tmp_path)))
    assert by_reader == by_writer
    _db(PKGS[reader], tmp_path).update_run({"status.state": "aborted"},
                                           "u1", "p1")
    assert _db(PKGS[writer], tmp_path).read_run("u1", "p1")["status"][
        "state"] == "aborted"


# -- tests/test_sqlitedb.py's contracts, on both packages ---------------------

@pytest.fixture(params=list(PKGS))
def db(request, tmp_path):
    return _db(PKGS[request.param], tmp_path)


def test_run_crud(db):
    run = {"metadata": {"name": "r1", "uid": "u1"},
           "status": {"state": "running"}}
    db.store_run(run, "u1", "p1")
    assert db.read_run("u1", "p1")["metadata"]["name"] == "r1"
    db.update_run({"status.state": "completed"}, "u1", "p1")
    assert db.read_run("u1", "p1")["status"]["state"] == "completed"
    assert len(db.list_runs(project="p1")) == 1
    db.del_run("u1", "p1")
    assert db.read_run("u1", "p1") is None


def test_artifact_tagging_and_logs(db):
    db.store_artifact("m", {"kind": "model", "metadata": {"key": "m"}},
                      uid="v1", tag="latest", project="p1")
    db.store_artifact("m", {"kind": "model", "metadata": {"key": "m"},
                            "spec": {"v": 2}}, uid="v2", tag="latest",
                      project="p1")
    assert db.read_artifact("m", tag="latest",
                            project="p1")["metadata"]["uid"] == "v2"
    assert db.read_artifact("m", uid="v1",
                            project="p1")["metadata"]["uid"] == "v1"
    db.store_run({"metadata": {"uid": "u9"},
                  "status": {"state": "completed"}}, "u9", "p1")
    db.store_log("u9", "p1", b"hello ")
    db.store_log("u9", "p1", b"world")
    assert db.get_log("u9", "p1") == ("completed", b"hello world")
    assert db.get_log("u9", "p1", offset=6)[1] == b"world"


def test_function_versioning_and_project_cascade(db):
    h1 = db.store_function({"kind": "job", "metadata": {"name": "f"}},
                           "f", "p1", versioned=True)
    assert db.get_function("f", "p1", hash_key=h1)["metadata"]["name"] == "f"
    db.store_project("p2", {"metadata": {"name": "p2"}})
    db.store_run({"metadata": {"uid": "u"}}, "u", "p2")
    with pytest.raises(Exception, match="has runs") as err:
        db.delete_project("p2", deletion_strategy="restricted")
    assert type(err.value).__name__ == "RunDBError"
    db.delete_project("p2", deletion_strategy="cascade")
    assert db.get_project("p2") is None


# -- get_run_db --------------------------------------------------------------

def test_get_run_db_opens_sqlite_and_refuses_what_is_left(tmp_path,
                                                         monkeypatch):
    """``get_run_db`` opens the sqlite file a ``*.sqlite`` dbpath names
    (else the one under MLT_HOME) and ``NopDB`` for "nop"; an ``http(s)``
    url opens the service's client (``HTTPRunDB``, whose connect only warns
    when no service answers) and a server SQL DSN ``SQLServerRunDB``, whose
    missing driver raises the reference's ``RunDBError`` — never a silent
    SQLite."""
    path = str(tmp_path / "runs.sqlite")
    monkeypatch.setenv("MLT_DBPATH", path)
    tdb_pkg.set_run_db(None)
    try:
        assert tdb_pkg.get_run_db().dsn == path
        assert isinstance(tdb_pkg.get_run_db("nop", force_reconnect=True),
                          tdb_pkg.NopDB)
        monkeypatch.delenv("MLT_DBPATH")
        home = tdb_pkg.get_run_db(force_reconnect=True).dsn
        assert home == str(tmp_path / "mlt-home" / "db.sqlite")
        assert jdb_pkg.get_run_db(force_reconnect=True).dsn == home
        import socket

        from mlrun_tpu_torch.db.httpdb import HTTPRunDB

        with socket.socket() as sock:  # a closed local port: refused
            sock.bind(("127.0.0.1", 0))
            closed = sock.getsockname()[1]
        monkeypatch.setenv("MLT_HTTPDB__RETRIES", "0")
        for url in (f"http://127.0.0.1:{closed}",
                    f"https://127.0.0.1:{closed}"):
            db = tdb_pkg.get_run_db(url, force_reconnect=True)
            assert isinstance(db, HTTPRunDB) and db.base_url == url
        for url, driver in (("postgresql://u:p@h/db", "psycopg2"),
                            ("mysql://u@h/db", "pymysql")):
            monkeypatch.setitem(sys.modules, driver, None)
            errors = []
            for pkg in (tdb_pkg, jdb_pkg):
                with pytest.raises(pkg.RunDBError,
                                   match=f"{driver} is not installed") as exc:
                    pkg.get_run_db(url, force_reconnect=True)
                errors.append(str(exc.value))
            assert errors[0] == errors[1]
    finally:
        tdb_pkg.set_run_db(None)
