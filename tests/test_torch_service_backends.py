"""The service's back ends and the CLI's service commands in
mlrun_tpu_torch against mlrun_tpu's (ROADMAP item 14b): ``SQLServerRunDB``
over ``tests/fake_pg.py`` (the bodies of ``tests/test_sqldb.py``), the
native log collector (the bodies of ``tests/test_log_collector.py``
against the port's g++ build of its own copy of the daemon,
``csrc/log_collector.cpp``), ``ProjectsFollower`` (the bodies of
``tests/test_projects_sync.py`` on each package's leader and follower
services), the requirements bootstrap overlay (a local package installed
offline, the flock released when its holder dies), and the CLI's ``db``
and ``bootstrap`` commands as child processes.

Every daemon and service binds an ephemeral ``127.0.0.1`` port; nothing
leaves localhost, and every child is stopped.
"""

import os
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import requests

import mlrun_tpu.db as jdb
import mlrun_tpu_torch.db as tdb
from mlrun_tpu.db import sqldb as jsqldb
from mlrun_tpu.db import sqlitedb as jsqlitedb
from mlrun_tpu.utils import bootstrap as jbootstrap
from mlrun_tpu.utils import log_collector as jlog_collector
from mlrun_tpu_torch.db import sqldb as tsqldb
from mlrun_tpu_torch.db import sqlitedb as tsqlitedb
from mlrun_tpu_torch.utils import bootstrap as tbootstrap
from mlrun_tpu_torch.utils import log_collector as tlog_collector

from . import fake_pg
from tests.torch_service import PKGS as SERVICE_PKGS
from tests.torch_service import Service, free_port

ROOT = Path(__file__).resolve().parents[1]
PKGS = {
    "jax": types.SimpleNamespace(name="jax", db=jdb, sqldb=jsqldb,
                                 sqlitedb=jsqlitedb, bootstrap=jbootstrap,
                                 log_collector=jlog_collector),
    "port": types.SimpleNamespace(name="port", db=tdb, sqldb=tsqldb,
                                  sqlitedb=tsqlitedb, bootstrap=tbootstrap,
                                  log_collector=tlog_collector),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- SQLServerRunDB (tests/test_sqldb.py) --------------------------------------

@pytest.fixture()
def pg_db(pkg, tmp_path, monkeypatch):
    fake_pg.install(monkeypatch, tmp_path)
    return pkg.sqldb.SQLServerRunDB("postgresql://svc:pw@dbhost:5499/mlt",
                                    logs_dir=str(tmp_path / "logs"))


def test_dsn_parsing_and_driver_args(pg_db):
    calls = sys.modules["psycopg2"]._calls
    assert calls[0] == {"host": "dbhost", "port": 5499, "user": "svc",
                        "dbname": "mlt"}


def test_unsupported_scheme_and_missing_driver(pkg, monkeypatch):
    with pytest.raises(pkg.db.RunDBError, match="scheme"):
        pkg.sqldb.SQLServerRunDB("oracle://h/db")
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    with pytest.raises(pkg.db.RunDBError, match="psycopg2"):
        pkg.sqldb.SQLServerRunDB("postgresql://h/db")


@pytest.mark.parametrize("sql", [
    "INSERT OR REPLACE INTO functions (project, name, tag, hash_key, "
    "updated, body) VALUES (?,?,?,?,?,?)",
    "INSERT OR REPLACE INTO artifact_tags (project, key, tag) "
    "VALUES (?,?,?)",
    "SELECT body FROM runs WHERE project=? AND uid=?",
])
def test_postgres_and_mysql_translation_match(sql, tmp_path, monkeypatch):
    """The dialect translation and the parsed primary keys are the
    reference's, statement for statement."""
    fake_pg.install(monkeypatch, tmp_path)
    out = []
    for p in PKGS.values():
        pg = p.sqldb.SQLServerRunDB("postgresql://u@h/tr",
                                    logs_dir=str(tmp_path))
        with monkeypatch.context() as patch:
            patch.setattr(p.sqldb.SQLServerRunDB, "_init_schema",
                          lambda self: None)
            my = p.sqldb.SQLServerRunDB("mysql://u:p@h/mlt")
        out.append([pg._translate(sql), my._translate(sql),
                    my._translate_ddl(
                        "CREATE TABLE IF NOT EXISTS events (id INTEGER "
                        "PRIMARY KEY AUTOINCREMENT, project TEXT, "
                        "body TEXT)"),
                    p.sqldb._PRIMARY_KEYS])
    assert out[0] == out[1]
    assert "?" not in out[1][0] and "AUTO_INCREMENT" in out[1][2]
    assert out[1][3]["runs"] == ["project", "uid", "iteration"]


def test_postgres_upsert_translation(pg_db):
    sql = pg_db._translate(
        "INSERT OR REPLACE INTO functions (project, name, tag, hash_key, "
        "updated, body) VALUES (?,?,?,?,?,?)")
    assert sql.startswith("INSERT INTO functions")
    assert "ON CONFLICT (project, name, tag)" in sql
    assert "DO UPDATE SET hash_key=EXCLUDED.hash_key" in sql
    assert "?" not in sql and sql.count("%s") == 6
    assert "DO NOTHING" in pg_db._translate(
        "INSERT OR REPLACE INTO artifact_tags (project, key, tag) "
        "VALUES (?,?,?)")


def test_run_db_surface_over_the_fake_server(pg_db):
    """Runs, logs, artifacts, projects and secrets through the postgres
    dialect (sqlite executes the generated statements for real)."""
    pg_db.store_run({"metadata": {"name": "r", "uid": "u1",
                                  "project": "p"},
                     "status": {"state": "running"}}, "u1", "p")
    pg_db.update_run({"status.state": "completed"}, "u1", "p")
    pg_db.store_run({"metadata": {"name": "r", "uid": "u1",
                                  "project": "p"},
                     "status": {"state": "completed"}}, "u1", "p")
    assert pg_db.read_run("u1", "p")["status"]["state"] == "completed"
    assert len(pg_db.list_runs(project="p")) == 1
    pg_db.store_log("u1", "p", b"hi ")
    pg_db.store_log("u1", "p", b"there")
    assert pg_db.get_log("u1", "p") == ("completed", b"hi there")
    pg_db.store_artifact("a", {"kind": "model", "metadata": {"key": "a"}},
                         uid="v1", project="p")
    assert pg_db.read_artifact("a", project="p")["metadata"]["uid"] == "v1"
    pg_db.store_project("p", {"metadata": {"name": "p"}})
    assert pg_db.get_project("p")["metadata"]["name"] == "p"
    pg_db.store_project_secrets("p", {"K": "v"})
    assert pg_db.get_project_secrets("p") == {"K": "v"}


def test_migrations_ride_schema_version_table(pkg, tmp_path, monkeypatch):
    fake_pg.install(monkeypatch, tmp_path)
    version = pkg.sqlitedb.SCHEMA_VERSION
    db = pkg.sqldb.SQLServerRunDB("postgresql://u@h/mig",
                                  logs_dir=str(tmp_path))
    assert db.schema_version == version
    cur = db._conn.cursor()
    cur.execute("UPDATE schema_version SET version=%s", (version - 1,))
    db._conn.commit()
    monkeypatch.setitem(
        pkg.sqlitedb._MIGRATIONS, version,
        "CREATE TABLE IF NOT EXISTS migration_probe (x INTEGER);")
    db2 = pkg.sqldb.SQLServerRunDB("postgresql://u@h/mig",
                                   logs_dir=str(tmp_path))
    assert db2.schema_version == version
    db2._conn.cursor().execute("SELECT * FROM migration_probe")
    cur.execute("UPDATE schema_version SET version=%s", (version + 5,))
    db._conn.commit()
    with pytest.raises(pkg.db.RunDBError, match="newer"):
        pkg.sqldb.SQLServerRunDB("postgresql://u@h/mig",
                                 logs_dir=str(tmp_path))


def test_service_and_get_run_db_use_the_sql_dsn(pkg, tmp_path,
                                                 monkeypatch):
    """``httpdb.dsn`` puts the whole service on the shared SQL store (a
    second replica reads the first's rows); ``get_run_db`` dispatches a
    ``postgresql://`` url to ``SQLServerRunDB``."""
    fake_pg.install(monkeypatch, tmp_path)
    dsn = "postgresql://svc@dbhost/shared"
    if pkg.name == "jax":
        from mlrun_tpu.config import mlconf

        monkeypatch.setattr(mlconf.httpdb, "dsn", dsn)
    else:
        monkeypatch.setenv("MLT_HTTPDB__DSN", dsn)
    app = SERVICE_PKGS[pkg.name].app
    state = app.ServiceState()
    assert type(state.db).__name__ == "SQLServerRunDB"
    state.db.store_run({"metadata": {"name": "r", "uid": "sqldsn0001",
                                     "project": "p"},
                        "status": {"state": "completed"}},
                       "sqldsn0001", "p")
    assert app.ServiceState().db.read_run("sqldsn0001", "p")[
        "status"]["state"] == "completed"
    pkg.db.set_run_db(None)
    try:
        db = pkg.db.get_run_db("postgresql://u@h/viaurl",
                               force_reconnect=True)
        assert type(db).__name__ == "SQLServerRunDB"
    finally:
        pkg.db.set_run_db(None)


def test_mysql_create_index_failure_handling(pkg, monkeypatch):
    monkeypatch.setattr(pkg.sqldb.SQLServerRunDB, "_init_schema",
                        lambda self: None)
    db = pkg.sqldb.SQLServerRunDB("mysql://u:p@h/mlt")

    class DriverError(Exception):
        pass

    class Cur:
        def __init__(self, exc):
            self.exc = exc

        def execute(self, sql):
            raise self.exc

    db._execute_ddl(Cur(DriverError(1061, "Duplicate key name 'ix'")),
                    "CREATE INDEX ix_runs ON runs(uid)")
    db._execute_ddl(Cur(DriverError(1071, "Specified key was too long")),
                    "CREATE INDEX ix_big ON runs(body)")
    with pytest.raises(DriverError):
        db._execute_ddl(Cur(DriverError(1064, "syntax error")),
                        "CREATE TABLE broken (x TEXT)")
    pg = pkg.sqldb.SQLServerRunDB("postgresql://u@h/mlt")
    with pytest.raises(DriverError):
        pg._execute_ddl(Cur(DriverError("boom")),
                        "CREATE INDEX ix ON runs(uid)")


# -- the native log collector (tests/test_log_collector.py) --------------------

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ not available")


def test_the_daemon_source_is_the_references():
    """The port builds its own copy of the daemon, byte for byte the
    reference's source, into the git-ignored host build root."""
    port_source = ROOT / "mlrun_tpu_torch" / "csrc" / "log_collector.cpp"
    assert port_source.read_bytes() == (
        ROOT / "native" / "log_collector.cpp").read_bytes()
    assert "build" in Path(tlog_collector.binary_path()).parts


def _start_daemon(store: Path, *extra) -> tuple:
    """The port's daemon on a free port: (process, port)."""
    assert tlog_collector.build_binary(), "mlt-logd build failed"
    port = free_port()
    proc = subprocess.Popen(
        [tlog_collector.binary_path(), "--port", str(port), "--store-dir",
         str(store), *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, port


def _ping(client, proc):
    for _ in range(100):
        if client.ping():
            return
        time.sleep(0.05)
    proc.kill()
    pytest.fail("daemon did not start")


def _until(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


@pytest.fixture()
def daemon(pkg, tmp_path):
    """The port's daemon, driven by ``pkg``'s client."""
    proc, port = _start_daemon(tmp_path / "store")
    client = pkg.log_collector.LogCollectorClient(f"127.0.0.1:{port}")
    _ping(client, proc)
    yield client, proc, tmp_path
    proc.kill()
    proc.wait()


@needs_gxx
def test_append_get_size(daemon):
    client, _, _ = daemon
    client.append("p1", "r1", b"alpha ")
    client.append("p1", "r1", b"beta")
    assert client.get_log("p1", "r1") == b"alpha beta"
    assert client.get_log("p1", "r1", offset=6) == b"beta"
    assert client.get_log("p1", "r1", offset=0, size=5) == b"alpha"
    assert client.get_log_size("p1", "r1") == 10


@needs_gxx
def test_tail_source_file(daemon):
    client, _, tmp_path = daemon
    src = tmp_path / "pod.log"
    src.write_text("first\n")
    client.start_log("p1", "r2", str(src))
    assert _until(lambda: client.get_log("p1", "r2") == b"first\n")
    with open(src, "a") as fp:
        fp.write("second\n")
    assert _until(lambda: client.get_log("p1", "r2") == b"first\nsecond\n")
    assert "p1/r2" in client.list_in_progress()
    client.stop_log("p1", "r2")
    assert "p1/r2" not in client.list_in_progress()


@needs_gxx
def test_restart_resumes_collection(pkg, daemon):
    client, proc, tmp_path = daemon
    src = tmp_path / "resume.log"
    src.write_text("before\n")
    client.start_log("p1", "r3", str(src))
    assert _until(lambda: client.get_log("p1", "r3") == b"before\n")
    proc.kill()
    proc.wait()
    proc2, port = _start_daemon(tmp_path / "store")
    client2 = pkg.log_collector.LogCollectorClient(f"127.0.0.1:{port}")
    try:
        _ping(client2, proc2)
        with open(src, "a") as fp:
            fp.write("after\n")
        assert _until(lambda: b"after" in client2.get_log("p1", "r3"))
        assert client2.get_log("p1", "r3") == b"before\nafter\n"
    finally:
        proc2.kill()
        proc2.wait()


@needs_gxx
def test_bad_input_rejected(daemon):
    client, _, _ = daemon
    with pytest.raises(RuntimeError, match="ERR"):
        client._command("START ../evil up /etc/passwd")
    with pytest.raises(RuntimeError, match="ERR"):
        client._command("BOGUS")


@needs_gxx
def test_db_routes_through_collector(pkg, daemon, tmp_path, monkeypatch):
    """A package's SQLite run db stores and reads logs through the daemon
    when MLT_LOG_COLLECTOR names it, leaving its log files untouched."""
    client, _, _ = daemon
    monkeypatch.setenv("MLT_LOG_COLLECTOR", f"{client.host}:{client.port}")
    db = pkg.sqlitedb.SQLiteRunDB(str(tmp_path / "db.sqlite"),
                                  logs_dir=str(tmp_path / "logs"))
    db.store_run({"metadata": {"uid": "u1"},
                  "status": {"state": "completed"}}, "u1", "p9")
    db.store_log("u1", "p9", b"via collector")
    assert db.get_log("u1", "p9") == ("completed", b"via collector")
    assert db.get_log_size("u1", "p9") == len(b"via collector")
    assert not os.path.exists(os.path.join(str(tmp_path / "logs"), "p9"))


@needs_gxx
def test_command_streaming_and_stop(pkg, tmp_path):
    """STARTCMD streams a command's stdout into the store (token-gated),
    an exited command leaves LIST, and STOP kills a quiet one."""
    proc, port = _start_daemon(tmp_path, "--cmd-token", "tok123")
    client = pkg.log_collector.LogCollectorClient(f"127.0.0.1:{port}")
    pidfile = tmp_path / "pid"
    try:
        _ping(client, proc)
        client.start_command("p", "cmdrun",
                             "printf 'line-one\\nline-two\\n'; sleep 0.2",
                             token="tok123")
        assert _until(lambda: b"line-two" in client.get_log("p", "cmdrun"))
        assert client.get_log("p", "cmdrun") == b"line-one\nline-two\n"
        assert _until(lambda: client.list_in_progress() == [])
        with pytest.raises(RuntimeError):
            client.start_command("p", "u2", "echo nope", token="wrong")
        assert not (tmp_path / "p" / "u2").exists()
        client.start_command(
            "p", "quiet", f"echo $$ > {pidfile}; exec sleep 600",
            token="tok123")
        assert _until(lambda: pidfile.exists()
                      and pidfile.read_text().strip())
        child = int(pidfile.read_text().strip())
        client.stop_log("p", "quiet")

        def gone():
            try:
                os.kill(child, 0)
            except OSError:
                return True
            return False

        assert _until(gone), f"streamed child {child} still alive"
    finally:
        proc.terminate()
        proc.wait()


@needs_gxx
def test_command_streaming_needs_a_token_and_resumes(tmp_path):
    """Without ``--cmd-token`` STARTCMD is refused; with one, a restarted
    daemon re-launches its persisted command tailers."""
    proc, port = _start_daemon(tmp_path / "a")
    client = tlog_collector.LogCollectorClient(f"127.0.0.1:{port}")
    try:
        _ping(client, proc)
        with pytest.raises(RuntimeError, match="disabled"):
            client.start_command("p", "u", "echo nope")
    finally:
        proc.terminate()
        proc.wait()
    marker = tmp_path / "marker"
    store = tmp_path / "b"
    proc, port = _start_daemon(store, "--cmd-token", "tok123")
    client = tlog_collector.LogCollectorClient(f"127.0.0.1:{port}")
    try:
        _ping(client, proc)
        client.start_command("p", "resumer",
                             f"touch {marker}; echo started; sleep 30",
                             token="tok123")
        assert _until(marker.exists)
        proc.terminate()
        proc.wait(timeout=5)
        marker.unlink()
        proc = subprocess.Popen(
            [tlog_collector.binary_path(), "--port", str(port),
             "--store-dir", str(store), "--cmd-token", "tok123"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        _ping(client, proc)
        assert _until(marker.exists)
        assert "p/resumer" in client.list_in_progress()
        client.stop_log("p", "resumer")
    finally:
        proc.terminate()
        proc.wait()


# -- ProjectsFollower (tests/test_projects_sync.py) ----------------------------

@pytest.fixture()
def leader_and_follower(pkg, tmp_path, monkeypatch):
    """``pkg``'s leader service and a second service following it."""
    spkg = SERVICE_PKGS[pkg.name]
    leader = Service(spkg, tmp_path, monkeypatch)
    if pkg.name == "jax":
        from mlrun_tpu.config import mlconf

        mlconf.projects.leader_url = leader.url
        mlconf.projects.sync_interval = 0.2
    else:
        monkeypatch.setenv("MLT_PROJECTS__LEADER_URL", leader.url)
        monkeypatch.setenv("MLT_PROJECTS__SYNC_INTERVAL", "0.2")
    (tmp_path / "follower").mkdir()
    follower = Service(spkg, tmp_path / "follower", monkeypatch,
                       advertise=False)
    yield leader, follower
    follower.stop()
    leader.stop()


def test_follower_syncs_projects_from_leader(leader_and_follower):
    leader, follower = leader_and_follower
    assert follower.state.projects_follower.enabled
    leader.db.store_project("alpha", {"metadata": {"name": "alpha"},
                                      "spec": {"description": "lead"}})

    def names():
        return [p.get("metadata", {}).get("name") or p.get("name")
                for p in follower.db.list_projects()]

    assert _until(lambda: "alpha" in names(), timeout=15), names()
    leader.db.delete_project("alpha")

    def archived():
        project = follower.state.db.get_project("alpha")
        return bool(project) and project.get("status", {}).get(
            "state") == "archived"

    assert _until(archived, timeout=15)


def test_follower_forwards_mutations_to_leader(leader_and_follower):
    leader, follower = leader_and_follower
    follower.db.store_project("beta", {"metadata": {"name": "beta"}})
    assert leader.state.db.get_project("beta") is not None
    assert follower.state.db.get_project("beta") is not None


def test_sync_once_counters_match(tmp_path, monkeypatch):
    """One reconciliation pass creates, updates and archives the same
    projects in both packages (each follower over the other package's
    leader: the REST contract is shared)."""
    from mlrun_tpu.service.projects_sync import ProjectsFollower as JF
    from mlrun_tpu_torch.service.projects_sync import ProjectsFollower as TF

    leaders = {name: Service(spkg, tmp_path, monkeypatch)
               for name, spkg in SERVICE_PKGS.items()}
    try:
        out = []
        for follower_cls, leader_name, sqlite in (
                (TF, "jax", tsqlitedb), (JF, "port", jsqlitedb)):
            leader = leaders[leader_name]
            leader.db.store_project("a", {"metadata": {"name": "a"}})
            leader.db.store_project("b", {"metadata": {"name": "b"},
                                          "spec": {"v": 1}})
            local = sqlite.SQLiteRunDB(
                str(tmp_path / f"f-{leader_name}.sqlite"))
            local.store_project("b", {"metadata": {"name": "b"}})
            local.store_project("gone", {"metadata": {"name": "gone"}})
            follower = follower_cls(local, leader_url=leader.url)
            out.append([follower.sync_once(), follower.sync_once(),
                        local.get_project("gone")["status"]["state"]])
        assert out[0] == out[1] == [
            {"created": 1, "updated": 1, "archived": 1},
            {"created": 0, "updated": 0, "archived": 0}, "archived"]
    finally:
        for svc in leaders.values():
            svc.stop()


# -- the requirements bootstrap overlay ----------------------------------------

OFFLINE_FLAGS = ["--no-index", "--no-build-isolation"]


def _local_pkg(tmp_path, name="mltdemo", value=3):
    src = tmp_path / f"pkg-{name}"
    src.mkdir(exist_ok=True)
    (src / "setup.py").write_text(
        "from setuptools import setup\n"
        f"setup(name='{name}', version='0.1', py_modules=['{name}'])\n")
    (src / f"{name}.py").write_text(
        f"def triple(x):\n    return x * {value}\n")
    return src


def test_overlay_cache_and_hash(tmp_path):
    """A local package installed offline into the cached overlay; the key
    is the reference's, and a second call is a cache hit."""
    reqs = OFFLINE_FLAGS + [str(_local_pkg(tmp_path))]
    assert tbootstrap.requirements_hash(reqs) == \
        jbootstrap.requirements_hash(list(reversed(reqs)))
    root = tmp_path / "overlays"
    overlay = tbootstrap.ensure_overlay(reqs, overlay_root=str(root))
    assert Path(overlay) == root / tbootstrap.requirements_hash(reqs)
    assert (Path(overlay) / ".ready").exists()
    assert tbootstrap.ensure_overlay(reqs, overlay_root=str(root)) == overlay
    out = subprocess.run(
        [sys.executable, "-c", "import mltdemo; print(mltdemo.triple(2))"],
        env={"PYTHONPATH": overlay, "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "6"


def test_overlay_lock_released_on_owner_death(tmp_path, monkeypatch):
    """The overlay lock is flock(2): a waiter times out while the holder
    lives and takes over the instant it is SIGKILLed (pip stubbed)."""
    reqs = ["stub-requirement"]
    root = tmp_path / "overlays"
    root.mkdir()
    lockfile = root / (tbootstrap.requirements_hash(reqs) + ".lock")
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import fcntl, os, time\n"
         f"fd = os.open({str(lockfile)!r}, os.O_CREAT | os.O_RDWR)\n"
         "fcntl.flock(fd, fcntl.LOCK_EX)\n"
         "print('locked', flush=True)\n"
         "time.sleep(120)\n"],
        stdout=subprocess.PIPE, text=True)
    installs = []

    class StubPip:
        def __init__(self, cmd, **kwargs):
            installs.append(cmd)
            os.makedirs(cmd[cmd.index("--target") + 1], exist_ok=True)
            self.stdout = iter(["installed\n"])

        def wait(self):
            return 0

    monkeypatch.setattr(tbootstrap.subprocess, "Popen", StubPip)
    try:
        assert holder.stdout.readline().strip() == "locked"
        with pytest.raises(TimeoutError):
            tbootstrap.ensure_overlay(reqs, overlay_root=str(root),
                                      timeout=0.5)
    finally:
        holder.send_signal(signal.SIGKILL)
        holder.wait()
    overlay = tbootstrap.ensure_overlay(reqs, overlay_root=str(root),
                                        timeout=30)
    assert (Path(overlay) / ".ready").exists()
    assert installs[0][:4] == [sys.executable, "-m", "pip", "install"]
    assert installs[0][-1] == "stub-requirement"


def test_exec_with_requirements_rewrites_the_cli(pkg, tmp_path,
                                                 monkeypatch):
    """The in-pod bootstrap execs its command with the overlay first on
    PYTHONPATH; the package's own CLI name runs as this interpreter's
    module (the port's for the port)."""
    reqs = ["cached"]
    root = tmp_path / "overlays"
    ready = root / pkg.bootstrap.requirements_hash(reqs)
    ready.mkdir(parents=True)
    (ready / ".ready").write_text("cached\n")
    calls = []
    monkeypatch.setattr(pkg.bootstrap.os, "execvpe",
                        lambda file, argv, env: calls.append((argv, env)))
    for command in (["mlrun-tpu", "run", "--from-env"],
                    ["python3", "job.py"]):
        pkg.bootstrap.exec_with_requirements(reqs, command,
                                             overlay_root=str(root))
    module = "mlrun_tpu" if pkg.name == "jax" else "mlrun_tpu_torch"
    assert calls[0][0] == [sys.executable, "-m", module, "run",
                           "--from-env"]
    assert calls[1][0] == [sys.executable, "job.py"]
    assert calls[0][1]["PYTHONPATH"].split(os.pathsep)[0] == str(ready)


# -- the CLI's db and bootstrap commands ---------------------------------------

def _cli_env(tmp_path) -> dict:
    env = dict(os.environ, MLT_HOME=str(tmp_path / "home"),
               PYTHONPATH=str(ROOT))
    env.pop("MLT_DBPATH", None)
    return env


@pytest.mark.parametrize("argv", [["mlrun_tpu_torch", "db"],
                                  ["mlrun_tpu_torch.service"]],
                         ids=["cli-db", "service-module"])
def test_db_command_serves_the_api(argv, tmp_path):
    """``python3 -m mlrun_tpu_torch db --port P`` (and ``python3 -m
    mlrun_tpu_torch.service``) serve the API on P over a SQLite db under
    MLT_HOME, and the port's client drives it."""
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", *argv, "--port", str(port),
         "--host", "127.0.0.1"], cwd=str(tmp_path), env=_cli_env(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        def healthy():
            try:
                return requests.get(f"{url}/api/v1/healthz",
                                    timeout=1).status_code == 200
            except requests.RequestException:
                return proc.poll() is not None
        assert _until(healthy, timeout=60) and proc.poll() is None, \
            proc.stderr.read().decode()[-2000:] if proc.poll() else ""
        db = tdb.httpdb.HTTPRunDB(url).connect()
        db.store_project("cli", {"metadata": {"name": "cli"}})
        assert [p["metadata"]["name"] for p in db.list_projects()] == ["cli"]
        assert (tmp_path / "home" / "db.sqlite").exists()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_bootstrap_command_execs_under_the_overlay(tmp_path):
    """``python3 -m mlrun_tpu_torch bootstrap -r <req> -- <cmd>`` execs the
    command with the cached overlay on PYTHONPATH (the overlay is ready,
    so nothing is installed)."""
    reqs = ["mltcached"]
    root = tmp_path / "overlays"
    overlay = root / tbootstrap.requirements_hash(reqs)
    overlay.mkdir(parents=True)
    (overlay / ".ready").write_text("mltcached\n")
    (overlay / "mltcached.py").write_text("VALUE = 41\n")
    out = subprocess.run(
        [sys.executable, "-m", "mlrun_tpu_torch", "bootstrap", "-r",
         "mltcached", "--overlay-root", str(root), "--", "python3", "-c",
         "import mltcached; print(mltcached.VALUE + 1)"],
        cwd=str(tmp_path), env=_cli_env(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "42"


# -- what is left of item 14 ----------------------------------------------------

FOURTEEN_B = ["mlrun_tpu_torch/__main__.py",
              "mlrun_tpu_torch/projects/pipelines.py",
              "mlrun_tpu_torch/utils/log_collector.py",
              "mlrun_tpu_torch/utils/bootstrap.py"] + sorted(
    str(p.relative_to(ROOT)) for folder in ("service", "db", "launcher")
    for p in (ROOT / "mlrun_tpu_torch" / folder).rglob("*.py"))


def test_no_14b_surface_raises_item_14_but_for_14c():
    """No ``not_ported(..., 14)`` is left on a 14b surface since part 14c
    landed (the builder, the deployments, the other runtimes), and the
    port queue's item 14 holds 14d alone."""
    import ast

    from mlrun_tpu_torch.serving.resilience import PORT_QUEUE

    left = []
    for path in FOURTEEN_B:
        tree = ast.parse((ROOT / path).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "not_ported" and len(
                    node.args) == 2 and getattr(node.args[1], "value",
                                                None) == 14:
                left.append((path, node.lineno, ast.unparse(node.args[0])))
    assert left == []
    assert set(PORT_QUEUE) == {14} and "14d" in PORT_QUEUE[14]
    assert "14c" not in PORT_QUEUE[14] and "14b" not in PORT_QUEUE[14]
