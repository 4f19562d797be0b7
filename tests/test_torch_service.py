"""mlrun_tpu_torch's service and its client (ROADMAP item 14b: the aiohttp
API server, the server-side launcher, the run monitor over the local
process provider, ``HTTPRunDB``, the remote launcher) against
mlrun_tpu's.

Each package runs its own service in a thread on an ephemeral localhost
port (``tests/torch_service.py``) over its own SQLite run db. The bodies
of ``tests/test_service.py``'s cases (all 22), the over-HTTP cases
of ``tests/test_secrets.py`` and ``tests/test_migrations_pagination.py``,
and the Grafana proxy cases run on both packages with the same inputs;
what each returns is compared modulo uids and timestamps. Cross-wired
cases drive each package's service with the other package's
``HTTPRunDB``: both packages share one SQLite schema and one REST
contract.

A submit that starts a child runs the package's own CLI (``python -m
mlrun_tpu`` / ``python -m mlrun_tpu_torch``; a port ``tpujob`` under
torchrun, one process on the CPU).
"""

import base64
import json
import time

import pytest
import requests

from tests.torch_registries import registries_left_as_found  # noqa: F401
from tests.torch_service import PKGS, Service, free_port

# keys that carry a uid, a hash or a clock reading
VOLATILE = {"uid", "hash", "hash_key", "updated", "created", "start_time",
            "last_update", "last_heartbeat", "time", "date", "started",
            "silence_until", "last_run_uri", "host"}


def _stable(obj):
    """``obj`` without its volatile keys, for comparing the packages."""
    if isinstance(obj, dict):
        return {k: _stable(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_stable(v) for v in obj]
    return obj


@pytest.fixture()
def services(tmp_path, monkeypatch):
    """Both packages' services, stopped afterwards."""
    running = {}
    try:
        for name, pkg in PKGS.items():
            running[name] = Service(pkg, tmp_path, monkeypatch)
        yield running
    finally:
        for svc in running.values():
            svc.stop()


def _both(services, scenario, *args):
    """Run ``scenario(pkg, svc, *args)`` on each package; returns
    {name: result}."""
    return {name: scenario(PKGS[name], svc, *args)
            for name, svc in services.items()}


def _alike(services, scenario, *args):
    out = _both(services, scenario, *args)
    assert _stable(out["port"]) == _stable(out["jax"])
    return out["port"]


def _wait_terminal(svc, uid, project, also=lambda run: True,
                   timeout=90.0):
    deadline = time.monotonic() + timeout
    run = None
    while time.monotonic() < deadline:
        svc.state.launcher.monitor_all()
        run = svc.db.read_run(uid, project)
        if run["status"]["state"] in ("completed", "error") and also(run):
            break
        time.sleep(0.2)
    return run


def _code(text: str) -> str:
    return base64.b64encode(text.encode()).decode()


# -- tests/test_service.py ----------------------------------------------------

def test_healthz_and_client_spec(services):
    def scenario(pkg, svc):
        spec = svc.db.api_call("GET", "client-spec")
        health = svc.db.api_call("GET", "healthz")
        return [bool(spec["version"]), health["status"],
                spec["namespace"], spec["default_project"],
                spec["config_overrides"]]

    assert _alike(services, scenario) == [True, "ok", "mlrun-tpu",
                                          "default", {}]
    spec = services["port"].db.api_call("GET", "client-spec")
    assert spec["gpu_defaults"]["gpu_product"] == "NVIDIA-H100-80GB-HBM3"


def test_run_crud_over_http(services):
    def scenario(pkg, svc):
        db = svc.db
        run = {"metadata": {"name": "r1", "uid": "u1", "project": "p1"},
               "status": {"state": "running"}}
        db.store_run(run, "u1", "p1")
        out = [db.read_run("u1", "p1")]
        db.update_run({"status.state": "completed"}, "u1", "p1")
        out.append(db.read_run("u1", "p1")["status"]["state"])
        out.append(len(db.list_runs(project="p1")))
        db.del_run("u1", "p1")
        with pytest.raises(pkg.base.RunDBError) as exc:
            db.read_run("u1", "p1")
        out.append("404" in str(exc.value))
        return out

    out = _alike(services, scenario)
    assert out[0]["metadata"]["name"] == "r1" and out[1:] == [
        "completed", 1, True]


def test_logs_over_http(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_run({"metadata": {"uid": "u2"},
                      "status": {"state": "completed"}}, "u2", "p1")
        db.store_log("u2", "p1", b"line one\n")
        db.store_log("u2", "p1", b"line two\n")
        state, data = db.get_log("u2", "p1")
        return [state, data, db.get_log_size("u2", "p1"),
                db.get_log("u2", "p1", offset=5, size=3)[1]]

    assert _alike(services, scenario) == [
        "completed", b"line one\nline two\n", 18, b"one"]


def test_artifact_and_function_roundtrip(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_artifact(
            "art1", {"kind": "model", "metadata": {"key": "art1"},
                     "spec": {"target_path": "/tmp/x"}}, project="p1",
            tag="latest")
        art = db.read_artifact("art1", project="p1")
        hash_key = db.store_function(
            {"kind": "job", "metadata": {"name": "f1"}}, "f1", "p1",
            versioned=True)
        func = db.get_function("f1", "p1", tag="latest")
        return [art, bool(hash_key), func["kind"],
                [f["metadata"]["name"] for f in db.list_functions(
                    project="p1")]]

    out = _alike(services, scenario)
    assert out[0]["spec"]["target_path"] == "/tmp/x"
    assert out[1:] == [True, "job", ["f1"]]


def test_project_lifecycle(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_project("projx", {"metadata": {"name": "projx"},
                                   "spec": {}})
        out = [db.get_project("projx")["metadata"]["name"],
               any(p["metadata"]["name"] == "projx"
                   for p in db.list_projects())]
        db.delete_project("projx")
        return out + [db.get_project("projx")]

    assert _alike(services, scenario) == ["projx", True, None]


def test_schedule_validation(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_schedule("p1", "s1", {"kind": "job",
                                       "cron_trigger": "*/10 * * * *"})
        out = [db.get_schedule("p1", "s1")["cron_trigger"]]
        with pytest.raises(pkg.base.RunDBError, match="bad cron") as exc:
            db.store_schedule("p1", "bad", {"cron_trigger": "not-cron"})
        return out + [str(exc.value).split("[400]: ")[-1]]

    out = _alike(services, scenario)
    assert out[0] == "*/10 * * * *" and "bad cron" in out[1]


def _submit_job(pkg, svc, monkeypatch, kind="job", spec=None,
                project="p1"):
    """``submit_job`` of a user handler doubling ``x``; returns the run
    once terminal and its log."""
    monkeypatch.setenv("MLT_DBPATH", svc.url)
    code = ("def handler(context, x: int = 1):\n"
            "    assert context.is_logging_worker()\n"
            "    context.log_result('doubled', x * 2)\n")
    function = {
        "kind": kind,
        "metadata": {"name": "subfn", "project": project, "tag": "latest"},
        "spec": {"image": "x", "default_handler": "handler",
                 "build": {"functionSourceCode": _code(code)},
                 **(spec or {})},
    }
    task = {"metadata": {"name": "subrun", "project": project},
            "spec": {"parameters": {"x": 21}, "handler": "handler"}}
    resp = svc.db.submit_job({"function": function, "task": task})
    uid = resp["data"]["metadata"]["uid"]
    run = _wait_terminal(svc, uid, project)
    return run, svc.db.get_log(uid, project)


def test_submit_job_executes(services, monkeypatch):
    """POST /submit_job -> a local-process resource running the package's
    own CLI -> the run completes with its results and its log."""
    def scenario(pkg, svc):
        run, (state, log) = _submit_job(pkg, svc, monkeypatch)
        return [run["status"]["state"], run["status"]["results"], state,
                b"completed" in log]

    assert _alike(services, scenario) == [
        "completed", {"doubled": 42}, "completed", True]


def test_submit_tpujob_executes(services, monkeypatch):
    """A ``tpujob`` submit -> the JobSet's own container command run as a
    child (the port: torchrun, one process, the rendezvous on localhost)
    -> the results land over HTTP."""
    specs = {"jax": {"accelerator_type": "tpu-v5-lite-podslice",
                     "topology": "2x2"},
             "port": {"nodes": 1, "gpus_per_node": 1}}

    def scenario(pkg, svc):
        run, (state, _) = _submit_job(pkg, svc, monkeypatch, kind="tpujob",
                                      spec=specs[pkg.name])
        return [run["status"]["state"], run["status"]["results"], state]

    assert _alike(services, scenario) == [
        "completed", {"doubled": 42}, "completed"]


def test_alert_firing(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_alert_config(
            "fail-alert", {
                "name": "fail-alert", "project": "p1",
                "summary": "too many failures",
                "trigger_events": ["run_failed"],
                "criteria": {"count": 2, "period_seconds": 3600},
                "notifications": [{"kind": "console"}],
            }, project="p1")
        states = []
        for _ in range(2):
            db.emit_event("run_failed", {"entity_id": "*"}, "p1")
            states.append(db.get_alert_config("fail-alert", "p1").get(
                "state", "inactive"))
        return states

    assert _alike(services, scenario) == ["inactive", "active"]


def test_alert_silence_endpoint(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_alert_config(
            "quiet-alert", {
                "name": "quiet-alert", "project": "p2",
                "trigger_events": ["run_failed"],
                "criteria": {"count": 1, "period_seconds": 3600},
                "notifications": [{"kind": "console"}],
            }, project="p2")
        silenced = db.silence_alert("quiet-alert", 15, project="p2")
        db.emit_event("run_failed", {"entity_id": "*"}, "p2")
        quiet = db.get_alert_config("quiet-alert", "p2").get(
            "state", "inactive")
        cleared = db.silence_alert("quiet-alert", 0, project="p2")
        db.emit_event("run_failed", {"entity_id": "*"}, "p2")
        return [bool(silenced["silence_until"]), quiet,
                cleared["silence_until"],
                db.get_alert_config("quiet-alert", "p2")["state"]]

    assert _alike(services, scenario) == [True, "inactive", "", "active"]


def test_background_task_listing(services):
    def scenario(pkg, svc):
        db = svc.db
        out = [db.list_background_tasks("p-bg")]
        svc.state.db.store_background_task("deploy-fn", "running",
                                           project="p-bg")
        svc.state.db.store_background_task("sync-proj", "succeeded",
                                           project="p-bg")
        out.append({t["name"]: t["state"]
                    for t in db.list_background_tasks("p-bg")})
        out.append(db.api_call(
            "GET", "projects/p-bg/background-tasks/deploy-fn",
            "get background task")["data"]["state"])
        with pytest.raises(pkg.base.RunDBError, match="404"):
            db.api_call("GET", "projects/p-bg/background-tasks/nope")
        return out

    assert _alike(services, scenario) == [
        [], {"deploy-fn": "running", "sync-proj": "succeeded"}, "running"]


@pytest.mark.parametrize("expr,when,matches", [
    ("*/5 * * * *", (2026, 7, 28, 10, 5), True),
    ("*/5 * * * *", (2026, 7, 28, 10, 7), False),
    ("30 3 * * 1-5", (2026, 7, 28, 3, 30), True),
    ("0,30 */2 1 * *", (2026, 7, 1, 4, 30), True),
])
def test_cron_parser(expr, when, matches):
    from datetime import datetime

    out = []
    for pkg in PKGS.values():
        cron = pkg.cron.CronSchedule(expr)
        nxt = cron.next_after(datetime(*when))
        out.append([cron.matches(datetime(*when)),
                    cron.min_interval_seconds(), nxt])
        with pytest.raises(ValueError):
            pkg.cron.CronSchedule("* * *")
    assert out[0] == out[1] and out[0][0] is matches


def test_api_gateway_roundtrip(services):
    """An api gateway with a canary, saved through each package's
    service, fetched and listed alike (api gateways are stored as
    ``api-gateway`` kind functions)."""
    from mlrun_tpu.runtimes.api_gateway import APIGateway as JGateway
    from mlrun_tpu_torch.runtimes.api_gateway import APIGateway as TGateway

    def scenario(pkg, svc):
        cls = JGateway if pkg.name == "jax" else TGateway
        gateway = cls("gw1", project="p1",
                      functions=["p1/srv-a:latest", "p1/srv-b:latest"])
        gateway.with_canary(["p1/srv-a:latest", "p1/srv-b:latest"],
                            [80, 20])
        gateway.save(db=svc.db)
        fetched = svc.db.api_call("GET", "projects/p1/api-gateways/gw1")
        listed = svc.db.api_call("GET", "projects/p1/api-gateways")
        picks = {gateway.pick_function() for _ in range(50)}
        return (fetched["data"]["spec"], len(listed["api_gateways"]),
                picks <= {"p1/srv-a:latest", "p1/srv-b:latest"})

    spec, listed, picks_ok = _alike(services, scenario)
    assert spec["canary"] == [80, 20] and listed == 1 and picks_ok


@pytest.mark.parametrize("route", [
    ("POST", "build/function", {"function": {"kind": "job"}}),
    ("GET", "build/status?name=f", None),
    ("POST", "projects/p1/functions/f/deploy",
     {"function": {"kind": "serving"}}),
    ("DELETE", "projects/p1/functions/f/deploy", None),
])
def test_the_builder_and_deployment_routes_answer_501(services, route):
    """The routes that reach the image builder or the deployment manager
    answer alike in both packages (none answers 501 any more): a build of
    a prebuilt image is ready at once, the status of an unknown function
    is 404 (the reference's run db error escapes as a 500 there), a
    serving function with no graph fails its deploy with the gateway's
    reason (400), and tearing down a function with no gateway removes
    nothing. Deploying a batch kind, which reaches neither, records it
    ready as the reference does."""
    method, path, body = route
    answers = {}
    for name, svc in services.items():
        resp = requests.request(method, f"{svc.url}/api/v1/{path}",
                                json=body, timeout=60)
        detail = resp.json().get("detail", "") if resp.headers.get(
            "Content-Type", "").startswith("application/json") else ""
        answers[name] = (resp.status_code, detail.split(":")[0],
                         "gateway did not become ready" in detail,
                         resp.json() if resp.ok else None)
    if path.startswith("build/status"):
        assert answers["jax"][0] == 500
    else:
        assert answers["port"] == answers["jax"]
    assert answers["port"][0] != 501
    assert answers["port"][:3] == {
        "build/function": (200, "", False),
        "build/status?name=f": (404, "function not found", False),
        "projects/p1/functions/f/deploy": (
            (400, "function deploy failed", True) if method == "POST"
            else (200, "", False)),
    }[path]

    def scenario(pkg, svc):
        return svc.db.api_call(
            "POST", "projects/p1/functions/b/deploy",
            json_body={"function": {"kind": "job",
                                    "metadata": {"tag": "latest"}}})

    assert _alike(services, scenario) == {"data": {"state": "ready",
                                                   "address": ""}}


def test_worker_proxies_mutations_to_chief(services, tmp_path,
                                           monkeypatch):
    """chief/worker clusterization: a worker forwards POSTs to the chief
    and serves reads from its own db."""
    def scenario(pkg, chief):
        monkeypatch.setenv("MLT_CLUSTER_ROLE", "worker")
        monkeypatch.setenv("MLT_CHIEF_URL", chief.url)
        worker_db = pkg.sqlitedb.SQLiteRunDB(
            str(tmp_path / f"worker-{pkg.name}.sqlite"))
        worker = Service(pkg, tmp_path, monkeypatch, advertise=False,
                         state=pkg.app.ServiceState(db=worker_db))
        try:
            client = pkg.httpdb.HTTPRunDB(worker.url)
            client.store_project("proxied-proj",
                                 {"metadata": {"name": "proxied-proj"}})
            return [chief.state.db.get_project("proxied-proj") is not None,
                    worker_db.get_project("proxied-proj"),
                    client.get_project("proxied-proj")]
        finally:
            worker.stop()
            monkeypatch.delenv("MLT_CLUSTER_ROLE")
            monkeypatch.delenv("MLT_CHIEF_URL")

    assert _alike(services, scenario) == [True, None, None]


def test_grafana_proxy(services):
    def scenario(pkg, svc):
        db = svc.db
        db.store_model_endpoint("p1", "ep1", {
            "uid": "ep1", "name": "m", "metrics": {
                "requests": 5, "avg_latency_microsec": 1200.0},
            "drift_status": "no_detection"})
        found = db.api_call("POST", "grafana-proxy/model-endpoints/search",
                            json_body={"target": "p1"})
        table = db.api_call("POST", "grafana-proxy/model-endpoints/query",
                            json_body={"targets": [{"target": "p1"}]})
        return [found, table]

    found, table = _alike(services, scenario)
    assert found == ["ep1"]
    assert table[0]["rows"][0][0] == "ep1" and table[0]["rows"][0][2] == 5


def test_list_pagination(services):
    def scenario(pkg, svc):
        db = svc.db
        for i in range(5):
            db.store_run({"metadata": {"name": f"pg{i}", "uid": f"pg{i}"},
                          "status": {"state": "completed"}}, f"pg{i}", "pgp")
        page = db.api_call("GET", "projects/pgp/runs",
                           params={"limit": 2, "offset": 1})["runs"]
        return [sorted(r["metadata"]["name"] for r in page),
                len(db.api_call("GET", "projects/pgp/runs")["runs"])]

    out = _alike(services, scenario)
    assert len(out[0]) == 2 and out[1] == 5


def test_tags_files_hub_endpoints(services, tmp_path):
    payload = tmp_path / "payload.txt"
    payload.write_text("hello mlt")
    hub_dir = tmp_path / "myhub" / "fn1"
    hub_dir.mkdir(parents=True)
    (hub_dir / "function.yaml").write_text(
        "kind: job\nmetadata:\n  name: fn1\n")

    def scenario(pkg, svc):
        db = svc.db
        out = []
        for uid in ("v1", "v2"):
            db.store_artifact("model-a", {"metadata": {"key": "model-a"},
                                          "kind": "model"},
                              uid=uid, project="p3")
        out.append(db.tag_objects("p3", "prod",
                                  [{"key": "model-a", "uid": "v1"}]))
        art = db.read_artifact("model-a", tag="prod", project="p3")
        out.append([art["metadata"]["uid"], art["metadata"]["tag"]])
        out.append(db.read_artifact("model-a", project="p3")[
            "metadata"]["uid"])
        out.append(db.tag_objects("p3", "prod",
                                  [{"key": "model-a", "uid": "v2"}]))
        out.append(db.read_artifact("model-a", tag="prod", project="p3")[
            "metadata"]["uid"])
        out.append(db.delete_objects_tag(
            "p3", "prod", [{"key": "model-a", "uid": "v2"}]))
        out.append(db.get_file(str(payload), project="p3"))
        out.append(db.get_filestat(str(payload), project="p3")["size"])
        out.append(any(s["name"] == "default"
                       for s in db.list_hub_sources()))
        out.append(bool(db.get_hub_catalog("default")))
        db.store_hub_source("myhub", {"path": str(tmp_path / "myhub")})
        out.append(db.get_hub_catalog("myhub"))
        out.append(db.get_hub_item("myhub", "fn1")["kind"])
        db.delete_hub_source("myhub")
        out.append(any(s["name"] == "myhub" for s in db.list_hub_sources()))
        return out

    assert _alike(services, scenario) == [
        1, ["v1", "prod"], "v2", 1, "v2", 1, b"hello mlt", 9, True, True,
        [{"name": "fn1"}], "job", False]


def test_auth_token_middleware(services, monkeypatch):
    from mlrun_tpu.config import mlconf

    monkeypatch.setattr(mlconf.httpdb, "auth_token", "sekret")
    monkeypatch.setenv("MLT_HTTPDB__AUTH_TOKEN", "sekret")

    def scenario(pkg, svc):
        out = [requests.get(f"{svc.url}/api/v1/projects",
                            timeout=10).status_code,
               requests.get(f"{svc.url}/api/v1/healthz",
                            timeout=10).status_code,
               requests.get(f"{svc.url}/metrics", timeout=10).status_code]
        db = pkg.httpdb.HTTPRunDB(svc.url, token="sekret")
        out.append(db.api_call("GET", "projects")["projects"])
        with pytest.raises(pkg.base.RunDBError, match="401"):
            pkg.httpdb.HTTPRunDB(svc.url, token="wrong").api_call(
                "GET", "projects")
        return out

    assert _alike(services, scenario) == [401, 200, 200, []]


def test_files_endpoint_denies_service_db(services):
    def scenario(pkg, svc):
        with pytest.raises(pkg.base.RunDBError,
                           match="403|not readable") as exc:
            svc.db.get_file(svc.state.db.dsn, project="px")
        return "403" in str(exc.value)

    assert _alike(services, scenario) is True


def test_runtime_resources_endpoints(services):
    def scenario(pkg, svc):
        db, state = svc.db, svc.state
        state.db.store_run({"metadata": {"uid": "rr1", "project": "prr"},
                            "status": {"state": "running"}}, "rr1", "prr")
        state.db.store_runtime_resource("rr1", "prr", "job",
                                        "proc-999999-1", time.time())
        grouped = db.list_runtime_resources(project="prr")
        out = [grouped[0]["kind"],
               grouped[0]["resources"][0]["resource_id"],
               grouped[0]["resources"][0]["state"],
               db.delete_runtime_resources(project="prr"),
               bool(db.list_runtime_resources(project="prr"))]
        deleted = db.delete_runtime_resources(project="prr", force=True)
        return out + [[d["uid"] for d in deleted],
                      db.list_runtime_resources(project="prr")]

    assert _alike(services, scenario) == [
        "job", "proc-999999-1", "Failed", [], True, ["rr1"], []]


def test_pipelines_endpoints(services):
    def scenario(pkg, svc):
        db, state = svc.db, svc.state
        state.workflows["wf-aaa"] = {"id": "wf-aaa", "project": "ppl",
                                     "state": "completed", "started": "t1"}
        state.workflows["wf-bbb"] = {"id": "wf-bbb", "project": "other",
                                     "state": "running", "started": "t2"}
        out = [[r["id"] for r in db.list_pipelines(project="ppl")["runs"]]]
        everything = db.list_pipelines(project="*")
        out += [everything["total_size"],
                [r["id"] for r in everything["runs"]],
                db.get_pipeline("wf-aaa")["run"]["state"]]
        with pytest.raises(pkg.base.RunDBError):
            db.get_pipeline("missing")
        return out

    assert _alike(services, scenario) == [
        ["wf-aaa"], 2, ["wf-bbb", "wf-aaa"], "completed"]


def test_endpoint_metrics_rest(services, tmp_path, monkeypatch):
    """The metric time-series REST surface over each package's monitoring
    tsdb (each under its own MLT_HOME)."""
    import importlib

    def scenario(pkg, svc):
        monkeypatch.setenv("MLT_HOME", str(tmp_path / f"home-{pkg.name}"))
        root = "mlrun_tpu" if pkg.name == "jax" else "mlrun_tpu_torch"
        tsdb_module = importlib.import_module(
            f"{root}.model_monitoring.tsdb")
        tsdb = tsdb_module.get_metrics_tsdb()
        for i in range(5):
            tsdb.write("pm", "epX", {"drift": 0.1 * i}, ts=2000.0 + i)
        series = svc.db.get_model_endpoint_metrics(
            "pm", "epX", name="drift", start=2001, end=2003)
        return [svc.db.list_model_endpoint_metric_names("pm", "epX"),
                [round(pt["value"], 9) for pt in series[0]["points"]]]

    assert _alike(services, scenario) == [["drift"], [0.1, 0.2, 0.3]]


# -- tests/test_secrets.py (over HTTP) ----------------------------------------

def test_secret_roundtrip_over_http(services):
    def scenario(pkg, svc):
        db = svc.db
        db.create_project_secrets("sp", {"API_KEY": "k-123",
                                         "DB_PASS": "p-456"})
        out = [db.list_project_secret_keys("sp")]
        text = requests.get(f"{svc.url}/api/v1/projects/sp/secret-keys",
                            timeout=10).text
        out.append("k-123" in text or "p-456" in text)
        out.append(svc.state.db.get_project_secrets("sp"))
        db.delete_project_secrets("sp", secrets=["API_KEY"])
        out.append(db.list_project_secret_keys("sp"))
        db.delete_project_secrets("sp")
        return out + [db.list_project_secret_keys("sp")]

    assert _alike(services, scenario) == [
        ["API_KEY", "DB_PASS"], False,
        {"API_KEY": "k-123", "DB_PASS": "p-456"}, ["DB_PASS"], []]


def test_secret_injected_into_run_context(services, monkeypatch):
    def scenario(pkg, svc):
        monkeypatch.setenv("MLT_DBPATH", svc.url)
        svc.db.create_project_secrets("sp2", {"TOKEN": "sekrit-42"})
        code = ("def handler(context):\n"
                "    context.log_result('token', "
                "context.get_secret('TOKEN'))\n")
        resp = svc.db.submit_job({
            "function": {
                "kind": "job",
                "metadata": {"name": "sfn", "project": "sp2",
                             "tag": "latest"},
                "spec": {"image": "x", "default_handler": "handler",
                         "build": {"functionSourceCode": _code(code)}}},
            "task": {"metadata": {"name": "srun", "project": "sp2"},
                     "spec": {"handler": "handler"}}})
        run = _wait_terminal(svc, resp["data"]["metadata"]["uid"], "sp2")
        return [run["status"]["state"], run["status"]["results"]]

    assert _alike(services, scenario) == ["completed",
                                          {"token": "sekrit-42"}]


def test_notification_params_masked_on_submit(services, monkeypatch):
    """Webhook params become a secret reference in the stored run; the
    server resolves them and pushes on completion, then drops the
    single-use secret."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    received = []

    class Hook(BaseHTTPRequestHandler):
        def do_POST(self):
            received.append(json.loads(
                self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *args):
            pass

    hook = HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=hook.serve_forever, daemon=True).start()
    hook_url = f"http://127.0.0.1:{hook.server_address[1]}/notify"

    def scenario(pkg, svc):
        monkeypatch.setenv("MLT_DBPATH", svc.url)
        received.clear()
        code = "def handler(context):\n    context.log_result('r', 1)\n"
        resp = svc.db.submit_job({
            "function": {
                "kind": "job",
                "metadata": {"name": "nfn", "project": "np",
                             "tag": "latest"},
                "spec": {"image": "x", "default_handler": "handler",
                         "build": {"functionSourceCode": _code(code)}}},
            "task": {
                "metadata": {"name": "nrun", "project": "np"},
                "spec": {"handler": "handler", "notifications": [{
                    "kind": "webhook", "name": "hook",
                    "when": ["completed"],
                    "params": {"url": hook_url,
                               "secret_token": "hunter2"}}]}}})
        uid = resp["data"]["metadata"]["uid"]
        stored = svc.state.db.read_run(uid, "np")
        params = stored["spec"]["notifications"][0]["params"]
        out = [list(params), "hunter2" in json.dumps(stored),
               bool(svc.state.db.get_project_secrets(
                   "np", keys=[params["secret"]]))]
        run = _wait_terminal(svc, uid, "np", also=lambda run: received)
        final = svc.state.db.read_run(uid, "np")
        return out + [run["status"]["state"], len(received),
                      final["spec"]["notifications"][0]["status"],
                      svc.state.db.get_project_secrets(
                          "np", keys=[params["secret"]]),
                      pkg.secrets.project_secret_env(svc.state.db, "np")]

    try:
        assert _alike(services, scenario) == [
            ["secret"], False, True, "completed", 1, "sent", {}, {}]
    finally:
        hook.shutdown()


# -- tests/test_migrations_pagination.py (over HTTP) --------------------------

def test_pagination_over_http(services):
    def scenario(pkg, svc):
        db = svc.db
        for i in range(7):
            svc.state.db.store_run({"metadata": {"uid": f"h{i}",
                                                 "name": "hr"},
                                    "status": {"state": "completed"}},
                                   f"h{i}", "hp")
        sizes, token, first = [], "", True
        while first or token:
            runs, token = db.paginated_list_runs("hp", page_size=3,
                                                 page_token=token or "")
            sizes.append([len(runs), bool(token)])
            first = False
        with pytest.raises(pkg.base.RunDBError,
                           match="invalid or expired"):
            db.paginated_list_runs("hp", page_token="bogus")
        return sizes

    assert _alike(services, scenario) == [[3, True], [3, True], [1, False]]


def test_pagination_edge_cases(services):
    def scenario(pkg, svc):
        db, state = svc.db, svc.state
        for i in range(3):
            state.db.store_run({"metadata": {"uid": f"e{i}", "name": "er"},
                                "status": {"state": "completed"}},
                               f"e{i}", "ep")
        page, token = state.db.paginated_list("list_runs", page_size=0,
                                              project="ep")
        out = [len(page), bool(token)]
        with pytest.raises(pkg.base.RunDBError, match="issued for"):
            state.db.paginated_list("list_artifacts", page_token=token)
        out.append(requests.get(
            f"{svc.url}/api/v1/projects/ep/runs?page_size=abc",
            timeout=10).status_code)
        state.db.store_run({"metadata": {"uid": "lab1", "name": "lr",
                                         "labels": {"team": "a"}},
                            "status": {"state": "completed"}}, "lab1", "ep")
        runs, _ = db.paginated_list_runs("ep", page_size=10,
                                         labels={"team": "a"})
        return out + [[r["metadata"]["uid"] for r in runs]]

    assert _alike(services, scenario) == [1, True, 400, ["lab1"]]


# -- tests/test_obs_control_plane.py: the Grafana metrics proxy ---------------

def test_grafana_metrics_proxy_over_http(services):
    """The simpleJSON datasource over each package's process time-series
    store (``obs/timeseries``): /search lists series, /query answers raw
    and function targets in grafana's ISO-8601 range, bad input is 400."""
    def scenario(pkg, svc):
        store = pkg.timeseries.TimeSeriesStore(resolution_s=1.0)
        for t in range(20):
            store.record("mlt_llm_queue_depth", float(t), at=float(t),
                         labels={"replica": "r0"})
            store.record("mlt_fleet_dispatches_total", float(t * 3),
                         at=float(t), kind="counter")
        pkg.timeseries.set_store(store)
        db = svc.db
        try:
            out = [db.api_call("GET", "grafana-proxy/metrics")["status"],
                   db.api_call("POST", "grafana-proxy/metrics/search",
                               json_body={"target": "queue"})]
            out.append(db.api_call(
                "POST", "grafana-proxy/metrics/query",
                json_body={
                    "range": {"from": "1970-01-01T00:00:05Z",
                              "to": "1970-01-01T00:00:08Z"},
                    "targets": [
                        {"target": 'mlt_llm_queue_depth{replica="r0"}'},
                        {"target": "rate(mlt_fleet_dispatches_total)[4]"},
                    ]}))
            for body in ({"range": {"from": 0, "to": 10},
                          "targets": [{"target": "!!"}]},
                         {"range": {"from": "not-a-time", "to": 10},
                          "targets": []}):
                with pytest.raises(pkg.base.RunDBError, match="400"):
                    db.api_call("POST", "grafana-proxy/metrics/query",
                                json_body=body)
            return out
        finally:
            pkg.timeseries.set_store(None)

    out = _alike(services, scenario)
    assert out[:2] == ["ok", ['mlt_llm_queue_depth{replica="r0"}']]
    assert out[2][0]["datapoints"] == [[5.0, 5000.0], [6.0, 6000.0],
                                       [7.0, 7000.0], [8.0, 8000.0]]
    assert all(v == pytest.approx(3.0) for v, _ in out[2][1]["datapoints"])


# -- cross-wired clients ------------------------------------------------------

@pytest.mark.parametrize("client,server", [("port", "jax"),
                                           ("jax", "port")],
                         ids=["port-client-jax-service",
                              "jax-client-port-service"])
def test_cross_wired_clients(services, client, server):
    """One package's ``HTTPRunDB`` drives the other package's service: run
    CRUD, logs, artifacts, projects, pagination and secrets."""
    pkg = PKGS[client]
    svc = services[server]
    db = pkg.httpdb.HTTPRunDB(svc.url).connect()
    assert db.server_version
    db.store_run({"metadata": {"name": "x", "uid": "cw1", "project": "cw"},
                  "status": {"state": "running"}}, "cw1", "cw")
    db.update_run({"status.state": "completed",
                   "status.results": {"a": 1}}, "cw1", "cw")
    run = svc.state.db.read_run("cw1", "cw")
    assert run["status"]["state"] == "completed"
    assert run["status"]["results"] == {"a": 1}
    assert [r["metadata"]["uid"] for r in db.list_runs(project="cw")] == [
        "cw1"]
    db.store_log("cw1", "cw", b"hello ")
    db.store_log("cw1", "cw", b"world\n")
    assert db.get_log("cw1", "cw") == ("completed", b"hello world\n")
    assert svc.state.db.get_log("cw1", "cw")[1] == b"hello world\n"
    db.store_artifact("data", {"kind": "dataset",
                               "metadata": {"key": "data"},
                               "spec": {"target_path": "/d"}},
                      uid="a1", project="cw")
    assert db.read_artifact("data", project="cw")["spec"] == {
        "target_path": "/d"}
    db.store_project("cw", {"metadata": {"name": "cw"}, "spec": {
        "description": "wired"}})
    assert svc.state.db.get_project("cw")["spec"]["description"] == "wired"
    for i in range(4):
        db.store_run({"metadata": {"uid": f"pg{i}"},
                      "status": {"state": "completed"}}, f"pg{i}", "cwp")
    runs, token = db.paginated_list_runs("cwp", page_size=3)
    more, token2 = db.paginated_list_runs("cwp", page_size=3,
                                          page_token=token)
    assert [len(runs), len(more), token2] == [3, 1, None]
    db.create_project_secrets("cw", {"K": "v"})
    assert db.list_project_secret_keys("cw") == ["K"]
    assert svc.state.db.get_project_secrets("cw") == {"K": "v"}
    db.del_run("cw1", "cw")
    with pytest.raises(pkg.base.RunDBError, match="404"):
        db.read_run("cw1", "cw")


# -- the port's client surfaces -----------------------------------------------

def test_get_run_db_and_the_remote_launcher_reach_the_service(
        services, monkeypatch, tmp_path):
    """``get_run_db`` of the service's url is the port's ``HTTPRunDB``;
    ``run(local=False)`` goes through ``ClientRemoteLauncher`` (the
    function stored in the service, the run submitted over HTTP, the job
    executed by the service's local provider); ``wait_for_run_completion``
    polls the service's workflows API."""
    import mlrun_tpu_torch
    from mlrun_tpu_torch import db as tdb
    from mlrun_tpu_torch.db.httpdb import HTTPRunDB
    from mlrun_tpu_torch.launcher import ClientRemoteLauncher
    from mlrun_tpu_torch.projects.pipelines import wait_for_run_completion

    svc = services["port"]
    monkeypatch.setenv("MLT_DBPATH", svc.url)
    tdb.set_run_db(None)
    try:
        db = tdb.get_run_db()
        assert isinstance(db, HTTPRunDB) and db.base_url == svc.url
        launched = []
        original = ClientRemoteLauncher.launch

        def launch(self, *args, **kwargs):
            launched.append(type(self).__name__)
            return original(self, *args, **kwargs)

        monkeypatch.setattr(ClientRemoteLauncher, "launch", launch)
        source = tmp_path / "remote_fn.py"
        source.write_text("def handler(context, x: int = 1):\n"
                          "    context.log_result('y', x + 1)\n")
        fn = mlrun_tpu_torch.code_to_function(
            "remote-fn", kind="job", image="img", project="rp",
            filename=str(source))
        run = fn.run(handler="handler", params={"x": 4}, local=False,
                     watch=False)
        assert launched == ["ClientRemoteLauncher"]
        state = _wait_terminal(svc, run.metadata.uid, "rp")
        assert state["status"]["state"] == "completed"
        assert state["status"]["results"] == {"y": 5}
        assert svc.state.db.get_function("remote-fn", "rp")["kind"] == "job"
        svc.state.workflows["wf-1"] = {"id": "wf-1", "project": "rp",
                                       "state": "completed"}
        assert wait_for_run_completion("wf-1", project="rp",
                                       timeout=10) == "completed"
    finally:
        tdb.set_run_db(None)


def test_service_thread_serves_and_stops(tmp_path, monkeypatch):
    """The port's ``ServiceThread`` serves the API beside other work in
    one process, refuses a port in use, and stops."""
    import socket

    from mlrun_tpu_torch.db.sqlitedb import SQLiteRunDB
    from mlrun_tpu_torch.service.app import ServiceState, ServiceThread

    monkeypatch.setenv("MLT_HTTPDB__PORT", "0")
    state = ServiceState(db=SQLiteRunDB(str(tmp_path / "t.sqlite")))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        sock.listen()
        with pytest.raises(OSError):
            ServiceThread(state, port=sock.getsockname()[1])
    server = ServiceThread(state, port=free_port())
    try:
        assert requests.get(f"{server.url}/api/v1/healthz",
                            timeout=10).json()["status"] == "ok"
    finally:
        server.stop()
    assert not server._thread.is_alive()
    with pytest.raises(requests.ConnectionError):
        requests.get(f"{server.url}/api/v1/healthz", timeout=2)
