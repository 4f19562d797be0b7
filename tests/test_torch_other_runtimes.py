"""mlrun_tpu_torch's other runtimes against mlrun_tpu's: ``serving`` (its
graph spec and mock server), ``remote``, the api gateways (through each
package's service), ``dask`` (the cluster manifests), ``spark`` (the
SparkApplication through the kubernetes provider over
``tests/fake_k8s.py``) and ``databricks`` (the submit flow over
``tests/fake_databricks.py``).

Each case runs the reference's contract (``tests/test_runtimes.py``'s
``test_remote_kind_requires_service`` and ``test_dask_cluster_manifests``,
``tests/test_service.py::test_api_gateway_roundtrip``,
``tests/test_k8s_provider.py::test_spark_handler_crd_lifecycle``,
``tests/test_databricks.py``) on both packages with the same inputs and
compares what each returns.
"""

import base64
import json
import types

import pytest

import mlrun_tpu
import mlrun_tpu_torch
from mlrun_tpu.runtimes.api_gateway import APIGateway as JAPIGateway
from mlrun_tpu_torch.runtimes.api_gateway import APIGateway as TAPIGateway

from . import fake_databricks, fake_k8s
from tests.torch_service import PKGS, Service

TOPS = {"jax": types.SimpleNamespace(top=mlrun_tpu, APIGateway=JAPIGateway),
        "port": types.SimpleNamespace(top=mlrun_tpu_torch,
                                      APIGateway=TAPIGateway)}


@pytest.fixture()
def port_home(tmp_path, monkeypatch):
    """The port's run db under its own MLT_HOME, reset around the test
    (the shared conftest resets the reference's only)."""
    from mlrun_tpu_torch.datastore import store_manager
    from mlrun_tpu_torch.db import set_run_db

    monkeypatch.setenv("MLT_HOME", str(tmp_path / "port-home"))
    set_run_db(None)
    store_manager._db = None
    yield
    set_run_db(None)
    store_manager._db = None


# -- tests/test_runtimes.py ---------------------------------------------------

def test_remote_kind_requires_service(port_home):
    for name, tops in TOPS.items():
        fn = tops.top.new_function("j", kind="job", image="img")
        with pytest.raises(RuntimeError, match="MLT_DBPATH"):
            fn.run()


def test_dask_cluster_manifests():
    """The dask cluster's scheduler Deployment + Service and worker
    Deployment, label-linked; the remote client path once an address is
    recorded."""
    out = []
    for tops in TOPS.values():
        fn = tops.top.new_function("dcluster", kind="dask", image="dask:img")
        fn.spec.min_replicas = 3
        fn.spec.worker_resources = {"cpu": "2", "memory": "4Gi"}
        resources = fn.generate_cluster_resources()
        fn.spec.scheduler_address = "tcp://somewhere:8786"
        out.append((resources, fn.spec.to_dict()["scheduler_address"],
                    fn.generate_cluster_resources("other-ns")))
    assert out[1] == out[0]
    resources = out[1][0]
    assert resources["scheduler"]["spec"]["replicas"] == 1
    assert resources["scheduler"]["spec"]["template"]["spec"]["containers"][
        0]["image"] == "dask:img"
    workers = resources["workers"]
    assert workers["spec"]["replicas"] == 3
    worker = workers["spec"]["template"]["spec"]["containers"][0]
    assert "tcp://mlt-dask-dcluster-scheduler:8786" in worker["args"][2]
    assert worker["resources"]["limits"]["memory"] == "4Gi"
    service = resources["service"]
    assert service["spec"]["selector"]["mlrun-tpu/component"] == "scheduler"
    assert {p["port"] for p in service["spec"]["ports"]} == {8786, 8787}
    assert resources["service"]["metadata"]["namespace"] == "mlrun-tpu"
    assert out[1][1] == "tcp://somewhere:8786"
    assert out[1][2]["workers"]["metadata"]["namespace"] == "other-ns"


def test_dask_client_needs_dask(monkeypatch):
    """Without dask, the client raises the reference's ImportError."""
    monkeypatch.setitem(__import__("sys").modules, "dask", None)
    monkeypatch.setitem(__import__("sys").modules, "dask.distributed", None)
    for tops in TOPS.values():
        fn = tops.top.new_function("d", kind="dask")
        with pytest.raises(ImportError, match="dask is not installed"):
            fn.client


def test_runtime_kinds_resolve_alike():
    """Every kind of the reference's registry resolves to the port's class
    of the same name, and an unknown kind raises alike."""
    from mlrun_tpu.runtimes import get_runtime_class as jget
    from mlrun_tpu_torch.runtimes import get_runtime_class as tget

    for kind in ("", "local", "handler", "job", "tpujob", "dask", "spark",
                 "databricks", "serving", "remote", "application"):
        assert tget(kind).__name__ == jget(kind).__name__, kind
    for get in (jget, tget):
        with pytest.raises(ValueError, match="unsupported runtime kind"):
            get("mpijob")


# -- serving and remote functions -----------------------------------------------

def _graph(fn):
    router = fn.set_topology("router")
    fn.add_model("m1", class_name="EchoModel", model_path="/models/m1",
                 scale=2)
    fn.add_model("m2", class_name="EchoModel")
    fn.set_tracking(stream_path="memory://stream")
    fn.with_secrets("inline", {"TOKEN": "t"})
    return router


def test_serving_spec_and_mock_server_match():
    """The same graph gives the same ``SERVING_SPEC_ENV`` spec and the
    same function dict; removing a model and a round trip through the
    dict (the db's) keep ``add_model`` working; the mock server answers
    alike."""
    specs, answers = [], []
    for name, tops in TOPS.items():
        fn = tops.top.new_function("srv", project="p", kind="serving")
        _graph(fn)
        fn.remove_models(["m2"])
        loaded = tops.top.new_function(
            "srv", project="p", kind="serving").from_dict(fn.to_dict())
        loaded.add_model("m3", class_name="EchoModel")
        with pytest.raises(ValueError, match="already set"):
            loaded.set_topology("router")
        specs.append((fn._get_serving_spec(), loaded.to_dict()["spec"],
                      fn.with_http(workers=2, port=9000).spec.config,
                      fn.add_trigger("k", {"kind": "kafka"}).spec.config))

        serving = __import__(f"{tops.top.__name__}.serving",
                             fromlist=["V2ModelServer"])

        class EchoModel(serving.V2ModelServer):
            def __init__(self, *args, scale: int = 1, **kwargs):
                super().__init__(*args, **kwargs)
                self.scale = scale

            def load(self):
                self.ready = True

            def predict(self, request):
                return [x * self.scale for x in request["inputs"]]

        server = fn.to_mock_server(namespace={"EchoModel": EchoModel})
        answers.append(server.test("/v2/models/m1/infer",
                                   body={"inputs": [1, 2]})["outputs"])
    assert specs[1] == specs[0]
    assert answers[1] == answers[0] == [2, 4]
    spec = specs[1][0]
    assert spec["function_uri"] == "p/srv:latest" and spec["track_models"]
    assert spec["secret_sources"] == [{"kind": "inline",
                                       "source": {"TOKEN": "t"}}]
    assert list(spec["graph"]["steps"]["router"]["routes"]) == ["m1"]


def test_remote_runtime_refuses_run_and_undeployed_invoke():
    for tops in TOPS.values():
        fn = tops.top.new_function("r", kind="remote")
        with pytest.raises(ValueError, match="not deployed"):
            fn.invoke("/")
        app = tops.top.new_function("a", kind="application")
        app.with_sidecar("side", "img", ports=[80])
        assert app.spec.config["sidecars"] == [
            {"name": "side", "image": "img", "ports": [80], "command": []}]


# -- tests/test_service.py::test_api_gateway_roundtrip ----------------------------

def test_api_gateway_roundtrip(tmp_path, monkeypatch):
    """An api gateway with a canary saved through each package's service,
    fetched and listed (by the route and by the project); its weighted
    pick and its basic auth alike."""
    out = {}
    for name, pkg in PKGS.items():
        svc = Service(pkg, tmp_path, monkeypatch)
        try:
            gateway = TOPS[name].APIGateway(
                "gw1", project="p1",
                functions=["p1/srv-a:latest", "p1/srv-b:latest"],
                host="gw.example", path="/api")
            gateway.with_canary(["p1/srv-a:latest", "p1/srv-b:latest"],
                                [80, 20])
            gateway.with_basic_auth("user", "pw")
            gateway.save(db=svc.db)
            fetched = svc.db.api_call(
                "GET", "projects/p1/api-gateways/gw1")["data"]
            listed = svc.db.api_call("GET", "projects/p1/api-gateways")
            picks = {gateway.pick_function() for _ in range(50)}
            with pytest.raises(ValueError, match="canary needs"):
                gateway.with_canary(["p1/srv-a:latest"], [100])
            project = TOPS[name].top.new_project(
                "p1", context=str(tmp_path / name))
            project._db = svc.db
            out[name] = (fetched["kind"], fetched["spec"],
                         len(listed["api_gateways"]), picks <= {
                             "p1/srv-a:latest", "p1/srv-b:latest"},
                         gateway.invoke_url(),
                         [g["metadata"]["name"]
                          for g in project.list_api_gateways()])
        finally:
            svc.stop()
    assert out["port"] == out["jax"]
    kind, spec, listed, picks_ok, url, by_project = out["port"]
    assert kind == "api-gateway" and spec["canary"] == [80, 20]
    assert spec["authentication_mode"] == "basicAuth"
    assert listed == 1 and picks_ok and url == "http://gw.example/api"
    assert by_project == ["gw1"]


# -- tests/test_k8s_provider.py::test_spark_handler_crd_lifecycle ---------------

def _run_obj(pkg_top, uid, name="sj"):
    run = pkg_top.model.RunObject()
    run.metadata.uid = uid
    run.metadata.name = name
    run.metadata.project = "kp"
    run.spec.handler = "handler"
    return run


@pytest.mark.parametrize("name", list(PKGS))
def test_spark_handler_crd_lifecycle(name, monkeypatch, tmp_path):
    """The SparkApplication lands through the handler; project secrets
    ride Secret + envFrom on both roles; a restarted service re-adopts it
    by label; the operator's applicationState drives the run terminal."""
    pkg, top = PKGS[name], TOPS[name].top
    monkeypatch.setattr(fake_k8s, "chaos_fire", pkg.chaos.fire)
    cluster = fake_k8s.install(monkeypatch)
    provider = pkg.handlers.KubernetesProvider(namespace="testns")
    db = pkg.sqlitedb.SQLiteRunDB(dsn=str(tmp_path / "svc.db"),
                                  logs_dir=str(tmp_path / "logs"))
    db.store_project_secrets("kp", {"SPARK_TOKEN": "tok"})
    fn = top.new_function("sj", project="kp", kind="spark",
                          image="spark-img")
    fn.spec.command = "local:///app/job.py"
    run = _run_obj(top, "5detc0ffee01")
    db.store_run({"metadata": {"name": "sj", "uid": run.metadata.uid,
                               "project": "kp"},
                  "status": {"state": "pending"}}, run.metadata.uid, "kp")
    handler = pkg.handlers.get_runtime_handler("spark", db, provider)
    rid = handler.run(fn, run)["resource_id"]
    assert rid.startswith("sparkapplication/")
    crd = rid.split("/", 1)[1]
    manifest = cluster.customs["sparkapplications"][crd]
    assert manifest["spec"]["mainApplicationFile"] == "local:///app/job.py"
    assert manifest["metadata"]["labels"]["mlrun-tpu/uid"] == \
        run.metadata.uid
    for role in ("driver", "executor"):
        assert {"secretRef": {"name": "mlrun-tpu-secrets-kp"}} in \
            manifest["spec"][role]["envFrom"]
    assert "tok" not in str(manifest)
    assert (rid, run.metadata.uid, "kp") in provider.list_resources("spark")
    phases = [provider.state(rid)]
    cluster.set_custom_status("sparkapplications", crd,
                              {"applicationState": {"state": "RUNNING"}})
    phases.append(provider.state(rid))
    cluster.set_custom_status("sparkapplications", crd,
                              {"applicationState": {"state": "COMPLETED"}})
    handler.monitor_runs()
    assert phases == ["Pending", "Running"]
    assert db.read_run(run.metadata.uid, "kp")["status"]["state"] == \
        "completed"
    run2 = _run_obj(top, "aa11bb22cc33")
    db.store_run({"metadata": {"name": "sj", "uid": run2.metadata.uid,
                               "project": "kp"},
                  "status": {"state": "pending"}}, run2.metadata.uid, "kp")
    rid2 = handler.run(fn, run2)["resource_id"]
    cluster.set_custom_status(
        "sparkapplications", rid2.split("/", 1)[1],
        {"applicationState": {"state": "SUBMISSION_FAILED"}})
    handler.monitor_runs()
    assert db.read_run(run2.metadata.uid, "kp")["status"]["state"] == \
        "error"
    provider.delete(rid2)
    assert rid2.split("/", 1)[1] not in cluster.customs["sparkapplications"]
    # the local provider cannot materialize a spark cluster
    local = pkg.handlers.get_runtime_handler(
        "spark", db, pkg.handlers.LocalProcessProvider(db))
    with pytest.raises(ValueError, match="kubernetes provider"):
        local.build_resource(fn, run)


def test_spark_application_manifest_matches():
    out = []
    for tops in TOPS.values():
        fn = tops.top.new_function("sj", project="kp", kind="spark",
                                   image="spark-img")
        fn.with_driver_resources(mem="3g", cpu="2")
        fn.with_executor_resources(mem="8g", cpu="4", replicas=5)
        run = _run_obj(tops.top, "0123456789ab")
        manifest = fn.generate_spark_application(run)
        env = manifest["spec"]["driver"].pop("env")
        out.append((manifest, [e["name"] for e in env]))
    assert out[1] == out[0]
    spec = out[1][0]["spec"]
    assert spec["driver"]["cores"] == 2 and spec["executor"]["instances"] == 5
    assert "MLT_EXEC_CONFIG" in out[1][1]


# -- tests/test_databricks.py -------------------------------------------------

CODE = "def handler(context):\n    return 1\n"


def _dbx(tops, cluster_id=None):
    fn = tops.top.new_function("dbxfn", project="dbx", kind="databricks")
    fn.spec.build.functionSourceCode = base64.b64encode(
        CODE.encode()).decode()
    if cluster_id:
        fn.spec.cluster_id = cluster_id
    return fn


def test_databricks_submit_flow_success(monkeypatch, port_home):
    out = {}
    for name, tops in TOPS.items():
        workspace = fake_databricks.install(monkeypatch)
        run = _dbx(tops, cluster_id="c-123").run(params={"x": 1},
                                                 local=False, watch=False)
        submitted = workspace.submissions[0]
        task = submitted["tasks"][0]
        payload = json.loads(task.spark_python_task.parameters[0])
        out[name] = (run.status.state, run.status.results, submitted[
            "run_name"], task.existing_cluster_id, task.new_cluster,
            payload["run_spec"]["metadata"]["name"],
            base64.b64decode(payload["code_b64"]).decode(),
            task.timeout_seconds)
    assert out["port"] == out["jax"]
    assert out["port"][0] == "completed"
    assert out["port"][1]["databricks_run_id"] == 7701
    assert "dbx.example" in out["port"][1]["databricks_run_url"]
    assert out["port"][3:] == ("c-123", None, "dbxfn", CODE, 3600)


def test_databricks_submit_flow_new_cluster_and_failure(monkeypatch,
                                                        port_home):
    out = {}
    for name, tops in TOPS.items():
        workspace = fake_databricks.install(monkeypatch)
        workspace.next_result_state = "FAILED"
        workspace.next_state_message = "driver OOM"
        try:
            run = _dbx(tops).run(local=False, watch=False)
            state, error = run.status.state, run.status.error or ""
        except Exception:  # noqa: BLE001 - a failed run may raise
            stored = tops.top.get_run_db().list_runs(
                name="dbxfn", project="dbx")[0]
            state = stored["status"]["state"]
            error = stored["status"].get("error", "")
        task = workspace.submissions[0]["tasks"][0]
        out[name] = (state, "FAILED" in error and "driver OOM" in error,
                     task.new_cluster.spec)
    assert out["port"] == out["jax"]
    assert out["port"][:2] == ("error", True)
    assert out["port"][2]["num_workers"] == 1
