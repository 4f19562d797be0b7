"""mlrun_tpu_torch's serving deploys (``runtimes/serving.py``,
``runtimes/remote.py``, ``service/deployments.py``) against mlrun_tpu's.

Each package runs its own service in a thread (``tests/torch_service.py``)
over its own SQLite run db with the local process provider; a deploy
starts the package's own gateway as a child process (``python -m
mlrun_tpu serve`` / ``python3 -m mlrun_tpu_torch serve``). The five cases
of ``tests/test_deploy.py`` run on both packages with the same inputs and
what each returns is compared. A deleted function leaves no gateway
process behind, and a tiny paged ``LLMModelServer`` route deployed by the
port on float32 weights (an HF checkpoint both packages load) answers the
greedy tokens of the reference's graph server on the same checkpoint.
"""

import base64
import os
import signal
import time
import types

import pytest

import mlrun_tpu
import mlrun_tpu_torch
from mlrun_tpu import utils as jutils
from mlrun_tpu_torch import utils as tutils
from mlrun_tpu_torch.config import SERVICE_DEFAULTS
from mlrun_tpu_torch.service.providers import _process_tree
from tests.torch_registries import registries_left_as_found  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_service import PKGS, Service

MODEL_CODE = """
from {pkg}.serving import V2ModelServer


class EchoModel(V2ModelServer):
    def load(self):
        self.ready = True

    def predict(self, request):
        return [x * 3 for x in request["inputs"]]
"""

TOPS = {"jax": types.SimpleNamespace(top=mlrun_tpu, utils=jutils,
                                     module="mlrun_tpu"),
        "port": types.SimpleNamespace(top=mlrun_tpu_torch, utils=tutils,
                                      module="mlrun_tpu_torch")}


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    """Both packages' services for the whole module, stopped afterwards."""
    running = {}
    patch = pytest.MonkeyPatch()
    try:
        for name, pkg in PKGS.items():
            running[name] = Service(pkg, tmp_path_factory.mktemp(name),
                                    patch)
        yield running
    finally:
        for svc in running.values():
            for row in svc.state.db.list_runtime_resources(kind="gateway"):
                svc.state.provider.delete(row["resource_id"])
            svc.stop()
        patch.undo()


@pytest.fixture(autouse=True)
def _advertised(services):
    """The reference's ``mlconf`` is reloaded before every test: point
    its advertised port at its service again."""
    from mlrun_tpu.config import mlconf

    mlconf.httpdb.port = services["jax"].port


def _serving_fn(name, svc, project="dep"):
    tops = TOPS[svc.pkg.name]
    fn = tops.top.new_function(name, project=project, kind="serving")
    fn.spec.build.functionSourceCode = base64.b64encode(
        MODEL_CODE.format(pkg=tops.module).encode()).decode()
    fn.set_topology("router")
    fn.add_model("echo", class_name="EchoModel")
    fn._db = svc.db
    return fn


def _gateway_row(svc, name):
    for row in svc.state.db.list_runtime_resources(kind="gateway"):
        if row["uid"] == f"gateway-{name}":
            return row
    return None


def _both(services, scenario):
    return {name: scenario(svc) for name, svc in services.items()}


def _address_port(address: str) -> str:
    return address.rsplit(":", 1)[0]


def _pid(row) -> int:
    return int(row["resource_id"].split("-")[1])


def _left_after_sigterm(svc, tree) -> bool | None:
    """True when no process of a torn-down gateway's tree is left (the
    port's gateway exits once drained). The reference's stays up drained
    until a second signal: None, and its tree is killed here."""
    if svc.pkg.name == "port":
        return _gone(tree)
    for pid in tree:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    return None


def _gone(pids, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        alive = []
        for pid in pids:
            try:
                with open(f"/proc/{pid}/stat", "rb") as f:
                    if f.read().decode(errors="replace").rsplit(
                            ") ", 1)[1][0] != "Z":
                        alive.append(pid)
            except (OSError, IndexError):
                pass
        if not alive:
            return True
        time.sleep(0.05)
    return False


# -- tests/test_deploy.py ---------------------------------------------------

def test_deploy_serving_function_e2e(services):
    """deploy -> live address -> invoke round trip -> undeploy kills it."""
    def scenario(svc):
        fn = _serving_fn("echosrv", svc)
        address = fn.deploy()
        out = {"address": _address_port(address), "state": fn.status.state}
        stored = svc.db.get_function("echosrv", "dep", tag="latest")
        out["stored"] = (stored["status"]["address"] == address,
                         stored["status"]["state"],
                         stored["status"]["external_invocation_urls"]
                         == [address])
        out["invoke"] = fn.invoke("/v2/models/echo/infer",
                                  body={"inputs": [1, 2, 3]})["outputs"]
        row = _gateway_row(svc, "echosrv")
        out["row"] = (row["uid"], row["kind"])
        tree = _process_tree(_pid(row))
        fn.undeploy()
        stored = svc.db.get_function("echosrv", "dep", tag="latest")
        out["after"] = (_gateway_row(svc, "echosrv"),
                        stored["status"]["state"],
                        stored["status"]["address"], fn.status.state)
        return out, _left_after_sigterm(svc, tree)

    got = _both(services, scenario)
    assert got["port"][0] == got["jax"][0] == {
        "address": "http://127.0.0.1", "state": "ready",
        "stored": (True, "ready", True), "invoke": [3, 6, 9],
        "row": ("gateway-echosrv", "gateway"),
        "after": (None, "offline", "", "offline")}
    assert got["port"][1] is True


def test_deploy_function_via_project(services, tmp_path, monkeypatch):
    """project.deploy_function returns (fn, address)."""
    def scenario(svc):
        tops = TOPS[svc.pkg.name]
        if svc.pkg.name == "jax":
            monkeypatch.setattr(mlrun_tpu.config.mlconf, "dbpath", svc.url)
            from mlrun_tpu.db import get_run_db

            get_run_db(svc.url, force_reconnect=True)
        else:
            from mlrun_tpu_torch.db import set_run_db

            monkeypatch.setenv("MLT_DBPATH", svc.url)
            set_run_db(None)
        try:
            project = tops.top.get_or_create_project(
                "dep", context=str(tmp_path / svc.pkg.name))
            fn = _serving_fn("projsrv", svc)
            project.set_function(fn)
            deployed, address = project.deploy_function(fn)
            answer = deployed.invoke("/v2/models/echo/infer",
                                     body={"inputs": [5]})["outputs"]
            deployed.undeploy()
            return (deployed is fn, _address_port(address), answer,
                    deployed.status.state)
        finally:
            if svc.pkg.name == "jax":
                from mlrun_tpu.db import get_run_db

                get_run_db("", force_reconnect=True)
            else:
                monkeypatch.delenv("MLT_DBPATH")
                set_run_db(None)

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == (True, "http://127.0.0.1", [15],
                                         "offline")


def test_gateway_death_flips_function_state(services):
    """kill -9 the gateway: the monitor marks the function error, clears
    the address and drops the gateway's runtime resource."""
    def scenario(svc):
        fn = _serving_fn("deadsrv", svc)
        fn.deploy()
        row = _gateway_row(svc, "deadsrv")
        os.kill(_pid(row), signal.SIGKILL)
        deadline = time.time() + 10
        while time.time() < deadline:
            svc.state.deployments.monitor()
            stored = svc.db.get_function("deadsrv", "dep", tag="latest")
            if stored["status"]["state"] == "error":
                break
            time.sleep(0.2)
        return (stored["status"]["state"], stored["status"]["address"],
                stored["status"]["external_invocation_urls"],
                _gateway_row(svc, "deadsrv"))

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == ("error", "", [], None)


def test_deploy_failure_surfaces_log_tail(services, monkeypatch):
    """A gateway that cannot start (no graph) fails the deploy with the
    reason instead of hanging or marking it ready; no gateway is left."""
    from mlrun_tpu.config import mlconf

    monkeypatch.setattr(mlconf.function, "gateway_ready_timeout", 15.0)
    monkeypatch.setitem(SERVICE_DEFAULTS["function"],
                        "gateway_ready_timeout", 15.0)

    def scenario(svc):
        tops = TOPS[svc.pkg.name]
        fn = tops.top.new_function("brokensrv", project="dep",
                                   kind="serving")
        fn._db = svc.db
        with pytest.raises((RuntimeError, svc.pkg.base.RunDBError),
                           match="deploy failed") as err:
            fn.deploy()
        stored = svc.db.get_function("brokensrv", "dep", tag="latest")
        return (type(err.value).__name__,
                "gateway did not become ready" in str(err.value),
                "SERVING_SPEC_ENV" in str(err.value)
                or "graph" in str(err.value).lower(),
                _gateway_row(svc, "brokensrv"),
                (stored["status"]["state"], stored["status"]["address"]))

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == ("RunDBError", True, True, None,
                                         ("error", ""))


def test_monitor_promotes_recovered_gateway(services):
    """A deploy that gave up waiting (``unhealthy``) is promoted back to
    ready by the monitor once its resource runs."""
    def scenario(svc):
        tops = TOPS[svc.pkg.name]
        fn = _serving_fn("slowsrv", svc)
        fn.deploy()
        stored = svc.db.get_function("slowsrv", "dep", tag="latest")
        address = stored["status"]["address"]
        before = stored["status"]["state"]
        tops.utils.update_in(stored, "status.state", "unhealthy")
        tops.utils.update_in(stored, "status.external_invocation_urls", [])
        svc.db.store_function(stored, "slowsrv", "dep", tag="latest")
        svc.state.deployments.monitor()
        stored = svc.db.get_function("slowsrv", "dep", tag="latest")
        fn.undeploy()
        return (before, stored["status"]["state"],
                stored["status"]["external_invocation_urls"] == [address])

    got = _both(services, scenario)
    assert got["port"] == got["jax"] == ("ready", "ready", True)


# -- the delete route tears the gateway down ---------------------------------

def test_deleting_a_deployed_function_leaves_no_process(services):
    """DELETE of a deployed function stops its gateway's process tree and
    drops the runtime resource before the function record goes."""
    def scenario(svc):
        fn = _serving_fn("delsrv", svc)
        fn.deploy()
        tree = _process_tree(_pid(_gateway_row(svc, "delsrv")))
        svc.db.delete_function("delsrv", "dep")
        with pytest.raises(svc.pkg.base.RunDBError, match="404"):
            svc.db.get_function("delsrv", "dep", tag="latest")
        return _gateway_row(svc, "delsrv"), _left_after_sigterm(svc, tree)

    got = _both(services, scenario)
    assert got["port"] == (None, True) and got["jax"] == (None, None)


# -- a tiny paged LLM route, deployed ----------------------------------------

LLM_CODE = """
import dataclasses

import torch

from mlrun_tpu_torch.frameworks import huggingface as hf
from mlrun_tpu_torch.serving.llm import LLMModelServer

_load = hf.load_hf_weights_into_llama


def _float32(path, device=None, **kwargs):
    config, params = _load(path, dtype=torch.float32, device=device)
    return dataclasses.replace(config, dtype=torch.float32), params


hf.load_hf_weights_into_llama = _float32
"""


def test_deployed_paged_llm_route_matches_reference_tokens(services,
                                                           tmp_path,
                                                           monkeypatch):
    """The port deploys a graph whose route is a tiny paged
    LLMModelServer on an HF checkpoint loaded in float32 (on the CPU);
    over HTTP it answers the greedy tokens the reference's graph server
    gives on the same checkpoint, a prefix-hit rerun included."""
    import numpy as np

    from mlrun_tpu.serving.llm import LLMModelServer as JServer
    from tests.test_torch_graph import REF, _server
    from tests.test_torch_hf import _float32_loaders, _hf_model, _save

    directory = _save(_hf_model(), str(tmp_path / "ckpt"), "single")
    common = dict(hf_model=directory, continuous_batching=True, paged=True,
                  slots=2, max_len=64, page_size=8, max_new_tokens=5,
                  warmup=False)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 128, n).tolist() for n in (20, 9)]

    svc = services["port"]
    fn = mlrun_tpu_torch.new_function("llmsrv", project="dep",
                                      kind="serving")
    fn.spec.build.functionSourceCode = base64.b64encode(
        LLM_CODE.encode()).decode()
    fn.set_topology("router")
    fn.add_model("llm", class_name="LLMModelServer", device="cpu",
                 **common)
    fn._db = svc.db
    fn.deploy()
    try:
        got = [fn.invoke("/v2/models/llm/infer",
                         body={"inputs": batch})["outputs"]
               for batch in (prompts, prompts[:1])]
    finally:
        fn.undeploy()

    _float32_loaders(monkeypatch)
    ref = mlrun_tpu.new_function("llmsrv", project="dep", kind="serving")
    ref.set_topology("router")
    ref.add_model("llm", class_name="LLMModelServer", **common)
    server = _server(REF, ref._get_serving_spec(),
                     {"LLMModelServer": JServer})
    try:
        want = [server.test("/v2/models/llm/infer",
                            body={"inputs": batch})["outputs"]
                for batch in (prompts, prompts[:1])]
    finally:
        server.graph.steps["router"].routes["llm"]._object.engine.stop()
    assert got == want
    assert [len(t) for t in got[0]] == [5, 5] and got[1][0] == got[0][0]


# -- the deploy cases of tests/test_k8s_provider.py ---------------------------

@pytest.fixture(params=list(PKGS))
def k8s(request, monkeypatch, tmp_path):
    """A fake cluster, the package's KubernetesProvider, run db and
    deployment manager; ``ready_timeout(s)`` sets the package's
    ``function.gateway_ready_timeout``."""
    from mlrun_tpu.config import mlconf

    from . import fake_k8s

    pkg = PKGS[request.param]
    monkeypatch.setattr(fake_k8s, "chaos_fire", pkg.chaos.fire)
    cluster = fake_k8s.install(monkeypatch)
    provider = pkg.handlers.KubernetesProvider(namespace="testns")
    db = pkg.sqlitedb.SQLiteRunDB(dsn=str(tmp_path / "svc.db"),
                                  logs_dir=str(tmp_path / "logs"))

    def ready_timeout(seconds):
        if pkg.name == "jax":
            monkeypatch.setattr(mlconf.function, "gateway_ready_timeout",
                                seconds)
        else:
            monkeypatch.setitem(SERVICE_DEFAULTS["function"],
                                "gateway_ready_timeout", seconds)

    return types.SimpleNamespace(
        pkg=pkg, cluster=cluster, provider=provider, db=db,
        manager=pkg.deployments.DeploymentManager(db, provider),
        ready_timeout=ready_timeout,
        bootstrap=(["mlrun-tpu", "bootstrap"] if pkg.name == "jax" else
                   ["python3", "-m", "mlrun_tpu_torch", "bootstrap"]))


def _k8s_serving_fn(name="ksrv", requirements=None):
    return {
        "kind": "serving",
        "metadata": {"name": name, "project": "kp", "tag": "latest"},
        "spec": {"image": "img", "min_replicas": 1,
                 "build": {"functionSourceCode": base64.b64encode(
                     b"x = 1").decode(),
                     "requirements": requirements or []}},
    }


def _k8s_wait(predicate, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


def test_deployment_create_state_delete_with_service(k8s):
    manifest = {"apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": "mlt-gw-p1-fn"},
                "spec": {"template": {"spec": {"containers": []}}}}
    rid = k8s.provider.create(manifest, "gateway-fn")
    assert rid == "deployment/mlt-gw-p1-fn"
    assert k8s.provider.state(rid) == "Pending"
    k8s.cluster.set_deployment_status("mlt-gw-p1-fn", available=1)
    assert k8s.provider.state(rid) == "Running"
    k8s.cluster.set_deployment_status("mlt-gw-p1-fn", available=0,
                                      progressing=False)
    assert k8s.provider.state(rid) == "Failed"
    k8s.provider.delete(rid)
    assert k8s.cluster.deployments == {}
    k8s.provider.create(manifest, "gateway-fn")
    k8s.provider.create_service({"metadata": {"name": "mlt-gw-p1-fn"},
                                 "spec": {}})
    k8s.provider.delete(rid)
    assert k8s.cluster.services == {}


def test_k8s_deploy_ready(k8s):
    """A deploy on the kubernetes provider: Deployment + Service, the
    in-cluster address, project secrets through a Secret and envFrom, the
    port's own gateway command; teardown removes both."""
    k8s.ready_timeout(5)
    k8s.db.store_project_secrets("kp", {"TOK": "v"})
    function = _k8s_serving_fn()
    k8s.db.store_function(function, "ksrv", "kp", tag="latest")
    k8s.cluster.script_deployment("mlt-gw-kp-ksrv",
                                  [{"available": 0, "progressing": True},
                                   {"available": 1, "progressing": True}])
    info = k8s.manager.deploy(function)
    assert info["state"] == "ready"
    assert info["address"] == \
        "http://mlt-gw-kp-ksrv.mlrun-tpu.svc.cluster.local:8080"
    deployment = k8s.cluster.deployments["mlt-gw-kp-ksrv"]
    assert "mlt-gw-kp-ksrv" in k8s.cluster.services
    container = deployment["spec"]["template"]["spec"]["containers"][0]
    assert {"secretRef": {"name": "mlrun-tpu-secrets-kp"}} in \
        container["envFrom"]
    head = k8s.bootstrap[:-1]
    assert container["command"] == head + ["serve", "--port", "8080",
                                           "--host", "0.0.0.0"]
    assert {e["name"] for e in container["env"]} >= {
        "MLT_DBPATH", "MLT_CLUSTER_ROLE", "MLT_EXEC_CODE"}
    assert deployment["metadata"]["namespace"] == "mlrun-tpu"
    assert k8s.manager.teardown("ksrv", "kp")
    assert k8s.cluster.deployments == {} and k8s.cluster.services == {}


def test_k8s_deploy_requirements_bootstrap_and_timeout(k8s):
    """A gateway with requirements gets the bootstrap-wrapped command and
    the extended ready timeout."""
    import threading

    k8s.ready_timeout(0.2)
    function = _k8s_serving_fn(name="rsrv", requirements=["scipy"])
    k8s.db.store_function(function, "rsrv", "kp", tag="latest")
    start = time.monotonic()
    k8s.cluster.set_deployment_status("mlt-gw-kp-rsrv", available=0,
                                      progressing=True)
    result = {}
    thread = threading.Thread(
        target=lambda: result.update(info=k8s.manager.deploy(function)),
        daemon=True)
    thread.start()
    assert _k8s_wait(lambda: "mlt-gw-kp-rsrv" in k8s.cluster.deployments)
    container = k8s.cluster.deployments["mlt-gw-kp-rsrv"]["spec"][
        "template"]["spec"]["containers"][0]
    assert container["command"][:len(k8s.bootstrap)] == k8s.bootstrap
    assert "scipy" in container["command"]
    time.sleep(0.5)
    assert thread.is_alive(), \
        "requirements deploy gave up at the unextended timeout"
    k8s.cluster.set_deployment_status("mlt-gw-kp-rsrv", available=1)
    thread.join(timeout=10)
    assert result["info"]["state"] == "ready"
    assert time.monotonic() - start < 60


def test_k8s_deploy_unhealthy_then_monitor_promotes(k8s):
    k8s.ready_timeout(0.3)
    function = _k8s_serving_fn(name="usrv")
    k8s.db.store_function(function, "usrv", "kp", tag="latest")
    k8s.cluster.set_deployment_status("mlt-gw-kp-usrv", available=0,
                                      progressing=True)
    info = k8s.manager.deploy(function)
    assert info["state"] == "unhealthy"
    assert info["address"].startswith("http://mlt-gw-kp-usrv")
    assert k8s.db.get_function("usrv", "kp", tag="latest")["status"][
        "state"] == "unhealthy"
    k8s.cluster.set_deployment_status("mlt-gw-kp-usrv", available=1)
    k8s.manager.monitor()
    stored = k8s.db.get_function("usrv", "kp", tag="latest")
    assert stored["status"]["state"] == "ready"
    assert stored["status"]["external_invocation_urls"] == [info["address"]]


def test_k8s_monitor_cleans_up_dead_gateway(k8s):
    k8s.ready_timeout(5)
    function = _k8s_serving_fn(name="dsrv")
    k8s.db.store_function(function, "dsrv", "kp", tag="latest")
    k8s.cluster.script_deployment("mlt-gw-kp-dsrv", [{"available": 1}])
    assert k8s.manager.deploy(function)["state"] == "ready"
    k8s.cluster.set_deployment_status("mlt-gw-kp-dsrv", available=0,
                                      progressing=False)
    k8s.manager.monitor()
    stored = k8s.db.get_function("dsrv", "kp", tag="latest")
    assert stored["status"]["state"] == "error"
    assert stored["status"]["address"] == ""
    assert "mlt-gw-kp-dsrv" not in k8s.cluster.deployments
    assert k8s.db.list_runtime_resources(kind="gateway") == []


def test_k8s_deploy_create_conflict_is_error_state(k8s):
    k8s.ready_timeout(1)
    k8s.cluster.deployments["mlt-gw-kp-csrv"] = {"metadata": {
        "name": "mlt-gw-kp-csrv"}}
    function = _k8s_serving_fn(name="csrv")
    k8s.db.store_function(function, "csrv", "kp", tag="latest")
    info = k8s.manager.deploy(function)
    assert info["state"] == "error"
    assert "exists" in info["error"]
