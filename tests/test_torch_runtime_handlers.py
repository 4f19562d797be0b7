"""mlrun_tpu_torch's run monitor (service/runtime_handlers.py), its
providers (service/providers.py) and the server-side launcher's recovery
against mlrun_tpu's.

Every case runs on both packages with the same inputs and asserts the
reference's contract on each: the handler cases of
``tests/test_fault_tolerance.py`` (a chaos-killed ``tpujob`` resumes from
its checkpoint, a user-code failure is not resubmitted, an exhausted
budget fails terminally, backoff defers, a stall escalates per policy, a
healthy heartbeat is left alone, a resubmission survives a service
restart, the stall clock restarts with the replacement, a probe blip is
not a death, ``on_stall`` resubmits regardless of ``retry_on``, a GC'd
completed run keeps its state), the provider and handler cases of
``tests/test_k8s_provider.py`` (pod, JobSet, Service, project secret,
the job handler's lifecycle and pod failure, the ``tpujob`` handler's
JobSet), over ``tests/fake_k8s.py``, and the four cases of
``tests/test_runtime_recovery.py`` over each package's live service.

The fake cluster fires its ``k8s.*`` chaos points through the module's
``chaos_fire``; a port case points it at the port's own registry. Where
the packages differ by design the port's side is asserted too: its
JobSet runs torchrun over ``python3 -m mlrun_tpu_torch run --from-env``
sized in GPUs, and a resubmitted JobSet's torchrun rendezvous
(``MASTER_ADDR``) follows the new name, as the reference rewrites its
MEGASCALE coordinator's address.
"""

import base64
import sys
import time
import types
from datetime import datetime, timedelta, timezone

import pytest

import mlrun_tpu
import mlrun_tpu_torch
from mlrun_tpu import chaos as jchaos
from mlrun_tpu.common import retry as jretry
from mlrun_tpu.db import sqlitedb as jsqlitedb
from mlrun_tpu.model import RunObject as JRunObject
from mlrun_tpu.service import app as japp
from mlrun_tpu.service import runtime_handlers as jhandlers
from mlrun_tpu_torch import chaos as tchaos
from mlrun_tpu_torch.common import retry as tretry
from mlrun_tpu_torch.db import sqlitedb as tsqlitedb
from mlrun_tpu_torch.model import RunObject as TRunObject
from mlrun_tpu_torch.service import app as tapp
from mlrun_tpu_torch.service import runtime_handlers as thandlers

from . import fake_k8s
from tests.torch_registries import registries_left_as_found  # noqa: F401
from tests.torch_service import PKGS as SERVICE_PKGS
from tests.torch_service import Service

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", top=mlrun_tpu, chaos=jchaos, retry=jretry,
        sqlitedb=jsqlitedb, RunObject=JRunObject, handlers=jhandlers,
        app=japp, bootstrap=["mlrun-tpu", "bootstrap"]),
    "port": types.SimpleNamespace(
        name="port", top=mlrun_tpu_torch, chaos=tchaos, retry=tretry,
        sqlitedb=tsqlitedb, RunObject=TRunObject, handlers=thandlers,
        app=tapp,
        bootstrap=["python3", "-m", "mlrun_tpu_torch", "bootstrap"]),
}


@pytest.fixture(autouse=True)
def _chaos_dark():
    for pkg in PKGS.values():
        pkg.chaos.chaos.clear()
    yield
    for pkg in PKGS.values():
        pkg.chaos.chaos.clear()


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def cluster(pkg, monkeypatch):
    """A fresh fake cluster whose ``k8s.*`` points fire in ``pkg``'s
    chaos registry."""
    monkeypatch.setattr(fake_k8s, "chaos_fire", pkg.chaos.fire)
    return fake_k8s.install(monkeypatch)


@pytest.fixture()
def db(pkg, tmp_path):
    return pkg.sqlitedb.SQLiteRunDB(dsn=str(tmp_path / "ft.db"),
                                    logs_dir=str(tmp_path / "logs"))


@pytest.fixture()
def provider(pkg, cluster):
    return pkg.handlers.KubernetesProvider(namespace="testns")


@pytest.fixture()
def handler(pkg, db, provider):
    return pkg.handlers.TpuJobHandler(db, provider)


def _tpujob(pkg, name="train", project="p1"):
    fn = pkg.top.new_function(name, kind="tpujob", project=project)
    if pkg.name == "jax":
        fn.with_tpu_topology("tpu-v5-lite-podslice", "2x4")
    else:
        fn.with_gpus(nodes=2, gpus_per_node=4)
    return fn


def _launch(pkg, handler, db, uid="abcd1234efgh", retry_policy=None):
    fn = _tpujob(pkg)
    run = pkg.RunObject()
    run.metadata.uid = uid
    run.metadata.name = "train"
    run.metadata.project = "p1"
    if retry_policy:
        run.spec.retry_policy = retry_policy
    db.store_run(run.to_dict(), uid, "p1")
    handler.run(fn, run)
    return f"train-{uid[:8]}"


def _pod_spec(cluster, name):
    return cluster.jobsets[name]["spec"]["replicatedJobs"][0]["template"][
        "spec"]["template"]["spec"]


def _jobset_env(cluster, name):
    containers = _pod_spec(cluster, name)["containers"]
    return {e["name"]: e.get("value") for e in containers[0]["env"]}


def _age_resource(handler, uid, seconds):
    rid, project, started = handler._resources[uid]
    handler._resources[uid] = (rid, project, started - seconds)


# -- tests/test_fault_tolerance.py: the handler cases -------------------------

def test_chaos_killed_tpujob_resumes_from_checkpoint(pkg, handler, cluster,
                                                     db):
    name = _launch(pkg, handler, db,
                   retry_policy={"max_retries": 2, "backoff": 0})
    assert name in cluster.jobsets
    db.update_run({"status.checkpoint": {"path": "/ckpts/train",
                                         "step": 420}},
                  "abcd1234efgh", "p1")
    with pkg.chaos.chaos.inject(
            "k8s.read", pkg.chaos.fail_nth(1),
            action=lambda point, ctx: cluster.kill_jobset(name)):
        handler.monitor_runs()
    run = db.read_run("abcd1234efgh", "p1")
    assert run["status"]["retry_count"] == 1
    assert run["status"]["state"] == "running"
    assert run["status"]["failure_class"] == \
        pkg.retry.FailureClass.resource_vanished
    replacement = f"{name}-r1"
    assert replacement in cluster.jobsets
    env = _jobset_env(cluster, replacement)
    assert env["MLT_RESUME_FROM_CHECKPOINT"] == "/ckpts/train"
    assert env["MLT_RESUME_STEP"] == "420"
    assert _pod_spec(cluster, replacement)["subdomain"] == replacement
    if pkg.name == "port":
        # torchrun's rendezvous: pod 0 of the renamed JobSet's first Job
        assert env["MASTER_ADDR"] == \
            f"{replacement}-slice-0-0.{replacement}"
        assert env["NNODES"] == "2" and env["NPROC_PER_NODE"] == "4"
    assert handler._resources["abcd1234efgh"][0] == f"jobset/{replacement}"


def test_user_code_failure_is_not_resubmitted(pkg, handler, cluster, db):
    name = _launch(pkg, handler, db, uid="feed5678cafe",
                   retry_policy={"max_retries": 2, "backoff": 0})
    db.update_run({"status.state": "error",
                   "status.error": "Traceback ...\nValueError: user bug"},
                  "feed5678cafe", "p1")
    cluster.set_jobset_conditions(
        name, [{"type": "Failed", "status": "True"}])
    handler.monitor_runs()
    run = db.read_run("feed5678cafe", "p1")
    assert run["status"]["state"] == "error"
    assert run["status"].get("retry_count", 0) == 0
    assert run["status"]["failure_class"] == \
        pkg.retry.FailureClass.user_code
    assert f"{name}-r1" not in cluster.jobsets
    assert "feed5678cafe" not in handler._resources


def test_exhausted_retries_fail_terminally(pkg, handler, cluster, db):
    name = _launch(pkg, handler, db, uid="0123beef4567",
                   retry_policy={"max_retries": 1, "backoff": 0})
    cluster.kill_jobset(name)
    handler.monitor_runs()
    assert db.read_run("0123beef4567", "p1")["status"]["retry_count"] == 1
    cluster.kill_jobset(f"{name}-r1")
    handler.monitor_runs()
    run = db.read_run("0123beef4567", "p1")
    assert run["status"]["state"] == "error"
    assert run["status"]["retry_count"] == 1
    assert f"{name}-r1-r2" not in cluster.jobsets


def test_backoff_defers_resubmission(pkg, handler, cluster, db):
    name = _launch(pkg, handler, db, uid="aaaa1111bbbb",
                   retry_policy={"max_retries": 1, "backoff": 30.0,
                                 "jitter": 0.0})
    cluster.kill_jobset(name)
    handler.monitor_runs()
    run = db.read_run("aaaa1111bbbb", "p1")
    assert run["status"]["state"] == "pending"
    assert "retry 1/1" in run["status"]["status_text"]
    assert run["status"].get("retry_count", 0) == 0
    assert f"{name}-r1" not in cluster.jobsets
    handler.monitor_runs()
    assert f"{name}-r1" not in cluster.jobsets
    handler._retry_at["aaaa1111bbbb"] = time.time() - 1
    handler.monitor_runs()
    assert f"{name}-r1" in cluster.jobsets
    assert db.read_run("aaaa1111bbbb", "p1")["status"]["retry_count"] == 1


def test_stalled_run_is_escalated_per_policy(pkg, handler, cluster, db):
    stale = (datetime.now(timezone.utc) - timedelta(seconds=60)).isoformat()
    name = _launch(pkg, handler, db, uid="dddd2222eeee",
                   retry_policy={"max_retries": 1, "backoff": 0,
                                 "stall_timeout": 5.0,
                                 "on_stall": "resubmit"})
    db.update_run({"status.last_heartbeat": stale}, "dddd2222eeee", "p1")
    _age_resource(handler, "dddd2222eeee", 60)
    handler.monitor_runs()
    run = db.read_run("dddd2222eeee", "p1")
    assert run["status"]["retry_count"] == 1
    assert run["status"]["failure_class"] == pkg.retry.FailureClass.stalled
    assert f"{name}-r1" in cluster.jobsets
    assert name not in cluster.jobsets

    name2 = _launch(pkg, handler, db, uid="9999ffff0000",
                    retry_policy={"stall_timeout": 5.0, "on_stall": "abort"})
    db.update_run({"status.last_heartbeat": stale}, "9999ffff0000", "p1")
    _age_resource(handler, "9999ffff0000", 60)
    handler.monitor_runs()
    run = db.read_run("9999ffff0000", "p1")
    assert run["status"]["state"] == "aborted"
    assert run["status"]["failure_class"] == pkg.retry.FailureClass.stalled
    assert run["status"]["status_text"].startswith("stalled")
    assert name2 not in cluster.jobsets


def test_healthy_heartbeat_is_not_stalled(pkg, handler, cluster, db):
    _launch(pkg, handler, db, uid="121234345656",
            retry_policy={"stall_timeout": 30.0, "on_stall": "abort"})
    db.update_run(
        {"status.last_heartbeat": datetime.now(timezone.utc).isoformat()},
        "121234345656", "p1")
    handler.monitor_runs()
    assert db.read_run("121234345656", "p1")["status"]["state"] == \
        "running"


def test_resubmission_survives_service_restart(pkg, provider, cluster, db):
    handler = pkg.handlers.TpuJobHandler(db, provider)
    fn = _tpujob(pkg)
    db.store_function(fn.to_dict(), "train", "p1", tag="latest")
    uid = "cafe0000dead"
    run = pkg.RunObject()
    run.metadata.uid = uid
    run.metadata.name = "train"
    run.metadata.project = "p1"
    run.spec.function = "p1/train:latest"
    run.spec.retry_policy = {"max_retries": 1, "backoff": 0}
    db.store_run(run.to_dict(), uid, "p1")
    handler.run(fn, run)
    name = f"train-{uid[:8]}"

    handler2 = pkg.handlers.TpuJobHandler(db, provider)
    handler2.recover_resources()
    assert uid in handler2._resources
    assert not handler2._manifests

    cluster.kill_jobset(name)
    handler2.monitor_runs()
    assert db.read_run(uid, "p1")["status"]["retry_count"] == 1
    assert f"{name}-r1" in cluster.jobsets
    if pkg.name == "port":
        # rebuilt from the stored function: the same GPU JobSet
        env = _jobset_env(cluster, f"{name}-r1")
        assert env["MASTER_ADDR"] == f"{name}-r1-slice-0-0.{name}-r1"
        assert env["NPROC_PER_NODE"] == "4"


def test_stall_clock_resets_after_resubmission(pkg, handler, cluster, db):
    stale = (datetime.now(timezone.utc) - timedelta(seconds=60)).isoformat()
    name = _launch(pkg, handler, db, uid="5151aaaa6262",
                   retry_policy={"max_retries": 3, "backoff": 0,
                                 "stall_timeout": 5.0,
                                 "on_stall": "resubmit"})
    db.update_run({"status.last_heartbeat": stale}, "5151aaaa6262", "p1")
    _age_resource(handler, "5151aaaa6262", 60)
    handler.monitor_runs()
    assert db.read_run("5151aaaa6262", "p1")["status"]["retry_count"] == 1
    handler.monitor_runs()
    handler.monitor_runs()
    run = db.read_run("5151aaaa6262", "p1")
    assert run["status"]["retry_count"] == 1
    assert run["status"]["state"] == "running"
    assert f"{name}-r1" in cluster.jobsets
    assert f"{name}-r1-r2" not in cluster.jobsets


def test_transient_probe_blip_does_not_resubmit(pkg, handler, cluster, db):
    name = _launch(pkg, handler, db, uid="bbbb7777cccc",
                   retry_policy={"max_retries": 2, "backoff": 0})
    with pkg.chaos.chaos.inject("k8s.read", pkg.chaos.fail_nth(1),
                                error=RuntimeError("apiserver timeout")):
        handler.monitor_runs()
    run = db.read_run("bbbb7777cccc", "p1")
    assert run["status"]["state"] == "running"
    assert run["status"].get("retry_count", 0) == 0
    assert f"{name}-r1" not in cluster.jobsets
    handler.monitor_runs()
    assert not handler._probe_failures
    with pkg.chaos.chaos.inject("k8s.read", pkg.chaos.fail_first(2),
                                error=RuntimeError("apiserver down")):
        handler.monitor_runs()
        handler.monitor_runs()
    assert db.read_run("bbbb7777cccc", "p1")["status"]["retry_count"] == 1
    assert f"{name}-r1" in cluster.jobsets


def test_on_stall_resubmit_not_gated_by_retry_on(pkg, handler, cluster, db):
    stale = (datetime.now(timezone.utc) - timedelta(seconds=60)).isoformat()
    name = _launch(pkg, handler, db, uid="3434dddd5656",
                   retry_policy={"max_retries": 1, "backoff": 0,
                                 "retry_on": ["preemption"],
                                 "stall_timeout": 5.0,
                                 "on_stall": "resubmit"})
    db.update_run({"status.last_heartbeat": stale}, "3434dddd5656", "p1")
    _age_resource(handler, "3434dddd5656", 60)
    handler.monitor_runs()
    assert db.read_run("3434dddd5656", "p1")["status"]["retry_count"] == 1
    assert f"{name}-r1" in cluster.jobsets


def test_completed_run_with_gcd_resource_not_mislabeled(pkg, handler,
                                                        cluster, db):
    name = _launch(pkg, handler, db, uid="7878eeee9090")
    db.update_run({"status.state": "completed"}, "7878eeee9090", "p1")
    cluster.kill_jobset(name)
    handler.monitor_runs()
    run = db.read_run("7878eeee9090", "p1")
    assert run["status"]["state"] == "completed"
    assert run["status"].get("failure_class") is None


@pytest.mark.parametrize("kwargs,expected", [
    ({"run_reported_terminal": True, "probe_error": "404"}, "user_code"),
    ({"probe_error": "pod evicted (spot)"}, "preemption"),
    ({"run_error": "slice 1 preempted"}, "slice_preempted"),
    ({"reason": "ImagePullBackOff"}, "image_pull_backoff"),
    ({"probe_error": "502 bad gateway"}, "http_5xx"),
    ({"probe_error": "not found"}, "resource_vanished"),
    ({}, "infra"),
])
def test_failure_classes_and_policies_match(kwargs, expected):
    """The classifier and the resolved policy (config defaults overlaid by
    a run's spec) are the reference's."""
    out = [(p.retry.classify_failure(**kwargs),
            p.retry.resolve_retry_policy({"max_retries": 2,
                                          "retry_on": ["infra"]}))
           for p in PKGS.values()]
    assert out[0][0] == out[1][0] == expected
    assert vars(out[0][1]) == vars(out[1][1])
    assert out[1][1].retries_left(1) and not out[1][1].retries_left(2)


# -- tests/test_k8s_provider.py: the 14b cases --------------------------------

def _pod_manifest(name="run-pod", uid="u1", project="p1"):
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "labels": {
            "mlrun-tpu/project": project, "mlrun-tpu/uid": uid,
            "mlrun-tpu/class": "job"}},
        "spec": {"containers": [{"name": "base", "image": "x"}]},
    }


def test_pod_create_state_delete(provider, cluster):
    rid = provider.create(_pod_manifest(), "u1")
    assert rid == "pod/run-pod"
    assert provider.state(rid) == "Pending"
    cluster.set_pod_phase("run-pod", "Running")
    assert provider.state(rid) == "Running"
    cluster.set_pod_phase("run-pod", "Succeeded")
    assert provider.state(rid) == "Succeeded"
    provider.delete(rid)
    assert cluster.pods == {}
    with pytest.raises(Exception):
        provider.delete(rid)


def test_duplicate_pod_create_raises(provider, cluster):
    provider.create(_pod_manifest(), "u1")
    with pytest.raises(Exception, match="exists"):
        provider.create(_pod_manifest(), "u1")


def test_jobset_create_state_delete(provider, cluster):
    manifest = {
        "apiVersion": "jobset.x-k8s.io/v1alpha2", "kind": "JobSet",
        "metadata": {"name": "train-js", "labels": {
            "mlrun-tpu/uid": "u2", "mlrun-tpu/project": "p1",
            "mlrun-tpu/class": "tpujob"}},
        "spec": {"replicatedJobs": []},
    }
    rid = provider.create(manifest, "u2")
    assert rid == "jobset/train-js"
    assert provider.state(rid) == "Running"
    for conditions, phase in (("Suspended", "Pending"),
                              ("Completed", "Succeeded"),
                              ("Failed", "Failed")):
        cluster.set_jobset_conditions(
            "train-js", [{"type": conditions, "status": "True"}])
        assert provider.state(rid) == phase
    assert provider.list_resources("tpujob") == [("jobset/train-js", "u2",
                                                  "p1")]
    provider.delete(rid)
    assert cluster.jobsets == {}


def test_create_service_create_then_replace(provider, cluster):
    manifest = {"metadata": {"name": "svc-a"}, "spec": {"ports": [1]}}
    assert provider.create_service(manifest) == "svc-a"
    assert ("create", "service", "svc-a") in cluster.events
    manifest2 = {"metadata": {"name": "svc-a"}, "spec": {"ports": [2]}}
    assert provider.create_service(manifest2) == "svc-a"
    assert ("replace", "service", "svc-a") in cluster.events
    assert cluster.services["svc-a"]["spec"]["ports"] == [2]


def test_ensure_project_secret_roundtrip(provider, cluster):
    name = provider.ensure_project_secret("p1", {"TOKEN": "s3cret",
                                                 "N": 7})
    assert name == "mlrun-tpu-secrets-p1"
    assert fake_k8s.decode_secret(cluster, name) == {"TOKEN": "s3cret",
                                                     "N": "7"}
    assert cluster.secrets[name]["labels"] == {"mlrun-tpu/project": "p1"}
    provider.ensure_project_secret("p1", {"TOKEN": "rotated"})
    assert fake_k8s.decode_secret(cluster, name) == {"TOKEN": "rotated"}
    assert ("replace", "secret", name) in cluster.events
    provider.delete_project_secret("p1")
    assert cluster.secrets == {}
    provider.delete_project_secret("p1")


def test_slice_status_and_replace_slice(pkg, provider, cluster):
    """Per-slice health of a live multi-slice JobSet and the replacement
    of one failed slice with the resume env upserted first."""
    fn = _tpujob(pkg)
    fn.spec.num_slices = 2
    if hasattr(fn, "with_elastic"):
        fn.with_elastic()
    run = pkg.RunObject()
    run.metadata.uid, run.metadata.name = "e1e2e3e4e5e6", "train"
    run.metadata.project = "p1"
    rid = provider.create(fn.generate_jobset(run), run.metadata.uid)
    name = rid.split("/", 1)[1]
    cluster.fail_slice(name, 1)
    status = provider.slice_status(rid)
    assert status["failed_slices"] == [1] and status["replicas"] == 2
    child = provider.replace_slice(rid, 1, extra_env={
        "MLT_RESUME_STEP": "7"})
    assert child == f"{name}-slice-1"
    assert _jobset_env(cluster, name)["MLT_RESUME_STEP"] == "7"
    with pytest.raises(ValueError, match="only applies to JobSets"):
        provider.replace_slice("pod/x", 0)
    assert provider.slice_status("pod/x") == {}


def _runtime(pkg, requirements=None):
    fn = pkg.top.new_function("kfn", project="kp", kind="job", image="img")
    if requirements:
        fn.with_requirements(requirements)
    return fn


def _run_obj(pkg, uid="abc12345def", name="kfn", project="kp"):
    run = pkg.RunObject()
    run.metadata.uid = uid
    run.metadata.name = name
    run.metadata.project = project
    return run


def _pending(db, uid, name="kfn"):
    db.store_run({"metadata": {"name": name, "uid": uid, "project": "kp"},
                  "status": {"state": "pending"}}, uid, "kp")


def test_job_handler_full_lifecycle(pkg, provider, cluster, db):
    db.store_project_secrets("kp", {"API_KEY": "xyz"})
    run = _run_obj(pkg)
    _pending(db, run.metadata.uid)
    handler = pkg.handlers.get_runtime_handler("job", db, provider)
    rid = handler.run(_runtime(pkg, requirements=["scipy"]),
                      run)["resource_id"]
    assert rid.startswith("pod/")
    pod_name = rid.split("/", 1)[1]
    pod = cluster.pods[pod_name]
    cmd = pod["spec"]["containers"][0]["command"]
    assert cmd[:len(pkg.bootstrap)] == pkg.bootstrap and "scipy" in cmd
    assert {"secretRef": {"name": "mlrun-tpu-secrets-kp"}} in \
        pod["spec"]["containers"][0].get("envFrom", [])
    assert "xyz" not in str(pod)
    assert fake_k8s.decode_secret(
        cluster, "mlrun-tpu-secrets-kp")["MLT_SECRET_API_KEY"] == "xyz"
    assert db.list_runtime_resources(kind="job")
    cluster.set_pod_phase(pod_name, "Succeeded")
    handler.monitor_runs()
    assert db.read_run(run.metadata.uid, "kp")["status"]["state"] == \
        "completed"
    assert db.list_runtime_resources(kind="job") == []


def test_job_handler_pod_failure_marks_error(pkg, provider, cluster, db):
    run = _run_obj(pkg, uid="feed0000beef")
    _pending(db, run.metadata.uid)
    handler = pkg.handlers.get_runtime_handler("job", db, provider)
    rid = handler.run(_runtime(pkg), run)["resource_id"]
    cluster.set_pod_phase(rid.split("/", 1)[1], "Failed")
    handler.monitor_runs()
    stored = db.read_run(run.metadata.uid, "kp")
    assert stored["status"]["state"] == "error"
    assert stored["status"]["error"] == "execution resource failed"
    assert stored["status"]["failure_class"] == "infra"


def test_tpujob_handler_creates_jobset(pkg, provider, cluster, db):
    fn = pkg.top.new_function("tj", project="kp", kind="tpujob",
                              image="img")
    run = _run_obj(pkg, uid="a0b1c2d3e4f5", name="tj")
    _pending(db, run.metadata.uid, name="tj")
    handler = pkg.handlers.get_runtime_handler("tpujob", db, provider)
    rid = handler.run(fn, run)["resource_id"]
    assert rid.startswith("jobset/")
    name = rid.split("/", 1)[1]
    assert name in cluster.jobsets
    main = _pod_spec(cluster, name)["containers"][0]
    env = _jobset_env(cluster, name)
    assert env["MLT_DBPATH"].startswith("http://127.0.0.1:")
    if pkg.name == "port":
        # torchrun over the port's CLI, sized in GPUs (one 8-GPU node)
        assert main["command"][0] == "/bin/sh" and "torchrun" in \
            main["command"][2]
        assert main["args"] == ["python3", "-m", "mlrun_tpu_torch", "run",
                                "--from-env"]
        assert main["resources"]["limits"]["nvidia.com/gpu"] == 8
        assert _pod_spec(cluster, name)["nodeSelector"][
            "nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
        assert env["MASTER_ADDR"] == f"{name}-slice-0-0.{name}"
    cluster.set_jobset_conditions(
        name, [{"type": "Completed", "status": "True"}])
    handler.monitor_runs()
    assert db.read_run(run.metadata.uid, "kp")["status"]["state"] == \
        "completed"
    assert db.list_runtime_resources(kind="tpujob") == []
    assert name in cluster.jobsets


def test_dask_and_spark_handlers_are_part_14c(provider, cluster, db):
    """The dask and spark handlers exist (a restarted service adopts their
    resources) and building their resources raises item 14."""
    for kind in ("dask", "spark"):
        handler = thandlers.get_runtime_handler(kind, db, provider)
        with pytest.raises(NotImplementedError, match="item 14"):
            handler.build_resource(None, _run_obj(PKGS["port"]))


# -- tests/test_runtime_recovery.py -------------------------------------------

@pytest.fixture()
def service(pkg, tmp_path, monkeypatch):
    svc = Service(SERVICE_PKGS[pkg.name], tmp_path, monkeypatch)
    monkeypatch.setenv("MLT_DBPATH", svc.url)
    yield svc
    svc.stop()


def _submit(db, code: str, task_extra: dict | None = None,
            name: str = "fn"):
    function = {
        "kind": "job",
        "metadata": {"name": name, "project": "rec", "tag": "latest"},
        "spec": {"image": "x", "default_handler": "handler",
                 "build": {"functionSourceCode":
                           base64.b64encode(code.encode()).decode()}},
    }
    task = {"metadata": {"name": name, "project": "rec"},
            "spec": {"handler": "handler", **(task_extra or {})}}
    return db.submit_job({"function": function,
                          "task": task})["data"]["metadata"]["uid"]


def _wait_terminal(read, timeout=60, tick=None):
    deadline = time.monotonic() + timeout
    run = None
    while time.monotonic() < deadline:
        if tick:
            tick()
        run = read()
        if run and run["status"].get("state") in ("completed", "error",
                                                  "aborted"):
            return run
        time.sleep(0.2)
    return run


def test_restarted_service_reaches_terminal_state(pkg, service):
    state = service.state
    uid = _submit(service.db, "import time\n"
                  "def handler(context):\n"
                  "    time.sleep(1)\n"
                  "    context.log_result('ok', 1)\n", name="restartfn")
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if state.db.list_runtime_resources(kind="job"):
            break
        time.sleep(0.05)
    rows = state.db.list_runtime_resources(kind="job")
    assert rows and rows[0]["uid"] == uid
    state2 = pkg.app.ServiceState(db=state.db)
    assert uid in state2.launcher.handler_for("job")._resources
    run = _wait_terminal(lambda: service.db.read_run(uid, "rec"),
                         tick=state2.launcher.monitor_all)
    assert run["status"]["state"] == "completed", run["status"]
    assert run["status"]["results"]["ok"] == 1
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        state2.launcher.monitor_all()
        if state.db.list_runtime_resources(kind="job") == []:
            break
        time.sleep(0.1)
    assert state.db.list_runtime_resources(kind="job") == []


def test_recovered_dead_resource_marked_error(pkg, service):
    state = service.state
    uid = "deadbeef00000000"
    state.db.store_run(
        {"metadata": {"name": "ghost", "uid": uid, "project": "rec"},
         "status": {"state": "running"}}, uid, "rec")
    state.db.store_runtime_resource(uid, "rec", "job", "proc-4194305",
                                    time.time())
    state2 = pkg.app.ServiceState(db=state.db)
    state2.launcher.recover()
    state2.launcher.monitor_all()
    run = state.db.read_run(uid, "rec")
    assert run["status"]["state"] == "error"
    assert run["status"]["failure_class"] == "infra"
    assert state.db.list_runtime_resources() == []


def test_parallel_hyper_fanout_overlaps(pkg, service):
    uid = _submit(service.db, "import time\n"
                  "def handler(context, p=0):\n"
                  "    context.log_result('t0', time.time())\n"
                  "    time.sleep(1.0)\n"
                  "    context.log_result('t1', time.time())\n",
                  name="sweepfn",
                  task_extra={"hyperparams": {"p": [1, 2, 3, 4]},
                              "hyper_param_options": {"parallel_runs": 4}})
    run = _wait_terminal(lambda: service.db.read_run(uid, "rec"),
                         timeout=120)
    assert run["status"]["state"] == "completed", run["status"]
    iters = run["status"]["iterations"]
    assert len(iters) == 4
    spans = sorted((row["results"]["t0"], row["results"]["t1"])
                   for row in iters)
    overlaps = sum(1 for (a0, a1), (b0, b1) in zip(spans, spans[1:])
                   if b0 < a1)
    assert overlaps >= 2, f"iterations did not overlap: {spans}"


def test_kubernetes_provider_paginated_listing(pkg, monkeypatch):
    import sys

    class _Meta:
        def __init__(self, cont):
            self._continue = cont

    class _Pod:
        def __init__(self, name, uid):
            self.metadata = types.SimpleNamespace(
                name=name, labels={"mlrun-tpu/uid": uid,
                                   "mlrun-tpu/project": "p"})

    class _PodList:
        def __init__(self, items, cont):
            self.items = items
            self.metadata = _Meta(cont)

    pages = {None: _PodList([_Pod("pod-a", "u1")], "tok1"),
             "tok1": _PodList([_Pod("pod-b", "u2")], None)}
    calls = []

    class _Core:
        def list_namespaced_pod(self, ns, label_selector="", limit=0,
                                _continue=None):
            calls.append(_continue)
            return pages[_continue]

    class _Custom:
        def list_namespaced_custom_object(self, *a, **kw):
            return {"items": [{"metadata": {
                "name": "js1", "labels": {"mlrun-tpu/uid": "u3",
                                          "mlrun-tpu/project": "p"}}}],
                "metadata": {}}

    fake = types.ModuleType("kubernetes")
    fake.config = types.SimpleNamespace(
        load_incluster_config=lambda: None, load_kube_config=lambda: None)
    fake.client = types.SimpleNamespace(CoreV1Api=_Core,
                                        CustomObjectsApi=_Custom)
    monkeypatch.setitem(sys.modules, "kubernetes", fake)
    found = pkg.handlers.KubernetesProvider(namespace="ns").list_resources(
        "job")
    assert ("pod/pod-a", "u1", "p") in found
    assert ("pod/pod-b", "u2", "p") in found
    assert ("jobset/js1", "u3", "p") in found
    assert calls[:2] == [None, "tok1"]


# -- the port's local process provider ----------------------------------------

def _wait(predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


def test_local_provider_runs_a_jobset_pod_0_on_localhost(tmp_path):
    """A JobSet's container command runs as pod 0 of slice 0: its field
    references read 0 and torchrun's rendezvous is 127.0.0.1 on a free
    port; the output reaches the run's log."""
    from mlrun_tpu_torch.k8s.jobset import build_jobset

    db = tsqlitedb.SQLiteRunDB(str(tmp_path / "lp.sqlite"),
                               logs_dir=str(tmp_path / "logs"))
    provider = thandlers.LocalProcessProvider(db)
    jobset = build_jobset("lp-js", "ns", {"containers": [{
        "name": "main", "image": "x",
        "command": ["/bin/sh", "-c",
                    'echo "$MASTER_ADDR $MASTER_PORT $NODE_RANK '
                    '$MLT_SLICE_ID $NNODES"']}]},
        gpu_product="H100", nodes=1, gpus_per_node=1)
    main = jobset["spec"]["replicatedJobs"][0]["template"]["spec"][
        "template"]["spec"]["containers"][0]
    # the pod's own command, without the torchrun wrapper around it
    main["command"], main["args"] = main["args"][:3], []
    jobset["metadata"]["labels"]["mlrun-tpu/project"] = "lp"
    rid = provider.create(jobset, "lp-uid")
    assert _wait(lambda: provider.state(rid) == "Succeeded")
    assert _wait(lambda: db.get_log("lp-uid", "lp")[1])
    addr, port, node_rank, slice_id, nnodes = db.get_log(
        "lp-uid", "lp")[1].decode().split()
    assert (addr, node_rank, slice_id, nnodes) == ("127.0.0.1", "0", "0",
                                                   "1")
    assert int(port) > 0 and int(port) != 29500


def test_local_provider_delete_stops_the_whole_process_tree(tmp_path):
    """``delete`` stops the child and a grandchild in a session of its
    own (torchrun starts its workers so); ``state`` reads Failed after."""
    db = tsqlitedb.SQLiteRunDB(str(tmp_path / "lp.sqlite"),
                               logs_dir=str(tmp_path / "logs"))
    provider = thandlers.LocalProcessProvider(db)
    pidfile = tmp_path / "grandchild"
    code = ("import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(120)'], start_new_session=True)\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            "time.sleep(120)\n")
    rid = provider.create({"kind": "Pod", "metadata": {"name": "tree"},
                           "spec": {"containers": [{
                               "name": "main",
                               "command": [sys.executable, "-c", code]}]}},
                          "tree-uid")
    assert _wait(lambda: pidfile.exists() and pidfile.read_text())
    grandchild = int(pidfile.read_text())
    assert provider.state(rid) == "Running"
    child = provider._pid_of(rid)[0]
    provider.delete(rid)

    def gone(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(") ", 1)[1][0] == "Z"
        except OSError:
            return True

    assert _wait(lambda: gone(child) and gone(grandchild))
