"""mlrun_tpu_torch's run stack against mlrun_tpu's: the run objects
(model.py), ``MLClientCtx`` (execution.py), the local launcher with its
hyper-parameter fan-out (launcher/, runtimes/local.py), the GPU-sized
``tpujob`` runtime (runtimes/tpujob.py, pod.py), artifacts resolved
through ``store://`` and ``ds://`` (artifacts/, datastore/), and one
``tpujob`` run of ``auto_trainer.train`` in each package.

The contracts are tests/test_runtimes.py's, tests/test_execution.py's and
tests/test_tpujob.py's (the last with GPU sizing in place of topology
strings), run on both packages with the same inputs. Run dicts are
compared exactly once the volatile fields are masked: the uids a run
draws and the paths that hold them, wall-clock stamps and the host.
"""

import json
import re

import numpy as np
import pandas as pd
import pytest
import torch

import mlrun_tpu
import mlrun_tpu_torch
from mlrun_tpu import model as jmodel
from mlrun_tpu.artifacts import get_model as jget_model
from mlrun_tpu.common.runtimes_constants import JobSetConditions as JConditions
from mlrun_tpu.execution import MLClientCtx as JCtx
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch import model as tmodel
from mlrun_tpu_torch.artifacts import get_model as tget_model
from mlrun_tpu_torch.common.runtimes_constants import JobSetConditions
from mlrun_tpu_torch.datastore import store_manager as tstore_manager
from mlrun_tpu_torch.execution import MLClientCtx as TCtx
from mlrun_tpu_torch.k8s.jobset import TopologyError
from mlrun_tpu_torch.runtimes import get_runtime_class

from .mocks import RunDBMock
from tests.torch_registries import registries_left_as_found  # noqa: F401

PKGS = {"jax": mlrun_tpu, "port": mlrun_tpu_torch}
VOLATILE = {"uid", "tree", "start_time", "last_update", "last_heartbeat",
            "created", "updated", "host", "sent_time"}
UID = re.compile(r"[0-9a-f]{32}|(?<=-)[0-9a-f]{8}(?=[./-]|$)")


@pytest.fixture(autouse=True)
def _fresh_port_db():
    """The port's process-wide db and store manager start empty (the
    shared conftest resets the reference's)."""
    tdb.set_run_db(None)
    tstore_manager._db = None
    yield
    tdb.set_run_db(None)
    tstore_manager._db = None


def _mask(obj):
    if isinstance(obj, dict):
        return {k: "<v>" if k in VOLATILE else _mask(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_mask(v) for v in obj]
    if isinstance(obj, str):
        return UID.sub("<uid>", obj)
    return obj


def _alike(scenario):
    got = {name: _mask(scenario(pkg)) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# -- run objects --------------------------------------------------------------

RUN = {
    "kind": "run",
    "metadata": {"uid": "abc", "name": "train", "project": "p1",
                 "labels": {"owner": "me"}, "annotations": {}, "iteration": 2},
    "spec": {"parameters": {"lr": 0.1}, "hyperparams": {"a": [1, 2]},
             "hyper_param_options": {"selector": "min.loss",
                                     "strategy": "list"},
             "inputs": {"data": "store://datasets/p1/d"}, "outputs": [],
             "output_path": "/tmp/a", "function": "p1/train:latest",
             "handler": "train", "notifications": [{"kind": "console"}],
             "retry_policy": {"max_retries": 2}, "returns": ["r"]},
    "status": {"state": "completed", "results": {"loss": 0.5},
               "artifact_uris": {"model": "store://models/p1/m"},
               "iterations": [{"iter": 1}], "error": None},
}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_run_dict_round_trips_across_packages(writer):
    """A run either package serializes loads in the other and serializes
    back to the same dict; the task builders agree."""
    first, second = (jmodel, tmodel) if writer == "jax" else (tmodel, jmodel)
    struct = first.RunObject.from_dict(json.loads(json.dumps(RUN))).to_dict()
    assert second.RunObject.from_dict(struct).to_dict() == struct
    again = second.RunObject.from_dict(struct)
    assert (again.state(), again.output("loss"), again.outputs) == (
        "completed", 0.5, {"loss": 0.5, "model": "store://models/p1/m"})
    for module in (jmodel, tmodel):
        assert module.RunObject.parse_uri("p1@abc#2:t") == \
            ("p1", "abc", "2", "t")

    def task(module):
        return module.new_task(
            name="t", project="p1", params={"x": 1},
            hyper_params={"a": [1]}, selector="max.acc",
            inputs={"i": "x"}, artifact_path="/out").with_retry(
            max_retries=1, retry_on=["preemption"]).to_dict()

    assert task(tmodel) == task(jmodel)
    with pytest.raises(ValueError, match="on_stall"):
        tmodel.new_task().with_retry(on_stall="never")
    with pytest.raises(ValueError, match="retry_on"):
        tmodel.new_task().with_retry(retry_on=["typo"])


# -- MLClientCtx: tests/test_execution.py on both packages ---------------------

def _ctx_scenario(pkg, tmp_path):
    ctx_cls = JCtx if pkg is mlrun_tpu else TCtx
    db = RunDBMock()
    ctx = ctx_cls.from_dict({"metadata": {"name": "test-run", "project": "p1"},
                             "spec": {"parameters": {"p1": 5}}}, rundb=db)
    params = (ctx.get_param("p1"), ctx.get_param("missing", 42),
              dict(ctx.parameters))
    ctx.log_result("loss", 0.5)
    ctx.log_results({"a": 1, "b": 2})
    ctx.log_result("np_int", np.int64(3))
    ctx.log_result("np_float", np.float32(0.5))
    ctx.log_result("arr", np.arange(3))
    ctx.artifact_path = str(tmp_path / "artifacts")
    ctx.log_artifact("doc", body="hello")
    ctx.log_dataset("ds", df=pd.DataFrame({"x": [1, 2]}), format="csv")
    ctx.log_model("m", body=b"weights", model_file="w.bin",
                  metrics={"acc": 0.9}, framework="torch")
    ctx.commit(completed=True)
    stored = db.runs[("p1", ctx._uid, 0)]
    artifacts = sorted(db.artifacts)
    ctx.set_state(error="boom")
    failed = db.runs[("p1", ctx._uid, 0)]["status"]
    return (params, stored, artifacts, failed["state"], failed["error"],
            [type(v).__name__ for v in stored["status"]["results"].values()])


def test_context_logs_results_artifacts_and_state(tmp_path):
    params, stored, artifacts, state, error, types = _alike(
        lambda pkg: _ctx_scenario(pkg, tmp_path))
    assert params == [5, 42, {"p1": 5, "missing": 42}]
    assert stored["status"]["state"] == "completed"
    assert stored["status"]["results"] == {
        "loss": 0.5, "a": 1, "b": 2, "np_int": 3, "np_float": 0.5,
        "arr": [0, 1, 2]}
    assert types[3] == "int"
    assert set(stored["status"]["artifact_uris"]) == {"doc", "ds", "m"}
    assert ["p1", "ds", "latest"] in artifacts
    assert [state, error] == ["error", "boom"]


def test_context_casts_torch_scalars_and_reads_rank(monkeypatch):
    """0-d torch tensors become Python numbers; the logging worker is
    torchrun's RANK 0 (the reference reads TPU_WORKER_ID)."""
    db = RunDBMock()
    ctx = TCtx.from_dict({"metadata": {"name": "w", "project": "p1"}},
                         rundb=db)
    ctx.log_results({"loss": torch.tensor(1.5), "step": torch.tensor(3)})
    ctx.commit()
    results = db.runs[("p1", ctx._uid, 0)]["status"]["results"]
    assert results == {"loss": 1.5, "step": 3}
    assert type(results["step"]) is int
    for env in ("RANK", "MLT_WORKER_RANK", "TPU_WORKER_ID"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    assert ctx.is_logging_worker()
    monkeypatch.setenv("RANK", "1")
    assert not ctx.is_logging_worker()
    quiet = TCtx.from_dict({"metadata": {"name": "w2", "project": "p1"}},
                           rundb=db)
    assert ("p1", quiet._uid, 0) not in db.runs
    monkeypatch.setenv("RANK", "0")
    assert ctx.is_logging_worker()


# -- the local launcher: tests/test_runtimes.py on both packages --------------

def _handler(context, x: int = 1):
    print(f"handler x={x}")
    context.log_result("y", x * 2)
    return x + 1


def _failing(context):
    raise RuntimeError("expected failure")


def _score(context, a: int = 0, b: int = 0):
    context.log_result("score", a * 10 + b)


def _sum(context, a: int = 0, b: int = 0):
    context.log_result("s", a + b)


def _value(context, a: int = 0):
    context.log_result("v", a)


def _runs_scenario(pkg):
    out = []
    run = pkg.new_function("f", kind="local", handler=_handler).run(
        params={"x": 4}, local=True)
    out.append((run.state(), run.status.results, run.output("return")))
    db = pkg.get_run_db()
    out.append(db.get_log(run.metadata.uid, run.metadata.project))
    out.append(db.read_run(run.metadata.uid, run.metadata.project))
    run = pkg.new_function("f", kind="local", handler=_failing).run(
        local=True)
    out.append((run.state(), run.status.error))
    run = pkg.new_function("f", kind="local", handler=_score).run(
        hyperparams={"a": [1, 2], "b": [3, 4]},
        hyper_param_options={"selector": "max.score"}, local=True)
    out.append(run.to_dict())
    out.append([db.read_run(run.metadata.uid, run.metadata.project, iter=i)
                for i in (1, 4)])
    run = pkg.new_function("f", kind="local", handler=_sum).run(
        hyperparams={"a": [1, 2], "b": [10, 20]},
        hyper_param_options={"strategy": "list", "selector": "max.s"},
        local=True)
    out.append((run.status.results, len(run.status.iterations)))
    run = pkg.new_function("f", kind="local", handler=_value).run(
        hyperparams={"a": [1, 2, 3, 4]},
        hyper_param_options={"stop_condition": "v >= 2",
                             "selector": "max.v"}, local=True)
    out.append(len(run.status.iterations))
    with pytest.raises(RuntimeError, match="MLT_DBPATH"):
        pkg.new_function("j", kind="job", image="img").run()
    return out


def test_local_runs_and_hyperparameter_runs_match_reference(capsys):
    out = _alike(_runs_scenario)
    assert out[0] == ["completed", {"y": 8, "return": 5}, 5]
    assert out[1] == ["completed", b"handler x=4\n"]
    assert out[3][0] == "error" and "expected failure" in out[3][1]
    assert out[4]["status"]["results"] == {"score": 24, "best_iteration": 4}
    assert len(out[4]["status"]["iterations"]) == 4
    assert out[5][1]["status"]["results"] == {"score": 24}
    assert out[6] == [{"s": 22, "best_iteration": 2}, 2]
    assert out[7] == 2


def test_unported_kinds_and_the_remote_launcher_raise(monkeypatch):
    for kind in ("dask", "spark", "databricks", "serving", "remote",
                 "application"):
        with pytest.raises(NotImplementedError, match="item 14"):
            get_runtime_class(kind)
    with pytest.raises(ValueError, match="unsupported runtime kind"):
        get_runtime_class("mpijob")
    fn = mlrun_tpu_torch.new_function("j", kind="job", image="img")
    with pytest.raises(NotImplementedError, match="item 14"):
        fn.deploy()
    # with a service url the run goes through the remote launcher, which
    # stores the function in the service first: no service answers on a
    # closed local port, so the store fails with the client's error
    import socket

    from mlrun_tpu_torch.db import RunDBError, set_run_db
    from mlrun_tpu_torch.launcher import ClientRemoteLauncher, LauncherFactory

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed = sock.getsockname()[1]
    monkeypatch.setenv("MLT_DBPATH", f"http://127.0.0.1:{closed}")
    monkeypatch.setenv("MLT_HTTPDB__RETRIES", "0")
    set_run_db(None)
    assert isinstance(LauncherFactory.create_launcher(is_remote=True),
                      ClientRemoteLauncher)
    try:
        with pytest.raises(RunDBError, match="store function"):
            fn.run()
    finally:
        set_run_db(None)


# -- the tpujob runtime: tests/test_tpujob.py, sized in GPUs -------------------

def _run_obj(module):
    run = module.RunObject()
    run.metadata.uid = "abcd1234efgh"
    run.metadata.name = "train"
    run.metadata.project = "p1"
    run.spec.parameters = {"lr": 0.1}
    return run


def _main(jobset):
    job = jobset["spec"]["replicatedJobs"][0]["template"]["spec"]
    return job, job["template"]["spec"]["containers"][0]


def test_tpujob_jobset_in_gpus():
    fn = mlrun_tpu_torch.new_function("train", kind="tpujob", project="p1")
    assert fn.with_gpus(1, nodes=1) is fn and fn.total_gpus == 1
    jobset = fn.generate_jobset(_run_obj(tmodel))
    assert jobset["apiVersion"] == "jobset.x-k8s.io/v1alpha2"
    job, main = _main(jobset)
    assert (job["parallelism"], job["completions"]) == (1, 1)
    assert job["completionMode"] == "Indexed"
    assert jobset["spec"]["replicatedJobs"][0]["replicas"] == 1
    assert main["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert job["template"]["spec"]["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    env = {e["name"]: e.get("value") for e in main["env"]}
    assert {"MASTER_ADDR", "MASTER_PORT", "NNODES", "NPROC_PER_NODE",
            "NODE_RANK", "MLT_SLICE_ID"} <= set(env)
    assert (env["NNODES"], env["NPROC_PER_NODE"]) == ("1", "1")
    assert "torchrun" in main["command"][2]
    # the port's CLI, never the reference's console script (fault 3.7)
    assert main["args"] == ["python3", "-m", "mlrun_tpu_torch", "run",
                            "--from-env"]
    # the exec config round-trips the run dict, as the reference's
    parsed = json.loads(env["MLT_EXEC_CONFIG"])
    assert parsed == _run_obj(tmodel).to_dict()
    assert parsed["spec"]["parameters"] == {"lr": 0.1}
    assert parsed["metadata"]["uid"] == "abcd1234efgh"
    jfn = mlrun_tpu.new_function("train", kind="tpujob", project="p1")
    jenv = {e["name"]: e.get("value") for e in _main(jfn.generate_jobset(
        _run_obj(jmodel)))[1]["env"]}
    assert json.loads(jenv["MLT_EXEC_CONFIG"]) == parsed

    fn.with_gpus(8, gpu_product="NVIDIA-A100", nodes=2, num_slices=2)
    assert fn.total_gpus == 32
    job, main = _main(fn.generate_jobset(_run_obj(tmodel)))
    assert (job["parallelism"], main["resources"]["limits"][
        "nvidia.com/gpu"]) == (2, 8)
    assert job["template"]["spec"]["nodeSelector"][
        "nvidia.com/gpu.product"] == "NVIDIA-A100"
    with pytest.raises(TopologyError, match="with_gpus"):
        fn.with_tpu_topology("tpu-v5-lite-podslice", "2x4")
    fn.spec.nodes = 0
    with pytest.raises(TopologyError, match="nodes"):
        fn.generate_jobset(_run_obj(tmodel))
    pod = mlrun_tpu_torch.new_function("j", kind="job").with_gpus(
        2, "NVIDIA-H100")
    assert pod.to_pod_spec()["containers"][0]["resources"]["limits"] == {
        "nvidia.com/gpu": 2}
    with pytest.raises(TopologyError, match="with_gpus"):
        pod.with_tpu(4)


def test_tpujob_function_spec_and_conditions_cross_packages():
    """A function spec the reference serializes loads as the port's
    ``TpuJobRuntime`` (kind, name, image and mesh kept; the topology
    fields unread), and the JobSet conditions map to the same states."""
    jfn = mlrun_tpu.new_function("train", kind="tpujob", project="p1",
                                 image="img:1")
    jfn.with_mesh({"data": 2}).with_elastic()
    spec = jfn.to_dict()
    loaded = get_runtime_class(spec["kind"]).from_dict(spec)
    assert type(loaded).__name__ == "TpuJobRuntime"
    assert loaded.spec.image == "img:1" and loaded.spec.mesh_shape == {
        "data": 2} and loaded.spec.elastic is True
    assert (loaded.metadata.name, loaded.metadata.project) == ("train", "p1")
    assert "topology" not in loaded.to_dict()["spec"]
    for conditions in ([{"type": "Completed", "status": "True"}],
                       [{"type": "Failed", "status": "True"}],
                       [{"type": "Suspended", "status": True}], []):
        assert JobSetConditions.to_run_state(conditions) == \
            JConditions.to_run_state(conditions)


# -- artifacts through store:// and ds:// -------------------------------------

def _logged_model(pkg, tmp_path):
    model_dir = tmp_path / "ckpt"
    model_dir.mkdir(exist_ok=True)
    (model_dir / "params.pt").write_bytes(b"params")

    def log(context):
        context.log_model("llm", model_dir=str(model_dir), upload=False,
                          target_path=str(model_dir), framework="torch",
                          metrics={"loss": 1.0})

    run = pkg.new_function("f", kind="local", handler=log, project="p1").run(
        local=True)
    get_model = jget_model if pkg is mlrun_tpu else tget_model
    local, spec, extra = get_model("store://models/p1/llm")
    return (run.status.artifact_uris, local, spec.to_dict(), extra,
            type(spec).__name__)


def test_get_model_resolves_a_store_uri_to_a_model_artifact(tmp_path):
    uris, local, spec, extra, kind = _alike(
        lambda pkg: _logged_model(pkg, tmp_path))
    assert uris == {"llm": "store://models/p1/llm:latest@<uid>"}
    assert local.rstrip("/") == str(tmp_path / "ckpt")
    assert kind == "ModelArtifact" and spec["kind"] == "model"
    assert spec["spec"]["metrics"] == {"loss": 1.0}


def test_ds_profiles_resolve_through_the_run_db(tmp_path):
    """A ``ds://`` url resolves through the db's profile (a file profile
    reads the file; an s3 one reaches the unported object store, item 10's
    tail)."""
    db = tdb.SQLiteRunDB(str(tmp_path / "db.sqlite"))
    tdb.set_run_db(db)
    (tmp_path / "data.txt").write_text("payload")
    db.store_datastore_profile({"name": "local", "type": "basic",
                                "fields": {"url": str(tmp_path)}})
    db.store_datastore_profile({"name": "bucket", "type": "s3",
                                "fields": {"bucket": "b"}})
    assert tstore_manager.object(url="ds://local/data.txt").get() == \
        b"payload"
    with pytest.raises(NotImplementedError, match="item 10") as err:
        tstore_manager.object(url="ds://bucket/x.npy")
    assert "'s3://'" in str(err.value)


# -- one tpujob run of auto_trainer.train in each package ---------------------

def _shape(obj):
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj[:1]]
    return type(obj).__name__


def test_tpujob_run_of_auto_trainer_matches_reference(tmp_path):
    """``new_function(kind="tpujob").run(handler=train, local=True)`` on a
    2-layer Llama for 2 steps in each package (the losses' parity is
    tests/test_torch_training.py's): the run dicts have the same shape,
    state and result keys, the db holds the run's results and the model
    resolves through its store uri."""
    from mlrun_tpu.frameworks.jax import auto_trainer as jauto
    from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto

    params = {"model": "tiny", "batch_size": 2, "seq_len": 16, "steps": 2,
              "log_every": 1, "model_name": "tiny-llm", "warmup": False}
    got = {}
    for name, pkg, handler, extra in (
            ("jax", mlrun_tpu, jauto.train, {"mesh_shape": {"fsdp": 1}}),
            ("port", mlrun_tpu_torch, tauto.train, {"device": "cpu"})):
        run = pkg.new_function("train", kind="tpujob", project="p1").run(
            handler=handler, local=True, params={
                **params, **extra,
                "checkpoint_dir": str(tmp_path / name / "ckpt")})
        stored = pkg.get_run_db().read_run(run.metadata.uid, "p1")
        got[name] = run.to_dict()
        assert run.state() == "completed", run.status.error
        assert stored["status"]["results"] == run.status.results
        spec = (jget_model if pkg is mlrun_tpu else tget_model)(
            "store://models/p1/tiny-llm")[1]
        assert spec.spec.target_path == str(tmp_path / name / "ckpt")
    jax_run, port_run = got["jax"], got["port"]
    port_run["spec"]["parameters"].pop("device")
    jax_run["spec"]["parameters"].pop("mesh_shape")
    assert _shape(port_run) == _shape(jax_run)
    assert set(port_run["status"]["results"]) == \
        set(jax_run["status"]["results"])
    assert set(port_run["status"]["artifact_uris"]) == {"tiny-llm"}
