"""mlrun_tpu_torch's projects and workflow engines (projects/, run.py's
helpers, ``BaseRuntime.as_step``) against mlrun_tpu's: the contracts of
tests/test_projects.py, tests/test_runtimes.py's function save / import
and ``code_to_function``, a ``project.yaml`` read across the two
packages, and the engines and commands the port leaves to the service.

Each package writes under its own ``MLT_HOME`` with a fresh run db; the
current project and the pipeline context, both process-wide, start
empty in each package.
"""

import os

import pandas as pd
import pytest
import yaml

import mlrun_tpu
import mlrun_tpu.db as jdb
import mlrun_tpu_torch
from mlrun_tpu.config import mlconf
from mlrun_tpu.datastore import store_manager as jstore
from mlrun_tpu.projects import pipelines as jpipelines
from mlrun_tpu.projects import project as jproject
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch.datastore import store_manager as tstore
from mlrun_tpu_torch.projects import pipelines as tpipelines
from mlrun_tpu_torch.projects import project as tproject

PKGS = {"jax": mlrun_tpu, "port": mlrun_tpu_torch}
MODULES = {"jax": (jproject, jpipelines), "port": (tproject, tpipelines)}
PORT_COMMAND = ["python3", "-m", "mlrun_tpu_torch", "run", "--from-env"]


def _reset():
    jdb.set_run_db(None)
    jdb._run_db = None
    jstore._db = None
    tdb.set_run_db(None)
    tstore._db = None
    for project, pipelines in MODULES.values():
        project._current_project = None
        pipelines._current_context = None


@pytest.fixture(autouse=True)
def _fresh_state():
    _reset()
    yield
    _reset()


@pytest.fixture()
def each(tmp_path, monkeypatch):
    """``each(scenario)`` runs ``scenario(name, pkg, directory)`` once per
    package, each under its own MLT_HOME and project directory."""

    def run(scenario):
        got = {}
        for name, pkg in PKGS.items():
            monkeypatch.setenv("MLT_HOME", str(tmp_path / f"home-{name}"))
            mlconf.reload()
            _reset()
            directory = tmp_path / name
            directory.mkdir(exist_ok=True)
            got[name] = scenario(name, pkg, directory)
        return got

    return run


def _masked(struct):
    """A project dict without its creation stamp and its directory."""
    out = dict(struct)
    out["metadata"] = {k: v for k, v in struct["metadata"].items()
                       if k != "created"}
    out["spec"] = {k: v for k, v in struct["spec"].items()
                   if k != "context"}
    return out


# -- tests/test_projects.py ---------------------------------------------------

def test_new_and_get_or_create_like_reference(each):
    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-x", context=str(directory))
        again = pkg.get_or_create_project("proj-x", context=str(directory))
        fresh = pkg.get_or_create_project("proj-fresh",
                                          context=str(directory / "f"))
        return (proj.name, os.path.isfile(directory / "project.yaml"),
                again.name, fresh.name, _masked(again.to_dict()),
                pkg.get_current_project().name,
                sorted(p["metadata"]["name"]
                       for p in pkg.get_run_db().list_projects()))

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ("proj-x", True, "proj-x", "proj-fresh")


def test_set_and_run_function_like_reference(each):
    def handler(context, v: int = 1):
        context.log_result("out", v * 3)

    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-y", context=str(directory))
        fn = pkg.new_function("h", kind="local", handler=handler)
        proj.set_function(fn, name="h")
        run = proj.run_function("h", params={"v": 7}, local=True)
        return (run.state(), run.status.results, proj.get_function_names(),
                proj.spec.functions)

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"out": 21}


def test_project_artifacts_like_reference(each):
    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-z", context=str(directory))
        proj.log_dataset("d1", df=pd.DataFrame({"a": [1]}), format="csv")
        proj.log_artifact("notes", body="hello", format="txt")
        arts = proj.list_artifacts()
        art = proj.get_artifact("d1")
        return (sorted(a["metadata"]["key"] for a in arts), art.kind,
                proj.get_artifact_uri("d1", category="dataset", tag="v1"),
                proj.get_store_resource(
                    proj.get_artifact_uri("notes")).get(encoding="utf-8"))

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (["d1", "notes"], "dataset")


WORKFLOW = '''from {pkg}.projects import get_current_project


def pipeline():
    proj = get_current_project()
    r1 = proj.run_function('step1', params={{'v': 2}}, local=True)
    proj.run_function('step2', params={{'v': r1.output('a')}}, local=True)
'''


def test_workflow_local_engine_like_reference(each):
    def step1(context, v: int = 0):
        context.log_result("a", v + 10)

    def step2(context, v: int = 0):
        context.log_result("b", v * 2)

    def scenario(name, pkg, directory):
        workflow = directory / "wf.py"
        workflow.write_text(WORKFLOW.format(pkg=pkg.__name__))
        proj = pkg.new_project("proj-w", context=str(directory))
        proj.set_function(pkg.new_function("step1", kind="local",
                                           handler=step1), name="step1")
        proj.set_function(pkg.new_function("step2", kind="local",
                                           handler=step2), name="step2")
        proj.set_workflow("main", str(workflow))
        status = proj.run("main", engine="local")
        context_after = MODULES[name][1].pipeline_context()
        return (status.state, len(status.runs),
                [r.status.results for r in status.runs], context_after)

    got = each(scenario)
    assert got["port"] == got["jax"] == ("completed", 2,
                                         [{"a": 12}, {"b": 24}], None)


def _stepfn(context, v: int = 1):
    context.log_result("r", v)


def test_kfp_compile_without_kfp_like_reference(each):
    """The kfp-free IR equals the reference's except each executor's
    command, which runs the port's CLI."""
    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-kfp", context=str(directory))
        fn = pkg.new_function("stepfn", kind="job", handler=_stepfn,
                              image="img:latest")
        proj.set_function(fn, name="stepfn")

        def workflow(**kwargs):
            a = proj.run_function("stepfn", params={"v": 2}, name="stepa")
            proj.run_function("stepfn", params={"v": a.output("r")},
                              name="stepb")
            proj.run_function("stepfn", name="stepc").after(a)

        return MODULES[name][1].compile_kfp_pipeline(
            proj, workflow_handler=workflow, name="wf1")

    got = each(scenario)
    commands = {}
    for name, spec in got.items():
        for executor in spec["deploymentSpec"]["executors"].values():
            commands.setdefault(name, set()).add(
                tuple(executor["container"].pop("command")))
    assert commands == {"jax": {("mlrun-tpu", "run", "--from-env")},
                        "port": {tuple(PORT_COMMAND)}}
    assert got["port"] == got["jax"]
    spec = got["port"]
    assert spec["root"]["dag"]["tasks"]["stepb"]["dependentTasks"] == [
        "stepa"]
    assert spec["deploymentSpec"]["executors"]["exec-stepb"]["container"][
        "args"] == ["--str-param", "v={{$.inputs.parameters['v']}}"]


def test_kfp_compile_duplicate_names_like_reference(each):
    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-kfp2", context=str(directory))
        fn = pkg.new_function("dup", kind="job", image="img")
        proj.set_function(fn, name="dup")

        def workflow(**kwargs):
            first = proj.run_function("dup")
            proj.run_function("dup").after(first)

        spec = MODULES[name][1].compile_kfp_pipeline(
            proj, workflow_handler=workflow, name="w2")
        return (sorted(spec["root"]["dag"]["tasks"]),
                spec["root"]["dag"]["tasks"]["dup-2"]["dependentTasks"],
                sorted(spec["deploymentSpec"]["executors"]))

    got = each(scenario)
    assert got["port"] == got["jax"] == (["dup", "dup-2"], ["dup"],
                                         ["exec-dup", "exec-dup-2"])


# -- tests/test_runtimes.py ---------------------------------------------------

def test_function_save_and_import_like_reference(each):
    def scenario(name, pkg, directory):
        fn = pkg.new_function("f2", kind="job", image="img:1", project="p1")
        uri = fn.save()
        loaded = pkg.import_function("db://p1/f2")
        tagged = pkg.import_function("db://p1/f2:latest", new_name="f3",
                                     project="p2")
        path = str(directory / "f2.yaml")
        fn.export(path)
        from_file = pkg.import_function(path)
        # the uri ends in the stored dict's hash, which holds its time
        return (uri.split("@")[0], loaded.kind, loaded.spec.image,
                tagged.metadata.name,
                tagged.metadata.project, from_file.kind,
                from_file.spec.image)

    got = each(scenario)
    assert got["port"] == got["jax"] == (
        "db://p1/f2:latest", "job", "img:1", "f3", "p2", "job", "img:1")


def test_code_to_function_embeds_source_like_reference(each):
    def scenario(name, pkg, directory):
        script = directory / "trainer.py"
        script.write_text("def handler(context, lr: float = 0.1):\n"
                          "    \"\"\"docstring\"\"\"\n"
                          "    context.log_result(\"ok\", 1)\n")
        fn = pkg.code_to_function(name="t", filename=str(script),
                                  kind="job", handler="handler",
                                  labels={"team": "a"})
        run = fn.run(local=True, handler="handler")
        return (bool(fn.spec.build.functionSourceCode),
                fn.spec.entry_points, fn.metadata.labels,
                run.status.results)

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][3] == {"ok": 1}
    assert got["port"][1]["handler"]["doc"] == "docstring"


def test_run_local_and_function_to_module_like_reference(each):
    def scenario(name, pkg, directory):
        (directory / "mod.py").write_text(
            "def handler(context, n: int = 0):\n"
            "    context.log_result('sq', n * n)\n")
        module = pkg.function_to_module("mod.py", workdir=str(directory))
        run = pkg.run_local(handler=module.handler, name="sq",
                            params={"n": 4})
        return run.metadata.name, run.state(), run.status.results

    got = each(scenario)
    assert got["port"] == got["jax"] == ("sq", "completed", {"sq": 16})


# -- project.yaml across packages --------------------------------------------

def _rich_project(pkg, directory):
    proj = pkg.new_project("proj-yaml", context=str(directory),
                           description="d", parameters={"lr": 0.1},
                           default_image="img:2", save=False)
    fn = pkg.new_function("trainer", kind="job", image="img:2")
    proj.set_function(fn, name="trainer")
    proj.set_workflow("main", "wf.py", handler="pipeline", engine="local")
    proj.set_artifact("data", target_path="/data/x.csv", tag="v1")
    proj.build_config(image="img:3", base_image="base",
                      commands=["echo hi"], requirements=["numpy"])
    proj.enable_model_monitoring()
    proj.set_model_monitoring_function("drift",
                                       application_class="DriftApp")
    return proj


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_project_yaml_reads_in_the_other_package(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    proj = _rich_project(PKGS[writer], tmp_path)
    proj.save(store=False)
    loaded = PKGS[reader].load_project(str(tmp_path), save=False)
    assert _masked(loaded.to_dict()) == _masked(proj.to_dict())
    assert loaded.spec.get_workflow("main")["handler"] == "pipeline"


# -- project state ------------------------------------------------------------

def test_project_state_like_reference(each):
    """Params, secrets, datastore profiles, alert configs, monitoring
    params, workflow export, export / reload, the setup hook and the
    registered artifacts, the same in both packages."""
    def scenario(name, pkg, directory):
        proj = _rich_project(pkg, directory)
        proj.set_secrets({"TOKEN": "t0"})
        secret = proj.get_secret("TOKEN")
        proj.register_datastore_profile({"name": "dsp", "type": "basic"})
        profiles = [p["name"] for p in proj.list_datastore_profiles()]
        proj.create_alert_from_template("failed", "JobFailed")
        alert = proj.get_alert_config("failed")
        proj.reset_alert_config("failed")
        alerts = [a["name"] for a in proj.list_alerts_configs()]
        proj.remove_model_monitoring_function("drift")
        proj.save_workflow("main", str(directory / "main.yaml"))
        exported = yaml.safe_load((directory / "main.yaml").read_text())
        proj.export(str(directory / "exported.yaml"))
        (directory / "project_setup.py").write_text(
            "def setup(project):\n"
            "    project.spec.params['set_up'] = True\n"
            "    return project\n")
        proj.save()
        proj.reload()
        proj = proj.setup(save=False)
        proj.register_artifacts()
        return (secret, profiles, alert["entity_id"], alerts, exported,
                proj.list_model_monitoring_functions(),
                _masked(proj.to_dict()),
                sorted(a["metadata"]["key"] for a in proj.list_artifacts()),
                os.path.isfile(directory / "exported.yaml"))

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "t0"
    assert got["port"][6]["spec"]["params"]["set_up"] is True


def test_as_step_is_a_pipeline_step_like_reference(each):
    def scenario(name, pkg, directory):
        fn = pkg.new_function("f", kind="job", image="img")
        step = fn.as_step(handler="h", name="s1", project="p",
                          params={"a": 1}, inputs={"x": "/d"},
                          artifact_path="/out", image="img:9")
        after = fn.as_step(name="s2").after(step)
        return (type(step).__name__, step.name, step.handler, step.params,
                step.inputs, step.artifact_path, step.image,
                [s.name for s in after.after_steps],
                step.output("r").key)

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "PipelineStep"


def test_workflow_failure_raises_like_reference(each):
    def boom(context):
        raise ValueError("bad step")

    def scenario(name, pkg, directory):
        proj = pkg.new_project("proj-f", context=str(directory))
        proj.set_function(pkg.new_function("boom", kind="local",
                                           handler=boom), name="boom")

        def workflow():
            run = proj.run_function("boom", local=True)
            raise RuntimeError(f"step state {run._run.state()}")

        with pytest.raises(RuntimeError) as exc:
            proj.run(workflow_handler=workflow, engine="local")
        return str(exc.value), MODULES[name][1].pipeline_context()

    got = each(scenario)
    assert got["port"] == got["jax"] == (
        "workflow  failed: step state error", None)


# -- what the port leaves to the service -------------------------------------

def test_engines_and_commands_the_port_leaves_to_the_service(tmp_path):
    """The calls that need the service (its builder, its deployments, its
    workflow runner) fail alike in both packages over a local run db:
    the local db has no builder or pipeline runner, a job kind has no
    serving deploy; the api gateways list empty."""
    got = {}
    for name, pkg in PKGS.items():
        proj = pkg.new_project("proj-s", context=str(tmp_path / name))
        fn = pkg.new_function("f", kind="job", image="img")
        proj.set_function(fn, name="f")
        outcomes = []
        for call in (lambda: proj.build_function("f"),
                     lambda: proj.build_image(image="x"),
                     lambda: proj.deploy_function("f"),
                     lambda: proj.list_api_gateways(),
                     lambda: pkg.projects.build_function("f"),
                     lambda: pkg.projects.deploy_function("f"),
                     lambda: proj.run(workflow_handler=lambda: None,
                                      engine="remote")):
            try:
                outcomes.append(("returned", call()))
            except Exception as exc:  # noqa: BLE001 - compared below
                outcomes.append((type(exc).__name__, str(exc)))
        got[name] = outcomes
        _reset()
    assert got["port"] == got["jax"]
    assert [kind for kind, _ in got["port"]] == [
        "NotImplementedError", "NotImplementedError", "TypeError",
        "returned", "NotImplementedError", "TypeError", "AttributeError"]
    assert "submit_pipeline" in got["port"][-1][1]
    # a run db with no service behind it never answers: both packages
    # poll until the timeout and return the state they started from
    for _, pipelines in MODULES.values():
        assert pipelines.wait_for_run_completion(
            "run-1", timeout=0.1) == "running"
    # the kfp engine needs the kfp SDK, as in the reference
    for pkg in PKGS.values():
        engine = pkg.projects.pipelines.get_workflow_engine("kfp")
        with pytest.raises(ImportError, match="kfp"):
            engine.run(proj, {}, workflow_handler=lambda: None)
        with pytest.raises(ValueError, match="unsupported workflow engine"):
            pkg.projects.pipelines.get_workflow_engine("argo")


STEPS = '''def step1(context, v: int = 0):
    context.log_result("a", v + 10)


def step2(context, v: int = 0):
    context.log_result("b", v * 2)
'''


def test_remote_engine_submits_the_workflow_to_the_service(each,
                                                           monkeypatch):
    """The remote workflow engine submits the workflow to the package's
    service (``submit_pipeline``), whose workflow runner loads the
    project from its context and runs it with the local engine; the
    client's status polls the service to the end."""
    from tests.torch_service import PKGS as SERVICE_PKGS
    from tests.torch_service import Service

    def scenario(name, pkg, directory):
        svc = Service(SERVICE_PKGS[name], directory, monkeypatch)
        try:
            if name == "jax":
                monkeypatch.setattr(mlconf, "dbpath", svc.url)
            else:
                monkeypatch.setenv("MLT_DBPATH", svc.url)
            _reset()
            (directory / "steps.py").write_text(STEPS)
            (directory / "wf.py").write_text(WORKFLOW.format(
                pkg=pkg.__name__))
            proj = pkg.new_project("proj-r", context=str(directory))
            for step in ("step1", "step2"):
                proj.set_function("steps.py", name=step, kind="local",
                                  handler=step).save()
            proj.set_workflow("main", "wf.py", context=str(directory))
            proj.save()
            status = proj.run("main", engine="remote")
            submitted = (status.state, bool(status.run_id))
            final = status.wait_for_completion(timeout=60)
            runs = sorted(
                (r["metadata"]["name"], r["status"].get("results"))
                for r in svc.db.list_runs(project="proj-r"))
            return submitted, final, runs
        finally:
            svc.stop()
            monkeypatch.delenv("MLT_DBPATH", raising=False)
            _reset()

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"] == (("running", True), "completed",
                           [("step1", {"a": 12}), ("step2", {"b": 24})])
