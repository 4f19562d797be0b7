"""mlrun_tpu_torch's small host surfaces (ROADMAP item 14a) against
mlrun_tpu's: the error hierarchy (errors.py), the structured logger and
the helpers (utils/logger.py, utils/helpers.py), the mount modifiers
(platforms/), HTML rendering (render.py, ``RunObject.show`` /
``_repr_html_``), the tracker hooks (track/), the function hub (hub.py
and each package's own ``hub_functions/``) and the top-level names.

The contracts are tests/test_misc.py's hub, mount and render cases and
tests/test_api_parity.py::test_top_level_exports_parity, run on both
packages with the same inputs and the same assertions, where a run is
deterministic its results equal across packages. The reference has no
test of ``track/``; the tracker manager is held here with no tracker
installed (mlflow is absent) on both. Each package writes under its own
``MLT_HOME`` with a fresh run db.
"""

import base64
import importlib
import io
import json
import re
from pathlib import Path

import numpy as np
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
ROOT = Path(__file__).resolve().parents[1]


def _reset():
    jdb.set_run_db(None)
    jdb._run_db = None
    jstore._db = None
    tdb.set_run_db(None)
    tstore._db = None
    for project, pipelines in ((jproject, jpipelines),
                               (tproject, tpipelines)):
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
    package, each under its own MLT_HOME with a fresh run db and a
    directory of its own."""

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


def _module(pkg, path):
    return importlib.import_module(f"{pkg.__name__}.{path}")


# -- errors.py ----------------------------------------------------------------

ERRORS = ("MLRunBaseError", "MLRunInvalidArgumentError", "MLRunNotFoundError",
          "MLRunConflictError", "MLRunTimeoutError", "MLRunRuntimeError")


@pytest.mark.parametrize("name", ERRORS)
def test_error_hierarchy_matches_reference(name):
    """Each error has the reference's bases (``MLRunNotFoundError`` is a
    ``KeyError``, ...) and is the package's top-level name."""
    from mlrun_tpu import errors as jerrors
    from mlrun_tpu_torch import errors as terrors

    def bases(module):
        return [c.__name__ for c in getattr(module, name).__mro__]

    assert bases(terrors) == bases(jerrors)
    assert getattr(mlrun_tpu_torch, name) is getattr(terrors, name)
    with pytest.raises(getattr(terrors, name).__mro__[-3]):
        raise getattr(terrors, name)("x")


# -- utils/logger.py and utils/helpers.py -------------------------------------

@pytest.mark.parametrize("fmt", ["human", "json"])
def test_logger_formats_like_reference(fmt):
    """``create_logger`` and ``Logger`` write the reference's records:
    the same JSON payload (the timestamp aside) or the same human line."""
    lines = {}
    for name, pkg in PKGS.items():
        stream = io.StringIO()
        log = _module(pkg, "utils.logger").create_logger(
            level="debug", fmt=fmt, name=f"parity-{name}-{fmt}",
            stream=stream)
        log.debug("hello", step=3, loss=0.5)
        log.warn("careful")
        log.set_level("error")
        log.info("dropped")
        lines[name] = stream.getvalue().splitlines()
    for got in lines.values():
        assert len(got) == 2
    if fmt == "json":
        for got in lines.values():
            for i, line in enumerate(got):
                record = json.loads(line)
                record.pop("datetime")
                got[i] = record
        assert lines["port"][0] == {"level": "debug", "message": "hello",
                                    "with": {"step": 3, "loss": 0.5}}
    else:
        stamp = re.compile(r"^> \d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} ")
        for got in lines.values():
            got[:] = [stamp.sub("> ", line) for line in got]
        assert lines["port"][0] == '> [debug] hello {"loss": 0.5, "step": 3}'
    assert lines["port"] == lines["jax"]


def test_helpers_match_reference(monkeypatch):
    """The helpers' results on the same inputs, the uid and the clock
    aside."""
    got = {}
    for name, pkg in PKGS.items():
        utils = _module(pkg, "utils.helpers")
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("not yet")
            return "ok"

        run = utils.fill_run_metadata({"metadata": {"name": "r"}})
        assert len(run["metadata"].pop("uid")) == 32
        pipe = utils.new_pipe_metadata("/arts")
        assert pipe.pop("generated")
        with pytest.raises(ValueError, match="does not match"):
            utils.verify_field_regex("name", "Bad_Name")
        with pytest.raises(TimeoutError, match="within 0.05s"):
            utils.retry_until_successful(0.01, 0.05, None, False,
                                         lambda: 1 / 0)
        got[name] = (
            [utils.as_list(v) for v in (None, 3, (1, 2), [4])],
            utils.dict_to_json({"a": 1, "when": pd.Timestamp(0)}),
            utils.dict_to_yaml({"b": [1, 2], "a": {"c": "d"}}),
            [utils.enrich_image_url(i) for i in ("", ".", "auto", "img:1")],
            run, pipe,
            [utils.is_relative_path(p) for p in ("", "a/b", "/a",
                                                 "s3://b/k")],
            utils.verify_field_regex("name", "good-name"),
            utils.retry_until_successful(
                0.0, 5.0, _module(pkg, "utils").logger, True, flaky),
        )
    assert got["port"] == got["jax"]


# -- platforms/ ---------------------------------------------------------------

def test_mount_modifiers(each, monkeypatch):
    monkeypatch.delenv("MLT_PVC_NAME", raising=False)
    monkeypatch.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)

    def scenario(name, pkg, directory):
        platforms = _module(pkg, "platforms")
        fn = pkg.new_function("m", kind="job", image="x")
        fn.apply(platforms.mount_pvc("my-pvc", volume_mount_path="/data"))
        fn.apply(platforms.mount_gcs_key())
        fn.apply(platforms.mount_tmpfs("2Gi"))
        fn.apply(platforms.mount_secret("s", items=[{"key": "k"}]))
        fn.apply(platforms.mount_configmap("c"))
        volumes = {v["name"] for v in fn.spec.volumes}
        assert volumes == {"pvc", "gcs-key", "shm", "secret", "configmap"}
        assert fn.get_env("GOOGLE_APPLICATION_CREDENTIALS") == \
            "/var/secrets/gcs/key.json"
        pod = fn.to_pod_spec()
        assert len(pod["volumes"]) == 5
        assert len(pod["containers"][0]["volumeMounts"]) == 5
        noop = pkg.new_function("n", kind="job", image="x")
        noop.apply(pkg.auto_mount())
        with pytest.raises(ValueError, match="pvc_name"):
            noop.apply(platforms.mount_pvc())
        return pod["volumes"], pod["containers"][0]["volumeMounts"], \
            noop.spec.volumes

    got = each(scenario)
    assert got["port"] == got["jax"]


# -- render.py and RunObject.show ---------------------------------------------

def test_render_html():
    html = {}
    for name, pkg in PKGS.items():
        render = _module(pkg, "render")
        runs = [{"metadata": {"uid": "abc123", "name": "r"},
                 "status": {"state": "completed",
                            "results": {"acc": 0.91234567}}}]
        table = render.runs_to_html(runs, display=False)
        assert "abc123" in table and "completed" in table \
            and "0.9123" in table
        arts = render.artifacts_to_html(
            [{"kind": "model", "metadata": {"key": "m1", "tag": "v1"},
              "spec": {"target_path": "/x"}}], display=False)
        assert "m1" in arts
        html[name] = table, arts
    assert html["port"] == html["jax"]


def test_run_object_show_and_repr_html(each, tmp_path):
    """A run's detail card: ``_repr_html_`` renders render.py's card
    (labels, parameters, results, artifact links, an html plot's
    iframe); ``show`` outside IPython logs a summary instead."""
    def scenario(name, pkg, directory):
        plot = directory / "plot.html"
        plot.write_text("<b>chart</b>")

        def handler(context, lr: float = 0.1):
            context.log_result("acc", 0.5)
            context.log_artifact("plot", local_path=str(plot), format="html")

        run = pkg.new_function("card", kind="local", handler=handler).run(
            params={"lr": 0.25}, local=True)
        assert run.state() == "completed", run.status.error
        card = run._repr_html_()
        assert "card" in card and "0.25" in card and "acc" in card
        assert "iframe" in card and "&lt;b&gt;chart&lt;/b&gt;" in card
        run.show()
        return re.sub(r"[0-9a-f]{32}|\d{4}-\d\d-\d\d[ T][\d:.]+", "<v>",
                      card).replace(str(directory), "<dir>")

    got = each(scenario)
    assert got["port"] == got["jax"]


# -- track/ -------------------------------------------------------------------

def test_tracker_manager_with_no_tracker_installed(each):
    """mlflow is absent: the default trackers load nothing and a run
    completes; a registered tracker's hooks wrap the handler; a failing
    tracker is logged and never fails the run."""
    def scenario(name, pkg, directory):
        track = _module(pkg, "track")
        manager = track.tracker_manager
        saved = list(manager._trackers)
        seen = []

        class Recording(track.Tracker):
            def pre_run(self, context):
                seen.append(("pre", context.name))

            def post_run(self, context):
                seen.append(("post", context.name))
                context.log_result("tracked", 1)

        class Failing(track.Tracker):
            def pre_run(self, context):
                raise RuntimeError("tracker down")

        def handler(context):
            seen.append(("handler", context.name))

        try:
            manager.pre_run(object())  # loads the defaults: none here
            assert manager._trackers == saved and manager._loaded
            assert not track.Tracker.is_enabled()
            manager.register(Recording())
            manager.register(Failing())
            run = pkg.new_function("tr", kind="local", handler=handler).run(
                local=True)
        finally:
            manager._trackers[:] = saved
        assert run.state() == "completed", run.status.error
        assert run.status.results == {"tracked": 1}
        return seen

    got = each(scenario)
    assert got["port"] == got["jax"] == [
        ("pre", "tr"), ("handler", "tr"), ("post", "tr")]


# -- hub.py and hub_functions/ ------------------------------------------------

def test_hub_import_and_run(each):
    def scenario(name, pkg, directory):
        fn = pkg.import_function("hub://iris_trainer")
        assert fn.kind == "job"
        assert fn.spec.default_handler == "trainer"
        run = fn.run(local=True, params={"max_iter": 120})
        assert run.state() == "completed", run.status.error
        assert run.status.results["accuracy"] > 0.8
        return run.status.results, sorted(run.status.artifact_uris)

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_hub_tpujob_function():
    """The reference's llama_finetune is a tpujob on a 2x4 slice (8 chips);
    the port's is a tpujob on one node of 8 GPUs, its handler the torch
    auto-trainer's ``train``."""
    ref = mlrun_tpu.import_function("hub://llama_finetune")
    assert ref.kind == "tpujob"
    assert ref.spec.topology == "2x4"
    fn = mlrun_tpu_torch.import_function("hub://llama_finetune")
    assert fn.kind == "tpujob"
    assert (fn.spec.nodes, fn.spec.gpus_per_node, fn.spec.gpu_product) == (
        1, 8, "NVIDIA-H100-80GB-HBM3")
    assert fn.total_gpus == ref.total_chips == 8
    assert fn.spec.default_handler == ref.spec.default_handler
    namespace = {}
    exec(base64.b64decode(fn.spec.build.functionSourceCode), namespace)
    from mlrun_tpu_torch.frameworks.torch import auto_trainer

    called = {}
    real = auto_trainer.train
    auto_trainer.train = lambda context, **kw: called.update(kw) or "ok"
    try:
        assert namespace["train_handler"](None, steps=1) == "ok"
    finally:
        auto_trainer.train = real
    assert called == {"steps": 1}


def test_hub_batch_inference_end_to_end(each, tmp_path):
    """hub://batch_inference: pickle model + csv in, prediction set +
    accuracy out."""
    import pickle

    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 3))
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    model = LogisticRegression().fit(X, y)
    model_path = tmp_path / "model.pkl"
    model_path.write_bytes(pickle.dumps(model))
    df = pd.DataFrame(X, columns=["a", "b", "c"])
    df["label"] = y
    data_path = tmp_path / "data.csv"
    df.to_csv(data_path, index=False)

    def scenario(name, pkg, directory):
        fn = pkg.import_function("hub://batch_inference")
        run = fn.run(local=True,
                     inputs={"dataset": str(data_path)},
                     params={"model_path": str(model_path),
                             "label_column": "label"})
        assert run.state() == "completed", run.status.error
        assert run.status.results["prediction_count"] == 80
        assert run.status.results["accuracy"] > 0.9
        assert "prediction_set" in run.status.artifact_uris
        return run.status.results, \
            run.artifact("prediction_set").as_df().to_dict("list")

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_hub_describe_end_to_end(each, tmp_path):
    """hub://describe: stats + histograms + label balance artifacts."""
    df = pd.DataFrame({"x": np.arange(50, dtype=float),
                       "cat": (["a"] * 30 + ["b"] * 20)})
    path = tmp_path / "d.csv"
    df.to_csv(path, index=False)

    def scenario(name, pkg, directory):
        fn = pkg.import_function("hub://describe")
        run = fn.run(local=True, inputs={"dataset": str(path)},
                     params={"label_column": "cat", "bins": 5})
        assert run.state() == "completed", run.status.error
        assert run.status.results["rows"] == 50
        for key in ("summary_stats", "histograms", "label_balance"):
            assert key in run.status.artifact_uris
        db = _module(pkg, "db").get_run_db()
        art = db.read_artifact("histograms", project=run.metadata.project)
        body = _module(pkg, "datastore").store_manager.object(
            url=art["spec"]["target_path"]).get()
        hist = json.loads(body)
        assert sum(hist["x"]["counts"]) == 50
        return run.status.results, hist

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_hub_drift_analysis(each, tmp_path):
    """hub://drift_analysis: per-feature drift table + overall status."""
    rng = np.random.default_rng(0)
    ref = tmp_path / "ref.csv"
    cur = tmp_path / "cur.csv"
    pd.DataFrame({"a": rng.normal(0, 1, 600),
                  "b": rng.normal(0, 1, 600)}).to_csv(ref, index=False)
    pd.DataFrame({"a": rng.normal(0, 1, 600),       # unchanged
                  "b": rng.normal(4, 1, 600)}).to_csv(cur, index=False)

    def scenario(name, pkg, directory):
        fn = pkg.import_function("hub://drift_analysis")
        run = fn.run(inputs={"sample_set": str(cur),
                             "reference_set": str(ref)}, local=True)
        assert run.state() == "completed", run.status.error
        assert run.status.results["drift_status"] == "DRIFT_DETECTED"
        assert run.status.results["drifted_features"] >= 1
        table = run.artifact("drift_table").as_df()
        verdicts = dict(zip(table["feature"], table["verdict"]))
        assert verdicts["b"] == "DRIFT_DETECTED"
        assert verdicts["a"] == "NO_DRIFT"
        return run.status.results, table.to_dict("list")

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_hub_model_server_is_item_14():
    """hub://model_server is a serving function: the port's serving
    runtime is part 14c, so its import raises item 14; the reference
    imports it."""
    assert mlrun_tpu.import_function("hub://model_server").kind == "serving"
    with pytest.raises(NotImplementedError, match="item 14"):
        mlrun_tpu_torch.import_function("hub://model_server")


def test_hub_sources_resolve_in_order(each, tmp_path, monkeypatch):
    """A registered source comes before ``MLT_HUB_SOURCE``, which comes
    before the package's own hub; ``hub://name:tag`` and dashed names
    resolve; an unknown name raises ValueError naming what was tried."""
    own = tmp_path / "own"
    (own / "iris-trainer").mkdir(parents=True)
    (own / "iris-trainer" / "function.yaml").write_text(yaml.safe_dump(
        {"kind": "job", "metadata": {"name": "mine"}, "spec": {}}))
    monkeypatch.setenv("MLT_HUB_SOURCE", str(tmp_path / "env"))

    def scenario(name, pkg, directory):
        hub = _module(pkg, "hub")
        sources = hub.list_hub_sources()
        assert sources[-2:] == [str(tmp_path / "env"),
                                hub.builtin_hub_path()]
        hub.add_hub_source(str(own))
        try:
            mine = pkg.import_function("hub://iris_trainer:latest")
            listed = hub.list_hub_sources()[0]
        finally:
            hub._hub_sources.remove(str(own))
        with pytest.raises(ValueError, match="not found; tried"):
            hub.get_hub_function("hub://no-such-function")
        ref = hub.FunctionReference(url="hub://describe", name="desc")
        fn = ref.to_function()
        return (mine.metadata.name, listed == str(own), fn.metadata.name,
                fn.spec.default_handler,
                hub.FunctionReference.from_dict(ref.to_dict()).to_dict())

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ("mine", True)


def _port_hub_yamls():
    return sorted((ROOT / "mlrun_tpu_torch" / "hub_functions").glob(
        "*/function.yaml"))


def test_port_hub_yamls_name_the_port_and_gpus():
    """Every port hub function: one for each of the reference's six,
    same kind, name and handler; its source (decoded) names the port
    wherever it names the package, and no yaml is sized in TPU terms."""
    ours = {p.parent.name: yaml.safe_load(p.read_text())
            for p in _port_hub_yamls()}
    refs = {p.parent.name: yaml.safe_load(p.read_text())
            for p in sorted((ROOT / "mlrun_tpu" / "hub_functions").glob(
                "*/function.yaml"))}
    assert sorted(ours) == sorted(refs) and len(ours) == 6
    for name, struct in ours.items():
        ref = refs[name]
        assert struct["kind"] == ref["kind"]
        assert struct["metadata"]["name"] == ref["metadata"]["name"]
        assert struct["spec"].get("default_handler") == \
            ref["spec"].get("default_handler")
        assert not {"accelerator_type", "topology"} & set(struct["spec"])
        code = struct["spec"].get("build", {}).get("functionSourceCode")
        if code:
            source = base64.b64decode(code).decode()
            compile(source, name, "exec")
            assert not re.search(r"mlrun_tpu(?!_torch)", source), name
            assert ("mlrun_tpu_torch" in source) == ("mlrun_tpu" in
                                                     base64.b64decode(
                ref["spec"]["build"]["functionSourceCode"]).decode()), name


# -- the top-level names ------------------------------------------------------

TOP_LEVEL = (
    "get_dataitem", "get_object", "get_pipeline", "pipeline_context",
    "auto_mount", "mount_pvc", "get_secret_or_env", "environ", "Version",
    "get_version", "ArtifactType", "MLRunBaseError", "MLRunConflictError",
    "MLRunInvalidArgumentError", "MLRunNotFoundError", "MLRunRuntimeError",
    "MLRunTimeoutError", "DefaultPackager", "Packager", "handler",
    "new_task", "RunObject", "RunTemplate", "HyperParamOptions",
    "Notification", "set_environment", "set_env_from_file")


def test_top_level_exports_parity(each):
    """tests/test_api_parity.py::test_top_level_exports_parity on both
    packages, with the rest of the reference's top-level names."""
    def scenario(name, pkg, directory):
        for attr in ("get_dataitem", "get_object", "get_pipeline",
                     "pipeline_context", "run_function", "build_function",
                     "deploy_function", "auto_mount", "mount_pvc",
                     "get_secret_or_env", "environ", "Version",
                     "ArtifactType", "MLRunInvalidArgumentError",
                     "MLRunNotFoundError", "ProjectMetadata",
                     "DefaultPackager", "Packager", "handler") + TOP_LEVEL:
            assert hasattr(pkg, attr), attr

        blob = directory / "b.txt"
        blob.write_text("payload")
        item = pkg.get_dataitem(str(blob))
        assert item.get(encoding="utf-8") == "payload"
        assert pkg.get_object(str(blob)) == b"payload"
        assert pkg.Version.get()["version"]
        assert issubclass(pkg.MLRunNotFoundError, KeyError)
        # pipeline_context is an OBJECT (pipeline_context.project)
        assert pkg.pipeline_context.project is None  # outside a workflow
        assert not pkg.pipeline_context

        # project-scope sugar rides the current project
        project = pkg.new_project("toplevel", context=str(directory),
                                  save=False)

        def h(context):
            context.log_result("ok", 11)

        project.set_function(name="hfn", handler=h, kind="local")
        run = pkg.run_function("hfn", local=True)
        assert run.status.results["ok"] == 11

        @pkg.handler(labels={"a": "b"}, outputs=["x"])
        def decorated():
            pass

        task = pkg.new_task(name="t", params={"p": 1})
        return (pkg.Version.get(), pkg.get_version(), decorated._mlt_handler,
                pkg.ArtifactType.model, type(task).__name__,
                task.spec.parameters, pkg.environ is __import__("os").environ)

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_set_environment_and_env_file(each, tmp_path, monkeypatch):
    """``set_env_from_file`` loads KEY=VALUE lines (comments and blanks
    skipped); ``set_environment`` sets the artifact path and default
    project and returns them."""
    env_file = tmp_path / "env"
    env_file.write_text("# c\n\nMLT_PARITY_A = 1\nMLT_PARITY_B=x=y\n")

    def scenario(name, pkg, directory):
        for key in ("MLT_PARITY_A", "MLT_PARITY_B", "MLT_ARTIFACT_PATH",
                    "MLT_DEFAULT_PROJECT"):
            monkeypatch.setenv(key, "")  # restored (unset) at teardown
            monkeypatch.delenv(key)
        loaded = pkg.set_env_from_file(str(env_file), return_dict=True)
        import os

        read = (os.environ["MLT_PARITY_A"], os.environ["MLT_PARITY_B"])
        monkeypatch.setenv("MLT_DEFAULT_PROJECT", "default")
        monkeypatch.setenv("MLT_ARTIFACT_PATH", "")
        out = pkg.set_environment(artifact_path=str(tmp_path / "arts"),
                                  project="envproj")
        return loaded, read, out

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][2] == ("envproj", str(tmp_path / "arts"))
