"""mlrun_tpu_torch's framework adapters (frameworks/, ROADMAP item 15 and
fault 3.10) against mlrun_tpu's: ``apply_mlrun`` for sklearn, the
xgboost and lightgbm interfaces on the reference tests' duck-typed
boosters (neither package is installed), tf_keras with its TensorBoard
writer and the shared-callback bridge, the ONNX gates, the user-code
torch adapter (``train`` / ``evaluate`` / ``TorchModelServer``) and
``auto_mlrun``.

The contracts are tests/test_frameworks.py's and tests/test_callbacks.py's
torch and keras cases, run on both packages with the same inputs and the
same assertions; where the two runs are deterministic (sklearn, the
boosters, seeded torch), their results must also be equal. Each package
writes under its own ``MLT_HOME`` with a fresh run db. tensorflow is
imported inside the keras tests only.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import mlrun_tpu
import mlrun_tpu.db as jdb
import mlrun_tpu_torch
from mlrun_tpu.config import mlconf
from mlrun_tpu.datastore import store_manager as jstore
from mlrun_tpu_torch import db as tdb
from mlrun_tpu_torch.datastore import store_manager as tstore
from tests.torch_registries import registries_left_as_found  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": mlrun_tpu, "port": mlrun_tpu_torch}


def _reset():
    jdb.set_run_db(None)
    jdb._run_db = None
    jstore._db = None
    tdb.set_run_db(None)
    tstore._db = None


@pytest.fixture(autouse=True)
def _fresh_dbs():
    _reset()
    yield
    _reset()


@pytest.fixture()
def each(tmp_path, monkeypatch):
    """``each(scenario)`` runs ``scenario(name, pkg)`` once per package,
    each under its own MLT_HOME with a fresh run db; returns
    {name: result}."""

    def run(scenario):
        got = {}
        for name, pkg in PKGS.items():
            monkeypatch.setenv("MLT_HOME", str(tmp_path / f"home-{name}"))
            mlconf.reload()
            _reset()
            got[name] = scenario(name, pkg)
        return got

    return run


def _module(pkg, path):
    return importlib.import_module(f"{pkg.__name__}.{path}")


def _server_kwargs(name):
    """The port's torch server runs on the card by default; here on the
    CPU."""
    return {"device": "cpu"} if name == "port" else {}


# -- sklearn ------------------------------------------------------------------

def test_sklearn_apply_mlrun_autologs(each):
    def scenario(name, pkg):
        sk = _module(pkg, "frameworks.sklearn")

        def handler(context):
            from sklearn.datasets import load_iris
            from sklearn.linear_model import LogisticRegression
            from sklearn.model_selection import train_test_split

            data = load_iris(as_frame=True)
            X_train, X_test, y_train, y_test = train_test_split(
                data.data, data.target, test_size=0.3, random_state=0)
            model = LogisticRegression(max_iter=200)
            sk.apply_mlrun(model, context, model_name="iris",
                           x_test=X_test, y_test=y_test)
            model.fit(X_train, y_train)

        run = pkg.new_function("sk", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert run.status.results["accuracy"] > 0.8
        assert "iris" in run.status.artifact_uris
        # the model round-trips through the registry into a model server
        server = sk.SKLearnModelServer(
            None, name="iris", model_path=run.status.artifact_uris["iris"])
        server.post_init()
        event = _module(pkg, "serving").MockEvent(
            body={"inputs": [[5.1, 3.5, 1.4, 0.2]]},
            path="/v2/models/iris/infer")
        out = server.do_event(event)
        assert out.body["outputs"][0] in (0, 1, 2)
        return (run.status.results, sorted(run.status.artifact_uris),
                out.body["outputs"])

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_sklearn_autolog_produces_plan_artifacts(each):
    def scenario(name, pkg):
        sk = _module(pkg, "frameworks.sklearn")

        def handler(context):
            from sklearn.datasets import load_iris
            from sklearn.ensemble import RandomForestClassifier
            from sklearn.model_selection import train_test_split

            data = load_iris(as_frame=True)
            X_train, X_test, y_train, y_test = train_test_split(
                data.data, data.target, test_size=0.3, random_state=0)
            model = RandomForestClassifier(n_estimators=10, random_state=0)
            sk.apply_mlrun(model, context, model_name="rf",
                           x_test=X_test, y_test=y_test)
            model.fit(X_train, y_train)

        run = pkg.new_function("ska", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert "confusion_matrix" in run.status.artifact_uris
        assert "feature_importance" in run.status.artifact_uris
        return run.status.results, sorted(run.status.artifact_uris)

    got = each(scenario)
    assert got["port"] == got["jax"]


# -- the boosters, on the reference tests' fakes ------------------------------

def test_xgboost_booster_logging(each):
    """xgboost interface without the package: callback contract +
    duck-typed booster logging."""

    class FakeBooster:
        best_iteration = 7

        def get_score(self, importance_type="gain"):
            return {"f0": 1.5, "f1": 0.5} if importance_type == "gain" \
                else {"f0": 3, "f1": 1}

        def save_model(self, path):
            with open(path, "w") as fp:
                fp.write("{}")

    def scenario(name, pkg):
        xgb = _module(pkg, "frameworks.xgboost")

        def handler(context):
            booster = FakeBooster()
            callback = xgb.MLRunLoggingCallback(context, log_every=1)
            evals = {"train": {"rmse": []}, "valid": {"rmse": []}}
            for epoch in range(3):
                evals["train"]["rmse"].append(1.0 / (epoch + 1))
                evals["valid"]["rmse"].append(1.5 / (epoch + 1))
                assert callback.after_iteration(booster, epoch,
                                                evals) is False
            callback.after_training(booster)
            xgb.log_booster(context, booster, model_name="xgb")

        run = pkg.new_function("xgbt", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert run.status.results["valid-rmse"] == pytest.approx(0.5)
        assert "xgb" in run.status.artifact_uris
        assert "xgb_feature_importance" in run.status.artifact_uris
        db = _module(pkg, "db").get_run_db()
        model = db.read_artifact("xgb", project=run.metadata.project)
        assert model["spec"]["parameters"]["best_iteration"] == 7
        # the temp save file is deleted after logging: loading through
        # the store uri proves the model payload was uploaded
        local, spec, _ = _module(pkg, "artifacts.model").get_model(
            run.status.artifact_uris["xgb"])
        with open(local) as fp:
            assert fp.read() == "{}"
        assert spec.model_file == local.split("/")[-1]
        importances = db.read_artifact("xgb_feature_importance",
                                       project=run.metadata.project)
        body = _module(pkg, "datastore").store_manager.object(
            url=importances["spec"]["target_path"]).get()
        scores = json.loads(body)
        assert scores["gain"]["f0"] == 1.5 and scores["weight"]["f1"] == 1
        return run.status.results, scores

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_lightgbm_callback_and_booster(each):
    """lightgbm interface without the package: CallbackEnv-style callback
    + duck-typed booster logging."""
    from collections import namedtuple

    Env = namedtuple("CallbackEnv", "iteration evaluation_result_list")

    class FakeBooster:
        best_iteration = 3

        def feature_name(self):
            return ["a", "b"]

        def feature_importance(self, importance_type="split"):
            return [2, 4] if importance_type == "split" else [0.2, 0.8]

        def save_model(self, path):
            with open(path, "w") as fp:
                fp.write("tree")

    def scenario(name, pkg):
        lgbm = _module(pkg, "frameworks.lightgbm")

        def handler(context):
            callback = lgbm.mlrun_callback(context, log_every=1)
            for i in range(3):
                callback(Env(iteration=i, evaluation_result_list=[
                    ("valid", "l2", 2.0 / (i + 1), True)]))
            callback.finalize()
            lgbm.log_booster(context, FakeBooster(), model_name="lgbm")

        run = pkg.new_function("lgbt", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert run.status.results["valid-l2"] == pytest.approx(2.0 / 3)
        assert "lgbm" in run.status.artifact_uris
        assert "lgbm_feature_importance" in run.status.artifact_uris
        return run.status.results, sorted(run.status.artifact_uris)

    got = each(scenario)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("framework", ["xgboost", "lightgbm"])
def test_booster_apply_mlrun_needs_its_package(each, framework):
    """Neither package is installed: ``apply_mlrun`` raises ImportError
    naming it in both packages, and the model servers are the sklearn
    server."""
    def scenario(name, pkg):
        adapter = _module(pkg, f"frameworks.{framework}")
        with pytest.raises(ImportError, match=framework):
            adapter.apply_mlrun(object(), context=object())
        server = getattr(adapter, {"xgboost": "XGBoostModelServer",
                                   "lightgbm": "LGBMModelServer"}[framework])(
            None, name="b", model_path="/nowhere")
        return type(server).__mro__[1].__name__

    got = each(scenario)
    assert got["port"] == got["jax"] == "V2ModelServer"


# -- onnx ---------------------------------------------------------------------

def test_onnx_gates_raise_without_their_packages(each):
    """onnx and onnxruntime are not installed: ``to_onnx`` and
    ``ONNXModelServer`` raise ImportError in both packages."""
    def scenario(name, pkg):
        onnx = _module(pkg, "frameworks.onnx")
        with pytest.raises(ImportError, match="onnx package") as export:
            onnx.to_onnx(torch.nn.Linear(2, 1), sample_input=torch.ones(1, 2))
        with pytest.raises(ImportError, match="onnxruntime") as serve:
            onnx.ONNXModelServer(None, name="o", model_path="/nowhere")
        return type(export.value).__name__, type(serve.value).__name__

    got = each(scenario)
    assert got["port"] == got["jax"] == ("ImportError", "ImportError")


# -- tf_keras (tensorflow imported inside) ------------------------------------

def test_tf_keras_apply_mlrun(each):
    pytest.importorskip("tensorflow")

    def scenario(name, pkg):
        tfk = _module(pkg, "frameworks.tf_keras")

        def handler(context):
            from tensorflow import keras

            rng = np.random.default_rng(0)
            X = rng.normal(size=(64, 4)).astype("float32")
            y = (X.sum(axis=1) > 0).astype("float32")
            model = keras.Sequential([
                keras.layers.Dense(8, activation="relu", input_shape=(4,)),
                keras.layers.Dense(1, activation="sigmoid"),
            ])
            model.compile(optimizer="adam", loss="binary_crossentropy",
                          metrics=["accuracy"])
            tfk.apply_mlrun(model, context, model_name="keras-model",
                            x_test=X[:16], y_test=y[:16])
            model.fit(X, y, epochs=2, verbose=0)

        run = pkg.new_function("k", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert "loss" in run.status.results
        assert "keras-model" in run.status.artifact_uris
        return sorted(run.status.results), sorted(run.status.artifact_uris)

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_tf_keras_tensorboard_callback(each):
    pytest.importorskip("tensorflow")
    import glob

    def scenario(name, pkg):
        tfk = _module(pkg, "frameworks.tf_keras")

        def handler(context):
            from tensorflow import keras

            rng = np.random.default_rng(0)
            X = rng.normal(size=(32, 4)).astype("float32")
            y = (X.sum(axis=1) > 0).astype("float32")
            model = keras.Sequential([
                keras.layers.Dense(4, activation="relu", input_shape=(4,)),
                keras.layers.Dense(1, activation="sigmoid"),
            ])
            model.compile(optimizer="adam", loss="binary_crossentropy")
            tfk.apply_mlrun(model, context, model_name="tbm",
                            tensorboard=True, tensorboard_weights=True)
            model.fit(X, y, epochs=2, verbose=0)

        run = pkg.new_function("tb", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert "tbm-tensorboard" in run.status.artifact_uris
        # event files actually written
        target = run.artifact("tbm-tensorboard").local()
        events = glob.glob(f"{target}/**/events.out.tfevents.*",
                           recursive=True) + glob.glob(
            f"{target}/events.out.tfevents.*")
        assert events, target
        return sorted(run.status.artifact_uris)

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_keras_bridge_early_stop(each, tmp_path):
    """tests/test_callbacks.py's keras case: the package's own
    EarlyStoppingCallback, through ``_SharedCallbackBridge``, sets keras'
    ``stop_training``."""
    keras = pytest.importorskip("tensorflow.keras")

    def scenario(name, pkg):
        tfk = _module(pkg, "frameworks.tf_keras")
        common = _module(pkg, "frameworks._common")
        context = pkg.get_or_create_ctx(
            "kerascb", spec={"metadata": {"project": "cbp"},
                             "spec": {"output_path": str(tmp_path / name)}})
        model = keras.Sequential([keras.layers.Dense(1, input_shape=(4,))])
        model.compile(optimizer="sgd", loss="mse")
        stopper = common.EarlyStoppingCallback(monitor="loss", patience=1,
                                               min_delta=100.0)
        tfk.apply_mlrun(model, context=context, log_model=False,
                        callbacks=[stopper])
        x = np.random.default_rng(0).normal(size=(32, 4)).astype("float32")
        y = x.sum(axis=1, keepdims=True).astype("float32")
        history = model.fit(x, y, epochs=10, verbose=0)
        assert len(history.history["loss"]) < 10  # stop_training honoured
        return len(history.history["loss"])

    got = each(scenario)
    assert got["port"] == got["jax"]


# -- the user-code torch adapter (fault 3.10) ---------------------------------

def _mlp():
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 1))


def test_torch_train_and_serve(each):
    def scenario(name, pkg):
        adapter = _module(pkg, "frameworks.torch")

        def handler(context):
            rng = torch.Generator().manual_seed(0)
            X = torch.randn(64, 4, generator=rng)
            y = X.sum(dim=1, keepdim=True)
            loader = [(X[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
            torch.manual_seed(0)
            model = _mlp()
            adapter.train(model, torch.nn.MSELoss(),
                          torch.optim.Adam(model.parameters(), lr=1e-2),
                          loader, context=context, epochs=3,
                          model_name="torch-model")

        run = pkg.new_function("tt", kind="local", handler=handler).run(
            local=True)
        assert run.state() == "completed", run.status.error
        assert "loss" in run.status.results
        assert "torch-model" in run.status.artifact_uris
        # serve the registered state dict
        server = adapter.TorchModelServer(
            None, name="t", model_path=run.status.artifact_uris["torch-model"],
            model_factory=_mlp, **_server_kwargs(name))
        server.post_init()
        out = server.do_event(_module(pkg, "serving").MockEvent(
            body={"inputs": [[1.0, 2.0, 3.0, 4.0]]},
            path="/v2/models/t/infer"))
        assert len(out.body["outputs"]) == 1
        return run.status.results, out.body["outputs"]

    got = each(scenario)
    assert got["port"] == got["jax"]


def _recorder(pkg):
    """A recording Callback subclass of ``pkg``'s base."""
    base = _module(pkg, "frameworks._common").Callback

    class Recorder(base):
        def __init__(self):
            self.events = []

        def on_train_begin(self):
            self.events.append("train_begin")

        def on_epoch_begin(self, epoch):
            self.events.append(("epoch_begin", epoch))

        def on_step_end(self, step, metrics):
            self.events.append(("step", step))

        def on_epoch_end(self, epoch, metrics):
            self.events.append(("epoch_end", epoch))

        def on_train_end(self, metrics=None):
            self.events.append("train_end")

    return Recorder()


def _torch_bits():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    xs = torch.randn(32, 4)
    ys = xs.sum(dim=1, keepdim=True)
    loader = list(zip(xs.split(8), ys.split(8)))
    return model, loader


def test_torch_train_callbacks_and_early_stop(each, tmp_path):
    def scenario(name, pkg):
        adapter = _module(pkg, "frameworks.torch")
        common = _module(pkg, "frameworks._common")
        model, loader = _torch_bits()
        context = pkg.get_or_create_ctx(
            "torchcb", spec={"metadata": {"project": "cbp"},
                             "spec": {"output_path": str(tmp_path / name)}})
        rec = _recorder(pkg)
        stopper = common.EarlyStoppingCallback(monitor="loss", patience=1,
                                               min_delta=100.0)
        out = adapter.train(model, torch.nn.functional.mse_loss,
                            torch.optim.SGD(model.parameters(), lr=0.05),
                            loader, context=context, epochs=10,
                            callbacks=[rec, stopper], log_model=False)
        assert out["stopped_early"] is True
        epochs_seen = [e for e in rec.events
                       if isinstance(e, tuple) and e[0] == "epoch_end"]
        assert len(epochs_seen) < 10
        assert rec.events[-1] == "train_end"
        return out, rec.events

    got = each(scenario)
    assert got["port"] == got["jax"]


def test_torch_train_metric_functions(each, tmp_path):
    """User metric callables m(y_pred, y_true) averaged over train and
    validation epochs."""
    def mae(y_pred, y_true):
        return (y_pred - y_true).abs().mean()

    def scenario(name, pkg):
        adapter = _module(pkg, "frameworks.torch")
        model, loader = _torch_bits()
        context = pkg.get_or_create_ctx(
            "torchmet", spec={"metadata": {"project": "cbp"},
                              "spec": {"output_path": str(tmp_path / name)}})
        out = adapter.train(model, torch.nn.functional.mse_loss,
                            torch.optim.SGD(model.parameters(), lr=0.05),
                            loader, context=context, epochs=3,
                            validation_loader=loader, metrics=[mae],
                            log_model=False)
        assert "mae" in out and out["mae"] >= 0
        assert "validation_mae" in out and "validation_loss" in out
        assert "lr" in out and out["lr"] == 0.05
        ev = adapter.evaluate(model, torch.nn.functional.mse_loss, loader,
                              metrics=[mae])
        assert "eval_loss" in ev and "eval_mae" in ev
        names = adapter._metric_names([lambda p, t: 0, lambda p, t: 1, mae])
        return out, ev, names

    got = each(scenario)
    assert got["port"] == got["jax"]
    assert got["port"][2] == ["<lambda>", "<lambda>_2", "mae"]


def test_torch_model_server_device():
    """The port's departure (ROADMAP 3): ``TorchModelServer`` loads and
    predicts on its ``device`` (default ``"cuda"``); with no CUDA device
    and no ``device="cpu"``, ``load`` fails with a clear error instead of
    serving on the CPU. ``train`` and ``evaluate`` leave a CPU model's
    batches where they are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mlrun_tpu_torch.frameworks.torch import TorchModelServer

    server = TorchModelServer(None, name="t", model_path="/nowhere",
                              model_factory=_mlp)
    assert server.device == "cuda"
    server.post_init()
    assert not server.ready
    assert "no CUDA device" in server.error and "device='cpu'" in server.error


def test_auto_mlrun_routes_like_the_reference(each):
    """sklearn estimators go to the sklearn adapter, no model goes to the
    auto-trainer's interface (the reference's JAX auto-trainer, the
    port's torch one), and anything else raises the reference's
    ValueError, a torch module included."""
    from sklearn.linear_model import LogisticRegression

    def scenario(name, pkg):
        frameworks = _module(pkg, "frameworks")
        context = pkg.get_or_create_ctx("auto")
        handler = frameworks.auto_mlrun(LogisticRegression(), context=context)
        trainer = frameworks.auto_mlrun(None, context=context)
        with pytest.raises(ValueError, match="cannot auto-detect"):
            frameworks.auto_mlrun(torch.nn.Linear(2, 1), context=context)
        return type(handler).__name__, type(trainer).__name__

    got = each(scenario)
    assert got["jax"] == ("SKLearnModelHandler", "JaxTrainerInterface")
    assert got["port"] == ("SKLearnModelHandler", "TorchTrainerInterface")
