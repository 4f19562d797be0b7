"""sklearn auto-logger — the port's copy of
``mlrun_tpu/frameworks/sklearn``: ``apply_mlrun`` patches an estimator's
``fit`` to log its parameters, test-set metrics, the evaluation plans'
artifacts and the pickled model to the run context;
``SKLearnModelServer`` serves such a pickle."""

from __future__ import annotations

import functools
import pickle
import tempfile
from typing import Any

from ...execution import MLClientCtx
from ...utils import logger


def apply_mlrun(model: Any = None, context: MLClientCtx | None = None,
                model_name: str = "model", tag: str = "",
                x_test=None, y_test=None, sample_set=None,
                label_column: str | None = None, log_model: bool = True,
                **kwargs):
    """Patch a sklearn-API estimator so fit() auto-logs to the context."""
    if context is None:
        from ...run import get_or_create_ctx

        context = get_or_create_ctx("sklearn")

    handler = SKLearnModelHandler(model, context, model_name, tag,
                                  x_test=x_test, y_test=y_test,
                                  sample_set=sample_set,
                                  label_column=label_column,
                                  log_model=log_model)
    if model is not None:
        handler.patch()
    return handler


class SKLearnModelHandler:
    def __init__(self, model, context, model_name="model", tag="",
                 x_test=None, y_test=None, sample_set=None,
                 label_column=None, log_model=True):
        self.model = model
        self.context = context
        self.model_name = model_name
        self.tag = tag
        self.x_test = x_test
        self.y_test = y_test
        self.sample_set = sample_set
        self.label_column = label_column
        self._log_model = log_model

    def patch(self):
        original_fit = self.model.fit

        @functools.wraps(original_fit)
        def wrapped_fit(*args, **kwargs):
            result = original_fit(*args, **kwargs)
            self._post_fit(args, kwargs)
            return result

        self.model.fit = wrapped_fit
        return self.model

    def _post_fit(self, fit_args, fit_kwargs):
        context = self.context
        try:
            params = {
                key: value for key, value in self.model.get_params().items()
                if isinstance(value, (int, float, str, bool))
            }
            context.parameters.update(params)
            context.set_label("model_class", type(self.model).__name__)
        except Exception:  # noqa: BLE001
            pass
        predictions = None
        if self.x_test is not None and self.y_test is not None:
            try:
                predictions = self.model.predict(self.x_test)
            except Exception as exc:  # noqa: BLE001
                logger.warning("test-set prediction failed",
                               error=str(exc))
        metrics = self._compute_metrics(predictions)
        if metrics:
            context.log_results(metrics)
        if predictions is not None:
            # the evaluation plans (confusion matrix, roc, calibration,
            # feature importance, residuals) over the same predictions
            from .._common import produce_artifacts

            try:
                produce_artifacts(context, self.model, self.x_test,
                                  self.y_test, y_pred=predictions)
            except Exception as exc:  # noqa: BLE001 - plots are best-effort
                logger.warning("artifact plans failed", error=str(exc))
        if self._log_model:
            self.log_model(metrics)

    def _compute_metrics(self, predictions=None) -> dict:
        if self.x_test is None or self.y_test is None:
            return {}
        import numpy as np

        from .._common.plans import _is_classifier

        metrics: dict = {}
        try:
            if predictions is None:
                predictions = self.model.predict(self.x_test)
            y = np.asarray(self.y_test).reshape(-1)
            p = np.asarray(predictions).reshape(-1)
            if _is_classifier(self.model, p):
                from sklearn.metrics import accuracy_score, f1_score

                metrics["accuracy"] = float(accuracy_score(y, p))
                try:
                    metrics["f1_score"] = float(
                        f1_score(y, p, average="macro"))
                except ValueError:
                    pass
            else:
                from sklearn.metrics import mean_squared_error, r2_score

                metrics["mse"] = float(mean_squared_error(y, p))
                metrics["r2"] = float(r2_score(y, p))
        except Exception as exc:  # noqa: BLE001
            logger.warning("metric computation failed", error=str(exc))
        return metrics

    def log_model(self, metrics: dict | None = None):
        # drop the instance-level fit patch so the estimator pickles clean
        patched_fit = self.model.__dict__.pop("fit", None)
        tmp = tempfile.NamedTemporaryFile(suffix=".pkl", delete=False)
        try:
            with open(tmp.name, "wb") as fp:
                pickle.dump(self.model, fp)
        finally:
            if patched_fit is not None:
                self.model.fit = patched_fit
        inputs = None
        outputs = None
        if self.sample_set is not None and self.label_column:
            inputs = [
                {"name": c, "value_type": str(self.sample_set[c].dtype)}
                for c in self.sample_set.columns if c != self.label_column
            ]
            outputs = [{"name": self.label_column}]
        return self.context.log_model(
            self.model_name, model_file=tmp.name, framework="sklearn",
            algorithm=type(self.model).__name__, metrics=metrics or {},
            tag=self.tag, inputs=inputs, outputs=outputs,
            training_set=self.sample_set, label_column=self.label_column)


class SKLearnModelServer:
    """V2ModelServer for pickled sklearn models."""

    def __new__(cls, *args, **kwargs):
        # defined here to avoid a serving import at module import time
        from ...serving.v2_serving import V2ModelServer

        class _Server(V2ModelServer):
            def load(self):
                model_file, extra = self.get_model(".pkl")
                with open(model_file, "rb") as fp:
                    self.model = pickle.load(fp)

            def predict(self, request):
                import numpy as np

                inputs = np.asarray(request["inputs"])
                return self.model.predict(inputs).tolist()

        return _Server(*args, **kwargs)
