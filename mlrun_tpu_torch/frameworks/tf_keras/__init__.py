"""TF/Keras auto-logger — the port's copy of
``mlrun_tpu/frameworks/tf_keras``: ``apply_mlrun`` wraps a keras
model's ``fit`` with the per-epoch logging callback, the structured
callbacks of ``_common`` (through ``_SharedCallbackBridge``) and an
optional TensorBoard writer, then logs the results and the saved
model; ``TFKerasModelServer`` serves it. Keras runs where the user's
code runs; tensorflow is imported inside the calls."""

from __future__ import annotations

import os
import tempfile
from ...execution import MLClientCtx
from ...utils import logger


def apply_mlrun(model=None, context: MLClientCtx | None = None,
                model_name: str = "model", tag: str = "",
                x_test=None, y_test=None, log_model: bool = True,
                tensorboard: bool = False,
                tensorboard_weights: bool = False,
                callbacks: list | None = None, **kwargs):
    """Patch a keras model so fit() logs per-epoch metrics and the final
    model to the run context. ``tensorboard=True`` additionally writes
    tf.summary event files (scalars per epoch; weight histograms with
    ``tensorboard_weights=True``) and registers the log dir as an
    artifact (``TensorboardLoggingCallback``)."""
    if context is None:
        from ...run import get_or_create_ctx

        context = get_or_create_ctx("tf-keras")
    handler = KerasModelHandler(model, context, model_name, tag,
                                x_test=x_test, y_test=y_test,
                                log_model=log_model,
                                tensorboard=tensorboard,
                                tensorboard_weights=tensorboard_weights,
                                callbacks=callbacks)
    if model is not None:
        handler.patch()
    return handler


class _MLRunLoggingCallback:
    """Per-epoch metric logging callback."""

    def __new__(cls, context, handler):
        from tensorflow import keras

        class _Callback(keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                if logs and context.is_logging_worker():
                    context.log_metrics(
                        {k: float(v) for k, v in logs.items()}, step=epoch)

            def on_train_end(self, logs=None):
                handler._post_fit(logs)

        return _Callback()


class TensorboardLoggingCallback:
    """tf.summary writer callback: per-epoch scalar summaries and
    optional weight histograms into a run-scoped log dir that lands in the
    artifact registry."""

    def __new__(cls, context, log_dir: str, weights: bool = False):
        import tensorflow as tf
        from tensorflow import keras

        writer = tf.summary.create_file_writer(log_dir)

        class _Callback(keras.callbacks.Callback):
            def on_epoch_end(self, epoch, logs=None):
                if not context.is_logging_worker():
                    return
                with writer.as_default(step=epoch):
                    for key, value in (logs or {}).items():
                        tf.summary.scalar(key, float(value))
                    if weights:
                        for weight in self.model.weights:
                            tf.summary.histogram(
                                weight.name.replace(":", "_"), weight)
                writer.flush()

            def on_train_end(self, logs=None):
                writer.close()

        return _Callback()


class _SharedCallbackBridge:
    """Translate the keras event stream into the framework-wide
    ``frameworks._common.Callback`` hooks, so one EarlyStopping /
    Checkpoint / TensorBoard / EvalPlan implementation serves keras too.
    A False vote from an epoch hook sets ``model.stop_training`` (the
    keras-native graceful stop)."""

    def __new__(cls, hooks, model):
        from tensorflow import keras

        class _Bridge(keras.callbacks.Callback):
            _global_step = 0  # keras batch indexes reset per epoch; the
            # shared hooks (checkpoint-every-N etc.) need a monotonic step

            def on_train_begin(self, logs=None):
                hooks.on_train_begin()

            def on_epoch_begin(self, epoch, logs=None):
                hooks.on_epoch_begin(epoch)

            def on_train_batch_end(self, batch, logs=None):
                metrics = {k: float(v) for k, v in (logs or {}).items()}
                if not hooks.on_step_end(self._global_step, metrics):
                    model.stop_training = True
                self._global_step += 1

            def on_epoch_end(self, epoch, logs=None):
                metrics = {k: float(v) for k, v in (logs or {}).items()}
                if not hooks.on_epoch_end(epoch, metrics):
                    model.stop_training = True

            def on_train_end(self, logs=None):
                hooks.on_train_end(
                    {k: float(v) for k, v in (logs or {}).items()})

        return _Bridge()


class KerasModelHandler:
    def __init__(self, model, context, model_name="model", tag="",
                 x_test=None, y_test=None, log_model=True,
                 tensorboard=False, tensorboard_weights=False,
                 callbacks=None):
        self.model = model
        self.context = context
        self.model_name = model_name
        self.tag = tag
        self.x_test = x_test
        self.y_test = y_test
        self._log_model = log_model
        self._tensorboard = tensorboard
        self._tensorboard_weights = tensorboard_weights
        self._shared_callbacks = callbacks
        self._tb_dir: str | None = None
        self._patched = False

    def patch(self):
        if self._patched:
            return self.model
        original_fit = self.model.fit
        handler = self

        def wrapped_fit(*args, **kwargs):
            callbacks = list(kwargs.get("callbacks") or [])
            callbacks.append(_MLRunLoggingCallback(handler.context, handler))
            if handler._shared_callbacks:
                from .._common.callbacks import CallbackList

                hooks = CallbackList(handler._shared_callbacks,
                                     context=handler.context,
                                     model=handler.model)
                callbacks.append(
                    _SharedCallbackBridge(hooks, handler.model))
            if handler._tensorboard:
                handler._tb_dir = os.path.join(
                    tempfile.mkdtemp(prefix="mlt-tb-"), "train")
                callbacks.append(TensorboardLoggingCallback(
                    handler.context, handler._tb_dir,
                    weights=handler._tensorboard_weights))
            kwargs["callbacks"] = callbacks
            return original_fit(*args, **kwargs)

        self.model.fit = wrapped_fit
        self._patched = True
        return self.model

    def _post_fit(self, logs=None):
        metrics = {k: float(v) for k, v in (logs or {}).items()}
        if self.x_test is not None and self.y_test is not None:
            try:
                evaluation = self.model.evaluate(
                    self.x_test, self.y_test, verbose=0, return_dict=True)
                metrics.update(
                    {f"test_{k}": float(v) for k, v in evaluation.items()})
            except Exception as exc:  # noqa: BLE001
                logger.warning("keras evaluation failed", error=str(exc))
        if metrics:
            self.context.log_results(metrics)
        if self._tb_dir and os.path.isdir(self._tb_dir):
            try:
                self.context.log_artifact(
                    f"{self.model_name}-tensorboard",
                    local_path=self._tb_dir)
            except Exception as exc:  # noqa: BLE001 - tb dir best-effort
                logger.warning("tensorboard artifact failed",
                               error=str(exc))
        if self._log_model:
            self.log_model(metrics)

    def log_model(self, metrics: dict | None = None):
        tmp_dir = tempfile.mkdtemp()
        path = os.path.join(tmp_dir, f"{self.model_name}.keras")
        self.model.save(path)
        return self.context.log_model(
            self.model_name, model_file=path, framework="tf.keras",
            metrics=metrics or {}, tag=self.tag)


class TFKerasModelServer:
    """V2ModelServer for saved keras models."""

    def __new__(cls, *args, **kwargs):
        from ...serving.v2_serving import V2ModelServer

        class _Server(V2ModelServer):
            def load(self):
                from tensorflow import keras

                model_file, _ = self.get_model(".keras")
                self.model = keras.models.load_model(model_file)

            def predict(self, request):
                import numpy as np

                inputs = np.asarray(request["inputs"])
                return self.model.predict(inputs, verbose=0).tolist()

        return _Server(*args, **kwargs)
