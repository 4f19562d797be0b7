"""LightGBM adapter — the port's copy of ``mlrun_tpu/frameworks/lightgbm``
(its own interface with training callbacks, not a sklearn alias).

- sklearn-API estimators (``LGBMClassifier``/``LGBMRegressor``): the
  sklearn fit-patch carries metric logging, plus a lightgbm-specific
  split/gain feature-importance artifact post-fit.
- native ``lightgbm.train`` workflows: ``mlrun_callback`` follows the
  lightgbm callback contract (a callable invoked each iteration with a
  ``CallbackEnv`` carrying ``iteration`` and ``evaluation_result_list``)
  and ``log_booster`` logs the trained booster.

Booster logic is duck-typed and testable without the lightgbm package;
only ``apply_mlrun`` on a real estimator requires the import.
"""

from __future__ import annotations

from .._common.boosters import (
    estimator_importance_scores,
    log_booster_model,
    log_importance_artifact,
    wrap_post_fit,
)


def _importance_artifact(context, booster, model_name: str) -> dict:
    """split/gain importances for Booster objects,
    ``feature_importances_`` for sklearn-API estimators."""
    scores: dict = {}
    importance = getattr(booster, "feature_importance", None)
    if importance is None:  # sklearn-API estimator
        scores = estimator_importance_scores(booster)
    else:
        names = (booster.feature_name()
                 if callable(getattr(booster, "feature_name", None))
                 else [])
        for importance_type in ("split", "gain"):
            try:
                values = importance(importance_type=importance_type)
            except Exception:  # noqa: BLE001
                continue
            keys = names or [f"f{i}" for i in range(len(values))]
            scores[importance_type] = {
                str(k): float(v) for k, v in zip(keys, values)}
    log_importance_artifact(context, model_name, scores, "lightgbm")
    return scores


def mlrun_callback(context, log_every: int = 10):
    """A lightgbm training callback: logs each eval metric per iteration
    (lightgbm calls the callback with a CallbackEnv whose
    ``evaluation_result_list`` holds ``(data_name, metric, value, _)``
    tuples) and the final values as run results via ``.finalize()``."""
    state = {"last": []}

    def callback(env):
        state["last"] = list(env.evaluation_result_list or [])
        if env.iteration % max(1, log_every) == 0:
            metrics = {f"{item[0]}-{item[1]}": float(item[2])
                       for item in state["last"]}
            if metrics:
                context.log_metrics(metrics, step=env.iteration)

    def finalize():
        for item in state["last"]:
            context.log_result(f"{item[0]}-{item[1]}", float(item[2]))

    callback.order = 20  # lightgbm sorts callbacks by this attribute
    callback.finalize = finalize
    return callback


def log_booster(context, booster, model_name: str = "model",
                tag: str = "", metrics: dict | None = None,
                label_column: str | None = None):
    """Log a trained booster (native ``lightgbm.train`` path) as a model
    artifact with importance scores."""
    _importance_artifact(context, booster, model_name)
    return log_booster_model(
        context, booster, "lightgbm", ".txt", model_name=model_name,
        tag=tag, metrics=metrics, label_column=label_column)


def apply_mlrun(model=None, context=None, model_name: str = "model",
                tag: str = "", **kwargs):
    """Auto-log an sklearn-API lightgbm estimator: metrics via the
    sklearn fit patch, plus the importance artifact post-fit."""
    try:
        import lightgbm  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "lightgbm is not installed in this environment") from exc
    from ..sklearn import apply_mlrun as sklearn_apply

    handler = sklearn_apply(model=model, context=context,
                            model_name=model_name, tag=tag, **kwargs)
    return wrap_post_fit(handler, _importance_artifact)


def LGBMModelServer(*args, **kwargs):
    from ..sklearn import SKLearnModelServer

    return SKLearnModelServer(*args, **kwargs)
