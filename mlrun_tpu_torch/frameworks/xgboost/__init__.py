"""XGBoost adapter — the port's copy of ``mlrun_tpu/frameworks/xgboost``
(its own interface, not a pass-through to sklearn).

Two integration levels:

- sklearn-API estimators (``XGBClassifier``/``XGBRegressor``): the sklearn
  fit-patch carries the metric logging, and an xgboost-specific post-fit
  hook adds the feature-importance artifact.
- native ``xgboost.train`` Booster workflows: ``MLRunLoggingCallback``
  implements the xgboost callback contract (``after_iteration``) to log
  per-iteration eval results, and ``log_booster`` logs the trained booster
  with gain/weight importances.

Everything operates duck-typed on the booster object so the logic is
testable without the xgboost package; only ``apply_mlrun`` on a real
estimator requires the import.
"""

from __future__ import annotations

from .._common.boosters import (
    estimator_importance_scores,
    log_booster_model,
    log_importance_artifact,
    wrap_post_fit,
)

try:  # real xgboost requires callbacks to subclass TrainingCallback
    from xgboost.callback import TrainingCallback as _CallbackBase
except ImportError:
    class _CallbackBase:  # duck-typed stand-in when xgboost is absent
        pass


def _importance_artifact(context, booster, model_name: str) -> dict:
    """Log per-feature importance scores (gain + weight for boosters,
    ``feature_importances_`` for sklearn-API estimators) as a json
    artifact; returns the scores dict."""
    scores: dict = {}
    get_score = getattr(booster, "get_score", None)
    if get_score is None:  # sklearn-API estimator
        scores = estimator_importance_scores(booster)
    else:
        for importance_type in ("gain", "weight"):
            try:
                scores[importance_type] = {
                    k: float(v)
                    for k, v in get_score(
                        importance_type=importance_type).items()}
            except Exception:  # noqa: BLE001 - not all boosters score both
                continue
    log_importance_artifact(context, model_name, scores, "xgboost")
    return scores


class MLRunLoggingCallback(_CallbackBase):
    """xgboost training callback: logs eval metrics per iteration and the
    final values as results (xgboost invokes
    ``after_iteration(model, epoch, evals_log)`` each boosting round)."""

    def __init__(self, context, log_every: int = 10):
        self.context = context
        self.log_every = max(1, log_every)
        self.evals_log: dict = {}

    def before_training(self, model):
        return model

    def after_training(self, model):
        for data_name, metrics in self.evals_log.items():
            for metric_name, history in metrics.items():
                if history:
                    self.context.log_result(
                        f"{data_name}-{metric_name}", float(history[-1]))
        return model

    def after_iteration(self, model, epoch: int, evals_log: dict) -> bool:
        self.evals_log = evals_log
        if epoch % self.log_every == 0:
            for data_name, metrics in evals_log.items():
                for metric_name, history in metrics.items():
                    if history:
                        self.context.log_metrics(
                            {f"{data_name}-{metric_name}":
                             float(history[-1])}, step=epoch)
        return False  # never request early stop


def log_booster(context, booster, model_name: str = "model",
                tag: str = "", metrics: dict | None = None,
                label_column: str | None = None):
    """Log a trained booster (native ``xgboost.train`` path) as a model
    artifact with importance scores."""
    _importance_artifact(context, booster, model_name)
    return log_booster_model(
        context, booster, "xgboost", ".json", model_name=model_name,
        tag=tag, metrics=metrics, label_column=label_column)


def apply_mlrun(model=None, context=None, model_name: str = "model",
                tag: str = "", **kwargs):
    """Auto-log an sklearn-API xgboost estimator: metrics via the sklearn
    fit patch, plus the xgboost feature-importance artifact post-fit."""
    try:
        import xgboost  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "xgboost is not installed in this environment") from exc
    from ..sklearn import apply_mlrun as sklearn_apply

    handler = sklearn_apply(model=model, context=context,
                            model_name=model_name, tag=tag, **kwargs)
    return wrap_post_fit(handler, _importance_artifact)


def XGBoostModelServer(*args, **kwargs):
    from ..sklearn import SKLearnModelServer

    return SKLearnModelServer(*args, **kwargs)
