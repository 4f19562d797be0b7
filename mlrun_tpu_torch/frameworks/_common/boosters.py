"""Booster-model logging shared by the gradient-boosting adapters — the
port's copy of ``mlrun_tpu/frameworks/_common/boosters.py``: one save and
log flow; each framework module keeps its own importance extraction."""

from __future__ import annotations

import json
import os
import tempfile


def log_importance_artifact(context, model_name: str, scores: dict,
                            framework: str):
    if not scores:
        return
    context.log_artifact(
        f"{model_name}_feature_importance",
        body=json.dumps(scores, indent=2),
        format="json", labels={"framework": framework})


def estimator_importance_scores(estimator) -> dict:
    """The sklearn-API branch shared by both boosting frameworks:
    ``feature_importances_`` -> {"importance": {name: value}}."""
    values = getattr(estimator, "feature_importances_", None)
    if values is None:
        return {}
    names = (getattr(estimator, "feature_names_in_", None)
             if getattr(estimator, "feature_names_in_", None) is not None
             else getattr(estimator, "feature_name_", None))
    if names is None:
        names = [f"f{i}" for i in range(len(values))]
    return {"importance": {str(n): float(v)
                           for n, v in zip(names, values)}}


def wrap_post_fit(handler, importance_fn):
    """Chain a framework's importance artifact onto the sklearn handler's
    post-fit hook (the xgboost and lightgbm ``apply_mlrun`` wrappers)."""
    post_fit = handler._post_fit

    def wrapped(fit_args, fit_kwargs):
        post_fit(fit_args, fit_kwargs)
        importance_fn(handler.context, handler.model, handler.model_name)

    handler._post_fit = wrapped
    return handler


def log_booster_model(context, booster, framework: str, suffix: str,
                      model_name: str = "model", tag: str = "",
                      metrics: dict | None = None,
                      label_column: str | None = None):
    """Serialize a booster (its own ``save_model`` when it has one, pickle
    otherwise) and log it as a model artifact; the temporary file is
    removed after the upload."""
    if not hasattr(booster, "save_model"):
        suffix = ".pkl"
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        if hasattr(booster, "save_model"):
            booster.save_model(path)
        else:
            import pickle

            with open(path, "wb") as fp:
                pickle.dump(booster, fp)
        parameters = {}
        best_iteration = getattr(booster, "best_iteration", None)
        # lightgbm uses -1 as its "no early stopping" sentinel
        if best_iteration is not None and int(best_iteration) >= 0:
            parameters["best_iteration"] = int(best_iteration)
        return context.log_model(
            model_name, model_file=path, framework=framework,
            algorithm=type(booster).__name__, metrics=metrics or {},
            tag=tag, label_column=label_column,
            parameters=parameters or None)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
