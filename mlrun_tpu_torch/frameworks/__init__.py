"""Framework adapters of the port: ``apply_mlrun`` for sklearn, xgboost,
lightgbm, tf_keras and user torch code (``torch``), ONNX export
(``onnx``), the Llama auto-trainer (``torch.auto_trainer``), the
structured callbacks and artifact plans (``_common``) and the
HuggingFace checkpoint loader and pipeline server (``huggingface``)."""

from __future__ import annotations


def auto_mlrun(model=None, context=None, **kwargs):
    """Detect the framework of ``model`` and apply its tracking: sklearn,
    xgboost and lightgbm estimators go to ``sklearn.apply_mlrun``; no
    model goes to the Llama auto-trainer's ``apply_mlrun`` (the
    reference's JAX auto-trainer has the same place there)."""
    module = type(model).__module__ if model is not None else ""
    if module.startswith("sklearn") or module.startswith("xgboost") \
            or module.startswith("lightgbm"):
        from .sklearn import apply_mlrun as apply

        return apply(model=model, context=context, **kwargs)
    if model is None:
        from .torch.auto_trainer import apply_mlrun as apply

        return apply(model=model, context=context, **kwargs)
    raise ValueError(f"cannot auto-detect framework for {type(model)}")
