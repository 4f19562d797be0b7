"""ONNX adapter — the port's copy of ``mlrun_tpu/frameworks/onnx``:
``to_onnx`` converts a torch module, a sklearn estimator or a keras
model and logs it as a model artifact; ``ONNXModelServer`` serves
one through onnxruntime. Every converter and the runtime are imported
inside the calls, each raising ``ImportError`` where it is missing."""

from __future__ import annotations

import os
import tempfile
from typing import Any


def to_onnx(model: Any, context=None, model_name: str = "model",
            sample_input=None, input_names: list | None = None,
            output_names: list | None = None, target_path: str = "",
            **export_kwargs) -> str:
    """Convert a torch module / sklearn estimator / keras model to ONNX and
    (when a context is given) register it in the artifact registry.

    Returns the exported file path. Requires the ``onnx`` package plus the
    family converter (torch bundles its exporter; sklearn needs skl2onnx,
    keras needs tf2onnx).
    """
    try:
        import onnx  # noqa: F401  - gated: the serializer every path needs
    except ImportError as exc:
        raise ImportError(
            "onnx export requires the onnx package; the model registry "
            "keeps torch state dicts without it") from exc

    path = target_path or os.path.join(tempfile.mkdtemp(prefix="mlt-onnx-"),
                                       f"{model_name}.onnx")

    exported = False
    try:
        import torch
    except ImportError:  # guard ONLY the import — export errors must
        torch = None     # surface, not fall through to other families

    if torch is not None and isinstance(model, torch.nn.Module):
        if sample_input is None:
            raise ValueError(
                "torch export needs sample_input (example args)")
        if not isinstance(sample_input, tuple):
            sample_input = (sample_input,)
        torch.onnx.export(
            model, sample_input, path,
            input_names=input_names, output_names=output_names,
            **export_kwargs)
        exported = True

    if not exported and _is_sklearn(model):
        from skl2onnx import to_onnx as skl_to_onnx  # gated import

        onx = skl_to_onnx(model, X=sample_input, **export_kwargs)
        with open(path, "wb") as fp:
            fp.write(onx.SerializeToString())
        exported = True

    if not exported and _is_keras(model):
        import tf2onnx  # gated import

        model_proto, _ = tf2onnx.convert.from_keras(model, **export_kwargs)
        with open(path, "wb") as fp:
            fp.write(model_proto.SerializeToString())
        exported = True

    if not exported:
        raise ValueError(
            f"no onnx converter for model type {type(model).__name__} "
            "(torch module, sklearn estimator, or keras model expected)")

    if context is not None:
        context.log_model(model_name, model_file=path, framework="onnx",
                          upload=True)
    return path


def _is_sklearn(model) -> bool:
    try:
        from sklearn.base import BaseEstimator

        return isinstance(model, BaseEstimator)
    except ImportError:
        return False


def _is_keras(model) -> bool:
    try:
        from tensorflow import keras

        return isinstance(model, keras.Model)
    except ImportError:
        return False


def ONNXModelServer(*args, **kwargs):
    try:
        import onnxruntime  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "onnxruntime is not installed in this environment") from exc
    from ...serving.v2_serving import V2ModelServer

    class _Server(V2ModelServer):
        def load(self):
            import onnxruntime as ort

            model_file, _ = self.get_model(".onnx")
            self.model = ort.InferenceSession(model_file)

        def predict(self, request):
            import numpy as np

            inputs = np.asarray(request["inputs"], dtype=np.float32)
            input_name = self.model.get_inputs()[0].name
            return self.model.run(None, {input_name: inputs})[0].tolist()

    return _Server(*args, **kwargs)
