"""V2 model server — counterpart of ``mlrun_tpu/serving/v2_serving.py``:
``V2ModelServer`` (op dispatch in ``do_event``, the load / predict /
validate / preprocess / postprocess hooks, ``set_metric``), the monitoring
stream pusher ``_ModelLogPusher`` (inference events pushed to
``context.monitoring_stream`` when one is set, never breaking serving),
and ``TpuModelServer``, a server whose forward is a torch callable run on
the card (the reference's name, so graph specs written for it resolve).
``get_model`` fetches the model file of ``model_path`` (a directory, a
file or a datastore url)."""

from __future__ import annotations

import threading
import time
import uuid
from datetime import datetime, timezone
from typing import Any

from ..utils import logger
from .resilience import ModelNotReadyError


class V2ModelServer:
    """Base model-serving class — subclass and implement load() +
    predict()."""

    def __init__(self, context=None, name: str | None = None,
                 model_path: str | None = None, model=None,
                 protocol: str | None = None, **class_args):
        self.name = name
        self.version = ""
        if name and ":" in name:
            self.name, self.version = name.split(":", 1)
        self.context = context
        self.ready = False
        self.error = ""
        self.protocol = protocol or "v2"
        self.model_path = model_path
        self.model = model
        self.model_spec = None
        self.class_args = class_args
        self._model_logger = None
        self.metrics: dict = {}
        self.labels: dict = {}
        self._lock = threading.Lock()
        self._load_time = 0.0

    def post_init(self, mode: str = "sync"):
        """Load the model (once) and mark the server ready; a failed load
        is recorded in ``error`` and reported by ``ready``/``infer``."""
        if self.model is None:
            started = time.monotonic()
            try:
                self.load()
            except Exception as exc:  # noqa: BLE001 - reported via error
                self.error = f"{type(exc).__name__}: {exc}"
                return
            self._load_time = time.monotonic() - started
        self.ready = True
        if self.context is not None and getattr(
                self.context, "monitoring_stream", None) is not None:
            self._model_logger = _ModelLogPusher(self, self.context)

    # -- model lifecycle hooks (override) ----------------------------------
    def load(self):
        """Load the model; use get_model() to fetch it."""

    def get_model(self, suffix: str = ""):
        """The model file of ``model_path`` (a directory's first entry
        ending in ``suffix``, a file, or a datastore url) as (local path,
        extra data); ``model_spec`` is set to the artifact's spec."""
        from ..artifacts.model import get_model

        local_path, model_spec, extra_data = get_model(self.model_path,
                                                       suffix)
        self.model_spec = model_spec
        return local_path, extra_data

    def predict(self, request: dict) -> Any:
        raise NotImplementedError("implement predict() in your model class")

    def explain(self, request: dict) -> Any:
        raise NotImplementedError(f"model {self.name} has no explain method")

    def validate(self, request: dict, operation: str) -> dict:
        if self.protocol == "v2" and operation in ("infer", "predict"):
            if not isinstance(request, dict) or "inputs" not in request:
                raise ValueError("request must contain an 'inputs' field")
        return request

    def preprocess(self, request: dict, operation: str) -> dict:
        return request

    def postprocess(self, request: dict) -> dict:
        return request

    def logged_results(self, request: dict, response: dict, op: str):
        """Hook to shape what gets pushed to monitoring."""
        return request.get("inputs"), response.get("outputs")

    def set_metric(self, name: str, value):
        self.metrics[name] = value

    # -- event dispatch ----------------------------------------------------
    def do_event(self, event, *args, **kwargs):
        """Dispatch the infer/predict/explain/metrics/ready ops."""
        event_body = event.body if hasattr(event, "body") else event
        path = getattr(event, "path", "/") or "/"
        op = self._extract_op(event_body, path)

        if op == "ready":
            if not self.ready:
                raise ModelNotReadyError(
                    f"model {self.name} is not ready: {self.error}")
            event.body = {"name": self.name, "ready": True}
            return event
        if op == "metrics":
            event.body = {"name": self.name, "metrics": dict(self.metrics)}
            return event
        if op == "explain" or op in ("infer", "predict", ""):
            request = event_body if isinstance(event_body, dict) else {
                "inputs": event_body}
            if not self.ready:
                with self._lock:
                    if not self.ready:
                        self.post_init()
                if not self.ready:
                    raise ModelNotReadyError(
                        f"model {self.name} failed to load: {self.error}")
            start = time.monotonic()
            try:
                request = self.preprocess(request, op)
                request = self.validate(request, op or "infer")
                if op == "explain":
                    outputs = self.explain(request)
                else:
                    outputs = self.predict(request)
                response = {
                    "id": request.get("id") or getattr(event, "id", None)
                    or uuid.uuid4().hex,
                    "model_name": self.name,
                    "outputs": _to_serializable(outputs),
                }
                if self.version:
                    response["model_version"] = self.version
                response = self.postprocess(response)
            except Exception as exc:  # noqa: BLE001 - pushed, then raised
                if self._model_logger:
                    self._model_logger.push_error(request, str(exc))
                raise
            microsec = int((time.monotonic() - start) * 1e6)
            self.metrics["latency_microsec"] = microsec
            self.metrics["requests"] = self.metrics.get("requests", 0) + 1
            if self._model_logger:
                self._model_logger.push(request, response, op or "infer",
                                        microsec)
            event.body = response
            return event
        raise ValueError(f"unsupported operation '{op}'")

    @staticmethod
    def _extract_op(body, path: str) -> str:
        parts = [p for p in path.split("/") if p]
        # v2 path convention: /v2/models/<name>/<op>
        if parts and parts[-1] in ("infer", "predict", "explain", "metrics",
                                   "ready"):
            return parts[-1]
        if isinstance(body, dict) and "operation" in body:
            return body["operation"]
        return "infer"


class TpuModelServer(V2ModelServer):
    """A V2ModelServer whose forward is a torch callable run on the card
    (the reference's name, kept so graph specs written for it resolve).

    Pass ``forward_fn(params, inputs)`` / ``params`` as class args or
    override :meth:`build_forward`. ``load`` runs each ``warmup_shapes``
    entry once on the device (float32 zeros, as the reference warms its
    compiled forward) and synchronizes, so the first request pays for no
    kernel build; ``predict`` moves the inputs to the device, runs under
    ``torch.inference_mode()`` and returns numpy. ``device`` defaults to
    the GPU; ``"cpu"`` runs the plain paths.
    """

    def __init__(self, *args, forward_fn=None, params=None,
                 warmup_shapes: list | None = None, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        from .llm import default_device

        self._forward = forward_fn
        self._params = params
        self._warmup_shapes = warmup_shapes or []
        self.device = default_device(device)

    def build_forward(self):
        """Override: return (forward_fn(params, inputs), params)."""
        if self._forward is None:
            raise NotImplementedError(
                "pass forward_fn/params or override build_forward()")
        return self._forward, self._params

    def _synchronize(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load(self):
        import torch

        forward, params = self.build_forward()
        self._params = params
        with torch.inference_mode():
            for shape in self._warmup_shapes:
                dummy = torch.zeros(tuple(shape), dtype=torch.float32,
                                    device=self.device)
                forward(self._params, dummy)
        self._synchronize()
        self.model = forward

    def predict(self, request: dict):
        import numpy as np
        import torch

        array = np.asarray(request["inputs"])
        if array.dtype == np.float64:
            # a JSON body's floats parse as float64; the reference's
            # jnp.asarray makes them float32 (x64 off), and so does this
            array = array.astype(np.float32)
        inputs = torch.as_tensor(array, device=self.device)
        with torch.inference_mode():
            outputs = self.model(self._params, inputs)
        return outputs.detach().cpu().numpy()


class _ModelLogPusher:
    """Streams inference events to the monitoring pipeline
    (``context.monitoring_stream``, anything with ``push(dict)``)."""

    def __init__(self, model: V2ModelServer, context):
        self.model = model
        self.context = context
        self.stream = getattr(context, "monitoring_stream", None)
        self.function_uri = getattr(
            getattr(context, "server", None), "function_uri", "") or ""

    def base_data(self) -> dict:
        return {
            "class": self.model.__class__.__name__,
            "model": self.model.name,
            "version": self.model.version,
            "function_uri": self.function_uri,
            "when": datetime.now(timezone.utc).isoformat(),
            "labels": self.model.labels,
        }

    def push(self, request, response, op: str, microsec: int):
        if self.stream is None:
            return
        inputs, outputs = self.model.logged_results(request, response, op)
        data = self.base_data()
        data.update({
            "request": {"inputs": _to_serializable(inputs),
                        "id": response.get("id")},
            "resp": {"outputs": _to_serializable(outputs)},
            "op": op,
            "microsec": microsec,
            "metrics": dict(self.model.metrics),
        })
        try:
            self.stream.push(data)
        except Exception as exc:  # noqa: BLE001 - monitoring must not
            # break serving
            logger.warning("failed to push monitoring event", error=str(exc))

    def push_error(self, request, error: str):
        if self.stream is None:
            return
        data = self.base_data()
        data.update({"error": error, "request": _to_serializable(request)})
        try:
            self.stream.push(data)
        except Exception:  # noqa: BLE001 - monitoring must not break serving
            pass


def _to_serializable(obj):
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_serializable(v) for v in obj]
    if hasattr(obj, "tolist"):
        try:
            return obj.tolist()
        except Exception:  # noqa: BLE001 - fall back to the text form
            return str(obj)
    return str(obj)
