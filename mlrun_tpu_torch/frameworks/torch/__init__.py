"""PyTorch user-code adapter — the port's copy of
``mlrun_tpu/frameworks/torch``: ``apply_mlrun`` (a ``TorchModelHandler``
that logs per-epoch metrics and the state dict as a model artifact),
``train`` / ``evaluate`` loops over the caller's model, loss, optimizer
and loaders, driven by the structured callbacks of ``_common``, and
``TorchModelServer`` for saved state dicts.

Device: ``train`` and ``evaluate`` move each batch to the device of the
model's first parameter, so a model placed on the card trains there.
``TorchModelServer`` loads and predicts on its ``device`` class arg
(default ``"cuda"``); without a CUDA device its ``load`` fails unless the
server was given ``device="cpu"``.

The Llama auto-trainer (the ``tpujob`` handler) is
``frameworks.torch.auto_trainer``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

from ...execution import MLClientCtx


def apply_mlrun(model=None, context: MLClientCtx | None = None,
                model_name: str = "model", tag: str = "", **kwargs):
    if context is None:
        from ...run import get_or_create_ctx

        context = get_or_create_ctx("torch")
    return TorchModelHandler(model, context, model_name, tag)


class TorchModelHandler:
    def __init__(self, model, context, model_name="model", tag=""):
        self.model = model
        self.context = context
        self.model_name = model_name
        self.tag = tag

    def log_epoch(self, epoch: int, metrics: dict):
        if self.context.is_logging_worker():
            self.context.log_metrics(
                {k: float(v) for k, v in metrics.items()}, step=epoch)

    def log_model(self, metrics: dict | None = None,
                  parameters: dict | None = None):
        import torch

        tmp_dir = tempfile.mkdtemp()
        path = os.path.join(tmp_dir, f"{self.model_name}.pt")
        torch.save(self.model.state_dict(), path)
        return self.context.log_model(
            self.model_name, model_file=path, framework="pytorch",
            metrics=metrics or {}, parameters=parameters or {},
            tag=self.tag)


def _metric_names(metrics: list) -> list[str]:
    """Unique reporting keys for metric callables: collisions (two
    lambdas, partials, or a metric shadowing 'loss'/'lr') get numeric
    suffixes instead of silently summing into one bucket."""
    names: list[str] = []
    taken = {"loss", "lr"}
    for metric in metrics:
        base = getattr(metric, "__name__", None) or type(metric).__name__
        name, n = base, 1
        while name in taken:
            n += 1
            name = f"{base}_{n}"
        taken.add(name)
        names.append(name)
    return names


def _placed(model):
    """A function moving a batch's tensors to the device of ``model``'s
    first parameter (the identity for a model without parameters)."""
    first = next(iter(model.parameters()), None)
    if first is None:
        return lambda value: value
    device = first.device
    return lambda value: value.to(device) if hasattr(value, "to") else value


def train(model, loss_fn, optimizer, train_loader,
          context: MLClientCtx | None = None, epochs: int = 1,
          validation_loader=None, model_name: str = "model",
          log_model: bool = True, callbacks: list | None = None,
          scheduler=None, metrics: list | None = None) -> dict:
    """Torch training loop driven by the shared callbacks: per-epoch
    metric logging, user ``metrics`` callables ``m(y_pred, y_true) ->
    float`` averaged over train and validation epochs, and any
    ``frameworks._common.Callback`` (EarlyStopping, Checkpoint,
    TensorBoard, EvalPlan) on the hooks the auto-trainer drives. Batches
    move to the model's device."""
    import torch

    from .._common.callbacks import CallbackList

    handler = apply_mlrun(model, context, model_name)
    context = handler.context
    hooks = CallbackList(callbacks, context=context, model=model)
    hooks.on_train_begin()
    place = _placed(model)
    metrics = metrics or []
    metric_names = _metric_names(metrics)
    final: dict = {}
    step = 0
    for epoch in range(epochs):
        hooks.on_epoch_begin(epoch)
        model.train()
        sums = {"loss": 0.0, **{name: 0.0 for name in metric_names}}
        count = 0
        stop = False
        for inputs, targets in train_loader:
            inputs, targets = place(inputs), place(targets)
            optimizer.zero_grad()
            outputs = model(inputs)
            loss = loss_fn(outputs, targets)
            loss.backward()
            optimizer.step()
            loss_value = float(loss.detach())
            sums["loss"] += loss_value
            with torch.no_grad():
                for name, metric in zip(metric_names, metrics):
                    sums[name] += float(metric(outputs, targets))
            count += 1
            if not hooks.on_step_end(step, {"loss": loss_value}):
                stop = True
            step += 1
            if stop:
                break
        if scheduler is not None:
            scheduler.step()
        epoch_metrics = {k: v / max(count, 1) for k, v in sums.items()}
        if optimizer.param_groups:
            epoch_metrics["lr"] = float(
                optimizer.param_groups[0].get("lr", 0.0))
        if validation_loader is not None:
            epoch_metrics.update(evaluate(
                model, loss_fn, validation_loader, metrics=metrics,
                prefix="validation_"))
        handler.log_epoch(epoch, epoch_metrics)
        final = epoch_metrics
        if not hooks.on_epoch_end(epoch, epoch_metrics) or stop:
            final = dict(final)
            final["stopped_early"] = True
            break
    hooks.on_train_end(final)
    if context is not None:
        context.log_results(final)
    if log_model:
        handler.log_model(metrics={
            k: v for k, v in final.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)})
    return final


def evaluate(model, loss_fn, loader, context: MLClientCtx | None = None,
             metrics: list | None = None, prefix: str = "eval_") -> dict:
    """Evaluation loop with the same metric callables as train(); batches
    move to the model's device."""
    import torch

    model.eval()
    place = _placed(model)
    metrics = metrics or []
    metric_names = _metric_names(metrics)
    sums = {"loss": 0.0, **{name: 0.0 for name in metric_names}}
    count = 0
    with torch.no_grad():
        for inputs, targets in loader:
            inputs, targets = place(inputs), place(targets)
            outputs = model(inputs)
            sums["loss"] += float(loss_fn(outputs, targets))
            for name, metric in zip(metric_names, metrics):
                sums[name] += float(metric(outputs, targets))
            count += 1
    results = {f"{prefix}{k}": v / max(count, 1) for k, v in sums.items()}
    if context is not None:
        context.log_results(results)
    return results


class TorchModelServer:
    """V2ModelServer for saved torch state dicts; needs a
    ``model_factory`` class arg. ``device`` (default ``"cuda"``) is where
    the state dict is loaded and ``predict`` runs."""

    def __new__(cls, *args, **kwargs):
        from ...serving.v2_serving import V2ModelServer

        class _Server(V2ModelServer):
            def __init__(self, *a, model_factory: Callable | None = None,
                         device: str = "cuda", **kw):
                super().__init__(*a, **kw)
                self.model_factory = model_factory
                self.device = device

            def load(self):
                import torch

                if self.model_factory is None:
                    raise ValueError(
                        "TorchModelServer needs a model_factory class arg")
                if torch.device(self.device).type == "cuda" \
                        and not torch.cuda.is_available():
                    raise RuntimeError(
                        f"TorchModelServer device {self.device!r}: no CUDA "
                        "device here (pass device='cpu' to serve on the "
                        "CPU)")
                model_file, _ = self.get_model(".pt")
                self.model = self.model_factory()
                self.model.load_state_dict(torch.load(
                    model_file, map_location=self.device,
                    weights_only=True))
                self.model.to(self.device)
                self.model.eval()

            def predict(self, request):
                import torch

                inputs = torch.tensor(request["inputs"], device=self.device)
                with torch.no_grad():
                    return self.model(inputs).tolist()

        return _Server(*args, **kwargs)
