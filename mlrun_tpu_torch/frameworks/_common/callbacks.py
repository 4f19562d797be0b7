"""Structured training callbacks — the port's copy of
``mlrun_tpu/frameworks/_common/callbacks.py``.

One hook set (``on_train_begin``, ``on_epoch_begin``, ``on_step_end``,
``on_epoch_end``, ``on_train_end``) that ``Trainer.fit`` drives on every
step, and on epochs when ``epoch_steps`` is set. A hook returning
``False`` from ``on_step_end`` / ``on_epoch_end`` stops training
gracefully: the trainer finishes its bookkeeping and reports
``stopped_early``. Callbacks that log call the run context's
``is_logging_worker()``, as the reference's do, or — for a context
without one — ``execution.is_logging_worker()`` (global rank 0).
``EvalPlanCallback`` runs the artifact plans of ``plans.py``.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, Optional, Sequence

from ...execution import logging_worker
from ...utils import logger


class Callback:
    """Base hook set. Subclass and override what you need; ``set_state``
    is called by the training loop before ``on_train_begin`` with whatever
    handles exist (run context, Trainer, model)."""

    context = None
    trainer = None
    model = None

    def set_state(self, context=None, trainer=None, model=None):
        self.context = context if context is not None else self.context
        self.trainer = trainer if trainer is not None else self.trainer
        self.model = model if model is not None else self.model

    def on_train_begin(self):
        pass

    def on_epoch_begin(self, epoch: int):
        pass

    def on_step_end(self, step: int, metrics: dict) -> Optional[bool]:
        pass

    def on_epoch_end(self, epoch: int, metrics: dict) -> Optional[bool]:
        pass

    def on_train_end(self, metrics: dict):
        pass


class FunctionCallback(Callback):
    """Adapter for the bare-callable contract ``callback(step, metrics,
    trainer)``: fired at log points only, with the log point's metrics
    (tokens_per_sec, mfu, step), so existing callables keep their
    cadence."""

    log_points_only = True

    def __init__(self, fn: Callable):
        self.fn = fn

    def on_step_end(self, step: int, metrics: dict) -> None:
        # return values are discarded: a callable returning something
        # falsy (CheckpointManager.save's bool) is not a stop vote
        self.fn(step, metrics, self.trainer)


class CallbackList:
    """Dispatches one event to every callback; aggregates stop votes (any
    explicit ``False`` stops training). A raising callback is logged and
    skipped: it must not kill the run it observes."""

    def __init__(self, callbacks: Sequence | None, context=None,
                 trainer=None, model=None):
        self.callbacks: list[Callback] = []
        for cb in callbacks or []:
            if isinstance(cb, Callback):
                self.callbacks.append(cb)
            elif callable(cb):
                self.callbacks.append(FunctionCallback(cb))
            else:
                raise TypeError(
                    f"callback {cb!r} is neither a Callback nor callable")
        for cb in self.callbacks:
            cb.set_state(context=context, trainer=trainer, model=model)

    @staticmethod
    def _call(cb, event: str, *args) -> bool:
        """One hook; False only for an explicit stop vote."""
        try:
            return getattr(cb, event)(*args) is not False
        except Exception as exc:  # noqa: BLE001 - isolated, see class doc
            logger.warning("callback failed", callback=type(cb).__name__,
                           event=event, error=str(exc))
            return True

    def _dispatch(self, event: str, *args) -> bool:
        votes = [self._call(cb, event, *args) for cb in self.callbacks]
        return all(votes)

    def on_train_begin(self):
        self._dispatch("on_train_begin")

    def on_epoch_begin(self, epoch: int):
        self._dispatch("on_epoch_begin", epoch)

    def on_step_end(self, step: int, metrics: dict,
                    log_point: bool = True) -> bool:
        votes = [self._call(cb, "on_step_end", step, metrics)
                 for cb in self.callbacks
                 if log_point or not getattr(cb, "log_points_only", False)]
        return all(votes)

    def on_epoch_end(self, epoch: int, metrics: dict) -> bool:
        return self._dispatch("on_epoch_end", epoch, metrics)

    def on_train_end(self, metrics: dict):
        self._dispatch("on_train_end", metrics)


class MetricsLoggingCallback(Callback):
    """Per-epoch metric logging into the run context (the trainer logs
    per step itself)."""

    def on_epoch_end(self, epoch: int, metrics: dict) -> None:
        if self.context is not None and metrics \
                and logging_worker(self.context):
            self.context.log_metrics(
                {k: float(v) for k, v in metrics.items()
                 if isinstance(v, (int, float))}, step=epoch)


class EarlyStoppingCallback(Callback):
    """Stop when ``monitor`` hasn't improved by ``min_delta`` for
    ``patience`` evaluations (epochs when epochs exist, else steps)."""

    def __init__(self, monitor: str = "loss", patience: int = 3,
                 min_delta: float = 0.0, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be min|max, got {mode!r}")
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.stale = 0
        self.stopped = False

    def on_train_begin(self):
        # a reused instance starts each run fresh: a carried-over stale
        # counter would stop the next run on its first epoch
        self.best = math.inf if self.mode == "min" else -math.inf
        self.stale = 0
        self.stopped = False
        self._epoch_driven = False

    def _observe(self, metrics: dict) -> Optional[bool]:
        value = metrics.get(self.monitor)
        if value is None:
            return None
        value = float(value)
        improved = (value < self.best - self.min_delta
                    if self.mode == "min"
                    else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.stale = 0
            return None
        self.stale += 1
        if self.stale >= self.patience:
            self.stopped = True
            logger.info("early stopping", monitor=self.monitor,
                        best=self.best, patience=self.patience)
            return False
        return None

    def on_epoch_end(self, epoch: int, metrics: dict) -> Optional[bool]:
        return self._observe(metrics)

    def on_step_end(self, step: int, metrics: dict) -> Optional[bool]:
        # steps drive early stop only where there is no epoch structure
        if getattr(self, "_epoch_driven", False):
            return None
        return self._observe(metrics)

    def on_epoch_begin(self, epoch: int):
        self._epoch_driven = True


class CheckpointCallback(Callback):
    """Checkpoint every N steps/epochs through a manager with
    ``save(step, state, force=False)`` (training.CheckpointManager), or a
    custom ``save_fn``. ``monitor`` + ``mode`` switch to best-only."""

    def __init__(self, manager=None, every_steps: int = 0,
                 every_epochs: int = 0, save_fn: Callable | None = None,
                 monitor: str | None = None, mode: str = "min"):
        if manager is None and save_fn is None:
            raise ValueError("CheckpointCallback needs manager= or save_fn=")
        self.manager = manager
        self.every_steps = every_steps
        self.every_epochs = every_epochs
        self.save_fn = save_fn
        self.monitor = monitor
        self.mode = mode
        self.best = math.inf if mode == "min" else -math.inf
        self.saves = 0

    def _improved(self, metrics: dict) -> bool:
        if not self.monitor:
            return True
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        better = value < self.best if self.mode == "min" \
            else value > self.best
        if better:
            self.best = value
        return better

    def _save(self, tag: int):
        if self.save_fn is not None:
            self.save_fn(tag)
        else:
            state = getattr(self.trainer, "state", None)
            if state is None:
                return
            self.manager.save(int(state.step), state, force=True)
            # the resumable point on the run's status: a run killed
            # without a deliverable SIGTERM resumes from here
            if self.context is not None and \
                    hasattr(self.context, "log_checkpoint"):
                self.context.log_checkpoint(
                    self.manager.directory, step=int(state.step))
        self.saves += 1

    def on_step_end(self, step: int, metrics: dict) -> None:
        if self.every_steps and (step + 1) % self.every_steps == 0 \
                and self._improved(metrics):
            self._save(step)

    def on_epoch_end(self, epoch: int, metrics: dict) -> None:
        if self.every_epochs and (epoch + 1) % self.every_epochs == 0 \
                and self._improved(metrics):
            self._save(epoch)


class TensorBoardCallback(Callback):
    """Scalar summaries per step/epoch into TensorBoard event files
    (``torch.utils.tensorboard``); the log dir is logged as a run
    artifact at train end."""

    def __init__(self, log_dir: str = "", name: str = "tensorboard"):
        # imported here so a missing writer fails at construction: the
        # callback list isolates hook exceptions, so a failure in
        # on_train_begin would silently drop the requested feature
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401

        self.log_dir = log_dir
        self.name = name
        self._writer = None

    def on_train_begin(self):
        from torch.utils.tensorboard import SummaryWriter

        self.log_dir = self.log_dir or os.path.join(
            tempfile.mkdtemp(prefix="mlt-tb-"), "train")
        os.makedirs(self.log_dir, exist_ok=True)
        self._writer = SummaryWriter(self.log_dir)

    def _write(self, prefix: str, tick: int, metrics: dict):
        if self._writer is None:
            return
        for key, value in metrics.items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool) \
                    and math.isfinite(float(value)):
                self._writer.add_scalar(f"{prefix}/{key}", float(value),
                                        tick)

    def on_step_end(self, step: int, metrics: dict) -> None:
        # no per-step flush: the writer flushes periodically, and
        # explicitly at epoch and train ends
        self._write("step", step, metrics)

    def on_epoch_end(self, epoch: int, metrics: dict) -> None:
        self._write("epoch", epoch, metrics)
        if self._writer is not None:
            self._writer.flush()

    def on_train_end(self, metrics: dict):
        if self._writer is not None:
            self._writer.close()
        if self.context is not None and self.log_dir \
                and os.path.isdir(self.log_dir) \
                and logging_worker(self.context):
            try:
                self.context.log_artifact(
                    self.name, local_path=self.log_dir,
                    labels={"viewer": "tensorboard"})
            except Exception as exc:  # noqa: BLE001 - best effort
                logger.warning("tensorboard artifact failed",
                               error=str(exc))


class EvalPlanCallback(Callback):
    """Per-epoch artifact plans (confusion matrix / ROC / residuals ...)
    from ``plans.py`` over a user eval set: ``eval_fn(model) -> (y_true,
    y_pred)`` runs every N epochs and at train end, each plan producing a
    versioned artifact (``<key>-epoch<N>``, then ``<key>``)."""

    def __init__(self, eval_fn: Callable, plans: Sequence | None = None,
                 every_epochs: int = 1, x=None):
        self.eval_fn = eval_fn
        self.plans = plans
        self.every_epochs = max(1, every_epochs)
        self.x = x

    def _produce(self, tick: int | None):
        from .plans import produce_artifacts

        if self.context is None or not logging_worker(self.context):
            return
        y_true, y_pred = self.eval_fn(self.model or self.trainer)
        suffix = "" if tick is None else f"-epoch{tick}"
        produce_artifacts(self.context, self.model, self.x, y_true,
                          y_pred=y_pred, plans=self.plans,
                          key_suffix=suffix)

    def on_epoch_end(self, epoch: int, metrics: dict) -> None:
        if (epoch + 1) % self.every_epochs == 0:
            self._produce(epoch)

    def on_train_end(self, metrics: dict):
        self._produce(None)
