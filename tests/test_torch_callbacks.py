"""The port's structured callbacks (mlrun_tpu_torch.frameworks._common) and
the hooks its ``Trainer.fit`` drives, against the JAX package on the CPU:
the contracts of the reference's ``tests/test_callbacks.py`` that touch
the JAX trainer, each run through both packages' callbacks and ``fit`` on
the same converted tiny float32 model, comparing the recorded event
sequences. Also faults 3.3 (a failed warmup) and 3.5 (checkpoints every N
steps) of ROADMAP.md through ``auto_trainer.train``.

Bounds: event sequences, stop steps, save steps and TensorBoard tags
equal; logged losses within 1e-4 relative (the training parity bound of
``tests/test_torch_training.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlrun_tpu.frameworks import _common as jcommon
from mlrun_tpu.frameworks.jax import auto_trainer as jauto
from mlrun_tpu.models import llama as jllama
from mlrun_tpu.training import data as jdata
from mlrun_tpu.training import train as jtrain
from mlrun_tpu_torch.frameworks import _common as tcommon
from mlrun_tpu_torch.frameworks.torch import auto_trainer as tauto
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.models.convert import params_from_numpy
from mlrun_tpu_torch.training import CheckpointManager
from mlrun_tpu_torch.training import data as tdata
from mlrun_tpu_torch.training import train as ttrain

RUN_REL_TOL = 1e-4
PACKAGES = (jcommon, tcommon)


def _recorder(pkg):
    class Recorder(pkg.Callback):
        def __init__(self):
            self.events = []
            self.step_types = {}

        def on_train_begin(self):
            self.events.append("train_begin")

        def on_epoch_begin(self, epoch):
            self.events.append(("epoch_begin", epoch))

        def on_step_end(self, step, metrics):
            self.events.append(("step", step))
            self.step_types[step] = type(metrics.get("loss"))

        def on_epoch_end(self, epoch, metrics):
            self.events.append(("epoch_end", epoch))

        def on_train_end(self, metrics):
            self.events.append("train_end")

    return Recorder()


# -- the callbacks alone -------------------------------------------------------

def _votes(pkg) -> list:
    calls = []
    rec = _recorder(pkg)
    hooks = pkg.CallbackList([rec, lambda step, m, tr: calls.append(step)])
    out = [hooks.on_step_end(0, {"loss": 1.0}), list(calls),
           ("step", 0) in rec.events,
           hooks.on_step_end(1, {}, log_point=False), list(calls)]

    class Stopper(pkg.Callback):
        def on_step_end(self, step, metrics):
            return False

    class Broken(pkg.Callback):
        def on_step_end(self, step, metrics):
            raise RuntimeError("boom")

    out.append(pkg.CallbackList([Stopper(), rec]).on_step_end(1, {}))
    out.append(pkg.CallbackList([Broken()]).on_step_end(0, {}))
    with pytest.raises(TypeError):
        pkg.CallbackList(["not a callback"])
    return out


def test_callback_list_normalizes_and_votes():
    """Bare callables become log-point-only FunctionCallbacks, an explicit
    False is a stop vote, a raising callback is isolated."""
    want, got = (_votes(pkg) for pkg in PACKAGES)
    assert got == want == [True, [0], True, True, [0], False, True]


def _early_stops(pkg) -> list:
    down = pkg.EarlyStoppingCallback(monitor="loss", patience=2, mode="min")
    out = [down.on_epoch_end(i, {"loss": v})
           for i, v in enumerate((1.0, 0.5, 0.6, 0.7))]
    up = pkg.EarlyStoppingCallback(monitor="accuracy", patience=1,
                                   mode="max")
    out += [up.on_epoch_end(i, {"accuracy": v})
            for i, v in enumerate((0.5, 0.4))]
    out += [down.stopped, pkg.EarlyStoppingCallback().on_epoch_end(0, {})]
    with pytest.raises(ValueError):
        pkg.EarlyStoppingCallback(mode="sideways")
    return out


def test_early_stopping_min_and_max():
    want, got = (_early_stops(pkg) for pkg in PACKAGES)
    assert got == want == [None, None, None, False, None, False, True, None]


def _cadences(pkg) -> list:
    saves = []
    every = pkg.CheckpointCallback(save_fn=saves.append, every_steps=3)
    for step in range(9):
        every.on_step_end(step, {})
    best = pkg.CheckpointCallback(save_fn=saves.append, every_epochs=1,
                                  monitor="loss", mode="min")
    for epoch, loss in enumerate((1.0, 2.0, 0.5)):
        best.on_epoch_end(epoch, {"loss": loss})
    with pytest.raises(ValueError):
        pkg.CheckpointCallback()
    return saves


def test_checkpoint_callback_cadence_and_best_only():
    want, got = (_cadences(pkg) for pkg in PACKAGES)
    assert got == want == [2, 5, 8, 0, 2]


# -- driven by both packages' Trainer.fit --------------------------------------

def _trainers():
    """The reference's tiny float32 Trainer on a one-device mesh and the
    port's from its converted init."""
    jcfg = jllama.tiny_llama(dtype=jnp.float32, attention_impl="reference")
    jt = jtrain.Trainer(jcfg, jtrain.TrainConfig(mesh_shape={"fsdp": 1}))
    jt.init(0)
    tt = ttrain.Trainer(tllama.tiny_llama(dtype=torch.float32),
                        ttrain.TrainConfig(), device="cpu")
    tt.init(params=params_from_numpy(jax.tree.map(np.asarray,
                                                  jt.state.params), "cpu"))
    return jt, tt


def _fit_both(steps, callbacks_of, **kw):
    """Both fits on the same stream; ``callbacks_of(pkg)`` builds each
    package's callbacks. Returns [(trainer, result, callbacks)] for the
    reference, then the port."""
    runs = []
    for pkg, trainer, data in zip(PACKAGES, _trainers(), (jdata, tdata)):
        callbacks = callbacks_of(pkg)
        out = trainer.fit(data.synthetic_token_stream(4, 32, 512, seed=1),
                          steps=steps, callbacks=callbacks, **kw)
        runs.append((trainer, out, callbacks))
    return runs


def test_trainer_fit_drives_hooks_with_epochs():
    """Every step's hook, epochs of 3 steps: the reference's sequence.
    Off the log points the port hands the raw device metrics (tensors,
    no host read); at log points host floats."""
    (_, _, [jrec]), (_, _, [trec]) = _fit_both(
        6, lambda pkg: [_recorder(pkg)], log_every=2, epoch_steps=3)
    assert trec.events == jrec.events
    assert trec.events[:4] == ["train_begin", ("epoch_begin", 0),
                               ("step", 0), ("step", 1)]
    assert trec.events[-3:] == [("step", 5), ("epoch_end", 1), "train_end"]
    assert trec.step_types[0] is torch.Tensor
    assert trec.step_types[1] is float


def test_trainer_early_stop_reports_stopped_early():
    def stop_at_2(pkg):
        class StopAt2(pkg.Callback):
            def on_step_end(self, step, metrics):
                if step >= 2:
                    return False

        return [StopAt2()]

    (jt, jout, _), (tt, tout, _) = _fit_both(50, stop_at_2, log_every=1)
    assert jout["stopped_early"] is tout["stopped_early"] is True
    assert int(jt.state.step) == tt.state.step == 3
    assert tout["step"] == jout["step"] == 3
    assert abs(tout["loss"] - jout["loss"]) <= RUN_REL_TOL * jout["loss"]


def test_early_stopping_on_epochs_stops_at_the_same_step():
    """An epoch-driven EarlyStoppingCallback (patience 1, an improvement
    no loss can make) stops both runs at the second epoch's end."""
    def callbacks(pkg):
        return [pkg.EarlyStoppingCallback(monitor="loss", patience=1,
                                          min_delta=1e3), _recorder(pkg)]

    runs = _fit_both(8, callbacks, log_every=4, epoch_steps=2)
    (jt, jout, [_, jrec]), (tt, tout, [_, trec]) = runs
    assert tout["stopped_early"] and jout["stopped_early"]
    assert tout["step"] == jout["step"] == tt.state.step == 4
    assert trec.events == jrec.events
    assert trec.events[-2:] == [("epoch_end", 1), "train_end"]


def test_trainer_checkpoint_every_n_steps(tmp_path):
    from mlrun_tpu.training import CheckpointManager as JManager

    managers = {jcommon: JManager(str(tmp_path / "j")),
                tcommon: CheckpointManager(str(tmp_path / "t"))}
    runs = _fit_both(4, lambda pkg: [pkg.CheckpointCallback(
        managers[pkg], every_steps=2)], log_every=2)
    for (_, _, [cb]), manager in zip(runs, managers.values()):
        manager.wait()
        assert cb.saves == 2 and manager.latest_step() == 4
        manager.close()
    assert sorted(os.listdir(tmp_path / "t")) == ["2", "4"]


class _Context:
    """A duck-typed run context that records what a run logs."""

    def __init__(self):
        self.metrics, self.results, self.artifacts = [], {}, {}
        self.result_calls, self.models, self.checkpoints = [], [], []

    def is_logging_worker(self):
        return True

    def log_metrics(self, metrics, step=None):
        self.metrics.append(dict(metrics))

    def log_result(self, key, value):
        self.result_calls.append(key)
        self.results[key] = value

    def log_results(self, results):
        self.results.update(results)

    def log_artifact(self, key, local_path="", labels=None, **kw):
        self.artifacts[key] = (local_path, labels)

    def log_model(self, key, **kw):
        self.models.append((key, kw))

    def log_checkpoint(self, path, step=None, commit=True):
        self.checkpoints.append(step)


def _scalars(log_dir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_trainer_tensorboard_artifact(tmp_path):
    """Event files in the log dir, logged as the ``tensorboard`` artifact;
    the same scalar tags and steps as the reference's, losses within the
    training bound."""
    contexts = [_Context(), _Context()]
    callbacks = {pkg: pkg.TensorBoardCallback(log_dir=str(tmp_path / name))
                 for pkg, name in zip(PACKAGES, ("j", "t"))}
    for pkg, trainer, data, context in zip(PACKAGES, _trainers(),
                                           (jdata, tdata), contexts):
        trainer.fit(data.synthetic_token_stream(4, 32, 512, seed=1), 2,
                    log_every=1, context=context, callbacks=[callbacks[pkg]])
    want, got = (_scalars(cb.log_dir) for cb in callbacks.values())
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(callbacks[tcommon].log_dir))
    assert sorted(got) == sorted(want) and "step/loss" in got
    for tag, points in want.items():
        assert [s for s, _ in got[tag]] == [s for s, _ in points], tag
    for (_, a), (_, b) in zip(want["step/loss"], got["step/loss"]):
        assert abs(a - b) <= RUN_REL_TOL * abs(a)
    for context, cb in zip(contexts, callbacks.values()):
        assert context.artifacts["tensorboard"] == (
            cb.log_dir, {"viewer": "tensorboard"})


def test_tensorboard_callback_fails_at_construction_without_a_writer(
        monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for pkg in PACKAGES:
        with pytest.raises(ImportError):
            pkg.TensorBoardCallback()


def test_legacy_callable_fires_at_log_points_only():
    seen = {}
    for pkg, trainer, data in zip(PACKAGES, _trainers(), (jdata, tdata)):
        calls = seen[pkg] = []
        trainer.fit(data.synthetic_token_stream(4, 32, 512, seed=1), 6,
                    log_every=3,
                    callbacks=[lambda step, m, tr: calls.append((step, m))])
    want, got = seen[jcommon], seen[tcommon]
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 5]
    for (_, wm), (_, gm) in zip(want, got):
        assert "tokens_per_sec" in gm and gm["step"] == wm["step"]
        assert abs(gm["loss"] - wm["loss"]) <= RUN_REL_TOL * wm["loss"]


def test_preempted_run_still_finalizes_callbacks():
    from mlrun_tpu.training.preemption import PreemptionGuard as JGuard
    from mlrun_tpu_torch.training import PreemptionGuard as TGuard

    runs = []
    for pkg, trainer, data, guard_cls in zip(PACKAGES, _trainers(),
                                             (jdata, tdata),
                                             (JGuard, TGuard)):
        rec = _recorder(pkg)
        guard = guard_cls()
        guard.request()  # latched before the first step
        out = trainer.fit(data.synthetic_token_stream(4, 32, 512, seed=1),
                          5, log_every=1, callbacks=[rec],
                          preemption_guard=guard)
        runs.append((out, rec.events))
    (jout, jevents), (tout, tevents) = runs
    assert jout["preempted"] is tout["preempted"] is True
    assert tevents == jevents == ["train_begin", "train_end"]


# -- auto_trainer.train: faults 3.3 and 3.5 ------------------------------------

def _raising_warmup(self, *args, **kwargs):
    raise RuntimeError("warmup exploded")


def test_failed_warmup_does_not_end_train(monkeypatch):
    """Fault 3.3: a warmup that raises degrades to a first-step build in
    both packages; the run finishes with the same metric keys and neither
    logs the warmup's ``compile_seconds`` result."""
    monkeypatch.setattr(jtrain.Trainer, "warmup", _raising_warmup)
    monkeypatch.setattr(ttrain.Trainer, "warmup", _raising_warmup)
    contexts = [_Context(), _Context()]
    common = dict(model="tiny", batch_size=2, seq_len=32, steps=2,
                  log_every=1, mesh_shape={"fsdp": 1})
    ref = jauto.train(context=contexts[0], **common)
    ours = tauto.train(context=contexts[1], device="cpu", **common)
    assert set(ours) == set(ref) and ours["step"] == 2.0
    for context in contexts:
        assert "compile_seconds" not in context.result_calls


def test_checkpoints_every_n_steps_through_train(tmp_path):
    """Fault 3.5: ``checkpoint_every=2`` over 6 steps with one log point
    saves steps 2, 4 and 6 in both packages (the port saved only at log
    points), and each save is logged as the run's checkpoint."""
    contexts = [_Context(), _Context()]
    common = dict(model="tiny", batch_size=2, seq_len=32, steps=6,
                  log_every=6, checkpoint_every=2, warmup=False,
                  mesh_shape={"fsdp": 1})
    jauto.train(context=contexts[0], checkpoint_dir=str(tmp_path / "j"),
                **common)
    tauto.train(context=contexts[1], checkpoint_dir=str(tmp_path / "t"),
                device="cpu", **common)
    for name in ("j", "t"):
        steps = sorted(p for p in os.listdir(tmp_path / name) if p.isdigit())
        assert steps == ["2", "4", "6"], name
    assert contexts[1].checkpoints == contexts[0].checkpoints == [2, 4, 6]
    (key, kw), = contexts[1].models
    assert key == "model" and kw["framework"] == "torch"
