"""The port's goodput ledger (mlrun_tpu_torch/obs/goodput.py) against the
reference's ``GoodputLedger`` under the same fake-clock transitions, and
the training metric families a ``fit`` exports. Exact: the fake clock
ticks in binary fractions, so every sum is exact in both."""

import itertools

import pytest
import torch

from mlrun_tpu.obs import goodput as jgoodput
from mlrun_tpu_torch.models import llama as tllama
from mlrun_tpu_torch.obs import REGISTRY
from mlrun_tpu_torch.obs import goodput as tgoodput
from mlrun_tpu_torch.training import TrainConfig, Trainer
from mlrun_tpu_torch.training import data as tdata
from tests.torch_registries import registries_left_as_found  # noqa: F401

TRAINING_FAMILIES = ("mlt_train_step_seconds", "mlt_training_mfu",
                     "mlt_train_input_wait_seconds",
                     "mlt_train_h2d_bytes_total",
                     "mlt_train_compile_seconds")
GOODPUT_FAMILIES = ("mlt_goodput_seconds_total", "mlt_badput_seconds_total",
                    "mlt_goodput_wall_seconds_total", "mlt_goodput_fraction")


def _drive(ledger_cls, script):
    ticks = itertools.count(0)
    ledger = ledger_cls(run="", clock=lambda: next(ticks) * 0.25)
    for op, *args in script:
        if op == "phase":
            with ledger.phase(args[0]):
                ledger.enter(args[1]) if len(args) > 1 else None
        else:
            getattr(ledger, op)(*args)
    return ledger


SCRIPTS = {
    "fit": [("phase", "checkpoint"), ("attribute", "compile", 1.5),
            ("enter", "data_wait"), ("enter", "h2d"), ("enter", "step"),
            ("transfer", "step", "compile", 0.25), ("enter", "data_wait"),
            ("enter", "h2d"), ("enter", "step"),
            ("phase", "metric_flush"), ("export",), ("close",)],
    "resume": [("phase", "checkpoint", "checkpoint"),
               ("attribute", "re_warm", 0.75), ("enter", "step"),
               ("transfer", "step", "re_warm", 9.0), ("enter", "stall"),
               ("close", "preemption_downtime")],
    "unknown_bucket": [("enter", "step"), ("enter", "mystery"),
                       ("enter", "step"), ("close",)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ledger_matches_reference_under_a_fake_clock(name):
    ours = _drive(tgoodput.GoodputLedger, SCRIPTS[name])
    ref = _drive(jgoodput.GoodputLedger, SCRIPTS[name])
    assert ours.summary() == ref.summary()
    summary = ours.summary()
    assert summary["goodput_s"] + sum(summary["badput"].values()) == \
        summary["wall_s"]
    assert ours.badput() == ref.badput()
    assert ours.goodput_fraction() == ref.goodput_fraction()
    assert tgoodput.BADPUT_BUCKETS == jgoodput.BADPUT_BUCKETS


def test_fit_attributes_its_wall_and_exports_the_families():
    """After a fit the trainer's ledger sums to its wall, its
    ``goodput_fraction`` is the ledger's at the log point, and the five
    training families and the four goodput families render."""
    trainer = Trainer(tllama.tiny_llama(dtype=torch.float32),
                      TrainConfig(learning_rate=1e-2), device="cpu")
    trainer.init(0)
    last = trainer.fit(tdata.synthetic_token_stream(2, 16, 512, seed=1), 3,
                       log_every=3, prefetch=0, defer_metrics=False)
    summary = trainer.goodput.summary()
    assert abs(summary["goodput_s"] + summary["badput_s"]
               - summary["wall_s"]) <= 1e-9 * summary["wall_s"]
    assert summary["badput"]["compile"] == trainer.compile_seconds
    assert {"data_wait", "h2d", "metric_flush"} <= set(summary["badput"])
    assert 0.0 < last["goodput_fraction"] < 1.0
    text = REGISTRY.render()
    for family in TRAINING_FAMILIES + GOODPUT_FAMILIES:
        assert f"# TYPE {family} " in text, family
    h2d = [line for line in text.splitlines()
           if line.startswith("mlt_train_h2d_bytes_total")]
    assert h2d and float(h2d[0].split()[-1]) >= 3 * 2 * 2 * 16 * 4


def test_fit_sets_the_mfu_gauge_and_mfu_alone_sets_nothing():
    """``fit`` sets ``mlt_training_mfu`` to the MFU of its log point;
    ``training.mfu.mfu`` is a pure calculation, so a caller that only
    wants the number leaves the training gauge as it was."""
    from mlrun_tpu_torch.obs import TRAIN_MFU
    from mlrun_tpu_torch.training.mfu import mfu

    trainer = Trainer(tllama.tiny_llama(dtype=torch.float32),
                      TrainConfig(learning_rate=1e-2), device="cpu")
    trainer.init(0)
    last = trainer.fit(tdata.synthetic_token_stream(2, 16, 512, seed=1), 2,
                       log_every=2, prefetch=0, defer_metrics=False)
    assert last["mfu"] > 0.0
    assert TRAIN_MFU.value() == last["mfu"]
    assert mfu(1e6, 1e9, device="cpu") == 1e6 * 1e9 / 1e12
    assert TRAIN_MFU.value() == last["mfu"]
