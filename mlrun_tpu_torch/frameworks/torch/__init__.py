"""Torch auto-trainer — counterpart of ``mlrun_tpu/frameworks/jax``."""

from .auto_trainer import (  # noqa: F401
    MODEL_PRESETS,
    TorchTrainerInterface,
    apply_mlrun,
    evaluate,
    train,
)
