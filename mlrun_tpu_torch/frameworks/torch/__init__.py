"""Torch auto-trainer — counterpart of ``mlrun_tpu/frameworks/jax``."""

from .auto_trainer import MODEL_PRESETS, train  # noqa: F401
