"""Framework plumbing shared by the port's adapters — counterpart of
``mlrun_tpu/frameworks/_common`` (the structured callbacks so far; the
artifact plans wait for ROADMAP.md item 10)."""

from .callbacks import (  # noqa: F401
    Callback,
    CallbackList,
    CheckpointCallback,
    EarlyStoppingCallback,
    FunctionCallback,
    MetricsLoggingCallback,
    TensorBoardCallback,
)
