"""Median, over the traced window's complete training steps, of the device
milliseconds of the ``train.optimizer`` phase (global norm, clip, AdamW),
read from the port's process tracer. None where the program emits no
phase spans."""

import statistics


def read(run):
    from mlrun_tpu_torch.obs import get_tracer
    from mlrun_tpu_torch.utils import profiler

    step_phases = getattr(profiler, "step_phases", None)
    if step_phases is None or run.get("kind") != "train":
        return None
    values = [s["ms"]["train.optimizer"] for s in
              step_phases(get_tracer().spans(), run["t0"], run["t1"])]
    return statistics.median(values) if values else None
