"""Median, over the traced window's complete training steps, of the device
milliseconds of the MoE layers' routing, dispatch and combine in the
forward: per step the sum of the ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans over the layers, those of a checkpoint's recompute
left out. Read from the port's process tracer; None where the program
emits no such spans."""

import statistics

PHASES = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    from mlrun_tpu_torch.obs import get_tracer
    from mlrun_tpu_torch.utils import profiler

    step_phases = getattr(profiler, "step_phases", None)
    if step_phases is None or run.get("kind") != "train":
        return None
    values = [sum(s["ms"].get(name, 0.0) for name in PHASES) for s in
              step_phases(get_tracer().spans(), run["t0"], run["t1"])
              if any(name in s["ms"] for name in PHASES)]
    return statistics.median(values) if values else None
