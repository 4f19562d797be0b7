"""Chaos-injection layer of the port: break a serving path on demand,
deterministically (registry.py). A copy of ``mlrun_tpu/chaos`` with its own
process-wide registry::

    from mlrun_tpu_torch.chaos import FaultPoints, chaos, fail_nth

    with chaos.inject(FaultPoints.llm_spec_verify, fail_nth(2),
                      error=RuntimeError("injected")):
        ...  # the second speculative round parks to plain decode
"""

from .registry import (  # noqa: F401
    ChaosRegistry,
    FaultPoints,
    Injection,
    Schedule,
    always,
    chaos,
    fail_after,
    fail_first,
    fail_nth,
    fail_with_prob,
    fire,
    set_fire_observer,
)
