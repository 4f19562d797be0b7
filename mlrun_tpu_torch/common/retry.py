"""Retry policy and deterministic backoff — the port's copy of the parts of
``mlrun_tpu/common/retry.py`` the engine fleet and the run objects use
(``FailureClass``, ``RetryPolicy``, ``compute_backoff``). The jitter draw is keyed on (seed, attempt), so a
given seed yields the reference's backoff sequence exactly."""

from __future__ import annotations

import dataclasses
import random


class FailureClass:
    """Coarse failure taxonomy recorded on ``status.failure_class``."""

    # retryable infra faults
    preemption = "preemption"                  # spot/preemptible eviction
    # ONE pod-slice of a multi-slice job evicted while the job itself is
    # alive — the elastic case: survivors reshard and keep training, the
    # monitor submits only a replacement slice (not a full resubmit).
    # Distinguished from ``preemption`` (whole job dead) by the provider's
    # slice_status probe / slice-scoped failure text.
    slice_preempted = "slice_preempted"
    image_pull_backoff = "image_pull_backoff"  # registry flake
    node_drain = "node_drain"                  # node shutdown / drain
    http_5xx = "http_5xx"                      # control-plane 5xx
    resource_vanished = "resource_vanished"    # GC'd / deleted out-of-band
    infra = "infra"                            # generic infra failure
    stalled = "stalled"                        # heartbeat-silent run
    # permanent
    user_code = "user_code"                    # handler raised / exit != 0

    @staticmethod
    def retryable() -> list[str]:
        return [
            FailureClass.preemption, FailureClass.slice_preempted,
            FailureClass.image_pull_backoff,
            FailureClass.node_drain, FailureClass.http_5xx,
            FailureClass.resource_vanished, FailureClass.infra,
            FailureClass.stalled,
        ]


@dataclasses.dataclass
class RetryPolicy:
    """Backoff policy: the reference's fields and defaults that
    :func:`compute_backoff` reads."""

    max_retries: int = 0
    backoff: float = 5.0          # first-retry delay, seconds
    backoff_factor: float = 2.0   # exponential growth per attempt
    backoff_max: float = 300.0    # delay ceiling
    jitter: float = 0.1           # ± fraction of the delay


def compute_backoff(attempt: int, policy: RetryPolicy, seed: str = "") -> float:
    """Exponential backoff with deterministic jitter: the jitter draw is
    keyed on (seed, attempt), so a retry timeline is reproducible.
    ``attempt`` is 0-based (0 -> first retry)."""
    if policy.backoff <= 0:
        return 0.0
    delay = min(policy.backoff * (policy.backoff_factor ** attempt),
                policy.backoff_max)
    if policy.jitter > 0:
        rng = random.Random(f"{seed}:{attempt}")
        delay *= 1.0 + rng.uniform(-policy.jitter, policy.jitter)
    return max(0.0, delay)
