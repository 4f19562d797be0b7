"""Retry policy and deterministic backoff — the port's copy of the parts of
``mlrun_tpu/common/retry.py`` the engine fleet uses (``RetryPolicy``,
``compute_backoff``). The jitter draw is keyed on (seed, attempt), so a
given seed yields the reference's backoff sequence exactly."""

from __future__ import annotations

import dataclasses
import random


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
