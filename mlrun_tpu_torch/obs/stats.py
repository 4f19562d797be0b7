"""Shared statistics helper of the port's observability layer — a copy of
``mlrun_tpu/obs/stats.py``: the one nearest-rank percentile the engine
latency rings quote p50/p95 with (p95 of 100 samples is the 95th
smallest: index ``ceil(q * n) - 1``)."""

from __future__ import annotations

import math


def nearest_rank(sorted_samples, q: float) -> float:
    """Nearest-rank percentile: the ``ceil(q * n)``-th order statistic of
    an already-sorted, non-empty sample sequence (0 < q <= 1)."""
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("nearest_rank needs at least one sample")
    idx = max(0, math.ceil(q * n) - 1)
    return sorted_samples[min(idx, n - 1)]
